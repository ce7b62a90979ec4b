"""Device time of the cuBLAS products a step (the chip step's synapse
product, and the dense route's), in us, from the device trace."""

from bench.lib import readers


def read(ctx):
    return readers.per_step_us(ctx, ctx.gemm)
