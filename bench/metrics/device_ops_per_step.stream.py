"""Device operations (kernels, copies, fills) a step of ``run_stream``,
from the device trace of the traced calls."""

from bench.lib import readers


def read(ctx):
    return readers.per_step_ops(ctx)
