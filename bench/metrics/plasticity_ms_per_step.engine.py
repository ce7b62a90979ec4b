"""Stream time of plasticity (``stream.plasticity``) an emulated step of
the traced engine steps, in ms, from the program's spans."""

from bench.lib import stages


def read(ctx):
    return stages.per_step(ctx, ["stream.plasticity"], 1e3)
