"""Stream time of the chip step (``stream.chip_step``: the delay-line
read, ``chip_step`` or ``chip_step_slots`` and the slot mask) a step of
the traced ``run_stream`` calls, in us, from the program's spans."""

from bench.lib import stages


def read(ctx):
    return stages.per_step(ctx, ["stream.chip_step"], 1e6)
