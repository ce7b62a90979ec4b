"""95th percentile of every ``EmulationEngine.step`` of the run (the
benchmark's spans; each ends with the step's copies to the host), in
ms."""

from bench.lib import readers


def read(ctx):
    return readers.span_p95_ms(ctx, "engine.step")
