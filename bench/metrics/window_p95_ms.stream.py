"""95th percentile of every synchronised ``run_stream`` call of the run
(the benchmark's spans), in ms."""

from bench.lib import readers


def read(ctx):
    return readers.span_p95_ms(ctx, "run_stream")
