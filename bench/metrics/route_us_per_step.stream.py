"""Stream time of the route (``stream.route``: the exchange stage, or the
dense route's product) a step of the traced ``run_stream`` calls, in us,
from the program's spans."""

from bench.lib import stages


def read(ctx):
    return stages.per_step(ctx, ["stream.route"], 1e6)
