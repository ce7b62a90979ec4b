"""Stream time of the exchange's packs (``exchange.egress``, the egress
frame, and ``fabric.uplink_pack``, every uplink pack) a step of the traced
``run_stream`` calls, in us, from the program's spans."""

from bench.lib import stages


def read(ctx):
    return stages.per_step(ctx, ["exchange.egress", "fabric.uplink_pack"],
                           1e6)
