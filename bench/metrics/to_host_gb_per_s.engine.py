"""The bytes the engine brought to the host (the program's counter
``engine.to_host_bytes``) over the stream time of the copies that brought
them (``engine.account`` and ``engine.finalize``), in GB/s."""

from bench.lib import stages


def read(ctx):
    return stages.to_host_gb_per_s(ctx)
