"""Stream time of the engine's copies to the host (``engine.account``, a
window's outputs, and ``engine.finalize``, each finished session's
result) an engine step of the traced steps, in ms, from the program's
spans."""

from bench.lib import stages


def read(ctx):
    return stages.to_host_ms_per_window(ctx)
