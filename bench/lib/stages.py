"""What the readers of the program's own stage spans share.

The port records its stages (``repro_torch.obs``: ``span`` and ``count``)
only while ``torch.profiler`` runs, that is, over the traced calls of a
``--trace 1`` run; ``obs.summary()`` sums them by name: ``count``,
``host_s``, ``self_host_s``, ``stream_s`` (CUDA events on the stream the
program runs on) and ``self_stream_s``, and the counters.  A program
without the recorder, or a run in which a stage never ran, gives these
readers nothing, and they return None.
"""

from __future__ import annotations

TO_HOST = ("engine.account", "engine.finalize")


def recorded() -> tuple[dict, dict]:
    """The program's spans and counters by name (empty if it records
    none)."""
    try:
        from repro_torch import obs
    except ImportError:
        return {}, {}
    got = obs.summary()
    return got["spans"], got["counters"]


def stream_s(spans: dict, names) -> float | None:
    """The summed stream seconds of the stages ``names`` that were seen,
    or None if none was."""
    seen = [spans[n]["stream_s"] for n in names if n in spans]
    return sum(seen) if seen else None


def per_step(ctx, names, scale: float) -> float | None:
    """The stages' stream time a traced emulated step, times ``scale``."""
    s = stream_s(recorded()[0], names)
    if s is None or not ctx.traced_steps:
        return None
    return scale * s / ctx.traced_steps


def to_host_ms_per_window(ctx) -> float | None:
    """Stream ms of the engine's copies to the host an engine step."""
    spans, _ = recorded()
    s = stream_s(spans, TO_HOST)
    steps = spans.get("engine.step", {}).get("count")
    if s is None or not steps:
        return None
    return 1e3 * s / steps


def to_host_gb_per_s(ctx) -> float | None:
    """Bytes the engine brought to the host over those copies' stream
    time, in GB/s."""
    spans, counters = recorded()
    s = stream_s(spans, TO_HOST)
    n = counters.get("engine.to_host_bytes")
    if not s or not n:
        return None
    return n / s * 1e-9
