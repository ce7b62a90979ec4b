"""What the per-layer metric readers (``bench/metrics/<metric>.py``) share.

A reader takes the run's context (``ctx``: the benchmark's spans around
the calls into each layer, the device trace of the traced calls, the
work those calls had to do, the configuration and the traffic) and
returns its number, or None when the run gave it nothing to read.
"""

from __future__ import annotations

import re

from bench.lib import roofline, stats

EXCHANGE = re.compile(r"exchange_(row|tiled)_kernel")
MERGE_PACK = re.compile(r"merge_pack_(scan|tiled)_kernel")


def per_step_ops(ctx) -> float | None:
    if ctx.trace is None or not ctx.traced_steps or not ctx.trace.device_ops:
        return None
    return ctx.trace.device_ops / ctx.traced_steps


def span_p95_ms(ctx, span: str) -> float | None:
    samples = ctx.spans.get(span) or []
    return 1e3 * stats.percentile(samples, 95) if samples else None


def per_step_us(ctx, pattern) -> float | None:
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = ctx.trace.seconds(pattern)
    return 1e6 * s / ctx.traced_steps if s else None


def idle_percent(ctx) -> float | None:
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def work_totals(counters) -> dict:
    """The traced calls' counted work summed by key (launches, events
    valid and kept, ...), as the result line's ``work``."""
    totals = {}
    for w in counters or []:
        for k in ("launches", "valid", "kept"):
            if k in w:
                totals[k] = totals.get(k, 0) + w[k]
    return totals


def exchange_share(ctx) -> float | None:
    """The exchange kernel's roofline share over the traced calls."""
    if ctx.trace is None or not ctx.counters:
        return None
    nbytes = ops = 0
    for w in ctx.counters:
        if "valid" not in w:
            continue
        slots = w["batch"] * w["n"] * w["cap_in"]
        b, o = roofline.exchange_cost(
            launches=w["launches"], slots=slots, n_dst=w["n"],
            enables=w["n"] * w["n"],
            out_slots=w["batch"] * w["n"] * w["capacity"],
            out_rows=w["batch"] * w["n"], valid=w["valid"], kept=w["kept"])
        nbytes, ops = nbytes + b, ops + o
    if not nbytes:
        return None
    return roofline.share(nbytes, ops, ctx.trace.seconds(EXCHANGE),
                          ctx.device_kind)


def merge_share(ctx) -> float | None:
    """The merge_pack kernel's roofline share over the traced calls."""
    if ctx.trace is None or not ctx.counters:
        return None
    nbytes = ops = 0
    for w in ctx.counters:
        if "merge_slots" not in w:
            continue
        rows = w["batch"] * w["n"]
        b, o = roofline.merge_cost(
            launches=w["launches"], slots=rows * w["merge_slots"],
            out_slots=rows * w["capacity"], out_rows=rows, kept=w["kept"],
            timed=ctx.traffic["timed"])
        nbytes, ops = nbytes + b, ops + o
    if not nbytes or not ctx.trace.launches(MERGE_PACK):
        return None
    return roofline.share(nbytes, ops, ctx.trace.seconds(MERGE_PACK),
                          ctx.device_kind)
