"""Plan verifier: pure-static invariant checks on compiled ``FabricPlan``s.

Port of ``src/repro/analysis/planlint.py`` over the port's plans
(``repro_torch.core.fabric``); every finding is the reference's, in its
order, message for message.

The hardware analogue is the pre-silicon assertion pass (Grübl et al. 2020)
— every invariant the exchange executors *assume* about a plan is proven
here on the plan alone, before anything runs:

  * structural typing — level shapes, enables matrices, health-vector
    lengths against ``edge_counts``, fan-in bounds (extension levels may
    not exceed the Aggregator's ``EXTENSION_LANES``);
  * capacity monotonicity — every cascaded compact-before-gather pack
    narrows (a capacity wider than its incoming stream is a widening: the
    wire would carry slots that can never fill);
  * merge-segment layout — the per-destination merge stream is tiled by
    disjoint, covering, nearest-level-first segments (the pack units index
    by these lengths; an overlap silently corrupts a neighbour's events);
  * detour discipline — extension-lane reroutes only above the leaf MGT
    tier, hosts alive / in-group / distinct, at most ``EXTENSION_LANES``
    detours per host, none when the spec forbids rerouting;
  * event conservation — every (src, dst) leaf pair is typed to exactly
    one outcome: gated off by route enables, delivered (optionally via a
    detour, i.e. counted ``ExchangeDrops.rerouted``), or dead-edge
    ``unroutable``; the remaining drop classes (``congestion``, ``uplink``)
    are capacity overflow on a *delivered* route and never overlap the
    dead-edge typing.

Violations carry the offending scenario/level/edge path.
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic, WARNING
from repro_torch.core.fabric import FabricPlan
from repro_torch.core.interconnect import EXTENSION_LANES


def stream_lengths(plan: FabricPlan, cap_in: int) -> tuple[int, ...]:
    """Per-level length of each child's stream entering level ``i``'s merge
    (level 0: the leaf egress after the MGT pack)."""
    out = []
    cur = plan.levels[0].link_capacity
    cur = cap_in if cur is None else cur
    for i, lvl in enumerate(plan.levels):
        out.append(cur)
        if i + 1 < plan.n_levels:
            nxt = plan.levels[i + 1].link_capacity
            cur = lvl.fan_in * cur if nxt is None else nxt
    return tuple(out)


def check_shape(plan: FabricPlan, path: str = "plan") -> list[Diagnostic]:
    """Structural typing: node counts, enables matrices, health vectors."""
    diags = []
    prod = 1
    for lvl in plan.levels:
        prod *= lvl.fan_in
    if plan.n_nodes != prod:
        diags.append(Diagnostic(
            "plan.shape", path,
            f"n_nodes={plan.n_nodes} but the levels fan out to {prod}"))
    if plan.capacity < 1:
        diags.append(Diagnostic(
            "plan.shape", path,
            f"ingress capacity must be positive: {plan.capacity}"))
    leaves = 1
    for i, (lvl, n_edges) in enumerate(zip(plan.levels, plan.edge_counts)):
        lpath = f"{path}/level[{i}]"
        leaves *= lvl.fan_in
        if lvl.leaves != leaves:
            diags.append(Diagnostic(
                "plan.shape", lpath,
                f"leaves={lvl.leaves} but the levels below cover {leaves}"))
        en = np.asarray(lvl.enables)
        if en.shape != (lvl.fan_in, lvl.fan_in):
            diags.append(Diagnostic(
                "plan.shape", lpath,
                f"enables shape {en.shape} does not match fan_in "
                f"{lvl.fan_in}"))
        elif en.dtype != np.bool_:
            diags.append(Diagnostic(
                "plan.shape", lpath,
                f"enables dtype {en.dtype} is not bool", WARNING))
        for name, vec in (("uplink_ok", lvl.uplink_ok),
                          ("downlink_ok", lvl.downlink_ok),
                          ("detour", lvl.detour)):
            if vec is not None and vec.shape != (n_edges,):
                diags.append(Diagnostic(
                    "plan.shape", lpath,
                    f"{name} has {vec.shape[0]} entries but the level "
                    f"crosses {n_edges} edges"))
    return diags


def check_fan_in(plan: FabricPlan, path: str = "plan") -> list[Diagnostic]:
    """Fan-in bounds: positive everywhere; extension levels within the
    Aggregator's spare-lane count."""
    diags = []
    for i, (lvl, spec_lvl) in enumerate(zip(plan.levels, plan.spec.levels)):
        lpath = f"{path}/level[{i}]"
        if lvl.fan_in < 1:
            diags.append(Diagnostic(
                "plan.fan-in", lpath, f"fan_in must be >= 1: {lvl.fan_in}"))
        if spec_lvl.extension and lvl.fan_in > EXTENSION_LANES:
            diags.append(Diagnostic(
                "plan.fan-in", lpath,
                f"extension level joins {lvl.fan_in} children over "
                f"{EXTENSION_LANES} Aggregator extension lanes"))
    return diags


def check_capacity_monotone(plan: FabricPlan, cap_in: int,
                            path: str = "plan") -> list[Diagnostic]:
    """Cascaded packs must narrow: a ``link_capacity`` wider than the stream
    feeding it provisions wire slots that can never fill (and desyncs the
    merge-segment tiling from the true event count)."""
    diags = []
    lens = stream_lengths(plan, cap_in)
    u0 = plan.levels[0].link_capacity
    if u0 is not None and u0 > cap_in:
        diags.append(Diagnostic(
            "plan.capacity-monotone", f"{path}/level[0]",
            f"leaf uplink capacity {u0} exceeds the egress frame width "
            f"{cap_in}"))
    for i in range(1, plan.n_levels):
        cap = plan.levels[i].link_capacity
        feed = plan.levels[i - 1].fan_in * lens[i - 1]
        if cap is not None and cap > feed:
            diags.append(Diagnostic(
                "plan.capacity-monotone", f"{path}/level[{i}]",
                f"uplink capacity {cap} exceeds the {feed}-event stream "
                f"aggregated below it (pack must narrow, never widen)"))
        if cap is not None and cap < 1:
            diags.append(Diagnostic(
                "plan.capacity-monotone", f"{path}/level[{i}]",
                f"uplink capacity must be >= 1: {cap}"))
    total = sum(lvl.fan_in * ln for lvl, ln in zip(plan.levels, lens))
    if plan.capacity > total:
        diags.append(Diagnostic(
            "plan.capacity-monotone", path,
            f"ingress capacity {plan.capacity} exceeds the {total}-event "
            f"merge stream it packs", WARNING))
    return diags


def check_merge_segments(plan: FabricPlan, cap_in: int, path: str = "plan",
                         layout=None) -> list[Diagnostic]:
    """The merge stream's segment tiling must partition each destination's
    frame: per level, ``fan_in`` equal segments of exactly the child-stream
    length (disjoint + covering), levels nearest-first.  ``layout`` defaults
    to the plan's own ``merge_layout`` — passing one lets tests (and future
    hand-built executors) validate an external tiling against the plan."""
    diags = []
    if layout is None:
        layout = plan.merge_layout(cap_in)
    lens = stream_lengths(plan, cap_in)
    if len(layout) != plan.n_levels:
        return [Diagnostic(
            "plan.merge-segments", path,
            f"layout covers {len(layout)} levels, plan has "
            f"{plan.n_levels}")]
    for i, (segs, lvl, unit) in enumerate(zip(layout, plan.levels, lens)):
        lpath = f"{path}/level[{i}]"
        width = lvl.fan_in * unit
        got = sum(segs)
        if any(s < 1 for s in segs):
            diags.append(Diagnostic(
                "plan.merge-segments", lpath,
                f"empty/negative segment in {segs}"))
            continue
        if got > width:
            diags.append(Diagnostic(
                "plan.merge-segments", lpath,
                f"segments sum to {got} but the level's stream is {width} "
                f"wide — overlapping windows would corrupt a neighbour's "
                f"events ({segs})"))
        elif got < width:
            diags.append(Diagnostic(
                "plan.merge-segments", lpath,
                f"segments sum to {got} < stream width {width} — "
                f"uncovered events would be dropped silently ({segs})"))
        if got == width and any(s != unit for s in segs):
            diags.append(Diagnostic(
                "plan.merge-segments", lpath,
                f"segment lengths {segs} do not tile the {unit}-wide child "
                f"streams (misaligned windows split events across "
                f"segments)"))
    return diags


def check_detours(plan: FabricPlan, path: str = "plan") -> list[Diagnostic]:
    """Extension-lane reroute discipline (the paper's 4 spare lanes)."""
    diags = []
    for i, lvl in enumerate(plan.levels):
        if lvl.detour is None:
            continue
        lpath = f"{path}/level[{i}]"
        if lvl.uplink_ok is None:
            diags.append(Diagnostic(
                "plan.detours", lpath,
                "detours assigned on a level with no dead uplinks"))
            continue
        live = np.flatnonzero(lvl.detour >= 0)
        if live.size and i == 0:
            diags.append(Diagnostic(
                "plan.detours", lpath,
                "leaf MGT lanes have no sibling interconnect to detour "
                f"over (edges {live.tolist()})"))
        if live.size and not plan.spec.reroute:
            diags.append(Diagnostic(
                "plan.detours", lpath,
                f"spec forbids rerouting but edges {live.tolist()} carry "
                f"detours"))
        for e in live:
            h = int(lvl.detour[e])
            epath = f"{lpath}/edge[{e}]"
            if lvl.uplink_ok[e]:
                diags.append(Diagnostic(
                    "plan.detours", epath,
                    f"detour hosted for an alive edge (host {h})", WARNING))
            if not 0 <= h < lvl.detour.shape[0]:
                diags.append(Diagnostic(
                    "plan.detours", epath, f"detour host {h} out of range"))
                continue
            if h == e:
                diags.append(Diagnostic(
                    "plan.detours", epath, "edge detours through itself"))
            if h // lvl.fan_in != e // lvl.fan_in:
                diags.append(Diagnostic(
                    "plan.detours", epath,
                    f"detour host {h} sits outside edge {e}'s group (no "
                    f"shared Aggregator, no spare lanes to borrow)"))
            if not lvl.uplink_ok[h]:
                diags.append(Diagnostic(
                    "plan.detours", epath,
                    f"detour host {h} is itself dead — the rerouted stream "
                    f"dies on the host's uplink"))
        counts = lvl.detour_counts()
        for h in np.flatnonzero(counts > EXTENSION_LANES):
            diags.append(Diagnostic(
                "plan.detours", f"{lpath}/edge[{h}]",
                f"host carries {int(counts[h])} detours over its "
                f"{EXTENSION_LANES} spare extension lanes"))
    return diags


def classify_pairs(plan: FabricPlan) -> dict[str, np.ndarray]:
    """Static event-conservation typing of every (src, dst) leaf pair.

    Returns bool[n, n] masks: ``ungated`` (route enables never address the
    pair), ``delivered``, ``unroutable`` (a dead edge with no surviving
    route kills the pair's traffic), plus the ``rerouted`` modifier
    (delivered over a detour — arrives, but counted in
    ``ExchangeDrops.rerouted``).  ``ungated``/``delivered``/``unroutable``
    partition the full pair matrix; the dynamic drop classes
    (``congestion``, ``uplink``) only ever apply to ``delivered`` pairs.
    """
    n = plan.n_nodes
    lvl_of = plan.delivery_levels()
    gate = np.zeros((n, n), bool)
    for i in range(plan.n_levels):
        at = lvl_of == i
        gate[at] = plan.level_gate(i)[at]
    src_dead = np.zeros((n, n), bool)
    src_detour = np.zeros((n, n), bool)
    dst_dead = np.zeros((n, n), bool)
    for j, lvl in enumerate(plan.levels):
        ent = plan.leaf_entities(j)
        crosses = lvl_of >= j        # pair's stream ascends through level j
        if lvl.uplink_ok is not None:
            src_dead |= crosses & ~lvl.routable[ent][:, None]
            det = ~lvl.uplink_ok & (lvl.detour >= 0)
            src_detour |= crosses & det[ent][:, None]
        if lvl.downlink_ok is not None:
            dst_dead |= crosses & ~lvl.downlink_ok[ent][None, :]
    unroutable = gate & (src_dead | dst_dead)
    delivered = gate & ~unroutable
    return {
        "ungated": ~gate,
        "delivered": delivered,
        "unroutable": unroutable,
        "rerouted": delivered & src_detour,
    }


def check_conservation(plan: FabricPlan, path: str = "plan"
                       ) -> list[Diagnostic]:
    """Every pair routes through exactly one level and lands in exactly one
    conservation class; detoured routes must cross only live hosts."""
    diags = []
    n = plan.n_nodes
    lvl_of = plan.delivery_levels()
    bad = np.argwhere((lvl_of < 0) | (lvl_of >= plan.n_levels))
    for s, d in bad[:8]:
        diags.append(Diagnostic(
            "plan.conservation", f"{path}/pair[{s},{d}]",
            "no hop-graph level joins the pair — unreachable route"))
    if bad.size:
        return diags
    classes = classify_pairs(plan)
    cover = (classes["ungated"].astype(int) + classes["delivered"]
             + classes["unroutable"])
    for s, d in np.argwhere(cover != 1)[:8]:
        diags.append(Diagnostic(
            "plan.conservation", f"{path}/pair[{s},{d}]",
            f"pair typed to {int(cover[s, d])} conservation classes "
            "(must be exactly one of ungated/delivered/unroutable)"))
    if bool(classes["delivered"].diagonal().any()):
        leaf = int(np.flatnonzero(classes["delivered"].diagonal())[0])
        diags.append(Diagnostic(
            "plan.conservation", f"{path}/pair[{leaf},{leaf}]",
            "self-delivery enabled at the leaf tier (the wire has no "
            "loopback lane)", WARNING))
    if not plan.degraded and bool(classes["unroutable"].any()):
        s, d = np.argwhere(classes["unroutable"])[0]
        diags.append(Diagnostic(
            "plan.conservation", f"{path}/pair[{s},{d}]",
            "healthy plan types the pair unroutable"))
    # A detoured route is only a delivery if every host on it is live —
    # check_detours flags the dead host; here we flag the typing fallout.
    for j, lvl in enumerate(plan.levels):
        if lvl.detour is None or lvl.uplink_ok is None:
            continue
        for e in np.flatnonzero(lvl.detour >= 0):
            h = int(lvl.detour[e])
            if 0 <= h < lvl.detour.shape[0] and not lvl.uplink_ok[h]:
                diags.append(Diagnostic(
                    "plan.conservation", f"{path}/level[{j}]/edge[{e}]",
                    f"route typed delivered-via-detour crosses dead host "
                    f"{h} — its events are lost but not counted "
                    f"unroutable"))
    return diags


def lint_plan(plan: FabricPlan, cap_in: int,
              path: str = "plan") -> list[Diagnostic]:
    """All plan passes; ``path`` prefixes every finding (scenario name)."""
    diags = check_shape(plan, path)
    if diags and any(d.check == "plan.shape" and d.severity == "error"
                     for d in diags):
        return diags                 # downstream checks index by these shapes
    diags += check_fan_in(plan, path)
    diags += check_capacity_monotone(plan, cap_in, path)
    diags += check_merge_segments(plan, cap_in, path)
    diags += check_detours(plan, path)
    diags += check_conservation(plan, path)
    return diags
