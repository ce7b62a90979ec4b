"""Fabric: N-level topologies compiled into one hop-graph executor.

Port of the stacked part of ``src/repro/core/fabric.py``.

* ``LevelSpec`` / ``FabricSpec`` — a declarative topology: per-level
  fan-in, route enables, uplink (link) capacities, crossing extras for the
  timed lane, the extension-lane constraint, static per-edge health and
  the wire strategy (``exchange_mode``, "gather" or "routed").
* ``compile_fabric`` → ``FabricPlan`` — the static hop graph, host side in
  numpy: per-level fan-ins, enables, compact-before-gather capacities,
  extension-lane detours around dead uplinks, and the per-destination
  merge segment layout.
* ``fabric_route_step`` — one exchange round for all leaves (and any
  leading batch rows) on one device.  The plain one-level untimed star runs
  the ``exchange`` kernel; every other plan, every round with a health
  overlay and every round with ``engine="merge"`` runs fwd LUT, cascaded
  uplink packs and the nearest-first merge in PyTorch, then the
  ``merge_pack`` kernel as the merge tail.  ``use_fused=False`` is the
  reference's unfused composition, plain PyTorch with no kernel.
* ``pick_exchange_mode`` — time both wire strategies on a plan and its
  traffic and keep the faster.
* ``fabric_exchange`` — the sharded executor on ``torch.distributed``: one
  leaf per rank of a nested ``DeviceMesh`` (``parallel.sharding.
  fabric_mesh``), one all-gather of 16-bit wire words per level, or in
  routed mode point-to-point sends along the hop-graph edges only; the
  same merge tail (the ``merge_pack`` kernel) and the same observables as
  ``fabric_route_step``, bit for bit.
* ``FabricInterconnect`` — the mesh binding, with ``exchange_fn`` /
  ``stream_fn``.

Hop-graph semantics (paper §III/§V): leaves are the ``prod(fan_in)``
Node-FPGA endpoints.  A tier-``i`` entity (tier 0 = leaf, tier 1 =
backplane, ...) uplinks its aggregated egress stream into the tier-``i+1``
merge, packed to that level's ``link_capacity`` (overflow is an uplink drop
attributed to every leaf of the entity); packs cascade.  A destination leaf
merges, nearest first, the streams of its own backplane, then of the
sibling backplanes in its case, and so on, gated by each level's route
enables (own subtree excluded above level 1); then it packs to the ingress
``capacity`` and applies its reverse LUT.  On the timed lane each crossing
above level 1 adds its fixed extra plus the uplink lane's wait of the
event's rank in the entity stream.

Degraded mode: static per-edge health is compiled into the plan (with
extension-lane detours); a dynamic ``FabricHealth`` overlay masks edges per
round on top of it without a recompile and without rerouting, and
``FaultEvent`` schedules expand into per-step overlays
(``health_schedule``) or into the constant-health segments that
``run_stream``'s reroute mode recompiles (``fault_boundaries``,
``dead_edges_at``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, resolve_device
from repro_torch.core import routing
from repro_torch.core.events import (EventFrame, make_frame, pack_wire16,
                                     unpack_wire16)
from repro_torch.core.interconnect import (BACKPLANES_PER_RACK,
                                           CHIPS_PER_BACKPLANE,
                                           EXTENSION_LANES)
from repro_torch.core.latency import LatencyParams, TimedWire, queue_wait_i32
from repro_torch.core.link import LinkConfig
from repro_torch.kernels.spike_router.ops import (fused_exchange,
                                                  fused_merge_pack)
from repro_torch.kernels.spike_router.ref import merge_pack_ref
from repro_torch.parallel.collectives import transport_device
from repro_torch.parallel.sharding import (edge_neighbor_permutes,
                                           fabric_leaf_index)


class ExchangeDrops(NamedTuple):
    """Loss accounting of one exchange round, split by drop point (int32,
    one entry per destination leaf):

    ``congestion``: destination pack-unit overflow.
    ``uplink``: overflow of the compact-before-gather uplink packs
    (higher-level overflow attributed to every leaf of the packed entity).
    ``unroutable``: events killed by a dead edge with no surviving route.
    ``rerouted``: not a loss — events that crossed a dead uplink over a
    sibling's spare extension lanes.
    """

    congestion: torch.Tensor
    uplink: torch.Tensor
    unroutable: torch.Tensor
    rerouted: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.congestion + self.uplink + self.unroutable


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Topology description (host side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One level of the hop graph: a node joining ``fan_in`` children.

    ``enables``: bool[fan_in, fan_in] route enables between the node's
    children (``None`` = all-to-all, without self-loops at level 1).
    ``link_capacity``: events each child's uplink admits per round (``None``
    = the whole stream travels); ``link`` derives it from the transceiver
    model instead.  ``latency``: per-level crossing extra for the timed
    lane (``None`` = the ``TimedWire`` default).  ``extension``: the
    children ride the Aggregator's extension lanes.  ``uplink_health`` /
    ``downlink_health``: static per-edge health, one bool per child entity
    crossing into this level, entity-major.
    """

    fan_in: int
    enables: object = None
    link_capacity: int | None = None
    link: LinkConfig | None = None
    latency: LatencyParams | None = None
    extension: bool = False
    uplink_health: tuple[bool, ...] | None = None
    downlink_health: tuple[bool, ...] | None = None


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """A declarative N-level topology, leaf level first."""

    levels: tuple[LevelSpec, ...]
    capacity: int
    window_us: float | None = None
    name: str = ""
    reroute: bool = True
    exchange_mode: str = "gather"

    @property
    def n_nodes(self) -> int:
        return math.prod(lvl.fan_in for lvl in self.levels)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Compiled static state of one hop-graph level (numpy)."""

    fan_in: int
    enables: np.ndarray        # bool[fan_in, fan_in]
    link_capacity: int | None  # per-child uplink pack into this level
    extra_ns: int | None       # timed crossing extra; None = TimedWire default
    leaves: int                # leaves under one node of this level
    uplink_ok: np.ndarray | None = None    # bool[n_edges]; None = all healthy
    detour: np.ndarray | None = None       # int32[n_edges] host edge, -1 none
    downlink_ok: np.ndarray | None = None  # bool[n_edges]; None = all healthy

    @property
    def routable(self) -> np.ndarray | None:
        """Edges whose traffic survives: alive, or detoured via a host."""
        if self.uplink_ok is None:
            return None
        return self.uplink_ok | (self.detour >= 0)

    @property
    def degraded(self) -> bool:
        return self.uplink_ok is not None or self.downlink_ok is not None

    def detour_counts(self) -> np.ndarray | None:
        """Detours hosted per uplink edge (index = the *host* edge), the
        static-analysis view of the extension-lane budget: every entry must
        stay <= ``interconnect.EXTENSION_LANES``.  ``None`` when healthy."""
        if self.detour is None:
            return None
        hosts = self.detour[self.detour >= 0]
        return np.bincount(hosts, minlength=self.detour.shape[0])


@dataclasses.dataclass(frozen=True)
class FabricPlan:
    """The compiled hop graph the executor consumes."""

    spec: FabricSpec
    levels: tuple[LevelPlan, ...]
    n_nodes: int
    capacity: int

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def fan_ins(self) -> tuple[int, ...]:
        return tuple(lvl.fan_in for lvl in self.levels)

    @property
    def compact(self) -> bool:
        """Every merge segment is front-compacted (leaf lanes packed)."""
        return self.levels[0].link_capacity is not None

    @property
    def exchange_mode(self) -> str:
        return self.spec.exchange_mode

    @property
    def degraded(self) -> bool:
        return any(lvl.degraded for lvl in self.levels)

    @property
    def edge_counts(self) -> tuple[int, ...]:
        """Per-level uplink/downlink edge counts (children crossing level
        i)."""
        out, gsize = [], 1
        for lvl in self.levels:
            out.append(self.n_nodes // gsize)
            gsize *= lvl.fan_in
        return tuple(out)

    # -- introspection hooks (the static-analysis surface, analysis/) --
    #
    # The hop graph's addressing as plain numpy: which entity a leaf is at
    # each tier, through which level a (src, dst) pair's traffic travels,
    # and what the route-enable gate says there, so the plan verifier
    # (analysis/planlint.py) can type every pair's delivery without
    # re-deriving the executors' index arithmetic.

    @property
    def group_sizes(self) -> tuple[int, ...]:
        """Leaves per tier-``i`` entity feeding level ``i``'s merge (tier 0 =
        leaf): ``(1, f0, f0·f1, ...)``, one entry per level."""
        out, g = [], 1
        for lvl in self.levels:
            out.append(g)
            g *= lvl.fan_in
        return tuple(out)

    def leaf_entities(self, level: int) -> np.ndarray:
        """int[n_nodes]: each leaf's tier-``level`` entity index, the
        global uplink/downlink edge its traffic crosses into that level's
        merge."""
        return np.arange(self.n_nodes) // self.group_sizes[level]

    def delivery_levels(self) -> np.ndarray:
        """int32[n, n]: the unique hop-graph level through which ``src``'s
        stream joins ``dst``'s merge, the lowest level whose joining node
        covers both leaves (health and gating not applied)."""
        n = self.n_nodes
        out = np.full((n, n), -1, np.int32)
        leaf = np.arange(n)
        for i in reversed(range(self.n_levels)):
            anc = leaf // (self.group_sizes[i] * self.levels[i].fan_in)
            same = anc[:, None] == anc[None, :]
            out = np.where(same, np.int32(i), out)
        return out

    def level_gate(self, level: int) -> np.ndarray:
        """bool[n, n]: the route-enable gate the executors apply to (src,
        dst) pairs whose traffic merges at ``level``:
        ``enables[src_child, dst_child]`` plus the structural own-subtree
        exclusion above level 0.  Only meaningful where
        ``delivery_levels() == level``."""
        lvl = self.levels[level]
        child = self.leaf_entities(level) % lvl.fan_in
        en = np.asarray(lvl.enables)
        gate = en[np.ix_(child, child)]
        if level > 0:
            gate = gate & (child[:, None] != child[None, :])
        return gate

    def merge_layout(self, cap_in: int) -> tuple[tuple[int, ...], ...]:
        """Per-level merge segment lengths for egress frames of ``cap_in``."""
        u0 = self.levels[0].link_capacity
        segs_u = (u0,) if u0 is not None else (cap_in,)
        out = []
        for i, lvl in enumerate(self.levels):
            out.append(segs_u * lvl.fan_in)
            if i + 1 < len(self.levels):
                nxt = self.levels[i + 1]
                segs_u = ((nxt.link_capacity,) if nxt.link_capacity is not None
                          else segs_u * lvl.fan_in)
        return tuple(out)

    def identity_tables(self, n_labels: int | None = None, *, device=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked identity fwd/rev LUTs for every leaf (testing/benchmarks).

        Both are ``.expand`` views ``[n_nodes, table]`` of one table: every
        row shares its storage, so copy before writing into them."""
        tables = routing.identity_tables(n_labels, device=device)
        n = self.n_nodes
        return (tables.fwd.expand(n, tables.fwd.shape[0]),
                tables.rev.expand(n, tables.rev.shape[0]))

    def describe(self) -> str:
        """One-line human summary ('12 x 2 x 4 = 96 leaves, ...'), the
        reference's string: stream checkpoints and recovery records carry
        it."""
        shape = " x ".join(str(f) for f in self.fan_ins)
        caps = "/".join("-" if lvl.link_capacity is None
                        else str(lvl.link_capacity) for lvl in self.levels)
        name = f"{self.spec.name}: " if self.spec.name else ""
        return (f"{name}{shape} = {self.n_nodes} leaves, "
                f"capacity {self.capacity}, uplink caps {caps}")


def _parse_health(raw, n_edges: int, what: str) -> np.ndarray | None:
    """Normalize a per-edge health vector: ``None``/all-True → ``None``."""
    if raw is None:
        return None
    health = np.asarray(raw, dtype=bool).reshape(-1)
    if health.shape[0] != n_edges:
        raise ValueError(f"{what} has {health.shape[0]} entries but the "
                         f"level crosses {n_edges} edges")
    return None if bool(health.all()) else health


def _assign_detours(alive: np.ndarray, fan_in: int) -> np.ndarray:
    """Host edge for each dead uplink: the nearest healthy sibling (ring
    distance in the group, ties to the lower slot) with spare extension
    lanes, each host taking at most ``EXTENSION_LANES`` detours; -1 for
    healthy edges and for dead edges with no host."""
    n_edges = alive.shape[0]
    detour = np.full(n_edges, -1, np.int32)
    budget = np.zeros(n_edges, np.int32)
    for base in range(0, n_edges, fan_in):
        for j in range(fan_in):
            if alive[base + j]:
                continue
            cands = sorted(
                (min((k - j) % fan_in, (j - k) % fan_in), k)
                for k in range(fan_in) if k != j and alive[base + k])
            for _, k in cands:
                if budget[base + k] < EXTENSION_LANES:
                    detour[base + j] = base + k
                    budget[base + k] += 1
                    break
    return detour


EXCHANGE_MODES = ("gather", "routed")


@obs.span("fabric.compile")
def compile_fabric(spec: FabricSpec) -> FabricPlan:
    """Compile a topology description into the static hop-graph plan."""
    if not spec.levels:
        raise ValueError("a fabric needs at least one level")
    if spec.capacity <= 0:
        raise ValueError(f"ingress capacity must be positive: {spec.capacity}")
    if spec.exchange_mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange_mode: {spec.exchange_mode!r} "
                         f"(expected one of {EXCHANGE_MODES})")
    n_nodes = spec.n_nodes
    levels = []
    leaves = 1
    for i, lvl in enumerate(spec.levels):
        f = lvl.fan_in
        if f < 1:
            raise ValueError(f"level {i} fan_in must be >= 1: {f}")
        if lvl.extension and f > EXTENSION_LANES:
            raise ValueError(
                f"level {i} rides the {EXTENSION_LANES} Aggregator extension "
                f"lanes but joins {f} children")
        if lvl.enables is None:
            enables = (~np.eye(f, dtype=bool) if i == 0
                       else np.ones((f, f), bool))
        else:
            enables = _to_numpy(lvl.enables).astype(bool)
            if enables.shape != (f, f):
                raise ValueError(
                    f"level {i} enables shape {enables.shape} does not match "
                    f"fan_in {f}")
        cap = lvl.link_capacity
        if cap is None and lvl.link is not None:
            if lvl.link.link_capacity is not None:
                cap = lvl.link.link_capacity
            elif spec.window_us is not None:
                cap = lvl.link.events_per_window(spec.window_us)
            else:
                raise ValueError(
                    f"level {i} has a LinkConfig without an event budget; "
                    "set LinkConfig.link_capacity or FabricSpec.window_us "
                    "to derive it from events_per_window")
        if cap is not None and cap < 1:
            raise ValueError(f"level {i} link_capacity must be >= 1: {cap}")
        extra = (None if lvl.latency is None
                 else int(round(lvl.latency.second_layer_extra_ns())))
        n_edges = n_nodes // leaves
        up_ok = _parse_health(lvl.uplink_health, n_edges,
                              f"level {i} uplink_health")
        down_ok = _parse_health(lvl.downlink_health, n_edges,
                                f"level {i} downlink_health")
        detour = None
        if up_ok is not None:
            # Leaf lanes (level 1) have no sibling interconnect to detour
            # over; only Aggregator-tier uplinks borrow a sibling's lanes.
            detour = (_assign_detours(up_ok, f) if spec.reroute and i > 0
                      else np.full(n_edges, -1, np.int32))
        leaves *= f
        levels.append(LevelPlan(fan_in=f, enables=enables,
                                link_capacity=cap, extra_ns=extra,
                                leaves=leaves, uplink_ok=up_ok,
                                detour=detour, downlink_ok=down_ok))
    return FabricPlan(spec=spec, levels=tuple(levels), n_nodes=leaves,
                      capacity=spec.capacity)


def with_exchange_mode(plan: FabricPlan, mode: str) -> FabricPlan:
    """Copy a compiled plan under a different wire strategy (the levels are
    strategy-independent, so nothing recompiles)."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(f"unknown exchange_mode: {mode!r} "
                         f"(expected one of {EXCHANGE_MODES})")
    if plan.spec.exchange_mode == mode:
        return plan
    return dataclasses.replace(
        plan, spec=dataclasses.replace(plan.spec, exchange_mode=mode))


def star_spec(n_nodes: int, capacity: int, *, enables=None,
              link_capacity: int | None = None,
              link: LinkConfig | None = None,
              window_us: float | None = None, name: str = "") -> FabricSpec:
    """One backplane star: the 1-level fabric."""
    return FabricSpec(
        levels=(LevelSpec(fan_in=n_nodes, enables=enables,
                          link_capacity=link_capacity, link=link),),
        capacity=capacity, window_us=window_us, name=name)


def hierarchical_spec(n_pods: int, per_pod: int, capacity: int, *,
                      intra_enables=None, inter_enables=None,
                      link_capacity: int | None = None,
                      pod_capacity: int | None = None,
                      name: str = "") -> FabricSpec:
    """The §V two-layer system: the 2-level fabric."""
    return FabricSpec(
        levels=(LevelSpec(fan_in=per_pod, enables=intra_enables,
                          link_capacity=link_capacity),
                LevelSpec(fan_in=n_pods, enables=inter_enables,
                          link_capacity=pod_capacity)),
        capacity=capacity, name=name)


def ext_4case_spec(capacity: int = 96, *,
                   chips_per_backplane: int = CHIPS_PER_BACKPLANE,
                   backplanes_per_case: int = BACKPLANES_PER_RACK,
                   n_cases: int = 4,
                   link_capacities: tuple[int | None, int | None, int | None]
                   = (None, None, None)) -> FabricSpec:
    """The 3-level extension scenario: two backplanes per 4U case, cases
    chained over the Aggregator's 4 extension lanes."""
    u0, u1, u2 = link_capacities
    n = chips_per_backplane * backplanes_per_case * n_cases
    return FabricSpec(
        levels=(LevelSpec(fan_in=chips_per_backplane, link_capacity=u0),
                LevelSpec(fan_in=backplanes_per_case, link_capacity=u1),
                LevelSpec(fan_in=n_cases, link_capacity=u2, extension=True)),
        capacity=capacity, name=f"EXT_4CASE_{n}CHIP")


def degrade_spec(spec: FabricSpec,
                 dead: Iterable[tuple[int, int] | tuple[int, int, str]],
                 *, reroute: bool | None = None) -> FabricSpec:
    """Copy ``spec`` with the given edges marked dead — ``(level, edge)`` or
    ``(level, edge, kind)`` tuples, kind defaulting to ``'uplink'``.
    Existing health is kept and degraded further."""
    n_nodes = spec.n_nodes
    health = {}
    gsize = 1
    for i, lvl in enumerate(spec.levels):
        n_edges = n_nodes // gsize
        for kind, raw in (("uplink", lvl.uplink_health),
                          ("downlink", lvl.downlink_health)):
            health[(i, kind)] = (np.ones(n_edges, bool) if raw is None
                                 else np.asarray(raw, bool).copy())
        gsize *= lvl.fan_in
    for entry in dead:
        level, edge, kind = entry if len(entry) == 3 else (*entry, "uplink")
        if (level, kind) not in health:
            raise ValueError(f"unknown fault kind or level: {kind!r}/{level}")
        if not 0 <= edge < health[(level, kind)].shape[0]:
            raise ValueError(f"edge {edge} outside level {level}'s "
                             f"{health[(level, kind)].shape[0]} edges")
        health[(level, kind)][edge] = False
    new_levels = tuple(
        dataclasses.replace(
            lvl,
            uplink_health=tuple(bool(b) for b in health[(i, "uplink")]),
            downlink_health=tuple(bool(b) for b in health[(i, "downlink")]))
        for i, lvl in enumerate(spec.levels))
    return dataclasses.replace(
        spec, levels=new_levels,
        reroute=spec.reroute if reroute is None else reroute)


# ---------------------------------------------------------------------------
# Degraded mode: dynamic health overlays and fault schedules
# ---------------------------------------------------------------------------


class FabricHealth(NamedTuple):
    """Dynamic per-edge health overlay of one exchange round: a bool tensor
    per level for uplinks and downlinks (``plan.edge_counts`` long, on the
    frames' device; ``None`` means that level is fully healthy).  Unlike
    the static health compiled into the plan it costs no recompile, but it
    cannot reroute: an edge masked here loses its traffic as
    ``unroutable`` even where the static plan gave it a detour.  The
    tensors of ``health_schedule`` carry a leading step axis."""

    uplink: tuple
    downlink: tuple


def full_health(plan: FabricPlan, device=None) -> FabricHealth:
    """All-healthy overlay matching ``plan`` (the identity element), on the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)

    def ones():
        return tuple(torch.ones((c,), dtype=torch.bool, device=device)
                     for c in plan.edge_counts)

    return FabricHealth(uplink=ones(), downlink=ones())


def _check_health(plan: FabricPlan, health: FabricHealth,
                  device: torch.device) -> None:
    counts = plan.edge_counts
    for side in ("uplink", "downlink"):
        vecs = getattr(health, side)
        if len(vecs) != plan.n_levels:
            raise ValueError(f"health.{side} has {len(vecs)} levels but the "
                             f"plan wires {plan.n_levels}")
        for i, vec in enumerate(vecs):
            if vec is None:
                continue
            if vec.shape[-1] != counts[i]:
                raise ValueError(
                    f"health.{side}[{i}] covers {vec.shape[-1]} edges but "
                    f"level {i} crosses {counts[i]}")
            if vec.device != device:
                raise ValueError(f"health.{side}[{i}] lies on {vec.device} "
                                 f"but the frames on {device}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled link fault: the edge ``(level, edge)`` dies at
    ``kill_step`` (inclusive) and, unless ``restore_step`` is ``None``
    (permanent), comes back at ``restore_step`` (exclusive).  ``kind``
    picks the direction."""

    level: int
    edge: int
    kill_step: int
    restore_step: int | None = None
    kind: str = "uplink"


def _check_faults(plan: FabricPlan, faults: Sequence[FaultEvent]) -> None:
    counts = plan.edge_counts
    for ev in faults:
        if ev.kind not in ("uplink", "downlink"):
            raise ValueError(f"unknown fault kind: {ev.kind!r}")
        if not 0 <= ev.level < plan.n_levels:
            raise ValueError(f"fault level {ev.level} outside the "
                             f"{plan.n_levels}-level plan")
        if not 0 <= ev.edge < counts[ev.level]:
            raise ValueError(f"fault edge {ev.edge} outside level "
                             f"{ev.level}'s {counts[ev.level]} edges")
        if ev.restore_step is not None and ev.restore_step <= ev.kill_step:
            raise ValueError(f"fault restore_step {ev.restore_step} must be "
                             f"> kill_step {ev.kill_step}")


def health_schedule(plan: FabricPlan, faults: Sequence[FaultEvent],
                    n_steps: int, device=None) -> FabricHealth:
    """Expand a fault schedule into per-step overlays: ``bool[n_steps,
    n_edges]`` per level (``None`` for untouched levels), built on the host
    and uploaded once, to the card unless ``device`` says otherwise."""
    _check_faults(plan, faults)
    device = resolve_device(device)
    counts = plan.edge_counts
    masks = {side: [None] * plan.n_levels for side in ("uplink", "downlink")}
    for ev in faults:
        tbl = masks[ev.kind]
        if tbl[ev.level] is None:
            tbl[ev.level] = np.ones((n_steps, counts[ev.level]), bool)
        stop = n_steps if ev.restore_step is None else min(ev.restore_step,
                                                           n_steps)
        tbl[ev.level][ev.kill_step:stop, ev.edge] = False

    def upload(tbl):
        return tuple(None if m is None else torch.from_numpy(m).to(device)
                     for m in tbl)

    return FabricHealth(uplink=upload(masks["uplink"]),
                        downlink=upload(masks["downlink"]))


def dead_edges_at(faults: Sequence[FaultEvent], step: int
                  ) -> tuple[tuple[int, int, str], ...]:
    """The ``(level, edge, kind)`` triples dead at ``step``, sorted."""
    dead = {(ev.level, ev.edge, ev.kind) for ev in faults
            if ev.kill_step <= step
            and (ev.restore_step is None or step < ev.restore_step)}
    return tuple(sorted(dead))


def fault_boundaries(faults: Sequence[FaultEvent], n_steps: int
                     ) -> tuple[int, ...]:
    """Segment starts where the dead-edge set may change (0 always
    included): the recompile points of ``run_stream``'s reroute mode."""
    marks = {0}
    for ev in faults:
        marks.add(ev.kill_step)
        if ev.restore_step is not None:
            marks.add(ev.restore_step)
    return tuple(sorted(m for m in marks if 0 <= m < n_steps))


def shift_faults(faults: Sequence[FaultEvent], start: int, n_steps: int
                 ) -> tuple[FaultEvent, ...]:
    """Rebase a whole-run fault schedule onto the window ``[start, start +
    n_steps)``: events outside it are dropped, a kill before it clamps to
    local step 0, and a restore at or past its end becomes permanent."""
    end = start + n_steps
    out = []
    for ev in faults:
        if ev.kill_step >= end:
            continue
        if ev.restore_step is not None and ev.restore_step <= start:
            continue
        restore = (None if ev.restore_step is None or ev.restore_step >= end
                   else ev.restore_step - start)
        out.append(dataclasses.replace(
            ev, kill_step=max(ev.kill_step - start, 0), restore_step=restore))
    return tuple(out)


# ---------------------------------------------------------------------------
# Static plan arrays on the device
# ---------------------------------------------------------------------------

# Keyed by (bytes, shape, dtype, device): a plan's static index and mask
# arrays are uploaded once per device, not once per exchange step.
_CONST_CACHE: dict = {}


def _const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    key = (a.tobytes(), a.shape, a.dtype.str, str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(a.copy()).to(device)
        _CONST_CACHE[key] = t
    return t


def _concrete_enables(enables) -> np.ndarray:
    """Routed mode compiles a static edge schedule from the route enables,
    so they must hold data: a meta tensor (PyTorch's placeholder for a
    traced value) holds none."""
    if isinstance(enables, torch.Tensor) and enables.is_meta:
        raise ValueError(
            "exchange_mode='routed' compiles a static edge schedule from the "
            "plan's route enables, which hold no data here (a meta tensor): "
            "build the plan from concrete enables or use "
            "exchange_mode='gather'")
    return _to_numpy(enables).astype(bool)


# Keyed by (n, gsize, fan_in, level > 0, enables bytes), as in the reference.
_ROUTED_MAP_CACHE: dict = {}


def _routed_leaf_maps(enables, level: int, n: int, gsize: int, f: int):
    """Static per-destination source schedule of one stacked level.

    Returns ``(src_flat, live, deg)``: ``src_flat`` int32[f·deg] lists, for
    each destination child slot, the ``deg`` child slots of its enabled
    sources in ascending order (own subtree excluded above level 0), padded
    with slot 0 where ``live`` (bool[n, deg], per destination leaf) is
    False; ``deg`` is the largest in-degree.  These are the hop-graph
    edges: a disabled pair never enters the merge stream.
    """
    en = _concrete_enables(enables)
    key = (n, gsize, f, min(level, 1), en.tobytes())
    hit = _ROUTED_MAP_CACHE.get(key)
    if hit is None:
        need = en & ~np.eye(f, dtype=bool) if level > 0 else en
        deg = max(1, int(need.sum(axis=0).max()))
        src = np.zeros((f, deg), np.int32)
        live = np.zeros((f, deg), bool)
        for k in range(f):
            js = np.flatnonzero(need[:, k])
            src[k, :len(js)] = js
            live[k, :len(js)] = True
        child = (np.arange(n) // gsize) % f
        hit = (src.reshape(-1), live[child], deg)
        _ROUTED_MAP_CACHE[key] = hit
    return hit


def merge_segments(plan: FabricPlan, cap_in: int) -> tuple[int, ...]:
    """Segment lengths of a destination's merge stream, nearest level
    first: each level's ``merge_layout`` in gather mode; in routed mode the
    segments of the ``deg`` enabled-source slots each destination takes."""
    layout = plan.merge_layout(cap_in)
    if plan.exchange_mode == "gather":
        return tuple(s for level in layout for s in level)
    segs, gsize = [], 1
    for i, lvl in enumerate(plan.levels):
        _, _, deg = _routed_leaf_maps(lvl.enables, i, plan.n_nodes, gsize,
                                      lvl.fan_in)
        segs += list(layout[i][:len(layout[i]) // lvl.fan_in]) * deg
        gsize *= lvl.fan_in
    return tuple(segs)


# ---------------------------------------------------------------------------
# Timed datapath and degraded-mode helpers
# ---------------------------------------------------------------------------


def _rank(valid: torch.Tensor) -> torch.Tensor:
    """Exclusive arrival rank of each valid slot along the last axis."""
    ok = valid.to(torch.int32)
    return torch.cumsum(ok, dim=-1, dtype=torch.int32) - ok


def _egress_times(frame_times, ev, timing: TimedWire) -> torch.Tensor:
    """Arrival times at the first merge input: departure + fixed sender path
    + the uplink lane's wait of each event's egress rank (computed on the
    unpacked egress, so the order-preserving uplink pack cannot change
    them)."""
    wait = queue_wait_i32(_rank(ev), timing.uplink_queue)
    t = frame_times.to(torch.int32) + timing.sender_fixed_ns + wait
    return torch.where(ev, t, torch.zeros_like(t))


def _flow_masks(lvl: LevelPlan, dyn_up, device):
    """Static and dynamic uplink masks of one level combined: ``flow_ok``
    (traffic survives: alive or detoured, and not masked by the overlay
    ``dyn_up``) and ``live_detour`` (travels a detour), bool[n_ent];
    ``(None, None)`` when both are healthy.  ``live_detour`` is ``None`` on
    a statically healthy level, where no edge has a detour."""
    if lvl.uplink_ok is None:
        return dyn_up, None
    routable = _const(lvl.routable, device)
    detoured = _const(~lvl.uplink_ok & (lvl.detour >= 0), device)
    if dyn_up is None:
        return routable, detoured
    return routable & dyn_up, detoured & dyn_up


def _down_mask(lvl: LevelPlan, dyn_down, ent: np.ndarray, ent_t, device):
    """Per-leaf downlink health of one level, static and dynamic combined
    (``ent``/``ent_t``: each leaf's child entity here), or ``None`` when
    both are healthy."""
    ok = (None if lvl.downlink_ok is None
          else _const(lvl.downlink_ok[ent], device))
    if dyn_down is not None:
        dyn = dyn_down[ent_t]
        ok = dyn if ok is None else ok & dyn
    return ok


def _detour_penalty(lvl: LevelPlan, timing: TimedWire, valid) -> torch.Tensor:
    """Timed cost of one more crossing of ``lvl``: its extra plus the lane's
    wait of the event's rank in the stream.  An extension-lane detour pays
    it, and so does every stream that cascades up into ``lvl``."""
    extra = (lvl.extra_ns if lvl.extra_ns is not None
             else timing.second_layer_extra_ns)
    return extra + queue_wait_i32(_rank(valid), timing.uplink_queue)


@obs.span("fabric.merge")
def _merge_round(parts_l, parts_v, parts_t, rev_tables, plan: FabricPlan,
                 seg_lens: tuple[int, ...], lead, *, use_fused: bool,
                 timing: TimedWire | None, uplink, unroutable, rerouted
                 ) -> tuple[EventFrame, ExchangeDrops]:
    """The tail both executors share: merge every destination's level
    segments in ``merge_pack`` (its kernel when ``use_fused``, else its
    plain version), add the receiver's fixed path to the timed lane and
    restore the ``lead`` batch dims."""
    merge = fused_merge_pack if use_fused else merge_pack_ref
    outs = merge(
        torch.cat(parts_l, dim=-1), torch.cat(parts_v, dim=-1), rev_tables,
        capacity=plan.capacity, seg_lens=seg_lens, compact=plan.compact,
        times=None if timing is None else torch.cat(parts_t, dim=-1),
        queue=None if timing is None else timing.queue)
    if timing is None:
        out_l, out_v, dropped = outs
        out_t = torch.zeros_like(out_l)
    else:
        # Receiver-side fixed path, after the merge's destination queue.
        out_l, out_v, out_t, dropped = outs
        out_t = torch.where(out_v, out_t + timing.recv_fixed_ns,
                            torch.zeros_like(out_t))

    def unflat(x):
        return x.reshape((*lead, *x.shape[1:]))

    return (EventFrame(labels=unflat(out_l), times=unflat(out_t),
                       valid=unflat(out_v)),
            ExchangeDrops(congestion=unflat(dropped), uplink=unflat(uplink),
                          unroutable=unflat(unroutable),
                          rerouted=unflat(rerouted)))


# ---------------------------------------------------------------------------
# Stacked executor
# ---------------------------------------------------------------------------


def fabric_route_step(state, frames: EventFrame, plan: FabricPlan, *,
                      use_fused: bool | None = None,
                      timing: TimedWire | None = None, engine: str = "auto",
                      health=None) -> tuple[EventFrame, ExchangeDrops]:
    """One N-level hop-graph exchange round, all leaves on one device.

    Args:
      state: routing state with stacked per-leaf ``fwd_tables`` /
        ``rev_tables`` (``aggregator.RouterState``; its ``route_enables``
        are ignored — enables live in the plan).
      frames: per-leaf egress frames, ``[..., n_nodes, cap_in]``; leading
        dims are independent batch rows, all exchanged in one pass.
      plan: compiled hop graph; ``exchange_mode`` "routed" builds each
        destination's stream from its enabled source entities only, with
        observables bit-identical to "gather".
      use_fused: ``True`` (and ``None``, the default) runs the kernels;
        ``False`` runs the reference's unfused composition in plain
        PyTorch (``merge_pack``'s plain version: the segmented pack, then
        the reverse LUT) and launches no kernel.  No environment variable
        changes the default.
      timing: timed datapath (``latency.timed_wire``): ``frames.times`` are
        int32 departures and the ingress ``times`` arrivals; ``None`` keeps
        the untimed wire (ingress times are zeros).
      engine: ``"auto"`` lets the plain one-level untimed round take the
        ``exchange`` kernel; ``"merge"`` forces the merge engine (same
        observables; the timed benchmarks' same-engine baseline).
      health: dynamic per-edge overlay (``FabricHealth``), one bool
        ``[n_edges]`` vector per level shared by every batch row, on the
        frames' device.  It masks flows on top of the plan's static health
        and never reroutes: a masked edge loses its traffic as
        ``unroutable`` (compile a statically degraded plan to detour).  A
        round with an overlay always runs the merge engine.

    Returns:
      (ingress frames [..., n_nodes, capacity], ExchangeDrops of
      int32[..., n_nodes]).
    """
    if use_fused is None:
        use_fused = True
    if engine not in ("auto", "merge"):
        raise ValueError(f"unknown engine: {engine!r}")
    levels = plan.levels
    *lead, n, cap_in = frames.labels.shape
    if n != plan.n_nodes:
        raise ValueError(f"frames carry {n} leaf streams but the plan wires "
                         f"{plan.n_nodes}")
    dev = frames.labels.device
    if health is not None:
        _check_health(plan, health, dev)
    routed = plan.exchange_mode == "routed"

    # The plain 1-level untimed star is one exchange-kernel round.
    if (engine == "auto" and use_fused and len(levels) == 1
            and timing is None and levels[0].link_capacity is None
            and not plan.degraded and health is None and not routed):
        out_l, out_v, dropped = fused_exchange(
            frames.labels, frames.valid, state.fwd_tables, state.rev_tables,
            _const(levels[0].enables, dev), capacity=plan.capacity)
        zeros = torch.zeros_like(dropped)
        return (EventFrame(labels=out_l, times=torch.zeros_like(out_l),
                           valid=out_v),
                ExchangeDrops(congestion=dropped, uplink=zeros,
                              unroutable=zeros, rerouted=zeros))

    b = math.prod(lead)
    wire, fwd_en = routing.lookup_fwd(state.fwd_tables,
                                      frames.labels.reshape(b, n, cap_in))
    ev = frames.valid.reshape(b, n, cap_in) & fwd_en
    times = (None if timing is None else
             _egress_times(frames.times.reshape(b, n, cap_in), ev, timing))

    # Leaf uplink: pack each leaf's egress to its lane capacity.
    u0 = levels[0].link_capacity
    zeros = torch.zeros((b, n), dtype=torch.int32, device=dev)
    uplink = zeros
    if u0 is not None:
        with obs.span("fabric.uplink_pack"):
            packed, uplink = make_frame(wire, times, ev, u0)
        wire, ev = packed.labels, packed.valid
        if timing is not None:
            times = packed.times

    leaf = np.arange(n)
    # U_i streams, one per tier-i entity (tier 0 = leaf): [b, n_ent, len].
    cur_l, cur_v, cur_t = wire, ev, times
    cur_len = u0 if u0 is not None else cap_in
    gsize = 1                                  # leaves per tier-i entity
    unroutable = rerouted = zeros
    recv_ok = None                             # per-leaf downlink path health
    parts_l, parts_v, parts_t = [], [], []
    for i, lvl in enumerate(levels):
        f = lvl.fan_in
        gnext = gsize * f
        n_grp = n // gnext
        ent = leaf // gsize                    # each leaf's entity here
        ent_t = _const(ent, dev)

        # Uplink health, static and dynamic, gates the entity streams before
        # they join this merge and before they cascade upward: detoured
        # streams keep their slot but pay the detour on the timed lane;
        # streams with no surviving route are masked and counted
        # unroutable.
        flow_ok, live_detour = _flow_masks(
            lvl, None if health is None else health.uplink[i], dev)
        if flow_ok is not None:
            counts = cur_v.sum(dim=-1, dtype=torch.int32)
            if timing is not None and live_detour is not None:
                pen = _detour_penalty(lvl, timing, cur_v)
                cur_t = torch.where(live_detour[:, None] & cur_v,
                                    cur_t + pen, cur_t)
            cur_v = cur_v & flow_ok[:, None]
            unroutable = unroutable + torch.where(flow_ok, 0, counts)[:, ent_t]
            if live_detour is not None:
                rerouted = (rerouted
                            + torch.where(live_detour, counts, 0)[:, ent_t])
        # Downlink health accumulates along each leaf's descent path.
        d_ok = _down_mask(lvl, None if health is None else health.downlink[i],
                          ent, ent_t, dev)
        if d_ok is not None:
            recv_ok = d_ok if recv_ok is None else recv_ok & d_ok

        s_len = f * cur_len
        anc = _const(leaf // gnext, dev)       # tier-(i+1) ancestor per leaf
        if routed:
            # Only the hop-graph edges enter the merge: each destination
            # takes its enabled source entities' streams as int16 wire words
            # (padded to the largest in-degree with dead segments, whose
            # `live` lane is False), in ascending source order.
            src_flat, live, deg = _routed_leaf_maps(lvl.enables, i, n,
                                                    gsize, f)
            src_t = _const(src_flat.astype(np.int64), dev)
            n_ent = n_grp * f
            sel = pack_wire16(cur_l, cur_v).reshape(b, n_grp, f, cur_len)
            sel = sel[:, :, src_t].reshape(b, n_ent, deg * cur_len)
            part_l = sel.repeat_interleave(n // n_ent, dim=1)
            part_v = _const(live, dev)[:, :, None].expand(
                n, deg, cur_len).reshape(n, deg * cur_len).expand(b, -1, -1)
        else:
            # The concat of the children's streams, gated per destination.
            s_l = cur_l.reshape(b, n_grp, s_len)
            s_v = cur_v.reshape(b, n_grp, f, cur_len)
            child = ent % f
            gate = lvl.enables.T[child]        # [n, f] src child → this dest
            if i > 0:
                gate = gate & (np.arange(f)[None, :] != child[:, None])
            part_l = s_l[:, anc]
            part_v = (s_v[:, anc] & _const(gate, dev)[None, :, :, None]
                      ).reshape(b, n, s_len)
        if recv_ok is not None:
            if routed:
                # Count the embedded valid bits, not the slot-level lane.
                lost = (unpack_wire16(part_l)[1] & part_v).sum(
                    dim=-1, dtype=torch.int32)
            else:
                lost = part_v.sum(dim=-1, dtype=torch.int32)
            part_v = part_v & recv_ok[:, None]
            unroutable = unroutable + torch.where(recv_ok, 0, lost)
        parts_l.append(part_l)
        parts_v.append(part_v)
        if timing is not None:
            if routed:
                sel_t = cur_t.reshape(b, n_grp, f, cur_len)[:, :, src_t]
                parts_t.append(sel_t.reshape(b, n_ent, deg * cur_len)
                               .repeat_interleave(n // n_ent, dim=1))
            else:
                parts_t.append(cur_t.reshape(b, n_grp, s_len)[:, anc])

        if i + 1 < len(levels):
            # U_{i+1}: each tier-(i+1) entity uplinks its whole aggregated
            # stream (ungated); timed events pay the crossing extra plus the
            # wait of their rank, and the pack cascades.
            nxt = levels[i + 1]
            s_l = cur_l.reshape(b, n_grp, s_len)
            s_vf = cur_v.reshape(b, n_grp, s_len)
            s_t = None
            if timing is not None:
                t = (cur_t.reshape(b, n_grp, s_len)
                     + _detour_penalty(nxt, timing, s_vf))
                s_t = torch.where(s_vf, t, torch.zeros_like(t))
            if nxt.link_capacity is not None:
                with obs.span("fabric.uplink_pack"):
                    up, drop = make_frame(s_l, s_t, s_vf, nxt.link_capacity)
                cur_l, cur_v, cur_len = up.labels, up.valid, nxt.link_capacity
                cur_t = up.times if timing is not None else None
                uplink = uplink + drop[:, anc]
            else:
                cur_l, cur_v, cur_t, cur_len = s_l, s_vf, s_t, s_len
            gsize = gnext

    return _merge_round(parts_l, parts_v, parts_t, state.rev_tables, plan,
                        merge_segments(plan, cap_in), lead,
                        use_fused=use_fused, timing=timing, uplink=uplink,
                        unroutable=unroutable, rerouted=rerouted)


# ---------------------------------------------------------------------------
# Wire-strategy selection
# ---------------------------------------------------------------------------


def pick_exchange_mode(state, frames: EventFrame, plan: FabricPlan, *,
                       timing: TimedWire | None = None,
                       trials: int = 3) -> tuple[FabricPlan, dict[str, float]]:
    """Time the merge engine under both wire strategies on this topology
    and traffic, and return the winning plan.

    ``frames`` carries a leading time axis (``[T, ..., n_nodes, cap_in]``):
    a pass is one ``fabric_route_step(engine="merge")`` call per round, as
    the reference's scan takes them.  Each mode runs one warm pass (on the
    card this also builds and loads the kernels), then ``trials`` timed
    passes interleaved across the modes (A B A B ...), so both see the
    same drift in wall-clock time; each mode keeps its minimum.  On CUDA
    the card is synchronised before and after each pass.

    Returns ``(with_exchange_mode(plan, winner), seconds)``, ``seconds``
    mapping each of ``EXCHANGE_MODES`` to its best pass.
    """
    cuda = frames.labels.is_cuda
    plans = {mode: with_exchange_mode(plan, mode) for mode in EXCHANGE_MODES}

    def one_pass(p) -> float:
        if cuda:
            torch.cuda.synchronize(frames.labels.device)
        t0 = time.perf_counter()
        for fr in zip(frames.labels, frames.times, frames.valid):
            fabric_route_step(state, EventFrame(*fr), p, timing=timing,
                              engine="merge")
        if cuda:
            torch.cuda.synchronize(frames.labels.device)
        return time.perf_counter() - t0

    for p in plans.values():
        one_pass(p)                                      # warm (and build)
    seconds = dict.fromkeys(plans, float("inf"))
    for _ in range(trials):
        for mode, p in plans.items():
            seconds[mode] = min(seconds[mode], one_pass(p))
    winner = min(seconds, key=seconds.get)
    return plans[winner], seconds


# ---------------------------------------------------------------------------
# Sharded executor: one leaf per rank of a torch.distributed mesh
# ---------------------------------------------------------------------------


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """One explicit copy of a stream plane to ``group``'s transport device;
    int16 wire words travel as their bytes (a ``uint8`` view, 2 B an
    event: neither gloo's all-gather nor NCCL takes int16)."""
    x = x.to(transport_device(group, x.device)).contiguous()
    return x.view(torch.uint8) if x.dtype == torch.int16 else x


def _from_wire(plane: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.int16:
        plane = plane.view(torch.int16)
    return plane.to(like.device)


class WireCall(NamedTuple):
    """One wire call of the sharded executor, as ``wire_log`` records it.

    ``kind``: ``"all_gather"`` (``_gather_plane``) or ``"routed"``
    (``_routed_plane``); ``level``: the fabric level whose process group
    it ran on; ``dtype``: the plane's dtype before the ``uint8`` view
    (``torch.int16`` for wire words, ``torch.int32`` for the timed lane);
    ``bytes``: for an all-gather its output, the ``f`` planes of the group
    (what the reference's program lint measures of an ``all_gather``);
    for a routed call the planes this rank receives (what it measures of
    the ``ppermute``s)."""

    kind: str
    level: int
    dtype: torch.dtype
    bytes: int


_WIRE_LOG: list | None = None


@contextlib.contextmanager
def wire_log() -> Iterator[list]:
    """Records every wire call of this process while the block runs, as
    ``WireCall``s in call order (the program lint's collective checks read
    them).  Outside such a block nothing is recorded."""
    global _WIRE_LOG
    outer, _WIRE_LOG = _WIRE_LOG, []
    try:
        yield _WIRE_LOG
    finally:
        _WIRE_LOG = outer


def _record_wire(kind: str, level: int, x: torch.Tensor, nbytes: int) -> None:
    if _WIRE_LOG is not None:
        _WIRE_LOG.append(WireCall(kind, level, x.dtype, nbytes))


def _gather_plane(x: torch.Tensor, group, level: int) -> torch.Tensor:
    """All-gather one level's stream plane over ``group``: ``x`` [b, L] on
    every rank → [b, f, L], row ``s`` from the rank in slot ``s``.  Counts
    its calls and the bytes this rank receives, and records the call in
    ``wire_log``."""
    f = dist.get_world_size(group)
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(f)]
    dist.all_gather(parts, wire, group=group)
    plane = wire.numel() * wire.element_size()
    _gather_plane.calls += 1
    _gather_plane.bytes += (f - 1) * plane
    _record_wire("all_gather", level, x, f * plane)
    return _from_wire(torch.stack(parts, dim=-2), x)


_gather_plane.calls = 0
_gather_plane.bytes = 0


def _routed_plane(x: torch.Tensor, group, perms, level: int) -> torch.Tensor:
    """Reconstruct one level's [b, f, L] plane edge-wise.

    The own slot never travels (every rank already holds its entity's
    stream); the other rows arrive over ring rotations, one
    ``batch_isend_irecv`` per rotation ``r`` of ``perms``
    (``parallel.sharding.edge_neighbor_permutes``), in which this rank
    posts its send to slot ``me + r`` and its receive from slot ``me - r``
    where that pair is in the rotation.  A pruned pair posts nothing on
    either side and its row stays zero, which decodes as invalid.  Counts
    the sends, the receives and the bytes this rank receives, and records
    the call in ``wire_log``.
    """
    f, me = dist.get_world_size(group), dist.get_rank(group)
    wire = _to_wire(x, group)
    plane = torch.zeros((f, *wire.shape), dtype=wire.dtype,
                        device=wire.device)
    plane[me] = wire
    received = 0
    for r, perm in enumerate(perms, start=1):
        dst, src = (me + r) % f, (me - r) % f
        ops = []
        if (me, dst) in perm:
            ops.append(dist.P2POp(dist.isend, wire,
                                  dist.get_global_rank(group, dst), group))
            _routed_plane.sends += 1
        if (src, me) in perm:
            ops.append(dist.P2POp(dist.irecv, plane[src],
                                  dist.get_global_rank(group, src), group))
            _routed_plane.recvs += 1
            received += wire.numel() * wire.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    _routed_plane.bytes += received
    _record_wire("routed", level, x, received)
    return _from_wire(plane.movedim(0, -2).contiguous(), x)


_routed_plane.sends = 0
_routed_plane.recvs = 0
_routed_plane.bytes = 0


def fabric_exchange(frame: EventFrame, mesh, fwd_table: torch.Tensor,
                    rev_table: torch.Tensor, plan: FabricPlan, *,
                    axis_names: Sequence[str] | None = None,
                    use_fused: bool | None = None,
                    timing: TimedWire | None = None,
                    health: FabricHealth | None = None
                    ) -> tuple[EventFrame, ExchangeDrops]:
    """One N-level exchange round seen from this rank's leaf.

    Every rank of ``mesh`` (a nested ``DeviceMesh``, one dimension per
    level, top level outermost: ``parallel.sharding.fabric_mesh``) calls
    this with its own leaf's egress ``frame`` ``[..., cap_in]`` and its own
    ``fwd_table`` [2^16] / ``rev_table`` [2^15]; leading dims are
    independent rounds, moved in one collective per level and merged in
    one ``merge_pack`` launch.  ``axis_names`` lists the mesh dimensions
    leaf level first (default: the mesh's dimensions reversed).

    Each level does one all-gather over its dimension's process group of
    int16 wire words (``events.pack_wire16``), with the gathered stream
    optionally packed to the next level's ``link_capacity`` before
    uplinking (packs cascade); the timed lane, when ``timing`` is set,
    travels as a separate int32 plane.  A ``"routed"`` plan replaces each
    gather with point-to-point sends along the hop-graph edges
    (``_routed_plane``): at the top level route-disabled pairs are pruned
    and post nothing.  Gating, segment layout, drops and timestamps mirror
    ``fabric_route_step`` bit for bit; a degraded plan or a ``health``
    overlay (``FabricHealth``, on the frame's device) masks dead slots on
    the gathered planes and retimes detoured streams the same way.

    Wire planes move to the group's transport device with one copy each
    way (``parallel.collectives.transport_device``: the card under NCCL,
    the host under gloo); the kernels and every other tensor stay on the
    frame's device.  ``use_fused`` as in ``fabric_route_step``: ``None``
    and ``True`` end the round in the ``merge_pack`` kernel, ``False`` in
    its plain version.

    Returns (this leaf's ingress frame ``[..., capacity]``, ExchangeDrops
    of int32 ``[...]``: congestion at this destination, uplink overflow and
    unroutable/rerouted events attributed to this leaf).
    """
    if use_fused is None:
        use_fused = True
    levels = plan.levels
    axes = (tuple(axis_names) if axis_names is not None
            else tuple(reversed(mesh.mesh_dim_names)))
    if len(axes) != len(levels):
        raise ValueError(f"{len(axes)} mesh axes for {len(levels)} fabric "
                         "levels")
    routed = plan.exchange_mode == "routed"
    perms = [edge_neighbor_permutes(_concrete_enables(lvl.enables),
                                    prune=i + 1 == len(levels))
             for i, lvl in enumerate(levels)] if routed else None
    dev = frame.labels.device
    if health is not None:
        _check_health(plan, health, dev)
    degraded = plan.degraded or health is not None
    *lead, cap_in = frame.labels.shape
    b = math.prod(lead)

    wire, fwd_en = routing.lookup_fwd(fwd_table,
                                      frame.labels.reshape(b, cap_in))
    ev = frame.valid.reshape(b, cap_in) & fwd_en
    times = (None if timing is None else
             _egress_times(frame.times.reshape(b, cap_in), ev, timing))
    u0 = levels[0].link_capacity
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    uplink = zeros
    if u0 is not None:
        with obs.span("fabric.uplink_pack"):
            packed, uplink = make_frame(wire, times, ev, u0)
        wire, ev = packed.labels, packed.valid
        if timing is not None:
            times = packed.times
    # This rank's global leaf, from its mesh coordinates.
    leaf = fabric_leaf_index(mesh, plan.fan_ins, axes) if degraded else None

    unroutable = rerouted = zeros
    recv_ok = None                     # this leaf's downlink path health
    cur_words, cur_times = pack_wire16(wire, ev), times
    gsize = 1
    parts_w, parts_en, parts_t = [], [], []
    for i, lvl in enumerate(levels):
        f = lvl.fan_in
        group = mesh.get_group(axes[i])
        me = dist.get_rank(group)
        flow_ok = live_detour = None
        if degraded:
            # Every leaf of a tier-i entity carries the entity stream, so
            # the entity's (pre-mask) events count against my own leaf, as
            # the stacked executor attributes them.
            ent_me = leaf // gsize
            flow_ok, live_detour = _flow_masks(
                lvl, None if health is None else health.uplink[i], dev)
            if flow_ok is not None:
                mine = unpack_wire16(cur_words)[1].sum(dim=-1,
                                                       dtype=torch.int32)
                unroutable = unroutable + torch.where(flow_ok[ent_me], 0,
                                                      mine)
                if live_detour is not None:
                    rerouted = rerouted + torch.where(live_detour[ent_me],
                                                      mine, 0)
            ent = np.array([ent_me])
            d_ok = _down_mask(lvl, None if health is None
                              else health.downlink[i], ent, _const(ent, dev),
                              dev)
            if d_ok is not None:
                d_ok = d_ok.reshape(())
                recv_ok = d_ok if recv_ok is None else recv_ok & d_ok

        if routed:
            g_words = _routed_plane(cur_words, group, perms[i], i)
            g_times = (None if timing is None
                       else _routed_plane(cur_times, group, perms[i], i))
        else:
            g_words = _gather_plane(cur_words, group, i)
            g_times = (None if timing is None
                       else _gather_plane(cur_times, group, i))
        seg = g_words.shape[-1]
        if flow_ok is not None:
            # Gathered slot s holds the entity (leaf // gnext) * f + s.
            slots = _const((leaf // (gsize * f)) * f + np.arange(f), dev)
            flow_s = flow_ok[slots][:, None]
            if timing is not None:
                if live_detour is not None:
                    g_v = unpack_wire16(g_words)[1]
                    pen = _detour_penalty(lvl, timing, g_v)
                    g_times = torch.where(live_detour[slots][:, None] & g_v,
                                          g_times + pen, g_times)
                g_times = torch.where(flow_s, g_times,
                                      torch.zeros_like(g_times))
            g_words = torch.where(flow_s, g_words, torch.zeros_like(g_words))
        gate = lvl.enables[:, me].copy()             # src slot → this dest
        if i > 0:
            gate[me] = False
        en = _const(np.repeat(gate, seg), dev).expand(b, f * seg)
        s_words = g_words.reshape(b, f * seg)
        if recv_ok is not None:
            lost = (unpack_wire16(s_words)[1] & en).sum(dim=-1,
                                                        dtype=torch.int32)
            unroutable = unroutable + torch.where(recv_ok, 0, lost)
            en = en & recv_ok
        parts_w.append(s_words)
        parts_en.append(en)
        if timing is not None:
            parts_t.append(g_times.reshape(b, f * seg))
        gsize *= f

        if i + 1 < len(levels):
            # U_{i+1}: the whole gathered stream uplinks (ungated); timed
            # events pay the crossing extra plus the wait of their rank,
            # and the pack cascades.
            nxt = levels[i + 1]
            s_labels, s_valid = unpack_wire16(s_words)
            s_t = None
            if timing is not None:
                t = parts_t[-1] + _detour_penalty(nxt, timing, s_valid)
                s_t = torch.where(s_valid, t, torch.zeros_like(t))
            if nxt.link_capacity is not None:
                with obs.span("fabric.uplink_pack"):
                    up, drop = make_frame(s_labels, s_t, s_valid,
                                          nxt.link_capacity)
                cur_words = pack_wire16(up.labels, up.valid)
                cur_times = up.times if timing is not None else None
                uplink = uplink + drop
            else:
                cur_words, cur_times = s_words, s_t

    # The planes keep the gather layout in routed mode too (a pruned slot
    # stays zero), so the segments are the gather mode's.
    return _merge_round(parts_w, parts_en, parts_t, rev_table, plan,
                        tuple(s for level in plan.merge_layout(cap_in)
                              for s in level), lead,
                        use_fused=use_fused, timing=timing, uplink=uplink,
                        unroutable=unroutable, rerouted=rerouted)


@dataclasses.dataclass(frozen=True)
class FabricInterconnect:
    """Binds the sharded exchange to a nested mesh, one dimension per
    fabric level (``parallel.sharding.fabric_mesh(plan)`` builds one).

    ``axis_names`` lists the dimensions leaf level first; ``None`` takes
    the mesh's dimensions reversed (outermost = top level).  Route enables
    come from the plan, so the returned functions take ``(frames,
    fwd_table, rev_table)``: this rank's frame and its own tables.  The
    reference takes the global array sharded over its mesh instead; here
    each rank passes and gets back its own shard.
    """

    mesh: object
    plan: FabricPlan
    axis_names: tuple[str, ...] | None = None
    use_fused: bool | None = None
    timing: TimedWire | None = None
    health: FabricHealth | None = None  # dynamic overlay, every round

    def _axes(self) -> tuple[str, ...]:
        axes = (tuple(self.axis_names) if self.axis_names is not None
                else tuple(reversed(self.mesh.mesh_dim_names)))
        if len(axes) != self.plan.n_levels:
            raise ValueError(f"{len(axes)} mesh axes for "
                             f"{self.plan.n_levels} fabric levels")
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        for name, lvl in zip(axes, self.plan.levels):
            if sizes.get(name) != lvl.fan_in:
                raise ValueError(
                    f"mesh axis {name!r} has size {sizes.get(name)} but the "
                    f"fabric level expects fan_in {lvl.fan_in}")
        return axes

    def _round(self, frame_dims: int, what: str):
        axes = self._axes()

        def fn(frames: EventFrame, fwd_table, rev_table):
            if frames.labels.dim() != frame_dims:
                raise ValueError(f"{what} takes this rank's "
                                 f"{frame_dims}-d frames, got labels "
                                 f"{tuple(frames.labels.shape)}")
            return fabric_exchange(frames, self.mesh, fwd_table, rev_table,
                                   self.plan, axis_names=axes,
                                   use_fused=self.use_fused,
                                   timing=self.timing, health=self.health)

        return fn

    def exchange_fn(self, *, donate: bool = False):
        """One round: ``fn(frame, fwd_table, rev_table)`` over this rank's
        ``[cap_in]`` frame → (``[capacity]`` frame, 0-d ExchangeDrops); one
        collective (or one set of sends) per level and one ``merge_pack``
        launch a call.  ``donate`` is kept for the reference's signature:
        PyTorch has no buffer donation, and the call never writes into its
        inputs."""
        return self._round(1, "exchange_fn")

    def stream_fn(self, *, donate: bool = False):
        """T rounds: ``fn(frames, fwd_table, rev_table)`` over ``[T,
        cap_in]`` → ``[T, capacity]`` frames and ``[T]`` drops, equal to T
        ``exchange_fn`` calls bit for bit.  The rounds of an exchange-only
        stream do not depend on each other, so all T move in one
        collective per level and merge in one ``merge_pack`` launch a call.
        ``donate`` as in ``exchange_fn``."""
        return self._round(2, "stream_fn")
