"""Program lint: weight-class regressions in the exchange programs.

The port's counterpart of ``src/repro/analysis/jaxprlint.py``.  The
reference walks jaxprs; the port has no staged program, so it runs the
entry points the fabric ships, ``fabric_route_step`` (the stacked
executor), ``fabric_exchange`` (one leaf per rank of a gloo group) and
``snn.stream.run_stream`` (the emulation loop), and records what they do:
every aten operation's outputs under a ``TorchDispatchMode``
(``ProgramTrace``), and every wire call of the sharded executor
(``core.fabric.wire_log``).  It fails on regressions no example-based test
reliably catches:

  * ``program.f64``               double-precision values anywhere (the
    wire is int16/int32; an f64 leak doubles every buffer it touches);
  * ``program.gather-widening``   a wire plane wider than the int16 wire
    words (a pre-gather upcast silently doubles wire bytes);
  * ``program.gather-count``      more than one all-gather per fabric level
    (or, as a warning, none);
  * ``program.collective-budget`` wire bytes per round exceeding the
    plan-derived link budget;
  * ``program.step-const``        the counterpart of ``program.scan-const``:
    a constant of more than ``LARGE_CONST_ELEMS`` elements made, or host
    data of that size brought in, in a step after the first, where it
    belongs in the plan's device cache (``fabric._const``).

Routed-mode programs get ``check_routed``: *zero* all-gathers (every wire
byte moves along hop-graph edges, point to point), the per-edge byte
budget and the int16 wire dtype on every routed plane.

The byte budgets are the reference's, measured as it measures them: an
all-gather by its output, the ``f`` planes of the group (``WireCall``'s
``bytes``; the executor's ``_gather_plane.bytes`` counter keeps the bytes
a rank receives, ``(f - 1)`` planes), a routed call by the planes this
rank receives.

``fabric_exchange`` needs one rank per leaf, so the lint runs a
structure-preserving *shrunk twin* of each plan (every fan-in clamped to 2,
capacities re-clamped, one dead edge kept per degraded level) on 2-8 gloo
ranks (``parallel.spawn.run_ranks``), where the reference forces 8 virtual
XLA devices: the checked properties are shape-generic.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.analysis.diagnostics import Diagnostic, WARNING
from repro_torch.analysis.planlint import stream_lengths
from repro_torch.core.fabric import FabricPlan, compile_fabric

LARGE_CONST_ELEMS = 1 << 15     # arrays beyond this don't belong in a step
WIRE_WORD_BYTES = 2             # events.pack_wire16, the int16 wire format
WIRE_DTYPES = ("int16", "uint16")
F64_DTYPES = (torch.float64, torch.complex128)

_aten = torch.ops.aten
# Operations that make a tensor of constant content (the reference's
# literal ``iota``/``broadcast_in_dim``), and ``lift_fresh``: a tensor made
# from host data (``torch.from_numpy``, ``torch.tensor``).
CONST_MAKERS = {_aten.zeros, _aten.ones, _aten.full, _aten.arange,
                _aten.eye, _aten.linspace, _aten.scalar_tensor,
                _aten.zeros_like, _aten.ones_like, _aten.full_like,
                _aten.new_zeros, _aten.new_ones, _aten.new_full,
                _aten.lift_fresh, _aten.lift_fresh_copy}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ProgramTrace(TorchDispatchMode):
    """Records the aten operations run while the mode is active.

    ``ops``: ``(op, dtype, shape)`` of every tensor output, in order.
    ``consts``: ``(op, what, elements)`` of every constant-content tensor,
    host-data tensor and host-to-device copy of more than
    ``LARGE_CONST_ELEMS`` elements."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, torch.dtype, tuple]] = []
        self.consts: list[tuple[str, str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket.__name__)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.ops.append((name, t.dtype, tuple(t.shape)))
        first = outs[0] if outs else None
        if (isinstance(first, torch.Tensor)
                and first.numel() > LARGE_CONST_ELEMS):
            if func.overloadpacket in CONST_MAKERS:
                what = ("host data" if "lift_fresh" in name
                        else "constant")
                self.consts.append((name, what, first.numel()))
            elif func.overloadpacket in (_aten._to_copy, _aten.copy_):
                src = args[1] if func.overloadpacket is _aten.copy_ \
                    else args[0]
                if (isinstance(src, torch.Tensor) and src.device.type == "cpu"
                        and first.device.type == "cuda"):
                    self.consts.append((name, "host-to-device copy",
                                        first.numel()))
        return out


def check_f64(ops, path: str) -> list[Diagnostic]:
    """No double precision anywhere in the program (one finding per
    operation, at most 8)."""
    diags = []
    for name, dtype, shape in ops:
        if dtype in F64_DTYPES:
            diags.append(Diagnostic(
                "program.f64", f"{path}/{name}",
                f"{_name(dtype)} value of shape {shape} — the datapath is "
                f"f32/int16/int32"))
    return diags[:8]


def check_step_consts(later: ProgramTrace, path: str,
                      first: ProgramTrace | None = None
                      ) -> list[Diagnostic]:
    """Large constants must be made once (the plan's device cache), not in
    every step.  ``later`` traces steps after the first; ``first``, when
    given, traces a run of the same program over fewer steps, and only
    what ``later`` makes more often counts (what both make once is set-up,
    not a step)."""
    extra = collections.Counter(later.consts)
    if first is not None:
        extra -= collections.Counter(first.consts)
    diags = []
    for (name, what, n), count in extra.items():
        diags.append(Diagnostic(
            "program.step-const", f"{path}/step/{name}",
            f"{n}-element {what} ({name}) made {count} time(s) in steps "
            f"after the first — hoist it out of the step (the plan's "
            f"constants live in fabric._const's device cache)"))
    return diags[:8]


def check_gathers(log, path: str, *, plan: FabricPlan | None = None,
                  cap_in: int | None = None,
                  timed: bool = False) -> list[Diagnostic]:
    """One int16 all-gather per fabric level, within the link budget, from
    one round's ``core.fabric.wire_log`` records."""
    diags = []
    per_level: dict[int, int] = {}
    total_bytes = 0
    allowed = WIRE_DTYPES + (("int32",) if timed else ())
    for call in log:
        if call.kind != "all_gather":
            continue
        per_level[call.level] = per_level.get(call.level, 0) + 1
        total_bytes += call.bytes
        if _name(call.dtype) not in allowed:
            diags.append(Diagnostic(
                "program.gather-widening", f"{path}/level[{call.level}]",
                f"all-gather moves {_name(call.dtype)} planes — the wire "
                f"format is int16 words; a pre-gather widening multiplies "
                f"wire bytes"))
    for level, count in sorted(per_level.items()):
        if count > (2 if timed else 1):
            diags.append(Diagnostic(
                "program.gather-count", f"{path}/level[{level}]",
                f"{count} all-gathers on one fabric level — each level is "
                f"one gather of the packed wire stream"))
    if plan is not None:
        for level in range(plan.n_levels):
            if level not in per_level:
                diags.append(Diagnostic(
                    "program.gather-count", f"{path}/level[{level}]",
                    "no all-gather on this fabric level — the exchange lost "
                    "its collective or the wire log missed it", WARNING))
    if plan is not None and cap_in is not None:
        budget = gather_budget_bytes(plan, cap_in, timed=timed)
        if total_bytes > budget:
            diags.append(Diagnostic(
                "program.collective-budget", path,
                f"program gathers {total_bytes} bytes/round but the plan's "
                f"link capacities budget {budget} "
                f"(fan_in x link_capacity x {WIRE_WORD_BYTES}B per level)"))
    return diags


def gather_budget_bytes(plan: FabricPlan, cap_in: int, *,
                        timed: bool = False) -> int:
    """Plan-derived wire budget of one exchange round, per leaf: each level
    gathers ``fan_in`` child streams of the packed length, as int16 wire
    words (plus the int32 timestamp plane when timed)."""
    lens = stream_lengths(plan, cap_in)
    word = WIRE_WORD_BYTES + (4 if timed else 0)
    return sum(lvl.fan_in * ln * word
               for lvl, ln in zip(plan.levels, lens))


def check_routed(log, path: str, *, plan: FabricPlan | None = None,
                 cap_in: int | None = None,
                 timed: bool = False) -> list[Diagnostic]:
    """Routed-mode program invariants: zero all-gathers (every wire byte
    moves edge to edge, point to point), the per-edge byte budget, and the
    int16 wire dtype on every routed plane."""
    diags = []
    n_gathers = 0
    total_bytes = 0
    allowed = WIRE_DTYPES + (("int32",) if timed else ())
    for call in log:
        if call.kind == "all_gather":
            n_gathers += 1
            continue
        total_bytes += call.bytes
        if _name(call.dtype) not in allowed:
            diags.append(Diagnostic(
                "program.gather-widening", f"{path}/level[{call.level}]",
                f"routed plane moves {_name(call.dtype)} — the routed wire "
                f"format is int16 words; a pre-exchange widening "
                f"multiplies per-edge bytes"))
    if n_gathers:
        diags.append(Diagnostic(
            "program.gather-count", path,
            f"{n_gathers} all-gather(s) in a routed program — routed mode "
            f"exchanges only along hop-graph edges; a gather reintroduces "
            f"O(n_chips) broadcast bandwidth"))
    if plan is not None and cap_in is not None:
        budget = routed_budget_bytes(plan, cap_in, timed=timed)
        if total_bytes > budget:
            diags.append(Diagnostic(
                "program.collective-budget", path,
                f"routed program moves {total_bytes} bytes/round but the "
                f"plan's edge schedule budgets {budget} "
                f"((fan_in - 1) x stream_len x {WIRE_WORD_BYTES}B per "
                f"level)"))
    return diags


def routed_budget_bytes(plan: FabricPlan, cap_in: int, *,
                        timed: bool = False) -> int:
    """Per-edge wire budget of one *routed* exchange round, per leaf: each
    level runs ``fan_in - 1`` ring rotations, each shipping this child's
    packed stream to one sibling (the own slot never travels), as int16
    wire words (plus the int32 timestamp plane when timed).  The routed /
    gather byte ratio is therefore ``(fan_in - 1) / fan_in`` per level in
    the worst case, and lower when route-enable pruning drops edges at
    the top level."""
    lens = stream_lengths(plan, cap_in)
    word = WIRE_WORD_BYTES + (4 if timed else 0)
    return sum((lvl.fan_in - 1) * ln * word
               for lvl, ln in zip(plan.levels, lens))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def shrink_plan(plan: FabricPlan, cap_in: int,
                max_fan: int = 2) -> tuple[FabricPlan, int]:
    """Structure-preserving twin small enough for a few ranks: fan-ins
    clamped to ``max_fan``, capacities re-clamped to the shrunk streams,
    one dead edge kept per level that had any (so degraded plans lint
    their degraded program).  Returns ``(twin, twin_cap_in)``."""
    cap_small = min(cap_in, 4)
    fans = [min(sl.fan_in, max_fan) for sl in plan.spec.levels]
    levels, lens = [], []
    for i, (sl, pl) in enumerate(zip(plan.spec.levels, plan.levels)):
        feed = cap_small if i == 0 else fans[i - 1] * lens[i - 1]
        cap = pl.link_capacity
        cap = None if cap is None else min(cap, feed)
        lens.append(feed if cap is None else cap)
        levels.append(dataclasses.replace(
            sl, fan_in=fans[i], enables=None, link_capacity=cap, link=None,
            uplink_health=None, downlink_health=None))
    n_nodes = math.prod(fans)
    gsize = 1
    for i, pl in enumerate(plan.levels):
        n_edges = n_nodes // gsize
        dead = [False] * n_edges
        dead[0] = True
        if pl.uplink_ok is not None:
            levels[i] = dataclasses.replace(
                levels[i], uplink_health=tuple(not d for d in dead))
        if pl.downlink_ok is not None:
            levels[i] = dataclasses.replace(
                levels[i], downlink_health=tuple(not d for d in dead))
        gsize *= fans[i]
    total = sum(f * ln for f, ln in zip(fans, lens))
    spec = dataclasses.replace(
        plan.spec, levels=tuple(levels),
        capacity=min(plan.capacity, total))
    return compile_fabric(spec), cap_small


def _traced(fn) -> ProgramTrace:
    with ProgramTrace() as trace:
        fn()
    return trace


def _egress(n: int, cap_in: int, seed: int, device) -> "EventFrame":
    """Egress frames ``[n, cap_in]`` at the catalogue's occupancy, labels
    the identity router's ``chip << 9 | neuron``."""
    from repro_torch.analysis.scenarios import OCC_HEADLINE
    from repro_torch.core.events import EventFrame

    rng = np.random.default_rng(seed)
    labels = ((np.arange(n)[:, None] << 9)
              + rng.integers(0, 512, (n, cap_in))).astype(np.int32)
    valid = rng.random((n, cap_in)) < OCC_HEADLINE
    return EventFrame(labels=torch.from_numpy(labels).to(device),
                      times=torch.zeros((n, cap_in), dtype=torch.int32,
                                        device=device),
                      valid=torch.from_numpy(valid).to(device))


def lint_route_step(plan: FabricPlan, cap_in: int,
                    path: str = "fabric_route_step", *,
                    device=None) -> list[Diagnostic]:
    """Run the stacked executor on this plan, two rounds, and check the
    traced program: no float64, no large constant made in the second
    round.  On the card the round runs the kernels; on the CPU their plain
    versions."""
    from repro_torch.core.aggregator import identity_router
    from repro_torch.core.fabric import fabric_route_step

    device = resolve_device(device)
    state = identity_router(plan.n_nodes, device=device)
    frames = _egress(plan.n_nodes, cap_in, 0, device)

    def step():
        fabric_route_step(state, frames, plan)

    first, later = _traced(step), _traced(step)
    return (check_f64(first.ops + later.ops, path)
            + check_step_consts(later, path))


def lint_run_stream(path: str = "run_stream", *, device=None,
                    n_steps: int = 3) -> list[Diagnostic]:
    """Run the emulation loop on the reference's small star network (2
    chips, capacity 64) for one step and for ``n_steps``, and check the
    traced programs: no float64, and nothing large made in the steps
    after the first (the longer run makes no more large constants than
    the one-step run)."""
    from repro_torch.snn import network as netlib
    from repro_torch.snn import stream as stlib

    device = resolve_device(device)
    cfg = netlib.NetworkConfig(n_chips=2, capacity=64)
    params = netlib.init_feedforward(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    drives = torch.from_numpy(
        (rng.random((n_steps, cfg.n_chips, 1, cfg.chip.n_rows)) < 0.05)
        .astype(np.float32)).to(device)

    def run(t):
        state = netlib.init_state(cfg, 1, device=device)
        return lambda: stlib.run_stream(params, state, drives[:t], cfg,
                                        mode="event", device=device)

    run(1)()                                     # warm the plan caches
    first, later = _traced(run(1)), _traced(run(n_steps))
    return (check_f64(first.ops + later.ops, path)
            + check_step_consts(later, path, first))


def _exchange_rank(rank: int, world: int, jobs: list, device: str) -> list:
    """One rank of the sharded lint: each job's twin exchanged for two
    rounds through ``FabricInterconnect.exchange_fn``, the second under
    ``wire_log`` and a ``ProgramTrace``.  Returns per job the wire calls,
    the traced dtypes and the large constants of the second round."""
    from repro_torch.core import fabric as fablib
    from repro_torch.core.events import EventFrame
    from repro_torch.core.routing import identity_tables
    from repro_torch.parallel.sharding import fabric_mesh

    dev = torch.device(device)
    tables = identity_tables(device=dev)
    out = []
    for plan, cap_in in jobs:
        mesh = fabric_mesh(plan, device_type=dev.type)
        fn = fablib.FabricInterconnect(mesh=mesh, plan=plan).exchange_fn()
        f = _egress(plan.n_nodes, cap_in, 1, dev)
        frame = EventFrame(f.labels[rank], f.times[rank], f.valid[rank])
        with ProgramTrace() as first:
            fn(frame, tables.fwd, tables.rev)
        with fablib.wire_log() as log, ProgramTrace() as later:
            fn(frame, tables.fwd, tables.rev)
        out.append({"wire": [tuple(c) for c in log],
                    "ops": first.ops + later.ops,
                    "consts": later.consts})
    return out


def lint_fabric_exchanges(jobs, *, device=None) -> list[Diagnostic]:
    """Lint the sharded executor on each job's shrunk twin.

    ``jobs``: ``(plan, cap_in, path)``; a plan in ``exchange_mode="routed"``
    gets ``check_routed``, else ``check_gathers``.  The twins of one size
    run together on ``twin.n_nodes`` gloo ranks (one ``run_ranks`` call),
    all on ``device``; every rank's findings count, each finding once."""
    from repro_torch.core.fabric import WireCall
    from repro_torch.parallel.spawn import run_ranks

    device = resolve_device(device)
    twins = [(*shrink_plan(plan, cap_in), path) for plan, cap_in, path in jobs]
    by_world: dict[int, list[int]] = {}
    for k, (twin, _, _) in enumerate(twins):
        by_world.setdefault(twin.n_nodes, []).append(k)
    results: dict[int, list] = {}
    for world, ks in sorted(by_world.items()):
        ranks = run_ranks(_exchange_rank, world,
                          [twins[k][:2] for k in ks], str(device),
                          timeout_s=600)
        for j, k in enumerate(ks):
            results[k] = [r[j] for r in ranks]
    diags: list[Diagnostic] = []
    for k, (twin, cap, path) in enumerate(twins):
        check = (check_routed if twin.exchange_mode == "routed"
                 else check_gathers)
        for res in results[k]:
            log = [WireCall(*c) for c in res["wire"]]
            trace = ProgramTrace()
            trace.consts = res["consts"]
            for d in (check_f64(res["ops"], path)
                      + check(log, path, plan=twin, cap_in=cap)
                      + check_step_consts(trace, path)):
                if d not in diags:
                    diags.append(d)
    return diags
