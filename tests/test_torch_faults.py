"""Fault injection in the port against the JAX package: the fault-schedule
helpers, the dynamic health overlay of ``fabric_route_step`` and
``run_stream(faults=, fault_mode=)`` in both modes.

Every input is made with numpy from a seed and fed to both packages.

Tolerances.  The helpers and the exchange round are exact: health masks,
dead-edge sets, boundaries and shifted schedules equal, and labels, valid,
times and all four ``ExchangeDrops`` fields equal bit for bit.  Whole-slice
runs follow ``test_torch_stream.py``'s rule through ``parity``: dyadic
weights and drives, every integer output (drops, latencies, ``unroutable``,
``rerouted``) equal up to the first spike flip, a flip allowed only where
the reference's margin ``|v - v_th|`` is below ``parity.FLIP_MARGIN``
(1e-5), the final float state within ``parity.STATE_ATOL`` (1e-5) and the
delay line equal where the rasters agree; the exchange stage is exact under
teacher forcing with each step's overlay or degraded plan.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import fabric as jfab
from repro.core.aggregator import RouterState as JRouter
from repro.core.events import EventFrame as JFrame
from repro.core.events import make_frame as j_make_frame
from repro.core.latency import timed_wire as j_timed_wire
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import fabric as tfab
from repro_torch.core.aggregator import RouterState as TRouter
from repro_torch.core.aggregator import identity_router
from repro_torch.core.events import EventFrame as TFrame
from repro_torch.core.latency import timed_wire as t_timed_wire
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from repro_torch.snn import stream as tstream
from test_torch_fabric import _tables as tables
from test_torch_stream import BATCH, SMALL_CHIP, STEPS, flatten
from torch_threads import share_cores

share_cores()

# (level, edge, kill_step, restore_step, kind), on EXT_4CASE_96CHIP's edge
# counts 96/8/4, over STEPS steps.
SCHEDULES = {
    "permanent": ((1, 0, 2, None, "uplink"),),
    "restored": ((1, 0, 2, 5, "uplink"),),
    "overlapping": ((1, 0, 1, 6, "uplink"), (1, 0, 3, 8, "uplink"),
                    (2, 1, 4, None, "uplink")),
    "downlink": ((0, 3, 4, None, "downlink"), (1, 2, 2, 7, "uplink")),
    "past_n_steps": ((0, 5, 6, 20, "uplink"), (1, 1, 12, None, "uplink"),
                     (2, 3, 9, 11, "downlink")),
}


def events(rows, cls):
    return [cls(*r) for r in rows]


def ext_plans():
    return (jfab.compile_fabric(jfab.ext_4case_spec(96)),
            tfab.compile_fabric(tfab.ext_4case_spec(96)))


# ---------------------------------------------------------------------------
# Fault-schedule helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCHEDULES)
def test_health_schedule_matches(name):
    j_plan, t_plan = ext_plans()
    assert t_plan.edge_counts == j_plan.edge_counts == (96, 8, 4)
    ref = jfab.health_schedule(j_plan, events(SCHEDULES[name],
                                              jfab.FaultEvent), STEPS)
    got = tfab.health_schedule(t_plan, events(SCHEDULES[name],
                                              tfab.FaultEvent), STEPS,
                               device="cpu")
    for side in ("uplink", "downlink"):
        for i, (r, g) in enumerate(zip(getattr(ref, side), getattr(got, side),
                                       strict=True)):
            assert (r is None) == (g is None), (side, i)
            if r is not None:
                assert g.dtype == torch.bool and g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                              err_msg=f"{side}[{i}]")


@pytest.mark.parametrize("name", SCHEDULES)
def test_dead_edges_and_boundaries_match(name):
    ref = events(SCHEDULES[name], jfab.FaultEvent)
    got = events(SCHEDULES[name], tfab.FaultEvent)
    for step in range(-1, 22):
        assert tfab.dead_edges_at(got, step) == jfab.dead_edges_at(ref, step)
    for n_steps in (0, 3, STEPS, 20):
        assert (tfab.fault_boundaries(got, n_steps)
                == jfab.fault_boundaries(ref, n_steps))


@pytest.mark.parametrize("name", SCHEDULES)
def test_shift_faults_matches(name):
    ref = events(SCHEDULES[name], jfab.FaultEvent)
    got = events(SCHEDULES[name], tfab.FaultEvent)
    for start, n_steps in ((0, 8), (3, 5), (6, 10)):
        r = jfab.shift_faults(ref, start, n_steps)
        g = tfab.shift_faults(got, start, n_steps)
        assert type(g) is tuple
        assert all(type(ev) is tfab.FaultEvent for ev in g)
        assert ([dataclasses.astuple(ev) for ev in g]
                == [dataclasses.astuple(ev) for ev in r]), (start, n_steps)


def test_fault_event_fields_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(tfab.FaultEvent)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jfab.FaultEvent)])
    with pytest.raises(dataclasses.FrozenInstanceError):
        tfab.FaultEvent(1, 0, 2).edge = 3


@pytest.mark.parametrize("bad", [
    (1, 0, 0, None, "sideways"),      # unknown kind
    (-1, 0, 0),                       # level below the plan
    (3, 0, 0),                        # level past the plan
    (1, 8, 0),                        # edge past level 1's 8
    (0, -1, 0),                       # negative edge
    (1, 0, 3, 3),                     # restore_step == kill_step
])
def test_check_faults_errors_match(bad):
    j_plan, t_plan = ext_plans()
    with pytest.raises(ValueError) as ref:
        jfab.health_schedule(j_plan, [jfab.FaultEvent(*bad)], STEPS)
    with pytest.raises(ValueError) as got:
        tfab.health_schedule(t_plan, [tfab.FaultEvent(*bad)], STEPS,
                             device="cpu")
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        tfab._check_faults(t_plan, [tfab.FaultEvent(*bad)])


def test_fault_helpers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, plan = ext_plans()
    for call in (lambda: tfab.full_health(plan),
                 lambda: tfab.health_schedule(
                     plan, [tfab.FaultEvent(1, 0, 2)], STEPS)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tfab.full_health(plan, device="cpu").uplink[0].device.type == "cpu"


# ---------------------------------------------------------------------------
# fabric_route_step(health=)
# ---------------------------------------------------------------------------

# The overlays: {(side, level): dead edges}, and whether the plan is the
# statically degraded variant (a dead level-1 uplink with a detour).
OVERLAYS = {
    "uplink_on_healthy": ({("uplink", 1): (0,), ("uplink", 0): (5,)}, False),
    "statically_detoured_edge": ({("uplink", 1): (0,)}, True),
    "downlink": ({("downlink", 0): (3,), ("downlink", 1): (1,)}, False),
}


def two_level_spec(fab):
    return fab.hierarchical_spec(4, 3, 24, link_capacity=6, pod_capacity=10)


def overlay_plans(name, degraded):
    """(reference plan, port plan, cap_in) of a test fabric."""
    if name == "EXT_4CASE_96CHIP":
        key = name + ("/1dead_uplink" if degraded else "")
        ref = next(s for s in jsc.benchmark_plans() if s.name == key)
        got = next(s for s in tsc.benchmark_plans() if s.name == key)
        return ref.plan, got.plan, ref.cap_in
    # Two detoured level-1 uplinks: the overlay masks edge 0 and leaves
    # edge 2's detour live, so the timed lane's penalty runs too.
    dead = ((1, 0), (1, 2)) if degraded else ()
    return (jfab.compile_fabric(jfab.degrade_spec(two_level_spec(jfab), dead)),
            tfab.compile_fabric(tfab.degrade_spec(two_level_spec(tfab), dead)),
            9)


def overlay_masks(plan, dead):
    """{side: [bool[n_edges] or None per level]} with the given edges
    masked."""
    masks = {"uplink": [None] * plan.n_levels,
             "downlink": [None] * plan.n_levels}
    for (side, level), edges in dead.items():
        m = np.ones(plan.edge_counts[level], bool)
        m[list(edges)] = False
        masks[side][level] = m
    return masks


def j_health(masks):
    return jfab.FabricHealth(*(tuple(None if m is None else jnp.asarray(m)
                                     for m in masks[s])
                               for s in ("uplink", "downlink")))


def t_health(masks, device="cpu"):
    return tfab.FabricHealth(*(
        tuple(None if m is None else torch.from_numpy(m).to(device)
              for m in masks[s]) for s in ("uplink", "downlink")))


def overlay_inputs(plan, cap_in, seed):
    """Router tables and two batch rows of egress frames."""
    rng = np.random.default_rng(seed)
    n = plan.n_nodes
    fwd, rev = tables(rng, n)
    shape = (2, n, cap_in)
    labels = rng.integers(0, 1 << 16, shape).astype(np.int32)
    times = rng.integers(0, 500, shape).astype(np.int32)
    valid = rng.random(shape) < 0.5
    return (fwd, rev, np.ones((n, n), bool)), (labels, times, valid)


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("mode", ["gather", "routed"])
@pytest.mark.parametrize("overlay", OVERLAYS)
@pytest.mark.parametrize("plan_name", ["EXT_4CASE_96CHIP", "two_level"])
def test_fabric_route_step_health_bit_exact(plan_name, overlay, mode, timed):
    """The port's batched round (two rows, one overlay) against the
    reference's round on each row."""
    dead, degraded = OVERLAYS[overlay]
    r_plan, g_plan, cap_in = overlay_plans(plan_name, degraded)
    r_plan = jfab.with_exchange_mode(r_plan, mode)
    g_plan = tfab.with_exchange_mode(g_plan, mode)
    masks = overlay_masks(r_plan, dead)
    router, frames = overlay_inputs(
        r_plan, cap_in, [len(plan_name), list(OVERLAYS).index(overlay),
                         mode == "routed", timed])
    out_g, drops_g = tfab.fabric_route_step(
        TRouter(*map(torch.from_numpy, router)),
        TFrame(*map(torch.from_numpy, frames)), g_plan,
        timing=t_timed_wire() if timed else None, health=t_health(masks))
    for b in range(2):
        out_r, drops_r = jfab.fabric_route_step(
            JRouter(*map(jnp.asarray, router)),
            JFrame(*(jnp.asarray(x[b]) for x in frames)), r_plan,
            timing=j_timed_wire() if timed else None, health=j_health(masks))
        for f in ("labels", "times", "valid"):
            np.testing.assert_array_equal(getattr(out_g, f)[b].numpy(),
                                          np.asarray(getattr(out_r, f)),
                                          err_msg=f"row {b} {f}")
        for f in drops_r._fields:
            np.testing.assert_array_equal(getattr(drops_g, f)[b].numpy(),
                                          np.asarray(getattr(drops_r, f)),
                                          err_msg=f"row {b} {f}")
    assert int(drops_g.unroutable.sum()) > 0, "the overlay masked nothing"
    if degraded and plan_name == "two_level":
        assert int(drops_g.rerouted.sum()) > 0, "no live detour exercised"


def test_health_is_validated():
    _, plan, cap_in = overlay_plans("two_level", False)
    router, frames = overlay_inputs(plan, cap_in, 0)
    args = (TRouter(*map(torch.from_numpy, router)),
            TFrame(*map(torch.from_numpy, frames)), plan)
    bad = tfab.FabricHealth(uplink=(torch.ones(5, dtype=torch.bool), None),
                            downlink=(None, None))
    with pytest.raises(ValueError, match="covers 5 edges"):
        tfab.fabric_route_step(*args, health=bad)
    with pytest.raises(ValueError, match="levels"):
        tfab.fabric_route_step(*args, health=tfab.FabricHealth((None,),
                                                               (None,)))


def test_overlay_equals_static_masking():
    """A dynamic overlay masks exactly like the same health compiled
    statically with reroute=False, and the identity overlay is a no-op
    (port of the reference's test_dynamic_overlay_equals_static_masking)."""
    spec = two_level_spec(tfab)
    healthy = tfab.compile_fabric(spec)
    static = tfab.compile_fabric(tfab.degrade_spec(spec, [(1, 0)],
                                                   reroute=False))
    router, frames = overlay_inputs(healthy, 9, 1)
    args = (TRouter(*map(torch.from_numpy, router)),
            TFrame(*map(torch.from_numpy, frames)))
    timing = t_timed_wire()
    overlay = t_health(overlay_masks(healthy, {("uplink", 1): (0,)}))
    for (a, da), (b, db) in (
            (tfab.fabric_route_step(*args, static, timing=timing),
             tfab.fabric_route_step(*args, healthy, timing=timing,
                                    health=overlay)),
            (tfab.fabric_route_step(*args, healthy, timing=timing),
             tfab.fabric_route_step(*args, healthy, timing=timing,
                                    health=tfab.full_health(healthy,
                                                            device="cpu")))):
        for x, y in zip((*a, *da), (*b, *db), strict=True):
            assert torch.equal(x, y)


def test_overlay_masks_even_a_statically_detoured_edge():
    """The overlay cannot reroute: masking an edge that the static plan
    detours kills its stream anyway (port of the reference's test of the
    same name)."""
    spec = tfab.hierarchical_spec(4, 3, 24)      # no packs: every event counts
    deg = tfab.compile_fabric(tfab.degrade_spec(spec, [(1, 0)]))
    assert deg.levels[1].detour[0] == 1
    router, frames = overlay_inputs(deg, 9, 2)
    plain = TRouter(*map(torch.from_numpy, router))
    _, drops = tfab.fabric_route_step(
        plain, TFrame(*map(torch.from_numpy, frames)), deg,
        health=t_health(overlay_masks(deg, {("uplink", 1): (0,)})))
    # Pod 0 is leaves 0-2: its egress after the fwd LUT, charged to each.
    wire_ok = (router[0][np.arange(12)[:, None], frames[0]] >> 15) & 1
    n_sub = (frames[2] & wire_ok.astype(bool))[:, :3].sum(axis=(1, 2))
    assert int(drops.rerouted.sum()) == 0
    np.testing.assert_array_equal(drops.unroutable[:, :3].numpy(),
                                  np.repeat(n_sub[:, None], 3, axis=1))
    assert int(drops.unroutable[:, 3:].sum()) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels); "
                    "run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("overlay", OVERLAYS)
def test_fabric_route_step_health_card_matches_cpu(cuda_device, overlay,
                                                   timed):
    dead, degraded = OVERLAYS[overlay]
    _, plan, cap_in = overlay_plans("EXT_4CASE_96CHIP", degraded)
    masks = overlay_masks(plan, dead)
    router, frames = overlay_inputs(plan, cap_in, 3)
    outs = {}
    for dev in ("cpu", cuda_device):
        out, drops = tfab.fabric_route_step(
            TRouter(*(torch.from_numpy(x).to(dev) for x in router)),
            TFrame(*(torch.from_numpy(x).to(dev) for x in frames)), plan,
            timing=t_timed_wire() if timed else None,
            health=t_health(masks, dev))
        outs[str(dev)] = (*out, *drops)
    torch.cuda.synchronize()
    names = ("labels", "times", "valid", *tfab.ExchangeDrops._fields)
    for name, a, b in zip(names, outs["cpu"], outs[str(cuda_device)],
                          strict=True):
        parity.assert_equal(f"card vs CPU {name}", a, b)
    with pytest.raises(ValueError, match="lies on cpu"):
        tfab.fabric_route_step(
            TRouter(*(torch.from_numpy(x).to(cuda_device) for x in router)),
            TFrame(*(torch.from_numpy(x).to(cuda_device) for x in frames)),
            plan, health=t_health(masks, "cpu"))


# ---------------------------------------------------------------------------
# run_stream(faults=, fault_mode=) — the whole slice
# ---------------------------------------------------------------------------

# The probe schedule: an uplink dead for steps 2-4, a downlink dead from
# step 4 on.  FULL_BACKPLANE has one level, so its uplink fault is a leaf's.
STREAM_FAULTS = {
    "EXT_4CASE_96CHIP": ((1, 0, 2, 5, "uplink"), (0, 3, 4, None, "downlink")),
    "FULL_BACKPLANE": ((0, 0, 2, 5, "uplink"), (0, 3, 4, None, "downlink")),
}


def jax_exchange_step(params, spikes, cfg, plan, timing, health):
    """The reference's exchange stage of one step (``run_stream``'s
    ``event_route``) on spikes [n_chips, batch, n_neurons]."""
    grid = jstream._egress_label_grid(cfg)

    def one(spk):                                  # [n_chips, n_neurons]
        times = jnp.zeros_like(grid) if timing is not None else None
        frames, egress_drop = j_make_frame(grid, times, spk > 0.5,
                                           cfg.capacity)
        ingress, drops = jfab.fabric_route_step(params.router, frames, plan,
                                                timing=timing, health=health)
        drives = jax.vmap(lambda lab, val, rmap: jchip.labels_to_rows(
            lab[None], val[None], rmap, cfg.chip.n_rows)[0])(
                ingress.labels, ingress.valid, params.row_of_label)
        lat = ingress.times if timing is not None else ingress.times[:, :0]
        lat_valid = (ingress.valid if timing is not None
                     else ingress.valid[:, :0])
        return (drives, egress_drop + drops.congestion, drops.uplink, lat,
                lat_valid, drops.unroutable, drops.rerouted)

    return jax.vmap(one, in_axes=1, out_axes=1)(spikes)


def stream_case(name, mode):
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    return (cfg_j, params_j, jfab.with_exchange_mode(plan_j, mode),
            cfg_t, params_t, tfab.with_exchange_mode(plan_t, mode))


@pytest.mark.parametrize("fault_mode", ["mask", "reroute"])
@pytest.mark.parametrize("name,mode,timed", [
    ("EXT_4CASE_96CHIP", "gather", True),
    ("EXT_4CASE_96CHIP", "routed", False),
    ("FULL_BACKPLANE", "gather", False),
])
def test_run_stream_faults_match_reference(name, mode, timed, fault_mode):
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(name, mode)
    faults_j = events(STREAM_FAULTS[name], jfab.FaultEvent)
    faults_t = events(STREAM_FAULTS[name], tfab.FaultEvent)
    rng = np.random.default_rng([len(name), timed, fault_mode == "mask"])
    shape = (STEPS, cfg_j.n_chips, BATCH, cfg_j.chip.n_rows)
    drives = ((rng.random(shape) < 0.6)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    kw_j = dict(fabric=plan_j, timed=timed, faults=faults_j,
                fault_mode=fault_mode)

    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             **kw_j)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, fabric=plan_t, timed=timed,
                             faults=faults_t, fault_mode=fault_mode,
                             device="cpu")

    def margin_at(t):       # the reference's state entering step t
        before = jstream.run_stream(params_j, state_j,
                                    jnp.asarray(drives[:t]), cfg_j,
                                    **kw_j).state if t else state_j
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t)

    report = parity.compare_streams(ref, got, margin_at)
    print(f"{name}/{mode}/timed={timed}/{fault_mode}: {report}")
    if report["first_flip_step"] is None:
        parity.assert_equal("final delay line", ref.state.inflight,
                            got.state.inflight)
    # Losses only from the first kill on; on EXT_4CASE_96CHIP reroute mode
    # detours the dead uplink (steps 2-4), so only the downlink loses.
    lost = got.unroutable.sum(dim=(1, 2)).numpy()
    detoured = got.rerouted.sum(dim=(1, 2)).numpy()
    assert not lost[:2].any() and lost[2:].sum() > 0, lost
    if fault_mode == "reroute" and name == "EXT_4CASE_96CHIP":
        assert not lost[:4].any(), lost
        assert detoured[2:5].sum() > 0, detoured
        assert not detoured[:2].any() and not detoured[5:].any(), detoured
    else:
        assert not detoured.any(), detoured

    # Teacher forcing: both packages route the reference's own spikes with
    # each step's overlay (mask) or degraded plan (reroute).
    ref_spikes = np.array(ref.spikes)
    plans_j, sched_j = (
        ([plan_j] * STEPS, jfab.health_schedule(plan_j, faults_j, STEPS))
        if fault_mode == "mask" else
        ([jfab.compile_fabric(jfab.degrade_spec(
            plan_j.spec, jfab.dead_edges_at(faults_j, t)))
          if jfab.dead_edges_at(faults_j, t) else plan_j
          for t in range(STEPS)], None))
    plans_t, sched_t = tstream.fault_segments(plan_t, faults_t, fault_mode,
                                              STEPS, "cpu")
    names = ("drives", "dropped", "uplink", "latency_ns", "latency_valid",
             "unroutable", "rerouted")
    for t in range(STEPS):
        h_j = (None if sched_j is None else
               jax.tree.map(lambda a: a[t], sched_j))
        ex_ref = jax_exchange_step(
            params_j, jnp.asarray(ref_spikes[t]), cfg_j, plans_j[t],
            j_timed_wire(cfg_j.latency) if timed else None, h_j)
        ex_got = tstream.exchange_spikes(
            params_t, torch.from_numpy(ref_spikes[t]), cfg_t, plans_t[t],
            t_timed_wire(cfg_t.latency) if timed else None,
            None if sched_t is None else tstream.health_at(sched_t, t))
        for field, r, g in zip(names, ex_ref, ex_got, strict=True):
            parity.assert_equal(f"step {t} teacher-forced {field}", r, g)


class Spy:
    """Counts the calls of a kernel wrapper and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("faults,fault_mode,exchange,merge", [
    (None, "mask", STEPS, 0),
    ((), "mask", STEPS, 0),                  # an empty schedule is healthy
    ([tfab.FaultEvent(0, 0, 2, 5)], "mask", 0, STEPS),
    ([tfab.FaultEvent(0, 0, 2, 5)], "reroute", STEPS - 3, 3),
    ([tfab.FaultEvent(0, 4, 0, kind="downlink")], "reroute", 0, STEPS),
])
def test_run_stream_fault_dispatch(monkeypatch, faults, fault_mode, exchange,
                                   merge):
    """A step with an overlay never takes the exchange fast path; a reroute
    segment with no dead edge does, a degraded one runs the merge
    engine."""
    cfg, params, plan = tsc.engine_network(
        "FULL_BACKPLANE", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    spies = {k: Spy(getattr(tfab, k))
             for k in ("fused_exchange", "fused_merge_pack")}
    for k, spy in spies.items():
        monkeypatch.setattr(tfab, k, spy)
    drives = torch.full((STEPS, cfg.n_chips, BATCH, 32), 0.75)
    tstream.run_stream(params, tnet.init_state(cfg, BATCH, device="cpu"),
                       drives, cfg, fabric=plan, faults=faults,
                       fault_mode=fault_mode, device="cpu")
    assert (spies["fused_exchange"].calls,
            spies["fused_merge_pack"].calls) == (exchange, merge)


# ---------------------------------------------------------------------------
# Ports of the reference's behaviour tests (tests/test_degraded.py)
# ---------------------------------------------------------------------------


def spec3(capacity):
    return tfab.FabricSpec(levels=(tfab.LevelSpec(2), tfab.LevelSpec(2),
                                   tfab.LevelSpec(2, extension=True)),
                           capacity=capacity)


def behaviour_setup(steps=6):
    """Eight full-size chips on a 2 x 2 x 2 fabric, an identity router,
    external drives on chip 0 only."""
    cfg = tnet.NetworkConfig(n_chips=8, capacity=2048)
    params = tnet.init_feedforward(cfg, seed=61, device="cpu")._replace(
        router=identity_router(8, device="cpu"))
    rng = np.random.default_rng(11)
    drives = np.zeros((steps, 8, 2, cfg.chip.n_rows), np.float32)
    drives[:, 0] = rng.random((steps, 2, cfg.chip.n_rows)) < 0.4
    state = tnet.init_state(cfg, 2, device="cpu")
    plan = tfab.compile_fabric(spec3(cfg.capacity))
    return cfg, params, torch.from_numpy(drives), state, plan


def test_run_stream_mask_mode_injects_and_recovers():
    """In-graph masking: the uplink dies for steps [2, 4); spikes match the
    healthy run before the window, unroutable counts the masked stream
    inside it, and nothing is rerouted."""
    cfg, params, drives, state, plan = behaviour_setup()
    faults = [tfab.FaultEvent(1, 0, kill_step=2, restore_step=4)]
    ref = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             device="cpu")
    out = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             faults=faults, fault_mode="mask", device="cpu")
    assert torch.equal(out.spikes[:2], ref.spikes[:2])
    assert int(out.rerouted.sum()) == 0
    per_step = out.unroutable.sum(dim=(1, 2)).numpy()
    assert (per_step[:2] == 0).all() and (per_step[4:] == 0).all()
    assert (per_step[2:4] > 0).all()


def test_run_stream_reroute_mode_is_bit_exact():
    """Recompile-at-boundary mode: with a live detour the spike trains equal
    the healthy run's for the whole stream, the detoured traffic shows in
    ``rerouted``, and the final state agrees."""
    cfg, params, drives, state, plan = behaviour_setup()
    faults = [tfab.FaultEvent(1, 0, kill_step=2, restore_step=4)]
    ref = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             device="cpu")
    out = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             faults=faults, fault_mode="reroute",
                             device="cpu")
    assert torch.equal(out.spikes, ref.spikes)
    assert int(out.unroutable.sum()) == 0
    per_step = out.rerouted.sum(dim=(1, 2)).numpy()
    assert (per_step[:2] == 0).all() and (per_step[4:] == 0).all()
    assert (per_step[2:4] > 0).all()
    assert torch.equal(out.state.inflight, ref.state.inflight)
    for a, b in zip(out.state.chips.neurons, ref.state.chips.neurons,
                    strict=True):
        assert torch.equal(a, b)


def test_run_stream_timed_reroute_keeps_spikes_shifts_latency():
    cfg, params, drives, state, plan = behaviour_setup()
    faults = [tfab.FaultEvent(1, 0, kill_step=1)]
    ref = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             timed=True, device="cpu")
    out = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             timed=True, faults=faults, fault_mode="reroute",
                             device="cpu")
    assert torch.equal(out.spikes, ref.spikes)
    assert torch.equal(out.latency_valid, ref.latency_valid)
    delta = torch.where(out.latency_valid, out.latency_ns - ref.latency_ns,
                        0).numpy()
    assert (delta >= 0).all()
    assert (delta[1:] > 0).any()              # detoured events pay extras
    assert (delta[0] == 0).all()              # pre-fault step untouched


def test_run_stream_rejects_bad_fault_args():
    cfg = tnet.NetworkConfig(n_chips=8, chip=tchip.ChipConfig(**SMALL_CHIP))
    drives = torch.zeros((2, 8, 2, 32))
    fault = [tfab.FaultEvent(1, 0, 0)]
    for faults in (fault, None):              # unknown even without faults
        with pytest.raises(ValueError, match="fault_mode"):
            tstream.run_stream(None, None, drives, cfg, faults=faults,
                               fault_mode="nope", device="cpu")
    with pytest.raises(ValueError, match="event"):
        tstream.run_stream(None, None, drives, cfg, mode="dense",
                           route_mats=torch.zeros((8, 8, 64, 32)),
                           faults=fault, device="cpu")
    # Mask mode validates the schedule; reroute mode raises what degrading
    # the spec raises.
    cfg, params, plan = tsc.engine_network(
        "EXT_4CASE_96CHIP", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    state = tnet.init_state(cfg, 1, device="cpu")
    drives = torch.zeros((2, 96, 1, 32))
    for fault_mode, match in (("mask", "fault edge 9 outside level 1's 8"),
                              ("reroute", "^edge 9 outside level 1's 8")):
        with pytest.raises(ValueError, match=match):
            tstream.run_stream(params, state, drives, cfg, fabric=plan,
                               faults=[tfab.FaultEvent(1, 9, 0)],
                               fault_mode=fault_mode, device="cpu")
