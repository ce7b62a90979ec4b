"""The port's hop-graph compiler and stacked exchange round against the JAX
package.

Plans: for every catalogue scenario (the two degraded ones included) and a
few hand-built specs, the port's ``compile_fabric`` must give the same
merge layout, enables, capacities, crossing extras, health, detours and
routed edge schedules.  Exchange round: ``fabric_route_step`` on the same
numpy-made frames and LUTs must be bit-exact on labels, valid, times and
all four ``ExchangeDrops`` fields, over each scenario × {gather, routed} ×
{untimed, timed}.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import fabric as jfab
from repro.core.aggregator import RouterState as JRouter
from repro.core.events import EventFrame as JFrame
from repro.core.latency import LatencyParams as JLatency
from repro.core.latency import timed_wire as j_timed_wire
from repro.core.link import LinkConfig as JLink
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import fabric as tfab
from repro_torch.core.aggregator import RouterState as TRouter
from repro_torch.core.events import EventFrame as TFrame
from repro_torch.core.latency import LatencyParams as TLatency
from repro_torch.core.latency import timed_wire as t_timed_wire
from repro_torch.core.link import LinkConfig as TLink
from torch_threads import share_cores

share_cores()

SCENARIOS = [s.name for s in jsc.benchmark_plans()]


def _scenario(name):
    ref = next(s for s in jsc.benchmark_plans() if s.name == name)
    got = next(s for s in tsc.benchmark_plans() if s.name == name)
    return ref, got


def _assert_same_plan(ref, got, cap_in):
    assert got.n_nodes == ref.n_nodes and got.capacity == ref.capacity
    assert got.merge_layout(cap_in) == ref.merge_layout(cap_in)
    assert got.compact == ref.compact and got.degraded == ref.degraded
    n, gsize = ref.n_nodes, 1
    for i, (r, g) in enumerate(zip(ref.levels, got.levels, strict=True)):
        assert (g.fan_in, g.link_capacity, g.extra_ns, g.leaves) == \
            (r.fan_in, r.link_capacity, r.extra_ns, r.leaves), i
        np.testing.assert_array_equal(g.enables, np.asarray(r.enables))
        for f in ("uplink_ok", "detour", "downlink_ok"):
            a, b = getattr(r, f), getattr(g, f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"{i} {f}")
        src, live, deg = jfab._routed_leaf_maps(r.enables, i, n, gsize,
                                                r.fan_in)
        g_src, g_live, g_deg = tfab._routed_leaf_maps(g.enables, i, n, gsize,
                                                      g.fan_in)
        assert g_deg == deg
        np.testing.assert_array_equal(g_src, np.asarray(src))
        np.testing.assert_array_equal(g_live, np.asarray(live))
        gsize *= r.fan_in


@pytest.mark.parametrize("name", SCENARIOS)
def test_catalogue_plans_match(name):
    ref, got = _scenario(name)
    assert got.cap_in == ref.cap_in
    _assert_same_plan(ref.plan, got.plan, ref.cap_in)


def test_hand_built_specs_match():
    rng = np.random.default_rng(0)
    intra = rng.random((4, 4)) < 0.6
    inter = rng.random((3, 3)) < 0.6
    star = rng.random((6, 6)) < 0.6
    pairs = [
        (jfab.star_spec(6, 32, enables=jnp.asarray(star), link_capacity=5),
         tfab.star_spec(6, 32, enables=star, link_capacity=5)),
        (jfab.hierarchical_spec(3, 4, 40, intra_enables=jnp.asarray(intra),
                                inter_enables=jnp.asarray(inter),
                                link_capacity=6, pod_capacity=11),
         tfab.hierarchical_spec(3, 4, 40, intra_enables=intra,
                                inter_enables=inter, link_capacity=6,
                                pod_capacity=11)),
        (jfab.ext_4case_spec(64, link_capacities=(4, None, 20)),
         tfab.ext_4case_spec(64, link_capacities=(4, None, 20))),
        (jfab.FabricSpec(levels=(jfab.LevelSpec(4, link=JLink()),
                                 jfab.LevelSpec(3, latency=JLatency(
                                     l2_link_ns=150.0))),
                         capacity=16, window_us=0.5),
         tfab.FabricSpec(levels=(tfab.LevelSpec(4, link=TLink()),
                                 tfab.LevelSpec(3, latency=TLatency(
                                     l2_link_ns=150.0))),
                         capacity=16, window_us=0.5)),
    ]
    dead = ((1, 2), (0, 5, "downlink"), (1, 0))
    for j_spec, t_spec in pairs:
        _assert_same_plan(jfab.compile_fabric(j_spec),
                          tfab.compile_fabric(t_spec), 9)
        if len(j_spec.levels) > 1:
            for reroute in (True, False):
                _assert_same_plan(
                    jfab.compile_fabric(jfab.degrade_spec(j_spec, dead,
                                                          reroute=reroute)),
                    tfab.compile_fabric(tfab.degrade_spec(t_spec, dead,
                                                          reroute=reroute)),
                    9)


def test_compile_rejects_bad_specs():
    with pytest.raises(ValueError, match="extension"):
        tfab.compile_fabric(tfab.FabricSpec(
            levels=(tfab.LevelSpec(2), tfab.LevelSpec(5, extension=True)),
            capacity=8))
    with pytest.raises(ValueError, match="exchange_mode"):
        tfab.compile_fabric(tfab.FabricSpec(levels=(tfab.LevelSpec(2),),
                                            capacity=8, exchange_mode="x"))
    with pytest.raises(ValueError, match="event budget"):
        tfab.compile_fabric(tfab.FabricSpec(
            levels=(tfab.LevelSpec(2, link=TLink()),), capacity=8))


def _tables(rng, n):
    fwd_en = (rng.random((n, 1 << 16)) < 0.9).astype(np.int64) << 15
    fwd = (rng.integers(0, 1 << 15, (n, 1 << 16)) | fwd_en).astype(np.int32)
    rev_en = (rng.random((n, 1 << 15)) < 0.9).astype(np.int64) << 16
    rev = (rng.integers(0, 1 << 16, (n, 1 << 15)) | rev_en).astype(np.int32)
    return fwd, rev


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("mode", ["gather", "routed"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_fabric_route_step_bit_exact(name, mode, timed):
    ref, got = _scenario(name)
    r_plan = jfab.with_exchange_mode(ref.plan, mode)
    g_plan = tfab.with_exchange_mode(got.plan, mode)
    n, cap_in = ref.plan.n_nodes, ref.cap_in
    rng = np.random.default_rng(
        [SCENARIOS.index(name), mode == "routed", timed])
    fwd, rev = _tables(rng, n)
    labels = rng.integers(0, 1 << 16, (n, cap_in)).astype(np.int32)
    times = rng.integers(0, 500, (n, cap_in)).astype(np.int32)
    valid = rng.random((n, cap_in)) < 0.5
    enables = np.ones((n, n), bool)
    out_r, drops_r = jfab.fabric_route_step(
        JRouter(*map(jnp.asarray, (fwd, rev, enables))),
        JFrame(*map(jnp.asarray, (labels, times, valid))), r_plan,
        timing=j_timed_wire() if timed else None)
    out_g, drops_g = tfab.fabric_route_step(
        TRouter(*map(torch.from_numpy, (fwd, rev, enables))),
        TFrame(*map(torch.from_numpy, (labels, times, valid))), g_plan,
        timing=t_timed_wire() if timed else None)
    for f in ("labels", "times", "valid"):
        np.testing.assert_array_equal(getattr(out_g, f).numpy(),
                                      np.asarray(getattr(out_r, f)),
                                      err_msg=f)
    for f in drops_r._fields:
        np.testing.assert_array_equal(getattr(drops_g, f).numpy(),
                                      np.asarray(getattr(drops_r, f)),
                                      err_msg=f)
    assert out_g.labels.dtype == out_g.times.dtype == torch.int32
    assert int(drops_g.congestion.sum()) > 0, "no congestion exercised"
    if timed:
        assert bool(out_g.valid.any()) and int(out_g.times.max()) > 0


def test_dynamic_health_not_ported():
    """Dynamic health overlays are ported (``tests/test_torch_faults.py``
    holds them against the reference); what is left of the old refusal is
    the validation of a malformed overlay, which raises before any work."""
    _, got = _scenario("FULL_BACKPLANE")
    frames = TFrame(*(torch.zeros((12, 4), dtype=d)
                      for d in (torch.int32, torch.int32, torch.bool)))
    router = TRouter(torch.zeros((12, 1 << 16), dtype=torch.int32),
                     torch.zeros((12, 1 << 15), dtype=torch.int32),
                     torch.ones((12, 12), dtype=torch.bool))
    for health, match in (
            (tfab.FabricHealth((None, None), (None, None)), "2 levels"),
            (tfab.FabricHealth((torch.ones(11, dtype=torch.bool),), (None,)),
             "covers 11 edges")):
        with pytest.raises(ValueError, match=match):
            tfab.fabric_route_step(router, frames, got.plan, health=health)
