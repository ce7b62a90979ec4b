"""``run_stream``'s remaining event-path options in the port against the JAX
package: ``overlap``, the ``topology="hierarchical"`` flag (with its uplink
packs) and the argument checks that guard them.

Every input is made with numpy from a seed and fed to both packages, and
the reference runs live, as in ``test_torch_stream.py``.

Tolerances follow that file's rule through ``parity``: dyadic weights and
drives, every integer output (drops, uplink drops, latencies and their
validity) equal up to the first spike flip, a flip allowed only where the
reference's margin ``|v - v_th|`` is below ``parity.FLIP_MARGIN`` (1e-5),
the final float state within ``parity.STATE_ATOL`` (1e-5) and the delay
line equal where the rasters agree.  The port against itself (overlap
against the plain loop, the flag against the same plan passed as
``fabric=``) is equal bit for bit in every output and in the state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import fabric as jfab
from repro.core import routing as jrt
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import fabric as tfab
from repro_torch.core import routing as trt
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from repro_torch.snn import stream as tstream
from test_torch_stream import BATCH, SMALL_CHIP, flatten
from torch_threads import share_cores

share_cores()

FIELDS = ("spikes", "dropped", "uplink_dropped", "latency_ns",
          "latency_valid", "unroutable", "rerouted")


def dyadic(params_j):
    """w_scale 2^-8: the synapse product is exact in float32."""
    return params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))


def drives_for(cfg, n_steps, seed, p=0.6):
    rng = np.random.default_rng(seed)
    shape = (n_steps, cfg.n_chips, BATCH, cfg.chip.n_rows)
    return ((rng.random(shape) < p)
            * rng.integers(8, 64, shape) / 16).astype(np.float32)


def hold(ref, got, margin_at, what):
    """``parity.compare_streams`` with the report printed."""
    report = parity.compare_streams(ref, got, margin_at)
    print(f"{what}: {report}")
    return report


def margins(params_j, params_t, state_j, drives, cfg_j, cfg_t, **kw):
    """``margin_at(t)``: the reference's margin entering step ``t`` of the
    plain (``overlap=False``) run, which every option here equals."""
    def margin_at(t):
        before = jstream.run_stream(params_j, state_j,
                                    jnp.asarray(drives[:t]), cfg_j,
                                    **kw).state if t else state_j
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t)
    return margin_at


def assert_same_run(a, b, what):
    """Two runs of the port, equal bit for bit in every output and the
    final state."""
    for field in FIELDS:
        parity.assert_equal(f"{what} {field}", getattr(a, field),
                            getattr(b, field))
    for x, y in zip(jax.tree_util.tree_leaves(tuple(a.state)),
                    jax.tree_util.tree_leaves(tuple(b.state)), strict=True):
        parity.assert_equal(f"{what} state", x, y)


# ---------------------------------------------------------------------------
# overlap=True
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt_us,n_steps", [(0.5, 7), (0.25, 9)])
@pytest.mark.parametrize("name,mode,timed", [
    ("FULL_BACKPLANE", "gather", False),
    ("EXT_4CASE_96CHIP", "gather", True),
    ("EXT_4CASE_96CHIP", "routed", True),
])
def test_overlap_matches_reference(name, mode, timed, dt_us, n_steps):
    """Delay 2 and 4, with T not a multiple of the delay, so the final roll
    back to shift order runs."""
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    cfg_j = dataclasses.replace(cfg_j, dt_us=dt_us)
    cfg_t = dataclasses.replace(cfg_t, dt_us=dt_us)
    delay = cfg_t.delay_steps
    assert delay == cfg_j.delay_steps == {0.5: 2, 0.25: 4}[dt_us]
    assert n_steps % delay
    params_j = dyadic(params_j)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    plan_j = jfab.with_exchange_mode(plan_j, mode)
    plan_t = tfab.with_exchange_mode(plan_t, mode)
    drives = drives_for(cfg_j, n_steps, [len(name), timed, delay])
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")

    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, timed=timed, overlap=True)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, fabric=plan_t, timed=timed, overlap=True,
                             device="cpu")
    hold(ref, got, margins(params_j, params_t, state_j, drives, cfg_j, cfg_t,
                           fabric=plan_j, timed=timed),
         f"{name}/{mode}/timed={timed}/delay {delay}")
    assert float(got.spikes[:, 1:].sum()) > 0      # traffic reached chip 1+
    plain = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                               cfg_t, fabric=plan_t, timed=timed,
                               device="cpu")
    assert_same_run(plain, got, "overlap against the plain loop")


def test_overlap_zero_steps_keeps_the_reference_quirk():
    """At T = 0 the reference's epilogue exchanges a zero window: the
    statistics come back one row long while ``spikes`` has none, and the
    zero window's drives overwrite slot ``delay - 1`` of the delay line
    (768 of the 1024 given survive here).  The port matches it bit for
    bit."""
    cfg_j = jnet.NetworkConfig(n_chips=4, chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=0.25)
    cfg_t = tnet.NetworkConfig(n_chips=4, chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=0.25)
    assert cfg_t.delay_steps == 4
    params_j = jnet.init_feedforward(jax.random.PRNGKey(0), cfg_j)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    state_j = jnet.init_state(cfg_j, BATCH)
    state_j = state_j._replace(inflight=jnp.ones_like(state_j.inflight))
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    drives = np.zeros((0, 4, BATCH, 32), np.float32)
    for timed in (False, True):
        ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives),
                                 cfg_j, overlap=True, timed=timed)
        got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                                 cfg_t, overlap=True, timed=timed,
                                 device="cpu")
        assert tuple(got.spikes.shape) == (0, 4, BATCH, 64)
        assert tuple(got.dropped.shape) == (1, 4, BATCH)
        assert float(got.state.inflight.sum()) == 768.0
        assert float(got.state.inflight[3].sum()) == 0.0
        for field in FIELDS:
            parity.assert_equal(f"timed={timed} {field}", getattr(ref, field),
                                getattr(got, field))
        for (path, r), g in zip(flatten(ref.state).items(),
                                jax.tree_util.tree_leaves(tuple(got.state)),
                                strict=True):
            parity.assert_equal(f"timed={timed} {path}", r, g)
    # The caller's delay line is untouched.
    assert float(state_t.inflight.sum()) == 1024.0


# ---------------------------------------------------------------------------
# topology="hierarchical"
# ---------------------------------------------------------------------------

N_PODS, PER_POD = 3, 4


def gated(rng):
    return (rng.random((PER_POD, PER_POD)) < 0.6,
            rng.random((N_PODS, N_PODS)) < 0.7)


# (enables, link_capacity, pod_capacity, timed); "default" is the catalogue's
# all-to-all (no self-loop at level 1, every backplane pair), "all_true"
# literally all-True matrices (self-loops included).
HIER_CASES = {
    "default_dense": ("default", None, None, False),
    "all_true_packed_timed": ("all_true", 3, 8, True),
    "gated_dense_timed": ("gated", None, None, True),
    "gated_packed": ("gated", 2, 5, False),
}


def hier_enables(kind, rng):
    if kind == "default":
        return ~np.eye(PER_POD, dtype=bool), np.ones((N_PODS, N_PODS), bool)
    if kind == "all_true":
        return (np.ones((PER_POD, PER_POD), bool),
                np.ones((N_PODS, N_PODS), bool))
    return gated(rng)


@pytest.mark.parametrize("case", HIER_CASES)
def test_hierarchical_flag_matches_reference(case):
    kind, link_cap, pod_cap, timed = HIER_CASES[case]
    n = N_PODS * PER_POD
    cfg_j = jnet.NetworkConfig(n_chips=n, chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=40)
    cfg_t = tnet.NetworkConfig(n_chips=n, chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=40)
    params_j = dyadic(jnet.init_feedforward(jax.random.PRNGKey(7), cfg_j))
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    rng = np.random.default_rng(list(HIER_CASES).index(case))
    intra, inter = hier_enables(kind, rng)
    kw = dict(topology="hierarchical", n_pods=N_PODS, link_capacity=link_cap,
              pod_capacity=pod_cap, timed=timed)
    drives = drives_for(cfg_j, 6, rng, p=0.8)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")

    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             intra_enables=jnp.asarray(intra),
                             inter_enables=jnp.asarray(inter), **kw)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, intra_enables=torch.from_numpy(intra),
                             inter_enables=inter, device="cpu", **kw)
    hold(ref, got, margins(params_j, params_t, state_j, drives, cfg_j, cfg_t,
                           intra_enables=jnp.asarray(intra),
                           inter_enables=jnp.asarray(inter), **kw), case)
    assert float(got.spikes[:, 1:].sum()) > 0
    if link_cap is not None:
        assert int(got.uplink_dropped.sum()) > 0, "no uplink pack overflowed"
    # The flag is the plan it compiles, passed as fabric=.
    plan = tfab.compile_fabric(tfab.hierarchical_spec(
        N_PODS, PER_POD, 40, intra_enables=intra, inter_enables=inter,
        link_capacity=link_cap, pod_capacity=pod_cap))
    assert_same_run(tstream.run_stream(params_t, state_t,
                                       torch.from_numpy(drives), cfg_t,
                                       fabric=plan, timed=timed,
                                       device="cpu"),
                    got, f"{case}: flag against fabric=")


def test_hierarchical_flag_is_projected_120chip():
    """With the catalogue's enables and level capacities (8, 40) the flag
    compiles PROJECTED_120CHIP's plan: the flag run equals the reference's
    flag run and the port's ``fabric=`` run of the catalogue plan."""
    name = "PROJECTED_120CHIP"
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    caps = tuple(lvl.link_capacity for lvl in plan_t.levels)
    assert caps == jsc.level_caps((12, 10), 32, jsc.OCC_HEADLINE) == (8, 40)
    params_j = dyadic(params_j)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    kw = dict(topology="hierarchical", n_pods=10, link_capacity=8,
              pod_capacity=40, timed=True)
    intra, inter = trt.full_route_enables(12, device="cpu"), np.ones(
        (10, 10), bool)
    drives = drives_for(cfg_j, 5, 11)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             intra_enables=jrt.full_route_enables(12),
                             inter_enables=jnp.asarray(inter), **kw)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, intra_enables=intra, inter_enables=inter,
                             device="cpu", **kw)
    hold(ref, got, margins(params_j, params_t, state_j, drives, cfg_j, cfg_t,
                           fabric=plan_j, timed=True), name)
    assert int(got.latency_valid.sum()) > 0
    assert_same_run(tstream.run_stream(params_t, state_t,
                                       torch.from_numpy(drives), cfg_t,
                                       fabric=plan_t, timed=True,
                                       device="cpu"),
                    got, "flag against the catalogue plan")


def test_overlap_composes_with_the_hierarchical_flag():
    """Overlap, the flag and use_fused=False together equal the plain
    fused loop of the same flag."""
    n = N_PODS * PER_POD
    cfg = tnet.NetworkConfig(n_chips=n, chip=tchip.ChipConfig(**SMALL_CHIP),
                             capacity=40, dt_us=0.5)
    params = tnet.init_feedforward(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    intra, inter = gated(rng)
    kw = dict(topology="hierarchical", n_pods=N_PODS, intra_enables=intra,
              inter_enables=inter, link_capacity=3, pod_capacity=8,
              timed=True, device="cpu")
    drives = torch.from_numpy(drives_for(cfg, 5, rng, p=0.8))
    state = tnet.init_state(cfg, BATCH, device="cpu")
    plain = tstream.run_stream(params, state, drives, cfg, **kw)
    assert int(plain.uplink_dropped.sum()) > 0
    assert_same_run(plain, tstream.run_stream(params, state, drives, cfg,
                                              overlap=True, use_fused=False,
                                              **kw),
                    "overlap + unfused against the plain loop")


# ---------------------------------------------------------------------------
# Argument checks, in the reference's order
# ---------------------------------------------------------------------------

# Each case: the keyword arguments (``"plan"`` stands for a 4-chip star
# plan, ``"en"`` for enables of the right shape), the delay line's depth,
# and the reference's message start.  Cases with two faults check which
# one the reference reports first.
ERROR_CASES = {
    "hier_without_enables": (dict(topology="hierarchical", n_pods=2), 1,
                             "hierarchical topology requires"),
    "hier_without_inter": (dict(topology="hierarchical", n_pods=2,
                                intra_enables="en"), 1,
                           "hierarchical topology requires"),
    "link_capacity_on_star": (dict(link_capacity=4), 1, "link_capacity/"),
    "pod_capacity_on_star": (dict(pod_capacity=4), 1, "link_capacity/"),
    "fabric_with_hier": (dict(fabric="plan", topology="hierarchical",
                              n_pods=2, intra_enables="en",
                              inter_enables="en"), 1,
                         "fabric replaces the topology flag"),
    "overlap_dense": (dict(overlap=True, mode="dense"), 2,
                      "overlap double-buffers"),
    "overlap_delay_one": (dict(overlap=True), 1, "overlap needs delay_steps"),
    "overlap_faults": (dict(overlap=True, faults=[]), 2,
                       "overlap defers each exchange"),
    "dense_hier_first": (dict(mode="dense", topology="hierarchical"), 1,
                         "hierarchical topology is event-mode only"),
    "timed_dense": (dict(mode="dense", timed=True), 1,
                    "timed streams require"),
    "hier_before_fabric": (dict(fabric="plan", topology="hierarchical",
                                n_pods=2), 1,
                           "hierarchical topology requires"),
    "link_before_overlap": (dict(link_capacity=4, overlap=True), 1,
                            "link_capacity/"),
    "delay_before_faults": (dict(overlap=True, faults=[]), 1,
                            "overlap needs delay_steps"),
    "faults_dense_before_overlap": (dict(faults=[], mode="dense",
                                         overlap=True), 2,
                                    "fault injection requires"),
}


@pytest.mark.parametrize("case", ERROR_CASES)
def test_argument_errors_match_reference(case):
    kwargs, delay, start = ERROR_CASES[case]
    n = 4
    dt = {1: 1.0, 2: 0.5}[delay]
    cfg_j = jnet.NetworkConfig(n_chips=n, chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=dt)
    cfg_t = tnet.NetworkConfig(n_chips=n, chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=dt)
    params_j = jnet.init_feedforward(jax.random.PRNGKey(0), cfg_j)
    params_t = tnet.init_feedforward(cfg_t, seed=0, device="cpu")
    swap = {"plan": (jfab.compile_fabric(jfab.star_spec(n, 48)),
                     tfab.compile_fabric(tfab.star_spec(n, 48))),
            "en": (jnp.ones((2, 2), bool), np.ones((2, 2), bool))}

    def side(k):
        return {key: swap[v][k] if isinstance(v, str) and v in swap else v
                for key, v in kwargs.items()}

    drives = np.zeros((2, n, BATCH, 32), np.float32)
    with pytest.raises(ValueError) as ref:
        # Both need route_mats to reach their dense-mode checks.
        jstream.run_stream(params_j, jnet.init_state(cfg_j, BATCH),
                           jnp.asarray(drives), cfg_j,
                           route_mats=jnp.zeros((n, n, 64, 32)), **side(0))
    with pytest.raises(ValueError) as got:
        tstream.run_stream(params_t, tnet.init_state(cfg_t, BATCH,
                                                     device="cpu"),
                           torch.from_numpy(drives), cfg_t, device="cpu",
                           route_mats=torch.zeros((n, n, 64, 32)), **side(1))
    assert str(ref.value).startswith(start), str(ref.value)
    assert str(got.value) == str(ref.value)
