"""The exchange engine's knobs in the port against the JAX package:
``fabric_route_step(engine=, use_fused=)``, ``pick_exchange_mode``, the
``aggregator`` wrappers' ``use_fused`` and the per-step event wrappers
``network.step_event`` / ``run_event`` / ``run_event_steps``.

Every input is made with numpy from a seed and fed to both packages.

Tolerances.  The exchange round is exact: labels, valid, times and all four
``ExchangeDrops`` fields equal bit for bit.  Which kernel wrapper runs is
pinned by spies on the two wrappers.  The network steps follow
``test_torch_stream.py``'s rule through ``parity``: dyadic weights and
drives, drops equal up to the first spike flip, a flip allowed only where
the reference's margin ``|v - v_th|`` is below ``parity.FLIP_MARGIN``
(1e-5), the final float state within ``parity.STATE_ATOL`` (1e-5) and the
delay line equal where the rasters agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import aggregator as jagg
from repro.core import fabric as jfab
from repro.core.aggregator import RouterState as JRouter
from repro.core.events import EventFrame as JFrame
from repro.core.latency import timed_wire as j_timed_wire
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import aggregator as tagg
from repro_torch.core import fabric as tfab
from repro_torch.core.aggregator import RouterState as TRouter
from repro_torch.core.events import EventFrame as TFrame
from repro_torch.core.latency import timed_wire as t_timed_wire
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from test_torch_fabric import _tables as tables
from test_torch_faults import Spy
from test_torch_stream import BATCH, SMALL_CHIP, STEPS, flatten
from torch_threads import share_cores

share_cores()

CATALOGUE = [c[0] for c in tsc.CASES]
FRAME_FIELDS = ("labels", "times", "valid")


def scenario(name):
    ref = next(s for s in jsc.benchmark_plans() if s.name == name)
    got = next(s for s in tsc.benchmark_plans() if s.name == name)
    return ref.plan, got.plan, ref.cap_in


def round_inputs(n, cap_in, seed, lead=(2,)):
    """Router tables (random LUTs, all enables) and egress frames with
    leading dims ``lead``."""
    rng = np.random.default_rng(seed)
    fwd, rev = tables(rng, n)
    shape = (*lead, n, cap_in)
    return ((fwd, rev, np.ones((n, n), bool)),
            (rng.integers(0, 1 << 16, shape).astype(np.int32),
             rng.integers(0, 500, shape).astype(np.int32),
             rng.random(shape) < 0.5))


def spy_on(monkeypatch):
    spies = {k: Spy(getattr(tfab, k))
             for k in ("fused_exchange", "fused_merge_pack")}
    for k, spy in spies.items():
        monkeypatch.setattr(tfab, k, spy)
    return spies


def assert_round_equal(ref, got, what=""):
    (out_r, drops_r), (out_g, drops_g) = ref, got
    for f in FRAME_FIELDS:
        parity.assert_equal(f"{what} {f}", getattr(out_r, f),
                            getattr(out_g, f))
    for f in drops_r._fields:
        parity.assert_equal(f"{what} {f}", getattr(drops_r, f),
                            getattr(drops_g, f))


# ---------------------------------------------------------------------------
# fabric_route_step(engine=, use_fused=)
# ---------------------------------------------------------------------------

# (engine, use_fused) -> kernel wrapper calls of one round, given whether
# the plan takes the exchange fast path under engine="auto".
KNOBS = [("auto", True), ("merge", True), ("auto", False), ("merge", False)]


def expected_calls(engine, use_fused, fast_path):
    if not use_fused:
        return {"fused_exchange": 0, "fused_merge_pack": 0}
    if engine == "auto" and fast_path:
        return {"fused_exchange": 1, "fused_merge_pack": 0}
    return {"fused_exchange": 0, "fused_merge_pack": 1}


@pytest.mark.parametrize("engine,use_fused", KNOBS)
@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("mode", ["gather", "routed"])
@pytest.mark.parametrize("name", CATALOGUE)
def test_engine_and_use_fused_match_reference(monkeypatch, name, mode, timed,
                                              engine, use_fused):
    """The port's batched round (two rows) against the reference's round on
    each row, with the same knobs; spies count the kernel wrappers."""
    r_plan, g_plan, cap_in = scenario(name)
    r_plan = jfab.with_exchange_mode(r_plan, mode)
    g_plan = tfab.with_exchange_mode(g_plan, mode)
    router, frames = round_inputs(
        g_plan.n_nodes, cap_in,
        [CATALOGUE.index(name), mode == "routed", timed])
    spies = spy_on(monkeypatch)
    got = tfab.fabric_route_step(
        TRouter(*map(torch.from_numpy, router)),
        TFrame(*map(torch.from_numpy, frames)), g_plan, use_fused=use_fused,
        timing=t_timed_wire() if timed else None, engine=engine)
    fast = (g_plan.n_levels == 1 and not timed and mode == "gather")
    assert {k: s.calls for k, s in spies.items()} == expected_calls(
        engine, use_fused, fast)
    for b in range(2):
        ref = jfab.fabric_route_step(
            JRouter(*map(jnp.asarray, router)),
            JFrame(*(jnp.asarray(x[b]) for x in frames)), r_plan,
            use_fused=use_fused, timing=j_timed_wire() if timed else None,
            engine=engine)
        assert_round_equal(ref, (TFrame(*(x[b] for x in got[0])),
                                 tfab.ExchangeDrops(*(x[b] for x in got[1]))),
                           f"row {b}")
    assert int(got[1].congestion.sum()) > 0, "no congestion exercised"


def test_use_fused_default_ignores_the_environment(monkeypatch):
    """``use_fused=None`` means the kernels whatever REPRO_FUSED_EXCHANGE
    says: no environment variable turns them off."""
    _, plan, cap_in = scenario("EXT_4CASE_96CHIP")
    router, frames = round_inputs(plan.n_nodes, cap_in, 0)
    args = (TRouter(*map(torch.from_numpy, router)),
            TFrame(*map(torch.from_numpy, frames)), plan)
    spies = spy_on(monkeypatch)
    monkeypatch.setenv("REPRO_FUSED_EXCHANGE", "0")
    default = tfab.fabric_route_step(*args)
    assert spies["fused_merge_pack"].calls == 1
    fused = tfab.fabric_route_step(*args, use_fused=True)
    for x, y in zip((*default[0], *default[1]), (*fused[0], *fused[1]),
                    strict=True):
        assert torch.equal(x, y)


def test_unknown_engine_raises_first():
    """The reference's message, before any other check (the frames here do
    not even match the plan)."""
    _, plan, _ = scenario("FULL_BACKPLANE")
    bad = TFrame(*(torch.zeros((3, 4), dtype=d)
                   for d in (torch.int32, torch.int32, torch.bool)))
    with pytest.raises(ValueError) as ref:
        jfab.fabric_route_step(None, JFrame(*(jnp.asarray(x.numpy())
                                              for x in bad)),
                               scenario("FULL_BACKPLANE")[0],
                               engine="fused")
    with pytest.raises(ValueError) as got:
        tfab.fabric_route_step(None, bad, plan, engine="fused")
    assert str(got.value) == str(ref.value) == "unknown engine: 'fused'"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels); "
                    "run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine,use_fused", KNOBS)
@pytest.mark.parametrize("name,mode,timed", [
    ("FULL_BACKPLANE", "gather", False),
    ("EXT_4CASE_96CHIP", "routed", True),
])
def test_engine_and_use_fused_card_matches_cpu(cuda_device, name, mode,
                                               timed, engine, use_fused):
    _, plan, cap_in = scenario(name)
    plan = tfab.with_exchange_mode(plan, mode)
    router, frames = round_inputs(plan.n_nodes, cap_in, [len(name), timed])
    outs = [tfab.fabric_route_step(
        TRouter(*(torch.from_numpy(x).to(dev) for x in router)),
        TFrame(*(torch.from_numpy(x).to(dev) for x in frames)), plan,
        use_fused=use_fused, timing=t_timed_wire() if timed else None,
        engine=engine) for dev in ("cpu", cuda_device)]
    torch.cuda.synchronize()
    assert_round_equal(*outs, "card vs CPU")


# ---------------------------------------------------------------------------
# aggregator.route_step* (use_fused=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("timed", [False, True])
def test_route_step_use_fused_matches_reference(monkeypatch, timed,
                                                use_fused):
    n, cap_in, cap = 6, 10, 16
    router, frames = round_inputs(n, cap_in, [timed, use_fused], lead=())
    router = (*router[:2], np.random.default_rng(1).random((n, n)) < 0.6)
    spies = spy_on(monkeypatch)
    kw = dict(use_fused=use_fused)
    got = tagg.route_step(TRouter(*map(torch.from_numpy, router)),
                          TFrame(*map(torch.from_numpy, frames)), cap,
                          timing=t_timed_wire() if timed else None, **kw)
    ref = jagg.route_step(JRouter(*map(jnp.asarray, router)),
                          JFrame(*map(jnp.asarray, frames)), cap,
                          timing=j_timed_wire() if timed else None, **kw)
    for f in FRAME_FIELDS:
        parity.assert_equal(f, getattr(ref[0], f), getattr(got[0], f))
    parity.assert_equal("dropped", ref[1], got[1])
    assert sum(s.calls for s in spies.values()) == int(use_fused)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("timed", [False, True])
def test_route_step_hierarchical_use_fused_matches_reference(timed,
                                                             use_fused):
    n_pods, per_pod, cap_in = 3, 4, 9
    n = n_pods * per_pod
    router, frames = round_inputs(n, cap_in, [timed, use_fused, 2], lead=())
    rng = np.random.default_rng(5)
    kw = dict(n_pods=n_pods, intra_enables=rng.random((per_pod, per_pod))
              < 0.7, inter_enables=rng.random((n_pods, n_pods)) < 0.7,
              link_capacity=4, pod_capacity=9, use_fused=use_fused)
    got = tagg.route_step_hierarchical(
        TRouter(*map(torch.from_numpy, router)),
        TFrame(*map(torch.from_numpy, frames)), 20,
        timing=t_timed_wire() if timed else None, **kw)
    ref = jagg.route_step_hierarchical(
        JRouter(*map(jnp.asarray, router)),
        JFrame(*map(jnp.asarray, frames)), 20,
        timing=j_timed_wire() if timed else None,
        **{**kw, "intra_enables": jnp.asarray(kw["intra_enables"]),
           "inter_enables": jnp.asarray(kw["inter_enables"])})
    assert_round_equal(ref, got)
    assert int(got[1].uplink.sum()) > 0


# ---------------------------------------------------------------------------
# pick_exchange_mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,timed", [("EXT_4CASE_96CHIP", True),
                                        ("FULL_BACKPLANE", False)])
def test_pick_exchange_mode(monkeypatch, name, timed):
    """Both modes timed (finite, positive), the winner's plan returned, the
    merge engine on every pass (even the plain star's), and the winning
    plan's rounds equal to the reference's with the same mode."""
    r_plan, g_plan, cap_in = scenario(name)
    n_rounds, trials = 3, 2
    router, frames = round_inputs(g_plan.n_nodes, cap_in, [len(name)],
                                  lead=(n_rounds,))
    t_router = TRouter(*map(torch.from_numpy, router))
    timing = t_timed_wire() if timed else None
    spies = spy_on(monkeypatch)
    plan, seconds = tfab.pick_exchange_mode(
        t_router, TFrame(*map(torch.from_numpy, frames)), g_plan,
        timing=timing, trials=trials)
    assert set(seconds) == set(tfab.EXCHANGE_MODES)
    assert all(np.isfinite(s) and s > 0 for s in seconds.values()), seconds
    winner = min(seconds, key=seconds.get)
    assert plan == tfab.with_exchange_mode(g_plan, winner)
    assert plan.exchange_mode == winner
    assert spies["fused_exchange"].calls == 0
    assert spies["fused_merge_pack"].calls == 2 * (1 + trials) * n_rounds
    r_plan = jfab.with_exchange_mode(r_plan, winner)
    for t in range(n_rounds):
        ref = jfab.fabric_route_step(
            JRouter(*map(jnp.asarray, router)),
            JFrame(*(jnp.asarray(x[t]) for x in frames)), r_plan,
            timing=j_timed_wire() if timed else None)
        got = tfab.fabric_route_step(
            t_router, TFrame(*(torch.from_numpy(x[t]) for x in frames)),
            plan, timing=timing)
        assert_round_equal(ref, got, f"round {t}")


# ---------------------------------------------------------------------------
# step_event, run_event, run_event_steps
# ---------------------------------------------------------------------------


def event_network(dt_us):
    cfg_j = jnet.NetworkConfig(n_chips=4, chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=dt_us)
    cfg_t = tnet.NetworkConfig(n_chips=4, chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=dt_us)
    params_j = jnet.init_feedforward(jax.random.PRNGKey(5), cfg_j)
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    rng = np.random.default_rng(int(dt_us * 4))
    shape = (STEPS + 1, 4, BATCH, 32)
    drives = ((rng.random(shape) < 0.7)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t, state_j, state_t, drives


class Run:
    """``run_event``'s triple as the fields ``parity.compare_streams``
    reads (no uplink, latency or fault fields on the star run)."""

    def __init__(self, state, spikes, dropped):
        self.state, self.spikes, self.dropped = state, spikes, dropped
        zeros = np.zeros(tuple(dropped.shape), np.int32)
        self.uplink_dropped = self.unroutable = self.rerouted = zeros
        self.latency_ns = self.latency_valid = zeros[..., None]


@pytest.mark.parametrize("dt_us", [1.0, 0.25])
@pytest.mark.parametrize("entry", ["run_event", "run_event_steps"])
def test_run_event_matches_reference(entry, dt_us):
    """Delay 1 and 4 (the latter with T not a multiple of it)."""
    cfg_j, cfg_t, params_j, params_t, state_j, state_t, drives = \
        event_network(dt_us)
    ref = Run(*getattr(jnet, entry)(params_j, state_j, jnp.asarray(drives),
                                    cfg_j))
    got = Run(*getattr(tnet, entry)(params_t, state_t,
                                    torch.from_numpy(drives), cfg_t,
                                    device="cpu"))
    assert got.dropped.dtype == torch.int32

    def margin_at(t):
        before = jnet.run_event(params_j, state_j, jnp.asarray(drives[:t]),
                                cfg_j)[0] if t else state_j
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t)

    report = parity.compare_streams(ref, got, margin_at)
    print(f"{entry}/dt {dt_us}: {report}")
    assert float(got.spikes[:, 1:].sum()) > 0


def test_step_event_matches_reference(monkeypatch):
    """One step from a non-resting state with a loaded delay line."""
    cfg_j, cfg_t, params_j, params_t, state_j, _, drives = event_network(0.25)
    state_j = jnet.run_event(params_j, state_j, jnp.asarray(drives[:3]),
                             cfg_j)[0]
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    new_j, spk_j, drop_j = jnet.step_event(params_j, state_j,
                                           jnp.asarray(drives[3]), cfg_j)
    new_t, spk_t, drop_t = tnet.step_event(params_t, state_t,
                                           torch.from_numpy(drives[3]),
                                           cfg_t, device="cpu")
    margin = parity.spike_margin(params_t, state_t,
                                 torch.from_numpy(drives[3]), cfg_t)
    clear = margin.numpy() >= parity.FLIP_MARGIN
    np.testing.assert_array_equal(spk_t.numpy()[clear],
                                  np.asarray(spk_j)[clear])
    assert float(spk_t.sum()) > 0
    assert tuple(drop_t.shape) == (4, BATCH)
    if np.array_equal(spk_t.numpy(), np.asarray(spk_j)):
        parity.assert_equal("dropped", drop_j, drop_t)
        parity.assert_equal("inflight", new_j.inflight, new_t.inflight)
        np.testing.assert_allclose(new_t.chips.neurons.v.numpy(),
                                   np.asarray(new_j.chips.neurons.v),
                                   rtol=0, atol=parity.STATE_ATOL)
    # The exchange half, held bit for bit on the reference's raster whether
    # or not a near-threshold flip changed the port's.
    chip_step = tnet.chiplib.chip_step
    spk_ref = torch.from_numpy(np.array(spk_j))
    monkeypatch.setattr(tnet.chiplib, "chip_step",
                        lambda *a, **k: (chip_step(*a, **k)[0], spk_ref))
    fed, _, drop_fed = tnet.step_event(params_t, state_t,
                                       torch.from_numpy(drives[3]), cfg_t,
                                       device="cpu")
    parity.assert_equal("dropped", drop_j, drop_fed)
    parity.assert_equal("inflight", new_j.inflight, fed.inflight)


def test_run_event_steps_equals_run_event_and_stream():
    """The per-step loop, the streamed run and ``run_stream`` on the star
    are one computation in the port: equal bit for bit."""
    _, cfg_t, _, params_t, _, state_t, drives = event_network(0.5)
    drives = torch.from_numpy(drives)
    a = tnet.run_event_steps(params_t, state_t, drives, cfg_t, device="cpu")
    b = tnet.run_event(params_t, state_t, drives, cfg_t, device="cpu")
    for x, y in zip(jax.tree_util.tree_leaves((tuple(a[0]), *a[1:])),
                    jax.tree_util.tree_leaves((tuple(b[0]), *b[1:])),
                    strict=True):
        parity.assert_equal("run_event_steps against run_event", x, y)


def test_event_wrappers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg_t, _, params_t, _, state_t, drives = event_network(1.0)
    drives = torch.from_numpy(drives)
    for call in (lambda: tnet.step_event(params_t, state_t, drives[0], cfg_t),
                 lambda: tnet.run_event(params_t, state_t, drives, cfg_t),
                 lambda: tnet.run_event_steps(params_t, state_t, drives,
                                              cfg_t)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
