"""The port's dense (differentiable) routing path against the JAX package.

``routing_matrices`` is held bit for bit.  Dense-mode runs
(``run_stream(mode="dense")``, ``run_dense``, ``step_dense``) follow
``test_torch_stream.py``'s rule with dyadic weights and drives (``w_scale``
2^-8, drives in multiples of 2^-4), so every synapse-product term and every
routed count is exact in float32: spikes, the delay line and the zero
statistics must be equal, with no spike flip; the final neuron state
within ``parity.STATE_ATOL`` (1e-5) and plastic traces and weights within
``parity.PLASTICITY_ATOL`` (1e-5) (``parity.compare_streams``).  In the
port, event mode equals dense mode where nothing is dropped, and the
stream equals the ``step_dense`` loop, bit for bit.  The clip ties of
``quantize_ste`` and the AdEx exponent get ``jax.grad``'s gradient
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn import neuron as jnrn
from repro.snn import plasticity as jplas
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.core import aggregator as tagg
from repro_torch.core import routing as trt
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from repro_torch.snn import neuron as tnrn
from repro_torch.snn import plasticity as tplas
from repro_torch.snn import stream as tstream
from test_torch_stream import BATCH, SMALL_CHIP, flatten
from torch_threads import share_cores

share_cores()

STEPS = 8
N_CHIPS = 3
DT_OF_DELAY = {1: 1.0, 3: 0.4}     # dt_us giving delay_steps 1 and 3


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Gradients at clip ties
# ---------------------------------------------------------------------------


def test_quantize_ste_gradient_at_clip_bounds_matches_jax():
    """Below, on, between and above the bounds 0 and 63: forward values
    equal, and the gradient is ``jax.grad``'s exactly (0.5 on a bound)."""
    w = np.array([-2.0, -0.0, 0.0, 0.4, 0.5, 31.5, 62.5, 63.0, 63.2, 70.0],
                 np.float32)
    scale = np.linspace(0.5, 2.0, w.size).astype(np.float32)
    ref_q = jchip.quantize_ste(jnp.asarray(w))
    ref_g = jax.grad(lambda x: jnp.sum(jchip.quantize_ste(x) * scale))(
        jnp.asarray(w))
    x = T(w).requires_grad_(True)
    got_q = tchip.quantize_ste(x)
    (got_g,) = torch.autograd.grad((got_q * T(scale)).sum(), x)
    np.testing.assert_array_equal(got_q.detach().numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(ref_g))
    assert got_g[7] == 0.5 * scale[7] and got_g[2] == 0.5 * scale[2]


def test_adex_exponent_gradient_at_clip_bounds_matches_jax():
    """AdEx with ``(v - v_exp) / delta_t`` landing exactly on ±20 (and
    below, between, above): ``membrane``'s value and its gradient with
    respect to ``v`` equal ``jax.grad`` of the reference's first half of
    ``neuron_step`` exactly."""
    params = dict(delta_t=0.5, v_exp=0.5, adapt_a=0.02, adapt_b=0.1)
    v = np.array([10.5, -9.5, 3.0, 12.0, -15.0, 0.7], np.float32)
    shape = v.shape
    i_syn = np.linspace(-1.0, 1.0, v.size).astype(np.float32)
    w_ad = np.full(shape, 0.125, np.float32)
    refrac = np.zeros(shape, np.int32)
    current = np.full(shape, 0.25, np.float32)
    p_j = jnrn.NeuronParams(**params)
    p_t = tnrn.NeuronParams(**params)

    def ref_v(vv):
        # The reference's membrane before the threshold, as neuron_step
        # computes it (no refractory neuron here).
        p = p_j
        i = p.alpha_syn * jnp.asarray(i_syn) + jnp.asarray(current)
        dv_leak = (1.0 - p.alpha_mem) * (p.v_leak - vv)
        exp_arg = jnp.clip((vv - p.v_exp) / p.delta_t, -20.0, 20.0)
        dv_exp = (1.0 - p.alpha_mem) * p.delta_t * jnp.exp(exp_arg)
        return vv + (dv_leak + dv_exp + (1.0 - p.alpha_mem)
                     * (i - jnp.asarray(w_ad)))

    ref_val = ref_v(jnp.asarray(v))
    ref_g = jax.grad(lambda vv: jnp.sum(ref_v(vv)))(jnp.asarray(v))
    x = T(v).requires_grad_(True)
    _, got_val = tnrn.membrane(
        tnrn.NeuronState(x, T(i_syn), T(w_ad), T(refrac)), T(current), p_t)
    (got_g,) = torch.autograd.grad(got_val.sum(), x)
    np.testing.assert_allclose(got_val.detach().numpy(), np.asarray(ref_val),
                               rtol=1e-6)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(ref_g))
    # The clip itself: half the gradient on each bound, as jnp.clip.
    y = T(np.array([-20.0, -3.0, 20.0, 25.0], np.float32)).requires_grad_(True)
    (g,) = torch.autograd.grad(tnrn.clip(y, -20.0, 20.0).sum(), y)
    ref = jax.grad(lambda a: jnp.clip(a, -20.0, 20.0).sum())(
        jnp.asarray(y.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))
    assert g.tolist() == [0.5, 1.0, 0.5, 0.0]


# ---------------------------------------------------------------------------
# routing_matrices
# ---------------------------------------------------------------------------


def network(n_chips=N_CHIPS, delay=1, capacity=600, router="feedforward",
            dyadic=True, seed=0):
    """Both packages' network: the reference's ``init_feedforward`` at
    SMALL_CHIP, its parameters carried across.  ``router="fan_in"`` routes
    every chip to every other (no self-loops), maps each source's neurons
    onto rows with collisions and unmapped labels, and clears some LUT
    enables."""
    dt = DT_OF_DELAY[delay]
    cfg_j = jnet.NetworkConfig(n_chips=n_chips,
                               chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=capacity, dt_us=dt)
    cfg_t = tnet.NetworkConfig(n_chips=n_chips,
                               chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=capacity, dt_us=dt)
    assert cfg_j.delay_steps == delay
    params_j = jnet.init_feedforward(jax.random.key(seed), cfg_j)
    arrays = flatten(params_j)
    if dyadic:
        arrays["chips.w_scale"] = np.full(n_chips, 2.0 ** -8, np.float32)
    if router == "fan_in":
        rng = np.random.default_rng(seed + 10)
        r = tagg.identity_router(n_chips, device="cpu")
        fwd = r.fwd_tables.numpy().copy()
        rev = r.rev_tables.numpy().copy()
        # Clear the enable bit of a few labels on each side.
        for table, bit in ((fwd, trt.FWD_ENABLE_MASK),
                           (rev, trt.REV_ENABLE_MASK)):
            off = rng.integers(0, n_chips << 9, (n_chips, 20))
            for c in range(n_chips):
                table[c, off[c]] &= ~bit
        table = np.full((n_chips, 1 << 16), -1, np.int32)
        for dst in range(n_chips):
            for src in range(n_chips):
                labels = (src << 9) + np.arange(64)
                rows = (labels * 7 + dst) % 32
                rows[rng.random(64) < 0.2] = -1
                table[dst, labels] = rows
        arrays.update({"router.fwd_tables": fwd, "router.rev_tables": rev,
                       "router.route_enables": r.route_enables.numpy(),
                       "row_of_label": table})
        params_j = jnet.NetworkParams(
            chips=jchip.ChipParams(*(jnp.asarray(arrays[f"chips.{k}"])
                                     for k in jchip.ChipParams._fields)),
            row_of_label=jnp.asarray(table),
            router=type(params_j.router)(jnp.asarray(fwd), jnp.asarray(rev),
                                         jnp.asarray(arrays[
                                             "router.route_enables"])))
    elif dyadic:
        params_j = params_j._replace(chips=params_j.chips._replace(
            w_scale=jnp.asarray(arrays["chips.w_scale"])))
    params_t = convert.network_params_from_numpy(arrays, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.mark.parametrize("router", ["feedforward", "fan_in"])
def test_routing_matrices_match_reference(router):
    cfg_j, params_j, cfg_t, params_t = network(router=router)
    ref = np.asarray(jnet.routing_matrices(params_j, cfg_j))
    got = tnet.routing_matrices(params_t, cfg_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0 and ref.max() == 1.0
    if router == "fan_in":
        # Every off-diagonal pair routes, with row collisions.
        assert (ref.sum(axis=(2, 3)) > 0).sum() == N_CHIPS * (N_CHIPS - 1)
        assert ref.sum(axis=2).max() > 1


# ---------------------------------------------------------------------------
# Dense runs against the reference
# ---------------------------------------------------------------------------


def dense_inputs(cfg, n_steps, seed, batch=BATCH):
    """Dyadic drives on every chip, and a slot mask idling each slot for
    three steps."""
    rng = np.random.default_rng(seed)
    shape = (n_steps, cfg.n_chips, batch, cfg.chip.n_rows)
    drives = ((rng.random(shape) < 0.4)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    mask = np.ones((n_steps, batch), bool)
    for b in range(batch):
        start = (b * 3 + 1) % max(n_steps - 2, 1)
        mask[start:start + 3, b] = False
    return drives, mask


def plasticity_args(params_j, plastic, batch=BATCH):
    """The plastic runs' arguments for both packages."""
    if plastic is None:
        return {}, {}
    ps_j = (jnet.init_slot_plasticity if plastic == "slot"
            else jnet.init_stream_plasticity)(params_j, batch)
    ps_t = (convert.slot_plasticity_from_numpy if plastic == "slot"
            else convert.stream_plasticity_from_numpy)(flatten(ps_j),
                                                       device="cpu")
    return (dict(plasticity=jplas.STDPConfig(), plasticity_state=ps_j),
            dict(plasticity=tplas.STDPConfig(), plasticity_state=ps_t))


def hold_dense(ref, got, what):
    """Equal spikes (no flip), delay line and statistics; the float state
    within the stated tolerances."""
    def no_flip(t):
        raise AssertionError(f"{what}: rasters differ at step {t}")

    report = parity.compare_streams(ref, got, no_flip)
    for field in ("spikes", "dropped", "uplink_dropped", "latency_ns",
                  "latency_valid", "unroutable", "rerouted"):
        a, b = parity.as_numpy(getattr(ref, field)), parity.as_numpy(
            getattr(got, field))
        parity.assert_equal(f"{what} {field}", a, b)
        assert b.dtype == a.dtype, (field, b.dtype, a.dtype)
    assert float(got.spikes.sum()) > 0, what
    return report


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("plastic", [None, "shared", "slot"])
@pytest.mark.parametrize("delay", [1, 3])
def test_run_stream_dense_matches_reference(delay, plastic, masked):
    cfg_j, params_j, cfg_t, params_t = network(delay=delay)
    mats_j = jnet.routing_matrices(params_j, cfg_j)
    mats_t = tnet.routing_matrices(params_t, cfg_t)
    drives, mask = dense_inputs(cfg_j, STEPS, [delay, masked,
                                               len(str(plastic))])
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j),
                                               device="cpu")
    kw_j, kw_t = plasticity_args(params_j, plastic)
    if masked:
        kw_j["slot_mask"], kw_t["slot_mask"] = jnp.asarray(mask), T(mask)
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             mode="dense", route_mats=mats_j, **kw_j)
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             mode="dense", route_mats=mats_t, device="cpu",
                             **kw_t)
    report = hold_dense(ref, got, f"delay {delay}/{plastic}/mask {masked}")
    assert report["flips"] == []
    assert (got.plasticity is None) == (plastic is None)
    if plastic is not None:
        assert report["plasticity_max_err"] <= parity.PLASTICITY_ATOL
        assert type(got.plasticity).__name__ == type(ref.plasticity).__name__
    if masked:
        assert float(got.spikes.transpose(1, 2)[~T(mask)].sum()) == 0


@pytest.mark.parametrize("delay", [1, 3])
def test_step_dense_and_run_dense_match_reference(delay):
    cfg_j, params_j, cfg_t, params_t = network(delay=delay)
    mats_j = jnet.routing_matrices(params_j, cfg_j)
    mats_t = tnet.routing_matrices(params_t, cfg_t)
    drives, _ = dense_inputs(cfg_j, STEPS, 40 + delay)
    state_j = jnet.init_state(cfg_j, BATCH)
    # A non-zero delay line on entry: both read slot 0 first.
    inflight = (np.arange(np.prod(state_j.inflight.shape)) % 3).reshape(
        state_j.inflight.shape).astype(np.float32)
    state_j = state_j._replace(inflight=jnp.asarray(inflight))
    state_t = convert.network_state_from_numpy(flatten(state_j),
                                               device="cpu")
    step_j = jax.jit(jnet.step_dense, static_argnames="cfg")
    s_j, s_t = state_j, state_t
    for t in range(STEPS):
        s_j, spk_j = step_j(params_j, s_j, jnp.asarray(drives[t]), mats_j,
                            cfg=cfg_j)
        s_t, spk_t = tnet.step_dense(params_t, s_t, T(drives[t]), mats_t,
                                     cfg_t, device="cpu")
        parity.assert_equal(f"step {t} spikes", spk_j, spk_t)
        parity.assert_equal(f"step {t} inflight", s_j.inflight, s_t.inflight)
    ref_state, ref_spk = jnet.run_dense(params_j, state_j,
                                        jnp.asarray(drives), mats_j, cfg_j)
    got_state, got_spk = tnet.run_dense(params_t, state_t, T(drives), mats_t,
                                        cfg_t, device="cpu")
    parity.assert_equal("run_dense spikes", ref_spk, got_spk)
    parity.assert_equal("run_dense inflight", ref_state.inflight,
                        got_state.inflight)
    for f in ("v", "i_syn", "w_adapt"):
        np.testing.assert_allclose(
            getattr(got_state.chips.neurons, f).numpy(),
            np.asarray(getattr(ref_state.chips.neurons, f)), rtol=0,
            atol=parity.STATE_ATOL, err_msg=f)
    assert float(got_spk.sum()) > 0


def test_run_stream_dense_zero_steps_matches_reference():
    cfg_j, params_j, cfg_t, params_t = network(delay=3)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j),
                                               device="cpu")
    drives = np.zeros((0, N_CHIPS, BATCH, 32), np.float32)
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             mode="dense",
                             route_mats=jnet.routing_matrices(params_j,
                                                              cfg_j))
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             mode="dense",
                             route_mats=tnet.routing_matrices(params_t,
                                                              cfg_t),
                             device="cpu")
    for field in ("spikes", "dropped", "uplink_dropped", "latency_ns",
                  "latency_valid", "unroutable", "rerouted"):
        parity.assert_equal(field, getattr(ref, field), getattr(got, field))
    parity.assert_equal("inflight", ref.state.inflight, got.state.inflight)


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delay", [1, 3])
def test_event_mode_equals_dense_mode(delay):
    """After ``tests/test_snn.py::test_event_mode_equals_dense_mode``: with
    frames wide enough that nothing drops, the exchange kernel's event
    path and the dense product give the same spike trains and delay
    line."""
    cfg_j, params_j, cfg_t, params_t = network(delay=delay, capacity=64,
                                               dyadic=False)
    mats = tnet.routing_matrices(params_t, cfg_t)
    rng = np.random.default_rng(5 + delay)
    drives = np.zeros((24, N_CHIPS, BATCH, 32), np.float32)
    drives[:, 0] = rng.random((24, BATCH, 32)) < 0.5
    state = tnet.init_state(cfg_t, BATCH, device="cpu")
    dense_state, dense_spikes = tnet.run_dense(params_t, state, T(drives),
                                               mats, cfg_t, device="cpu")
    event_state, event_spikes, dropped = tnet.run_event(
        params_t, state, T(drives), cfg_t, device="cpu")
    assert int(dropped.sum()) == 0
    assert torch.equal(dense_spikes, event_spikes)
    assert torch.equal(dense_state.inflight, event_state.inflight)
    assert float(dense_spikes[:, -1].sum()) > 0      # reached the last chip


@pytest.mark.parametrize("delay", [1, 3])
def test_run_stream_dense_matches_step_dense_loop(delay):
    """After ``tests/test_stream.py::
    test_run_stream_dense_matches_step_dense_loop``: the stream's ring
    buffer against the shift register of ``step_dense``, bit for bit."""
    cfg_j, params_j, cfg_t, params_t = network(delay=delay, dyadic=False)
    mats = tnet.routing_matrices(params_t, cfg_t)
    drives, _ = dense_inputs(cfg_t, 7, 60 + delay)
    state = tnet.init_state(cfg_t, BATCH, device="cpu")
    out = tstream.run_stream(params_t, state, T(drives), cfg_t, mode="dense",
                             route_mats=mats, device="cpu")
    s, spikes = state, []
    for t in range(drives.shape[0]):
        s, spk = tnet.step_dense(params_t, s, T(drives[t]), mats, cfg_t,
                                 device="cpu")
        spikes.append(spk)
    assert torch.equal(out.spikes, torch.stack(spikes))
    assert torch.equal(out.state.inflight, s.inflight)
    for a, b in zip(out.state.chips.neurons, s.chips.neurons):
        assert torch.equal(a, b)
    assert int(out.dropped.sum()) == 0 and out.latency_ns.shape[-1] == 0


def test_dense_gradients_reach_weights_and_leave_inputs_untouched():
    """Gradients flow from ``StreamOut.spikes`` through the in-place delay
    ring to ``params.chips.weights`` (the last chip's spikes depend on
    every chip's weights), and no caller tensor is written."""
    cfg_j, params_j, cfg_t, params_t = network(delay=3, dyadic=False)
    mats = tnet.routing_matrices(params_t, cfg_t)
    drives, _ = dense_inputs(cfg_t, STEPS, 77)
    state = tnet.init_state(cfg_t, BATCH, device="cpu")
    before = [x.clone() for x in (state.inflight, mats, T(drives))]
    w = params_t.chips.weights.clone().requires_grad_(True)
    params = params_t._replace(chips=params_t.chips._replace(weights=w))
    out = tstream.run_stream(params, state, T(drives), cfg_t, mode="dense",
                             route_mats=mats, device="cpu")
    (g,) = torch.autograd.grad(out.spikes[:, -1].sum(), w)
    assert all(float(g[c].abs().sum()) > 0 for c in range(N_CHIPS))
    for x, y in zip(before, (state.inflight, mats, T(drives))):
        assert torch.equal(x, y)


def test_dense_mode_composes_with_plasticity_and_mask_like_event_mode():
    """Shared and per-slot plasticity with a slot mask: dense mode's
    spikes, traces and weights equal event mode's where nothing drops."""
    cfg_j, params_j, cfg_t, params_t = network(delay=1, capacity=64)
    mats = tnet.routing_matrices(params_t, cfg_t)
    drives, mask = dense_inputs(cfg_t, STEPS, 88)
    state = tnet.init_state(cfg_t, BATCH, device="cpu")
    for init in (tnet.init_stream_plasticity, tnet.init_slot_plasticity):
        kw = dict(plasticity=tplas.STDPConfig(),
                  plasticity_state=init(params_t, BATCH), slot_mask=T(mask),
                  device="cpu")
        dense = tstream.run_stream(params_t, state, T(drives), cfg_t,
                                   mode="dense", route_mats=mats, **kw)
        event = tstream.run_stream(params_t, state, T(drives), cfg_t, **kw)
        assert int(event.dropped.sum()) == 0
        assert torch.equal(dense.spikes, event.spikes)
        for a, b in zip(dense.plasticity, event.plasticity):
            assert torch.equal(a, b)


def test_dense_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_j, params_j, cfg_t, params = network()
    mats = tnet.routing_matrices(params, cfg_t)
    state = tnet.init_state(cfg_t, 1, device="cpu")
    drives = torch.zeros((2, N_CHIPS, 1, 32))
    for call in (lambda: tnet.step_dense(params, state, drives[0], mats,
                                         cfg_t),
                 lambda: tnet.run_dense(params, state, drives, mats, cfg_t),
                 lambda: tstream.run_stream(params, state, drives, cfg_t,
                                            mode="dense", route_mats=mats)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_run_card_matches_cpu(cuda_device):
    """The dense run on the card (a cuBLAS product a step, no exchange
    kernel) equals the CPU's: dyadic weights and drives, so spikes and the
    delay line are equal bit for bit."""
    cfg_j, params_j, cfg_t, params = network(delay=3)
    drives, mask = dense_inputs(cfg_t, STEPS, 99)
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tnet.to_device(params, dev)
        runs[str(dev)] = tstream.run_stream(
            p, tnet.init_state(cfg_t, BATCH, device=dev), T(drives), cfg_t,
            mode="dense", route_mats=tnet.routing_matrices(p, cfg_t),
            slot_mask=T(mask), device=dev)
    hold_dense(runs["cpu"], runs[str(cuda_device)], "card against CPU")
