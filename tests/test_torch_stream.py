"""The port's SNN substrate and closed-loop ``run_stream`` against the JAX
package.

Neuron and chip step: within ``atol=1e-6``.  XLA on the CPU contracts
multiply-adds into fused ones where PyTorch's elementwise kernels round
twice, so the float state is close, not guaranteed bit-exact.

Whole slice: the port's ``run_stream`` against ``repro.snn.stream``'s on
``engine_network`` at a reduced chip, with the parameters carried across by
``repro_torch.convert``.  ``w_scale`` is overwritten with 2^-8 and the
external drives are multiples of 2^-4, so the quantized weights and every
synapse-product term are dyadic and the product is exact in float32 in any
sum order.  Rasters, drops, latencies and validity must then be equal,
except for a spike flip where the reference's ``|v - v_th|`` at that step
is below ``parity.FLIP_MARGIN`` (1e-5: the fused multiply-add difference
above, accumulated over a few steps); every flip is reported with its
margin.  Where the rasters agree the final float state must agree within
``parity.STATE_ATOL`` (1e-5, same reason).  Separately, the exchange stage
is held bit-exact under teacher forcing: both packages route the
reference's own spikes of every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import fabric as jfab
from repro.core.events import make_frame as j_make_frame
from repro.core.latency import timed_wire as j_timed_wire
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn import neuron as jnrn
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import fabric as tfab
from repro_torch.core.latency import timed_wire as t_timed_wire
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from repro_torch.snn import neuron as tnrn
from repro_torch.snn import stream as tstream
from torch_threads import share_cores

share_cores()

SMALL_CHIP = dict(n_neurons=64, n_rows=32)
BATCH, STEPS = 2, 8


def flatten(tree, prefix=""):
    """A JAX NamedTuple pytree as the {dotted path: numpy array} dict that
    ``repro_torch.convert`` reads."""
    out = {}
    for field, value in zip(tree._fields, tree):
        if hasattr(value, "_fields"):
            out.update(flatten(value, f"{prefix}{field}."))
        else:
            out[f"{prefix}{field}"] = np.array(value)
    return out


# ---------------------------------------------------------------------------
# Neuron and chip step
# ---------------------------------------------------------------------------


def _neuron_state(rng, shape):
    return (rng.uniform(-0.5, 1.0, shape).astype(np.float32),
            rng.uniform(-1.0, 2.0, shape).astype(np.float32),
            rng.uniform(0.0, 0.3, shape).astype(np.float32),
            rng.integers(0, 3, shape).astype(np.int32))


@pytest.mark.parametrize("params", [jnrn.LIF, jnrn.ADEX,
                                    jnrn.NeuronParams(refrac_us=2.0)])
def test_neuron_step_matches(params):
    rng = np.random.default_rng(0)
    state = _neuron_state(rng, (3, 4, 64))
    current = rng.normal(0.0, 0.5, (3, 4, 64)).astype(np.float32)
    ref_state, ref_spk = jax.jit(jnrn.neuron_step, static_argnums=2)(
        jnrn.NeuronState(*map(jnp.asarray, state)), jnp.asarray(current),
        params)
    t_params = tnrn.NeuronParams(**vars(params))
    got_state, got_spk = tnrn.neuron_step(
        tnrn.NeuronState(*map(torch.from_numpy, state)),
        torch.from_numpy(current), t_params)
    for f in ("v", "i_syn", "w_adapt"):
        np.testing.assert_allclose(getattr(got_state, f).numpy(),
                                   np.asarray(getattr(ref_state, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    # The threshold decision: equal wherever the margin exceeds the atol.
    _, v = tnrn.membrane(tnrn.NeuronState(*map(torch.from_numpy, state)),
                         torch.from_numpy(current), t_params)
    clear = (v - params.v_th).abs().numpy() > 1e-6
    np.testing.assert_array_equal(got_spk.numpy()[clear],
                                  np.asarray(ref_spk)[clear])
    np.testing.assert_array_equal(got_state.refrac.numpy(),
                                  np.asarray(ref_state.refrac))


def test_spike_fn_superspike_gradient():
    x = torch.tensor([-0.3, 0.0, 0.2], requires_grad=True)
    tnrn.spike_fn(x).sum().backward()
    ref = jax.grad(lambda v: jnrn.spike_fn(v).sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-6)


def test_chip_step_matches():
    rng = np.random.default_rng(1)
    cfg_j = jchip.ChipConfig(**SMALL_CHIP)
    n_chips = 3
    weights = rng.uniform(0.0, 63.0, (n_chips, 32, 64)).astype(np.float32)
    sign = np.where(rng.random((n_chips, 32)) < 0.8, 1.0, -1.0).astype(
        np.float32)
    scale = np.full(n_chips, 2.0 ** -8, np.float32)
    state = _neuron_state(rng, (n_chips, BATCH, 64))
    drive = (rng.integers(0, 40, (n_chips, BATCH, 32)) / 16).astype(np.float32)
    ref_state, ref_spk = jax.vmap(lambda p, s, d: jchip.chip_step(
        p, s, d, cfg_j))(jchip.ChipParams(*map(jnp.asarray,
                                               (weights, sign, scale))),
                         jchip.ChipState(jnrn.NeuronState(
                             *map(jnp.asarray, state))), jnp.asarray(drive))
    got_state, got_spk = tchip.chip_step(
        tchip.ChipParams(*map(torch.from_numpy, (weights, sign, scale))),
        tchip.ChipState(tnrn.NeuronState(*map(torch.from_numpy, state))),
        torch.from_numpy(drive), tchip.ChipConfig(**SMALL_CHIP))
    for f in ("v", "i_syn", "w_adapt"):
        np.testing.assert_allclose(
            getattr(got_state.neurons, f).numpy(),
            np.asarray(getattr(ref_state.neurons, f)), rtol=0, atol=1e-6,
            err_msg=f)
    # quantize_ste's forward value is exactly round(w), half to even.
    np.testing.assert_array_equal(
        tchip.quantize_ste(torch.from_numpy(weights)).numpy(),
        np.asarray(jchip.quantize_ste(jnp.asarray(weights))))
    w = torch.tensor([0.5, 1.5, 2.5, 70.0, -3.0], requires_grad=True)
    q = tchip.quantize_ste(w)
    assert q.tolist() == [0.0, 2.0, 2.0, 63.0, 0.0]
    q.sum().backward()
    assert w.grad.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]


def test_labels_to_rows_matches():
    rng = np.random.default_rng(2)
    table = rng.integers(-1, 32, (1 << 16,)).astype(np.int32)
    labels = rng.integers(0, 1 << 16, (5, 40)).astype(np.int32)
    valid = rng.random((5, 40)) < 0.6
    ref = jchip.labels_to_rows(jnp.asarray(labels), jnp.asarray(valid),
                               jnp.asarray(table), 32)
    got = tchip.labels_to_rows(torch.from_numpy(labels),
                               torch.from_numpy(valid),
                               torch.from_numpy(table), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    spk = (rng.random((2, 64)) < 0.5).astype(np.float32)
    for r, g in zip(jchip.spikes_to_labels(jnp.asarray(spk), 3),
                    tchip.spikes_to_labels(torch.from_numpy(spk), 3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_network_init_matches_reference_layout():
    cfg_j = jnet.NetworkConfig(n_chips=5, chip=jchip.ChipConfig(**SMALL_CHIP))
    cfg_t = tnet.NetworkConfig(n_chips=5, chip=tchip.ChipConfig(**SMALL_CHIP))
    assert cfg_t.delay_steps == cfg_j.delay_steps
    assert tnet.NetworkConfig(dt_us=0.25).delay_steps == \
        jnet.NetworkConfig(dt_us=0.25).delay_steps
    np.testing.assert_array_equal(tnet._feedforward_row_map(5, 32).numpy(),
                                  np.asarray(jnet._feedforward_row_map(5, 32)))
    ref_p = flatten(jnet.init_feedforward(jax.random.PRNGKey(0), cfg_j))
    got_p = tnet.init_feedforward(cfg_t, seed=0, device="cpu")
    got_flat = {"chips.weights": got_p.chips.weights,
                "chips.row_sign": got_p.chips.row_sign,
                "chips.w_scale": got_p.chips.w_scale,
                "row_of_label": got_p.row_of_label,
                "router.fwd_tables": got_p.router.fwd_tables,
                "router.rev_tables": got_p.router.rev_tables,
                "router.route_enables": got_p.router.route_enables}
    for k, v in got_flat.items():
        assert v.shape == ref_p[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(ref_p[k].dtype), k
        if not k.startswith("chips.w") and k != "chips.row_sign":
            np.testing.assert_array_equal(v.numpy(), ref_p[k], err_msg=k)
    np.testing.assert_array_equal(got_p.chips.w_scale.numpy(),
                                  ref_p["chips.w_scale"])
    # A seed gives the same network on every call (torch.Generator).
    again = tnet.init_feedforward(cfg_t, seed=0, device="cpu")
    assert torch.equal(again.chips.weights, got_p.chips.weights)
    ref_s = flatten(jnet.init_state(cfg_j, BATCH))
    got_s = convert.network_state_from_numpy(ref_s, device="cpu")
    want = tnet.init_state(cfg_t, BATCH, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(got_s)),
                    jax.tree_util.tree_leaves(tuple(want))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------


def _jax_exchange(params, spikes, cfg, plan, timing):
    """The reference's per-step exchange stage (``run_stream``'s
    ``event_route``) on spikes [T, n_chips, batch, n_neurons]."""
    grid = jstream._egress_label_grid(cfg)

    def one(spk):                                  # [n_chips, n_neurons]
        times = jnp.zeros_like(grid) if timing is not None else None
        frames, egress_drop = j_make_frame(grid, times, spk > 0.5,
                                           cfg.capacity)
        ingress, drops = jfab.fabric_route_step(params.router, frames, plan,
                                                timing=timing)
        drives = jax.vmap(lambda lab, val, rmap: jchip.labels_to_rows(
            lab[None], val[None], rmap, cfg.chip.n_rows)[0])(
                ingress.labels, ingress.valid, params.row_of_label)
        lat = ingress.times if timing is not None else ingress.times[:, :0]
        lat_valid = (ingress.valid if timing is not None
                     else ingress.valid[:, :0])
        return (drives, egress_drop + drops.congestion, drops.uplink, lat,
                lat_valid, drops.unroutable, drops.rerouted)

    per_batch = jax.vmap(one, in_axes=1, out_axes=1)
    return jax.jit(jax.vmap(per_batch))(spikes)


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("mode", ["gather", "routed"])
@pytest.mark.parametrize("name", ["FULL_BACKPLANE", "PROJECTED_120CHIP",
                                  "EXT_4CASE_96CHIP"])
def test_run_stream_matches_reference(name, mode, timed):
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))
    plan_j = jfab.with_exchange_mode(plan_j, mode)
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    plan_t = tfab.with_exchange_mode(plan_t, mode)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    rng = np.random.default_rng(len(name) + timed)
    shape = (STEPS, cfg_j.n_chips, BATCH, cfg_j.chip.n_rows)
    drives = ((rng.random(shape) < 0.6)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")

    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, timed=timed)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, fabric=plan_t, timed=timed, device="cpu")

    def margin_at(t):       # the reference's state entering step t
        before = jstream.run_stream(params_j, state_j,
                                    jnp.asarray(drives[:t]), cfg_j,
                                    fabric=plan_j).state if t else state_j
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t)

    report = parity.compare_streams(ref, got, margin_at)
    print(f"{name}/{mode}/timed={timed}: {report}")
    assert float(got.spikes.sum()) > 0
    if timed:
        assert int(got.latency_valid.sum()) > 0

    # Teacher forcing: both packages route the reference's own spikes.
    ref_spikes = np.array(ref.spikes)
    ex_ref = _jax_exchange(params_j, jnp.asarray(ref_spikes), cfg_j, plan_j,
                           j_timed_wire(cfg_j.latency) if timed else None)
    ex_got = tstream.exchange_spikes(
        params_t, torch.from_numpy(ref_spikes).transpose(0, 1), cfg_t,
        plan_t, t_timed_wire(cfg_t.latency) if timed else None)
    names = ("drives", "dropped", "uplink", "latency_ns", "latency_valid",
             "unroutable", "rerouted")
    for field, r, g in zip(names, ex_ref, ex_got):
        parity.assert_equal(f"teacher-forced {field}", r, g.transpose(0, 1))


@pytest.mark.parametrize("name,mode,timed", [
    ("FULL_BACKPLANE", "gather", False),
    ("FULL_BACKPLANE", "routed", False),
    ("EXT_4CASE_96CHIP", "gather", True),
    ("EXT_4CASE_96CHIP", "routed", True),
])
def test_run_stream_zero_steps_matches_reference(name, mode, timed):
    """T = 0: zero-length outputs of the reference's shapes and types (the
    latency planes zero-width untimed, capacity-wide timed) and the state
    it was given, bit for bit."""
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    plan_j = jfab.with_exchange_mode(plan_j, mode)
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    plan_t = tfab.with_exchange_mode(plan_t, mode)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    rng = np.random.default_rng(6)
    # A non-resting state, so that "unchanged" is not "reset".
    state_j = jax.tree_util.tree_map(
        lambda a: a + rng.integers(0, 4, a.shape).astype(a.dtype),
        jnet.init_state(cfg_j, BATCH))
    state_np = flatten(state_j)
    state_t = convert.network_state_from_numpy(state_np, device="cpu")
    drives = np.zeros((0, cfg_j.n_chips, BATCH, cfg_j.chip.n_rows),
                      np.float32)

    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, timed=timed)
    got = tstream.run_stream(params_t, state_t, torch.from_numpy(drives),
                             cfg_t, fabric=plan_t, timed=timed, device="cpu")
    for field in ("spikes", "dropped", "uplink_dropped", "latency_ns",
                  "latency_valid", "unroutable", "rerouted"):
        r, g = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, (field, g.shape,
                                                           r.shape)
    assert got.latency_ns.shape[-1] == (cfg_j.capacity if timed else 0)
    for (path, r), g in zip(flatten(ref.state).items(),
                            jax.tree_util.tree_leaves(tuple(got.state))):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=path)
        np.testing.assert_array_equal(g.numpy(), state_np[path],
                                      err_msg=path)


def test_run_stream_star_topology_and_ring_order():
    """The legacy star path (enables from the router) with a delay line
    deeper than one step, so the ring buffer's roll back to shift order is
    exercised."""
    cfg_j = jnet.NetworkConfig(n_chips=4, chip=jchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=0.25)
    cfg_t = tnet.NetworkConfig(n_chips=4, chip=tchip.ChipConfig(**SMALL_CHIP),
                               capacity=48, dt_us=0.25)
    n_steps = STEPS + 1
    assert cfg_j.delay_steps > 1 and n_steps % cfg_j.delay_steps
    params_j = jnet.init_feedforward(jax.random.PRNGKey(3), cfg_j)
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    rng = np.random.default_rng(4)
    shape = (n_steps, 4, BATCH, 32)
    drives = ((rng.random(shape) < 0.7)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    state_j = jnet.init_state(cfg_j, BATCH)
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j)
    got = tstream.run_stream(
        params_t, convert.network_state_from_numpy(flatten(state_j),
                                                   device="cpu"),
        torch.from_numpy(drives), cfg_t, device="cpu")

    def margin_at(t):
        before = jstream.run_stream(params_j, state_j,
                                    jnp.asarray(drives[:t]),
                                    cfg_j).state if t else state_j
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t)

    report = parity.compare_streams(ref, got, margin_at)
    print(report)
    assert float(got.spikes[:, 1:].sum()) > 0      # traffic reached chip 1+


def test_latency_stats_match_reference():
    rng = np.random.default_rng(5)
    lat = rng.integers(900, 1300, (4, 3, 2, 16)).astype(np.int32)
    valid = rng.random(lat.shape) < 0.5
    ref = jstream.masked_latency_stats(jnp.asarray(lat), jnp.asarray(valid))
    got = tstream.masked_latency_stats(torch.from_numpy(lat),
                                       torch.from_numpy(valid))
    assert got["count"] == ref["count"]
    for k in ("median_ns", "p01_ns", "p99_ns", "jitter_ns", "jitter_frac"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    empty = tstream.masked_latency_stats(torch.from_numpy(lat),
                                         torch.zeros(lat.shape, dtype=bool),
                                         strict=False)
    assert empty["count"] == 0 and np.isnan(empty["median_ns"])
    with pytest.raises(ValueError, match="no delivered events"):
        tstream.masked_latency_stats(torch.from_numpy(lat),
                                     torch.zeros(lat.shape, dtype=bool))


@pytest.mark.parametrize("kwargs", [dict(mode="dense")])
def test_unported_options_raise(kwargs):
    """Dense mode, ported since, raises the reference's ``ValueError``
    without ``route_mats``, before any other argument is looked at."""
    cfg_j = jnet.NetworkConfig(n_chips=2, chip=jchip.ChipConfig(**SMALL_CHIP))
    cfg = tnet.NetworkConfig(n_chips=2, chip=tchip.ChipConfig(**SMALL_CHIP))
    with pytest.raises(ValueError) as ref:
        jstream.run_stream(None, None, jnp.zeros((1, 2, 1, 32)), cfg_j,
                           **kwargs)
    with pytest.raises(ValueError) as got:
        tstream.run_stream(None, None, torch.zeros((1, 2, 1, 32)), cfg,
                           device="cpu", **kwargs)
    assert str(got.value) == str(ref.value) == "dense mode requires route_mats"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tnet.NetworkConfig(n_chips=2, chip=tchip.ChipConfig(**SMALL_CHIP))
    for call in (lambda: tnet.init_feedforward(cfg),
                 lambda: tnet.init_state(cfg, 1),
                 lambda: tsc.engine_network("FULL_BACKPLANE"),
                 lambda: convert.network_state_from_numpy(
                     flatten(jnet.init_state(jnet.NetworkConfig(n_chips=2),
                                             1)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_compare_streams_flip_rule():
    """The flip rule itself: a flipped spike passes only with a reference
    margin below FLIP_MARGIN, and an integer mismatch before the first flip
    always fails."""
    cfg, params, plan = tsc.engine_network(
        "FULL_BACKPLANE", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    state = tnet.init_state(cfg, BATCH, device="cpu")
    drives = torch.full((4, cfg.n_chips, BATCH, 32), 0.75)
    ref = tstream.run_stream(params, state, drives, cfg, fabric=plan,
                             device="cpu")
    margin = parity.spike_margin(params, state, drives[0], cfg)
    assert margin.shape == (cfg.n_chips, BATCH, 64)
    flipped = ref.spikes.clone()
    flipped[2, 1, 0, 5] = 1.0 - flipped[2, 1, 0, 5]
    got = ref._replace(spikes=flipped)
    near = lambda t: torch.full((cfg.n_chips, BATCH, 64), 1e-6)
    report = parity.compare_streams(ref, got, near)
    assert report["first_flip_step"] == 2
    assert [f[:4] for f in report["flips"]] == [(2, 1, 0, 5)]
    with pytest.raises(AssertionError, match="reference margin"):
        parity.compare_streams(ref, got, lambda t: near(t) + 1e-3)
    dropped = ref.dropped.clone()
    dropped[1, 0, 0] += 1
    with pytest.raises(AssertionError, match="dropped"):
        parity.compare_streams(ref, got._replace(dropped=dropped), near)


def test_chip_and_neuron_init_state_default_to_the_card(monkeypatch):
    """``snn.chip.init_state`` and ``snn.neuron.init_state`` raise without a
    card unless given ``device="cpu"``, and then equal the JAX package's
    resting state bit for bit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ccfg = tchip.ChipConfig(**SMALL_CHIP)
    for call in (lambda **kw: tchip.init_state(ccfg, 2, BATCH, **kw),
                 lambda **kw: tnrn.init_state((BATCH, 64), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    jcfg = jchip.ChipConfig(**SMALL_CHIP)
    got = tchip.init_state(ccfg, 2, BATCH, device="cpu").neurons
    want = jchip.init_state(jcfg, BATCH).neurons
    for g, w in zip(got, want, strict=True):
        assert g.numpy().dtype == np.asarray(w).dtype
        for c in range(2):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))
    got = tnrn.init_state((BATCH, 64), device="cpu")
    want = jnrn.init_state((BATCH, 64))
    for g, w in zip(got, want, strict=True):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
