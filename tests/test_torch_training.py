"""The port's encoders and surrogate-gradient training against the JAX
package.

Given the reference's own ``jax.random`` draws, ``poisson_encode``,
``synthetic_task`` and ``make_batch`` equal the reference bit for bit;
``latency_encode`` and ``regular_encode`` are deterministic and equal bit
for bit.  ``loss_fn`` and ``train_step`` are held against the reference's
jitted ones on the same parameters and batch: the rasters equal, the loss
and aux within 1e-6 relative (spike means summed in another order), the
gradient and the momentum within 1e-5 × max|g| (autograd and XLA sum the
backward products in other orders, about 2e-7 × max|g| apart).  The new
weights are ``w − lr·m`` rounded to float32, so they agree within
lr × 1e-5 × max|g| plus one float32 ulp of the weight: a momentum that
differs in its last bits may round ``w − lr·m`` to the neighbouring
float.  The tie case places weights exactly on the clip bounds 0 and 63,
where ``quantize_ste`` passes half the gradient in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import chip as jchip
from repro.snn import encoding as jenc
from repro.snn import network as jnet
from repro.snn import training as jtr
from repro_torch import convert
from repro_torch.snn import chip as tchip
from repro_torch.snn import encoding as tenc
from repro_torch.snn import network as tnet
from repro_torch.snn import training as ttr
from test_torch_stream import flatten
from torch_threads import share_cores

share_cores()

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5          # × max|g|
DT_OF_DELAY = {1: 1.0, 3: 0.4}


def T(a):
    return torch.from_numpy(np.array(a))


def reference_batch_draws(key, cfg_j, batch):
    """The draws ``repro.snn.training.make_batch`` takes from ``key``, as
    the port's ``BatchDraws``."""
    k_task, k_enc = jax.random.split(key)
    k_cls, k_noise = jax.random.split(k_task)
    n_rows = cfg_j.network.chip.n_rows
    labels = jax.random.randint(k_cls, (batch,), 0, cfg_j.n_classes)
    noise = jax.random.uniform(k_noise, (batch, n_rows), minval=0.0,
                               maxval=0.05)
    u = jax.random.uniform(k_enc, (cfg_j.n_steps, batch, n_rows))
    return ttr.BatchDraws(task=ttr.TaskDraws(labels=T(labels), noise=T(noise)),
                          encode=T(u))


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def test_poisson_encode_with_draws_matches_reference():
    key = jax.random.key(11)
    values = np.array([[-0.2, 0.0, 0.3, 0.5], [0.7, 1.0, 1.4, 0.05]],
                      np.float32)
    for rate in (0.5, 0.3):
        ref = jenc.poisson_encode(key, jnp.asarray(values), 40, rate)
        u = jax.random.uniform(key, (40, *values.shape))
        got = tenc.poisson_encode(T(values), 40, rate, draws=T(u),
                                  device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="draws must be"):
        tenc.poisson_encode(T(values), 40, draws=T(u)[:3], device="cpu")
    with pytest.raises(ValueError, match="a generator or draws"):
        tenc.poisson_encode(T(values), 40, device="cpu")


def test_poisson_encode_generator_statistics():
    """The reference test's statistics (``tests/test_snn.py::
    test_encoders``), from a seeded ``torch.Generator``."""
    gen = torch.Generator().manual_seed(3)
    sp = tenc.poisson_encode(torch.tensor([0.0, 0.5, 1.0]), 100,
                             generator=gen, device="cpu")
    rates = sp.mean(0)
    assert sp.shape == (100, 3)
    assert float(rates[0]) < 0.05 < float(rates[2])
    assert abs(float(rates[2]) - 0.5) < 0.15


@pytest.mark.parametrize("n_steps", [1, 10, 33])
def test_latency_encode_matches_reference(n_steps):
    values = np.array([[-0.5, 0.0, 0.25, 0.5], [0.75, 0.9, 1.0, 2.0]],
                      np.float32)
    ref = jenc.latency_encode(jnp.asarray(values), n_steps)
    got = tenc.latency_encode(T(values), n_steps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.sum()) == values.size


@pytest.mark.parametrize("args", [(1e4, 100, 1.0), (1e4, 100, 1.0, 0.0, 3),
                                  (2.5e5, 64, 0.4, 1.3, 2),
                                  (3.3e4, 200, 0.25, 7.0, 1)])
def test_regular_encode_matches_reference(args):
    ref = jenc.regular_encode(*args)
    got = tenc.regular_encode(*args, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.sum()) >= 1


# ---------------------------------------------------------------------------
# The synthetic task and its batches
# ---------------------------------------------------------------------------


def train_configs(n_chips=2, n_rows=32, n_steps=16, delay=1, lr=0.2):
    """Both packages' ``TrainConfig`` at 512 neurons x ``n_rows`` rows."""
    out = []
    for lib_net, lib_chip, lib_tr in ((jnet, jchip, jtr), (tnet, tchip, ttr)):
        net_cfg = lib_net.NetworkConfig(
            n_chips=n_chips, chip=lib_chip.ChipConfig(n_rows=n_rows),
            capacity=600, dt_us=DT_OF_DELAY[delay])
        out.append(lib_tr.TrainConfig(network=net_cfg, n_steps=n_steps,
                                      n_classes=4, lr=lr))
    assert out[0].network.delay_steps == delay
    return out


def test_make_batch_with_draws_matches_reference():
    cfg_j, cfg_t = train_configs(n_chips=3)
    for seed in (0, 5):
        key = jax.random.key(100 + seed)
        ref_d, ref_l = jtr.make_batch(key, cfg_j, 6)
        draws = reference_batch_draws(key, cfg_j, 6)
        got_d, got_l = ttr.make_batch(cfg_t, 6, draws=draws, device="cpu")
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
        assert got_l.dtype == torch.int32
        k_task = jax.random.split(key)[0]
        ref_v, _ = jtr.synthetic_task(k_task, 6, 32, 4)
        got_v, _ = ttr.synthetic_task(6, 32, 4, draws=draws.task,
                                      device="cpu")
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
        assert float(got_d[:, 1:].abs().sum()) == 0      # stimulus on chip 0


def test_make_batch_from_a_generator():
    _, cfg_t = train_configs()
    a = ttr.make_batch(cfg_t, 8, generator=torch.Generator().manual_seed(4),
                       device="cpu")
    b = ttr.make_batch(cfg_t, 8, generator=torch.Generator().manual_seed(4),
                       device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    drives, labels = a
    assert drives.shape == (16, 2, 8, 32) and labels.shape == (8,)
    assert int(labels.min()) >= 0 and int(labels.max()) < 4
    # The labelled block fires at about 0.45 a step, the rest at about 0.05.
    stim = drives[:, 0].mean(0)
    hot = torch.arange(32)[None] // 8 == labels[:, None]
    assert float(stim[hot].mean()) > 0.3 > 0.1 > float(stim[~hot].mean())
    with pytest.raises(ValueError, match="a generator or draws"):
        ttr.make_batch(cfg_t, 8, device="cpu")


# ---------------------------------------------------------------------------
# loss_fn and train_step against the reference
# ---------------------------------------------------------------------------


def training_case(delay, on_bounds, n_chips=3, batch=4, seed=0):
    """The reference's feed-forward network and a batch from its draws,
    carried to the port.  ``on_bounds`` puts every 5th weight on 0 and
    every 7th on 63."""
    cfg_j, cfg_t = train_configs(n_chips=n_chips, delay=delay)
    params_j = jnet.init_feedforward(jax.random.key(seed), cfg_j.network)
    if on_bounds:
        w = np.array(params_j.chips.weights)
        flat = w.reshape(-1)
        flat[::5] = 0.0
        flat[3::7] = 63.0
        params_j = params_j._replace(chips=params_j.chips._replace(
            weights=jnp.asarray(w)))
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    key = jax.random.key(200 + seed)
    drives_j, labels_j = jtr.make_batch(key, cfg_j, batch)
    drives_t, labels_t = ttr.make_batch(
        cfg_t, batch, draws=reference_batch_draws(key, cfg_j, batch),
        device="cpu")
    mats_j = jnet.routing_matrices(params_j, cfg_j.network)
    mats_t = tnet.routing_matrices(params_t, cfg_t.network)
    return (cfg_j, params_j, mats_j, drives_j, labels_j,
            cfg_t, params_t, mats_t, drives_t, labels_t)


def zero_momentum_j(params_j):
    return jax.tree.map(
        lambda x: jnp.zeros_like(x) if x.dtype == jnp.float32 else x,
        params_j)


def zero_momentum_t(params_t):
    return params_t._replace(chips=params_t.chips._replace(
        weights=torch.zeros_like(params_t.chips.weights)))


def assert_close_rel(got, ref, what):
    ref = float(ref)
    assert abs(float(got) - ref) <= LOSS_RTOL * max(abs(ref), 1e-30), (
        what, float(got), ref)


@pytest.mark.parametrize("delay", [1, 3])
def test_loss_fn_matches_reference(delay):
    (cfg_j, params_j, mats_j, drives_j, labels_j,
     cfg_t, params_t, mats_t, drives_t, labels_t) = training_case(delay,
                                                                  False)
    _, ref_spk = jax.jit(jtr.forward_rates, static_argnums=(3, 4))(
        params_j, mats_j, drives_j, cfg_j, 4)
    _, got_spk = ttr.forward_rates(params_t, mats_t, drives_t, cfg_t, 4,
                                   device="cpu")
    np.testing.assert_array_equal(got_spk.numpy(), np.asarray(ref_spk))
    assert float(got_spk[:, -1].sum()) > 0
    ref_loss, ref_aux = jax.jit(jtr.loss_fn, static_argnums=4)(
        params_j, mats_j, drives_j, labels_j, cfg_j)
    got_loss, got_aux = ttr.loss_fn(params_t, mats_t, drives_t, labels_t,
                                    cfg_t, device="cpu")
    assert_close_rel(got_loss, ref_loss, "loss")
    assert set(got_aux) == set(ref_aux)
    for k in ref_aux:
        assert_close_rel(got_aux[k], ref_aux[k], k)


@pytest.mark.parametrize("on_bounds", [False, True])
@pytest.mark.parametrize("delay", [1, 3])
def test_train_step_matches_reference(delay, on_bounds):
    """Two steps from zero momentum (the second carries momentum)."""
    (cfg_j, params_j, mats_j, drives_j, labels_j,
     cfg_t, params_t, mats_t, drives_t, labels_t) = training_case(delay,
                                                                  on_bounds)
    step_j = jax.jit(lambda p, m: jtr.train_step(p, m, mats_j, drives_j,
                                                 labels_j, cfg_j))
    p_j, m_j = params_j, zero_momentum_j(params_j)
    p_t, m_t = params_t, zero_momentum_t(params_t)
    for k in range(2):
        w_before = p_t.chips.weights
        p_j, m_j, loss_j, aux_j = step_j(p_j, m_j)
        p_t, m_t, loss_t, aux_t = ttr.train_step(p_t, m_t, mats_t, drives_t,
                                                 labels_t, cfg_t,
                                                 device="cpu")
        assert_close_rel(loss_t, loss_j, f"step {k} loss")
        for key in aux_j:
            assert_close_rel(aux_t[key], aux_j[key], f"step {k} {key}")
        ref_m = np.asarray(m_j.chips.weights)
        scale = np.abs(ref_m).max()
        assert scale > 0
        m_err = np.abs(m_t.chips.weights.numpy() - ref_m).max()
        assert m_err <= GRAD_TOL * scale, (k, m_err / scale)
        ref_w = np.asarray(p_j.chips.weights)
        w_err = np.abs(p_t.chips.weights.numpy() - ref_w)
        bound = cfg_t.lr * GRAD_TOL * scale + np.spacing(np.abs(ref_w))
        assert (w_err <= bound).all(), (k, w_err.max())
        # The update itself is exact: w − lr·m in float32.
        assert torch.equal(p_t.chips.weights,
                           w_before - cfg_t.lr * m_t.chips.weights)
        # Only the chip weights train.
        assert torch.equal(p_t.row_of_label, params_t.row_of_label)
        assert torch.equal(p_t.chips.row_sign, params_t.chips.row_sign)
    if on_bounds:
        # Half the gradient on a bound: the port's ties are the reference's.
        w0 = params_t.chips.weights
        assert int(((w0 == 0) | (w0 == 63)).sum()) > 1000


def test_train_step_gradient_is_autograd_through_the_stream():
    """The momentum after one step from zero is the gradient of
    ``loss_fn`` with respect to the chip weights."""
    (_, _, _, _, _, cfg_t, params_t, mats_t, drives_t,
     labels_t) = training_case(1, True)
    w = params_t.chips.weights.clone().requires_grad_(True)
    loss, _ = ttr.loss_fn(params_t._replace(chips=params_t.chips._replace(
        weights=w)), mats_t, drives_t, labels_t, cfg_t, device="cpu")
    (g,) = torch.autograd.grad(loss, w)
    _, m, loss2, _ = ttr.train_step(params_t, zero_momentum_t(params_t),
                                    mats_t, drives_t, labels_t, cfg_t,
                                    device="cpu")
    assert torch.equal(m.chips.weights, g)
    assert float(loss2) == float(loss.detach())
    assert not params_t.chips.weights.requires_grad


def test_multichip_training_reduces_loss():
    """After ``tests/test_snn.py::test_multichip_training_reduces_loss``: 2
    full-width chips, 24 steps, batch 16, 30 momentum-SGD steps on
    batches from a seeded generator."""
    _, cfg = train_configs(n_chips=2, n_rows=256, n_steps=24)
    params = tnet.init_feedforward(cfg.network, seed=0, device="cpu")
    mats = tnet.routing_matrices(params, cfg.network)
    mom = zero_momentum_t(params)
    losses = []
    for i in range(30):
        gen = torch.Generator().manual_seed(100 + i)
        drives, labels = ttr.make_batch(cfg, 16, generator=gen, device="cpu")
        params, mom, loss, aux = ttr.train_step(params, mom, mats, drives,
                                                labels, cfg, device="cpu")
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = train_configs()
    gen = torch.Generator()
    for call in (lambda: ttr.make_batch(cfg, 2, generator=gen),
                 lambda: ttr.synthetic_task(2, 32, 4, generator=gen),
                 lambda: tenc.poisson_encode(torch.zeros(3), 4,
                                             generator=gen),
                 lambda: tenc.latency_encode(torch.zeros(3), 4),
                 lambda: tenc.regular_encode(1e4, 10, 1.0),
                 lambda: ttr.forward_rates(None, None, None, cfg, 2),
                 lambda: ttr.loss_fn(None, None, None, torch.zeros(2), cfg),
                 lambda: ttr.train_step(None, None, None, None, None, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_device):
    """One ``train_step`` on the card against the CPU on the same batch:
    equal rasters, loss within 1e-6 relative, momentum within 1e-5 ×
    max|g|, weights as in ``test_train_step_matches_reference``."""
    (_, _, _, _, _, cfg, params, mats, drives, labels) = training_case(3,
                                                                       True)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tnet.to_device(params, dev)
        _, spk = ttr.forward_rates(p, mats, drives, cfg, 4, device=dev)
        out[str(dev)] = (spk.cpu(), *ttr.train_step(
            p, zero_momentum_t(p), mats, drives, labels, cfg, device=dev))
    spk_c, p_c, m_c, loss_c, _ = out["cpu"]
    spk_g, p_g, m_g, loss_g, _ = out[str(cuda_device)]
    assert torch.equal(spk_c, spk_g)
    assert_close_rel(loss_g.cpu(), loss_c, "loss")
    scale = float(m_c.chips.weights.abs().max())
    assert float((m_g.chips.weights.cpu() - m_c.chips.weights).abs().max()
                 ) <= GRAD_TOL * scale
    ref_w = p_c.chips.weights.numpy()
    bound = cfg.lr * GRAD_TOL * scale + np.spacing(np.abs(ref_w))
    assert (np.abs(p_g.chips.weights.cpu().numpy() - ref_w) <= bound).all()


# ---------------------------------------------------------------------------
# Gradients through plastic dense runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_bounds", [False, True])
@pytest.mark.parametrize("plastic", ["shared", "slot"])
def test_plastic_dense_gradient_matches_reference(plastic, on_bounds):
    """The gradient of ``sum(spikes · c)`` over an 8-step plastic dense run
    with respect to the chip weights, ``torch.autograd.grad`` against
    ``jax.grad``, within 1e-5 × max|g|.  The chips integrate the
    plasticity's weights, which start as the parameters' and pass the
    weight clip every step; ``on_bounds`` puts every 5th weight on 0 and
    every 7th on 63, where ``jnp.clip`` passes half the gradient."""
    from repro.snn import plasticity as jplas
    from repro.snn import stream as jstream
    from repro_torch.snn import plasticity as tplas
    from repro_torch.snn import stream as tstream
    from test_torch_dense import BATCH, dense_inputs, network

    cfg_j, params_j, cfg_t, params_t = network(delay=1, dyadic=False)
    w0 = np.array(params_j.chips.weights)
    if on_bounds:
        flat = w0.reshape(-1)
        flat[::5] = 0.0
        flat[3::7] = 63.0
    mats_j = jnet.routing_matrices(params_j, cfg_j)
    mats_t = tnet.routing_matrices(params_t, cfg_t)
    drives, _ = dense_inputs(cfg_t, 8, 31)
    c = np.random.default_rng(32).random(
        (8, cfg_t.n_chips, BATCH, cfg_t.chip.n_neurons)).astype(np.float32)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = tnet.init_state(cfg_t, BATCH, device="cpu")
    init_j = (jnet.init_slot_plasticity if plastic == "slot"
              else jnet.init_stream_plasticity)
    init_t = (tnet.init_slot_plasticity if plastic == "slot"
              else tnet.init_stream_plasticity)

    def loss_j(w):
        p = params_j._replace(chips=params_j.chips._replace(weights=w))
        out = jstream.run_stream(
            p, state_j, jnp.asarray(drives), cfg_j, mode="dense",
            route_mats=mats_j, plasticity=jplas.STDPConfig(),
            plasticity_state=init_j(p, BATCH))
        return (out.spikes * jnp.asarray(c)).sum()

    ref = np.asarray(jax.grad(loss_j)(jnp.asarray(w0)))
    w = T(w0).requires_grad_(True)
    p = params_t._replace(chips=params_t.chips._replace(weights=w))
    out = tstream.run_stream(p, state_t, T(drives), cfg_t, mode="dense",
                             route_mats=mats_t, plasticity=tplas.STDPConfig(),
                             plasticity_state=init_t(p, BATCH), device="cpu")
    (got,) = torch.autograd.grad((out.spikes * T(c)).sum(), w)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got.numpy() - ref).max()
    assert err <= GRAD_TOL * scale, (plastic, on_bounds, err / scale)
    if on_bounds:
        assert int(((w0 == 0) | (w0 == 63)).sum()) > 1000
