"""The port's online plasticity and slot masking against the JAX package.

The STDP steps are held bit for bit against the reference's compiled
steps: the port rounds the update as XLA does (``snn.plasticity``), and the
two exact reductions the reference states (the shared step at batch 1 on
one chip is ``stdp_step``; the per-slot step at batch 1 is the shared one)
hold in the port bit for bit.  ``chip_step_slots`` equals the reference's
bit for bit on dyadic weights and drives (``w_scale`` 2^-8, drives in
multiples of 2^-4: the product is exact in any sum order) and equals a
batch-1 ``chip_step`` bit for bit at the default, non-dyadic scale.

``run_stream`` with plasticity follows ``test_torch_stream.py``'s rule
(``parity.compare_streams``): dyadic weights and drives, integer outputs
equal up to the first spike flip, a flip allowed only where the
reference's margin ``|v - v_th|`` at that step, computed on that step's
evolving weights, is below ``parity.FLIP_MARGIN`` (1e-5); where the
rasters agree, the final neuron state within ``parity.STATE_ATOL`` (1e-5)
and the final traces and weights within ``parity.PLASTICITY_ATOL``
(1e-5).  The port against itself (chained windows, batch rows against
batch-1 runs, overlap against the plain loop) is equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jsc
from repro.core import fabric as jfab
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn import neuron as jnrn
from repro.snn import plasticity as jplas
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.core import fabric as tfab
from repro_torch.kernels.stdp_slot import ops as slot_ops
from repro_torch.kernels.stdp_slot import ref as slot_ref
from repro_torch.kernels.stdp_slot.ref import (float32_midpoint,
                                              midpoints, stdp_slot_ref)
from repro_torch.runtime.engine import EmulationEngine
from repro_torch.snn import chip as tchip
from repro_torch.snn import network as tnet
from repro_torch.snn import neuron as tnrn
from repro_torch.snn import plasticity as tplas
from repro_torch.snn import stream as tstream
from test_torch_stream import BATCH, SMALL_CHIP, STEPS, flatten
from test_torch_stream_options import FIELDS as OUT_FIELDS
from test_torch_stream_options import assert_same_run as assert_same_outputs
from torch_threads import share_cores

share_cores()

STATE_FIELDS = ("trace_pre", "trace_post", "weights")
CONFIGS = {"default": (jplas.STDPConfig(), tplas.STDPConfig()),
           "fast": (jplas.STDPConfig(tau_pre_us=7.0, tau_post_us=13.0,
                                     lr_pot=0.11, lr_dep=0.07, dt_us=0.5),
                    tplas.STDPConfig(tau_pre_us=7.0, tau_post_us=13.0,
                                     lr_pot=0.11, lr_dep=0.07, dt_us=0.5))}


def T(a):
    return torch.from_numpy(np.array(a))


def assert_state_equal(ref, got, what=""):
    for field in STATE_FIELDS:
        parity.assert_equal(f"{what}{field}", getattr(ref, field),
                            getattr(got, field))


def step_inputs(rng, c, b, r=32, n=64):
    """Traces, drives (multiples of 1/16 plus delivered counts) and 0/1
    spikes of one plasticity step."""
    tp = rng.uniform(0.0, 3.0, (c, b, r)).astype(np.float32)
    tq = rng.uniform(0.0, 3.0, (c, b, n)).astype(np.float32)
    pre = ((rng.random((c, b, r)) < 0.5)
           * rng.integers(1, 64, (c, b, r)) / 16).astype(np.float32)
    post = (rng.random((c, b, n)) < 0.3).astype(np.float32)
    return tp, tq, pre, post


# ---------------------------------------------------------------------------
# The three STDP steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", CONFIGS)
def test_stdp_step_matches(config):
    jcfg, tcfg = CONFIGS[config]
    rng = np.random.default_rng(0)
    tp, tq, pre, post = (a[0, 0] for a in step_inputs(rng, 1, 1))
    w = rng.uniform(0.0, 63.0, (32, 64)).astype(np.float32)
    w[0, :8] = [0.0, 63.0, 62.999, 0.001, 31.5, 0.5, 62.5, 10.0]
    ref_s, ref_w = jax.jit(jplas.stdp_step, static_argnums=4)(
        jplas.STDPState(*map(jnp.asarray, (tp, tq))), jnp.asarray(w),
        jnp.asarray(pre), jnp.asarray(post), jcfg)
    got_s, got_w = tplas.stdp_step(tplas.STDPState(T(tp), T(tq)), T(w),
                                   T(pre), T(post), tcfg)
    parity.assert_equal("weights", ref_w, got_w)
    parity.assert_equal("trace_pre", ref_s.trace_pre, got_s.trace_pre)
    parity.assert_equal("trace_post", ref_s.trace_post, got_s.trace_post)
    assert not np.array_equal(np.asarray(ref_w), w)


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("config", CONFIGS)
def test_stdp_stream_step_matches(config, batch):
    jcfg, tcfg = CONFIGS[config]
    rng = np.random.default_rng(batch)
    tp, tq, pre, post = step_inputs(rng, 3, batch)
    w = rng.uniform(0.0, 63.0, (3, 32, 64)).astype(np.float32)
    ref = jax.jit(jplas.stdp_stream_step, static_argnums=3)(
        jplas.StreamPlasticityState(*map(jnp.asarray, (tp, tq, w))),
        jnp.asarray(pre), jnp.asarray(post), jcfg)
    got = tplas.stdp_stream_step(
        tplas.StreamPlasticityState(T(tp), T(tq), T(w)), T(pre), T(post),
        tcfg)
    assert_state_equal(ref, got)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_stdp_slot_step_matches(config, masked):
    jcfg, tcfg = CONFIGS[config]
    rng = np.random.default_rng(7 + masked)
    tp, tq, pre, post = step_inputs(rng, 3, 4)
    w = rng.uniform(0.0, 63.0, (3, 4, 32, 64)).astype(np.float32)
    mask = np.array([True, False, True, False]) if masked else None
    ref = jax.jit(jplas.stdp_slot_step, static_argnums=3)(
        jplas.SlotPlasticityState(*map(jnp.asarray, (tp, tq, w))),
        jnp.asarray(pre), jnp.asarray(post), jcfg,
        None if mask is None else jnp.asarray(mask))
    got = tplas.stdp_slot_step(
        tplas.SlotPlasticityState(T(tp), T(tq), T(w)), T(pre), T(post),
        tcfg, mask=None if mask is None else T(mask))
    assert_state_equal(ref, got)
    if masked:          # the masked slots pass through unchanged
        for field, x in zip(STATE_FIELDS, (tp, tq, w)):
            np.testing.assert_array_equal(
                getattr(got, field)[:, ~mask].numpy(), x[:, ~mask])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_one_reductions_are_exact(seed):
    """The reference's two stated reductions, in the port, bit for bit:
    the shared step at batch 1 on one chip is ``stdp_step``, and the
    per-slot step at batch 1 is the shared step."""
    rng = np.random.default_rng(seed)
    tp, tq, pre, post = step_inputs(rng, 1, 1)
    w = rng.uniform(0.0, 63.0, (1, 32, 64)).astype(np.float32)
    cfg = tplas.STDPConfig()
    one_s, one_w = tplas.stdp_step(tplas.STDPState(T(tp[0, 0]), T(tq[0, 0])),
                                   T(w[0]), T(pre[0, 0]), T(post[0, 0]), cfg)
    shared = tplas.stdp_stream_step(
        tplas.StreamPlasticityState(T(tp), T(tq), T(w)), T(pre), T(post), cfg)
    parity.assert_equal("weights", one_w, shared.weights[0])
    parity.assert_equal("trace_pre", one_s.trace_pre, shared.trace_pre[0, 0])
    parity.assert_equal("trace_post", one_s.trace_post,
                        shared.trace_post[0, 0])
    w3 = rng.uniform(0.0, 63.0, (3, 32, 64)).astype(np.float32)
    tp, tq, pre, post = step_inputs(rng, 3, 1)
    shared = tplas.stdp_stream_step(
        tplas.StreamPlasticityState(T(tp), T(tq), T(w3)), T(pre), T(post),
        cfg)
    slot = tplas.stdp_slot_step(
        tplas.SlotPlasticityState(T(tp), T(tq), T(w3[:, None])), T(pre),
        T(post), cfg)
    assert_state_equal(shared._replace(weights=shared.weights[:, None]),
                       slot)


def _slot_state(rng, c=3, b=4):
    tp, tq, pre, post = step_inputs(rng, c, b)
    w = rng.uniform(0.0, 63.0, (c, b, 32, 64)).astype(np.float32)
    mask = np.arange(b) % 2 == 0
    return (tplas.SlotPlasticityState(T(tp), T(tq), T(w)), T(pre), T(post),
            T(mask))


@pytest.mark.parametrize("masked", [False, True])
def test_stdp_slot_cpu_takes_the_plain_version(masked):
    """CPU tensors run the kernel's plain version and launch nothing."""
    state, pre, post, mask = _slot_state(np.random.default_rng(11))
    mask = mask if masked else None
    before = slot_ops.stdp_slot.launches
    got = tplas.stdp_slot_step(state, pre, post, tplas.STDPConfig(),
                               mask=mask)
    want = stdp_slot_ref(state, pre, post, tplas.STDPConfig(), mask)
    assert slot_ops.stdp_slot.launches == before
    for field in STATE_FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def _needs_grad(state, pre, post, operand):
    """The operands with ``operand`` a leaf that requires grad."""
    args = dict(state=state, pre=pre, post=post)
    if operand in ("pre", "post"):
        args[operand] = args[operand].clone().requires_grad_(True)
    else:
        args["state"] = state._replace(
            **{operand: getattr(state, operand).clone().requires_grad_(True)})
    return args


GRAD_OPERANDS = ["weights", "trace_pre", "pre", "post"]


@pytest.mark.parametrize("operand", GRAD_OPERANDS)
def test_stdp_slot_gradient_on_the_cpu_takes_the_plain_version(operand):
    """On CPU tensors a call that needs a gradient runs the plain version,
    which keeps its ``grad_fn`` and equals the call without a gradient."""
    state, pre, post, mask = _slot_state(np.random.default_rng(14))
    args = _needs_grad(state, pre, post, operand)
    before = slot_ops.stdp_slot.launches
    got = tplas.stdp_slot_step(args["state"], args["pre"], args["post"],
                               tplas.STDPConfig(), mask=mask)
    assert slot_ops.stdp_slot.launches == before
    assert got.weights.grad_fn is not None
    want = stdp_slot_ref(state, pre, post, tplas.STDPConfig(), mask)
    for field in STATE_FIELDS:
        assert torch.equal(getattr(got, field).detach(),
                           getattr(want, field)), field


@pytest.mark.parametrize("operand", GRAD_OPERANDS)
def test_stdp_slot_gradient_on_the_card_raises(monkeypatch, operand):
    """Where the operands stand for card tensors, a call that needs a
    gradient raises before any launch (the kernel has no backward); the
    same call under ``no_grad`` reaches the launch, counted once."""
    state, pre, post, mask = _slot_state(np.random.default_rng(12))
    launched = []

    def fake_launch(*args):
        launched.append(args)
        with torch.no_grad():
            return stdp_slot_ref(*args)

    monkeypatch.setattr(slot_ops, "on_card", lambda *t: True)
    monkeypatch.setattr(slot_ops, "_launch", fake_launch)
    args = _needs_grad(state, pre, post, operand)
    before = slot_ops.stdp_slot.launches
    with pytest.raises(TypeError, match="stdp_slot has no backward"):
        tplas.stdp_slot_step(args["state"], args["pre"], args["post"],
                             tplas.STDPConfig(), mask=mask)
    assert not launched and slot_ops.stdp_slot.launches == before
    with torch.no_grad():
        tplas.stdp_slot_step(args["state"], args["pre"], args["post"],
                             tplas.STDPConfig(), mask=mask)
    assert len(launched) == 1 and slot_ops.stdp_slot.launches == before + 1


@pytest.mark.parametrize("case", ["trace_pre_shape", "post_shape",
                                  "weights_rank", "weights_float64",
                                  "pre_float16", "mask_length"])
def test_stdp_slot_rejects_bad_operands(case):
    state, pre, post, mask = _slot_state(np.random.default_rng(13))
    error = ValueError
    if case == "trace_pre_shape":
        state = state._replace(trace_pre=state.trace_pre[:, :, :-1])
    elif case == "post_shape":
        post = post[:, :3]
    elif case == "weights_rank":
        state = state._replace(weights=state.weights[:, 0])
    elif case == "weights_float64":
        state, error = state._replace(weights=state.weights.double()), \
            TypeError
    elif case == "pre_float16":
        pre, error = pre.half(), TypeError
    else:
        mask = mask[:-1]
    with pytest.raises(error):
        tplas.stdp_slot_step(state, pre, post, tplas.STDPConfig(), mask=mask)


def test_init_states_match():
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 15.0, (4, 32, 64)).astype(np.float32)
    for j_init, t_init in ((jplas.init_stream_stdp, tplas.init_stream_stdp),
                           (jplas.init_slot_stdp, tplas.init_slot_stdp)):
        ref, got = j_init(jnp.asarray(w), 3), t_init(T(w), 3)
        for field in STATE_FIELDS:
            r, g = np.asarray(getattr(ref, field)), getattr(got, field)
            assert g.dtype == torch.float32 and g.shape == r.shape, field
            np.testing.assert_array_equal(g.numpy(), r, err_msg=field)
    slot = tplas.init_slot_stdp(T(w), 3)
    slot.weights[0, 0] += 1.0                     # each slot owns its copy
    assert torch.equal(slot.weights[0, 1], T(w[0]))
    ref = jplas.init_stdp(32, 64)
    got = tplas.init_stdp(32, 64, device="cpu")
    for r, g in zip(ref, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_network_plasticity_inits_and_convert_match():
    cfg_j = jnet.NetworkConfig(n_chips=3, chip=jchip.ChipConfig(**SMALL_CHIP))
    params_j = jnet.init_feedforward(jax.random.PRNGKey(1), cfg_j)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    for j_init, t_init, conv in (
            (jnet.init_stream_plasticity, tnet.init_stream_plasticity,
             convert.stream_plasticity_from_numpy),
            (jnet.init_slot_plasticity, tnet.init_slot_plasticity,
             convert.slot_plasticity_from_numpy)):
        ref = j_init(params_j, BATCH)
        got = t_init(params_t, BATCH)
        assert type(got).__name__ == type(ref).__name__
        assert_state_equal(ref, got)
        assert_state_equal(ref, conv(flatten(ref), device="cpu"))


def test_init_stdp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplas.init_stdp(32, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.stream_plasticity_from_numpy(
            {f: np.zeros((1, 1, 1), np.float32) for f in STATE_FIELDS})


# ---------------------------------------------------------------------------
# The chip step with per-slot weights
# ---------------------------------------------------------------------------


def _chip_inputs(rng, n_chips, batch):
    sign = np.where(rng.random((n_chips, 32)) < 0.8, 1.0, -1.0).astype(
        np.float32)
    v = rng.uniform(-0.5, 1.0, (n_chips, batch, 64)).astype(np.float32)
    i = rng.uniform(-1.0, 2.0, (n_chips, batch, 64)).astype(np.float32)
    a = rng.uniform(0.0, 0.3, (n_chips, batch, 64)).astype(np.float32)
    r = rng.integers(0, 3, (n_chips, batch, 64)).astype(np.int32)
    drive = (rng.integers(0, 40, (n_chips, batch, 32)) / 16).astype(
        np.float32)
    w = rng.uniform(0.0, 63.0, (n_chips, batch, 32, 64)).astype(np.float32)
    return sign, (v, i, a, r), drive, w


def test_chip_step_slots_matches():
    rng = np.random.default_rng(11)
    n_chips, batch = 3, 4
    sign, state, drive, w = _chip_inputs(rng, n_chips, batch)
    scale = np.full(n_chips, 2.0 ** -8, np.float32)
    shared_w = w[:, 0]
    jp = jchip.ChipParams(*map(jnp.asarray, (shared_w, sign, scale)))
    ref_state, ref_spk = jax.vmap(
        lambda p, s, d, ww: jchip.chip_step_slots(
            p, s, d, ww, jchip.ChipConfig(**SMALL_CHIP)))(
        jp, jchip.ChipState(jnrn.NeuronState(*map(jnp.asarray, state))),
        jnp.asarray(drive), jnp.asarray(w))
    got_state, got_spk = tchip.chip_step_slots(
        tchip.ChipParams(T(shared_w), T(sign), T(scale)),
        tchip.ChipState(tnrn.NeuronState(*map(T, state))), T(drive), T(w),
        tchip.ChipConfig(**SMALL_CHIP))
    # Dyadic product: the currents are exact; the neuron update rounds as
    # in test_torch_stream.py's chip step (within 1e-6).
    for f in ("v", "i_syn", "w_adapt"):
        np.testing.assert_allclose(
            getattr(got_state.neurons, f).numpy(),
            np.asarray(getattr(ref_state.neurons, f)), rtol=0, atol=1e-6,
            err_msg=f)
    cur = tchip.synapse_current(tchip.ChipParams(T(shared_w), T(sign),
                                                 T(scale)),
                                T(drive), tchip.ChipConfig(**SMALL_CHIP),
                                T(w))
    ref_cur = jnp.einsum("cbr,cbrn->cbn", jnp.asarray(drive), jnp.asarray(
        jnp.round(jnp.clip(jnp.asarray(w), 0, 63)) * 2.0 ** -8
        * jnp.asarray(sign)[:, None, :, None]))
    np.testing.assert_array_equal(cur.numpy(), np.asarray(ref_cur))
    _, v = tnrn.membrane(tnrn.NeuronState(*map(T, state)), cur,
                         tnrn.LIF)
    clear = (v - tnrn.LIF.v_th).abs().numpy() > 1e-6
    np.testing.assert_array_equal(got_spk.numpy()[clear],
                                  np.asarray(ref_spk)[clear])


@pytest.mark.parametrize("quantize", [True, False])
def test_chip_step_slots_equals_batch_one_chip_step(quantize):
    """Each slot equals a batch-1 ``chip_step`` on its own weights, bit
    for bit, at the default (non-dyadic) weight scale."""
    rng = np.random.default_rng(12 + quantize)
    n_chips, batch = 5, 3
    cfg = tchip.ChipConfig(**SMALL_CHIP, quantize_weights=quantize)
    sign, state, drive, w = _chip_inputs(rng, n_chips, batch)
    drive = drive + rng.random(drive.shape).astype(np.float32)
    params = tchip.init_params(n_chips, cfg, torch.Generator().manual_seed(0))
    params = params._replace(row_sign=T(sign))
    state_t = tchip.ChipState(tnrn.NeuronState(*map(T, state)))
    slots_state, slots_spk = tchip.chip_step_slots(params, state_t, T(drive),
                                                   T(w), cfg)
    for b in range(batch):
        one = tchip.ChipState(tnrn.NeuronState(
            *(x[:, b:b + 1] for x in state_t.neurons)))
        one_state, one_spk = tchip.chip_step(
            params._replace(weights=T(w[:, b])), one, T(drive[:, b:b + 1]),
            cfg)
        parity.assert_equal(f"slot {b} spikes", one_spk,
                            slots_spk[:, b:b + 1])
        for f, x, y in zip(tnrn.NeuronState._fields, one_state.neurons,
                           slots_state.neurons):
            parity.assert_equal(f"slot {b} {f}", x, y[:, b:b + 1])


def test_crossbar_to_rows_matches():
    rng = np.random.default_rng(13)
    spk = (rng.random((3, 2, 64)) < 0.4).astype(np.float32)
    select = (rng.random((64, 32)) < 0.1).astype(np.float32)
    ref = jchip.crossbar_to_rows(jnp.asarray(spk), jnp.asarray(select))
    got = tchip.crossbar_to_rows(T(spk), T(select))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# run_stream with plasticity and slot masks
# ---------------------------------------------------------------------------


def stream_case(name, dt_us=None):
    """Both packages' network at SMALL_CHIP with dyadic weights."""
    cfg_j, params_j, plan_j = jsc.engine_network(
        name, chip=jchip.ChipConfig(**SMALL_CHIP))
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -8)))
    cfg_t, _, plan_t = tsc.engine_network(
        name, chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    if dt_us is not None:
        cfg_j = dataclasses.replace(cfg_j, dt_us=dt_us)
        cfg_t = dataclasses.replace(cfg_t, dt_us=dt_us)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    return cfg_j, params_j, plan_j, cfg_t, params_t, plan_t


def stream_inputs(cfg, n_steps, seed, batch=BATCH, p=0.4):
    """Dyadic drives and a slot mask that idles every slot for a while."""
    rng = np.random.default_rng(seed)
    shape = (n_steps, cfg.n_chips, batch, cfg.chip.n_rows)
    drives = ((rng.random(shape) < p)
              * rng.integers(8, 64, shape) / 16).astype(np.float32)
    mask = np.ones((n_steps, batch), bool)
    for b in range(batch):
        start = (b * 3 + 1) % max(n_steps - 2, 1)
        mask[start:start + 3, b] = False
    return drives, mask


def initial_plasticity(params_j, per_slot, batch=BATCH):
    ps_j = (jnet.init_slot_plasticity if per_slot
            else jnet.init_stream_plasticity)(params_j, batch)
    ps_t = (convert.slot_plasticity_from_numpy if per_slot
            else convert.stream_plasticity_from_numpy)(flatten(ps_j),
                                                       device="cpu")
    return ps_j, ps_t


def plastic_margins(params_j, params_t, state_j, ps_j, drives, mask, cfg_j,
                    cfg_t, **kw):
    """``margin_at(t)``: the reference's margin entering step ``t``, on the
    weights that step integrates (shared or per slot)."""
    def margin_at(t):
        if t:
            out = jstream.run_stream(
                params_j, state_j, jnp.asarray(drives[:t]), cfg_j,
                plasticity=jplas.STDPConfig(), plasticity_state=ps_j,
                slot_mask=jnp.asarray(mask[:t]), **kw)
            before, weights = out.state, out.plasticity.weights
        else:
            before, weights = state_j, ps_j.weights
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device="cpu"),
            torch.from_numpy(drives[t]), cfg_t, weights=T(weights))
    return margin_at


def hold_plastic(ref, got, margin_at, what):
    report = parity.compare_streams(ref, got, margin_at)
    print(f"{what}: {report}")
    assert type(got.plasticity).__name__ == type(ref.plasticity).__name__
    assert float(got.spikes.sum()) > 0
    return report


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("name", ["FULL_BACKPLANE", "PROJECTED_120CHIP",
                                  "EXT_4CASE_96CHIP"])
def test_run_stream_plasticity_matches_reference(name, timed, per_slot):
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(name)
    drives, mask = stream_inputs(cfg_j, STEPS, [len(name), timed, per_slot])
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    ps_j, ps_t = initial_plasticity(params_j, per_slot)
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, timed=timed,
                             plasticity=jplas.STDPConfig(),
                             plasticity_state=ps_j,
                             slot_mask=jnp.asarray(mask))
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             fabric=plan_t, timed=timed,
                             plasticity=tplas.STDPConfig(),
                             plasticity_state=ps_t, slot_mask=T(mask),
                             device="cpu")
    hold_plastic(ref, got, plastic_margins(
        params_j, params_t, state_j, ps_j, drives, mask, cfg_j, cfg_t,
        fabric=plan_j), f"{name}/timed={timed}/per_slot={per_slot}")
    # The weights moved, and masked slots sent nothing.
    assert not torch.equal(got.plasticity.weights, ps_t.weights)
    assert float(got.spikes.transpose(1, 2)[~T(mask)].sum()) == 0


def test_run_stream_plasticity_default_state_matches_reference():
    """Without ``plasticity_state`` the run starts from zero traces over
    ``params.chips.weights``; without ``slot_mask`` nothing is masked."""
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(
        "FULL_BACKPLANE")
    drives, mask = stream_inputs(cfg_j, STEPS, 31)
    mask[:] = True
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, plasticity=jplas.STDPConfig())
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             fabric=plan_t, plasticity=tplas.STDPConfig(),
                             device="cpu")
    ps_j = jnet.init_stream_plasticity(params_j, BATCH)
    hold_plastic(ref, got, plastic_margins(
        params_j, params_t, state_j, ps_j, drives, mask, cfg_j, cfg_t,
        fabric=plan_j), "FULL_BACKPLANE default plasticity state")
    plain = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                               fabric=plan_t, device="cpu")
    assert plain.plasticity is None


@pytest.mark.parametrize("per_slot", [False, True])
def test_run_stream_plasticity_overlap_matches_reference(per_slot):
    """Overlap at 0.25 us steps (delay 4): deferred spikes were masked when
    they were produced; the port's overlap run equals the reference's and
    its own plain loop."""
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(
        "EXT_4CASE_96CHIP", dt_us=0.25)
    drives, mask = stream_inputs(cfg_j, STEPS, 41 + per_slot)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    ps_j, ps_t = initial_plasticity(params_j, per_slot)
    kw_t = dict(fabric=plan_t, timed=True, plasticity=tplas.STDPConfig(),
                plasticity_state=ps_t, slot_mask=T(mask), device="cpu")
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             fabric=plan_j, timed=True, overlap=True,
                             plasticity=jplas.STDPConfig(),
                             plasticity_state=ps_j,
                             slot_mask=jnp.asarray(mask))
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             overlap=True, **kw_t)
    hold_plastic(ref, got, plastic_margins(
        params_j, params_t, state_j, ps_j, drives, mask, cfg_j, cfg_t,
        fabric=plan_j), f"overlap/per_slot={per_slot}")
    plain = tstream.run_stream(params_t, state_t, T(drives), cfg_t, **kw_t)
    assert_same_run(plain, got, "overlap against plain")


@pytest.mark.parametrize("fault_mode", ["mask", "reroute"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_run_stream_plasticity_faults_match_reference(per_slot, fault_mode):
    """Faults in both modes: the plasticity state crosses reroute segments
    untouched."""
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(
        "EXT_4CASE_96CHIP")
    rows = ((1, 0, 2, 5, "uplink"), (0, 3, 4, None, "downlink"))
    faults_j = [jfab.FaultEvent(*r) for r in rows]
    faults_t = [tfab.FaultEvent(*r) for r in rows]
    drives, mask = stream_inputs(cfg_j, STEPS, 51 + per_slot)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    ps_j, ps_t = initial_plasticity(params_j, per_slot)
    kw_j = dict(fabric=plan_j, timed=True, faults=faults_j,
                fault_mode=fault_mode)
    ref = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                             plasticity=jplas.STDPConfig(),
                             plasticity_state=ps_j,
                             slot_mask=jnp.asarray(mask), **kw_j)
    got = tstream.run_stream(params_t, state_t, T(drives), cfg_t,
                             fabric=plan_t, timed=True, faults=faults_t,
                             fault_mode=fault_mode,
                             plasticity=tplas.STDPConfig(),
                             plasticity_state=ps_t, slot_mask=T(mask),
                             device="cpu")
    hold_plastic(ref, got, plastic_margins(
        params_j, params_t, state_j, ps_j, drives, mask, cfg_j, cfg_t,
        **kw_j), f"faults {fault_mode}/per_slot={per_slot}")
    assert int(got.unroutable.sum()) > 0


def assert_same_run(a, b, what):
    """Two plastic runs of the port, equal bit for bit in every output,
    the final state and the plasticity state."""
    assert_same_outputs(a, b, what)
    assert_state_equal(a.plasticity, b.plasticity, f"{what} plasticity ")


@pytest.mark.parametrize("per_slot", [False, True])
def test_chained_windows_equal_one_run(per_slot):
    """Two windows chained through the returned state and plasticity state
    equal one long run bit for bit; the reference's property
    (``tests/test_stream.py``), in the port."""
    cfg, params, plan = tsc.engine_network(
        "EXT_4CASE_96CHIP", chip=tchip.ChipConfig(**SMALL_CHIP),
        device="cpu")
    drives, mask = stream_inputs(cfg, 2 * STEPS, 61 + per_slot)
    drives, mask = T(drives), T(mask)
    state = tnet.init_state(cfg, BATCH, device="cpu")
    ps = (tnet.init_slot_plasticity if per_slot
          else tnet.init_stream_plasticity)(params, BATCH)
    kw = dict(fabric=plan, timed=True, plasticity=tplas.STDPConfig(),
              device="cpu")
    whole = tstream.run_stream(params, state, drives, cfg,
                               plasticity_state=ps, slot_mask=mask, **kw)
    first = tstream.run_stream(params, state, drives[:STEPS], cfg,
                               plasticity_state=ps, slot_mask=mask[:STEPS],
                               **kw)
    second = tstream.run_stream(params, first.state, drives[STEPS:], cfg,
                                plasticity_state=first.plasticity,
                                slot_mask=mask[STEPS:], **kw)
    joined = second._replace(**{f: torch.cat([getattr(first, f),
                                              getattr(second, f)])
                                for f in OUT_FIELDS})
    assert_same_run(whole, joined, "chained windows")


def test_slot_rows_equal_batch_one_runs():
    """Per-slot plasticity at batch 3 equals three batch-1 runs, bit for
    bit, at the default (non-dyadic) weight scale and with each row's
    own slot mask."""
    cfg, params, plan = tsc.engine_network(
        "FULL_BACKPLANE", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    batch = 3
    drives, mask = stream_inputs(cfg, STEPS, 71, batch=batch)
    drives, mask = T(drives), T(mask)
    state = tnet.init_state(cfg, batch, device="cpu")
    kw = dict(fabric=plan, timed=True, plasticity=tplas.STDPConfig(),
              device="cpu")
    together = tstream.run_stream(
        params, state, drives, cfg, slot_mask=mask,
        plasticity_state=tnet.init_slot_plasticity(params, batch), **kw)
    assert float(together.spikes.sum()) > 0
    one_state = tnet.init_state(cfg, 1, device="cpu")
    for b in range(batch):
        alone = tstream.run_stream(
            params, one_state, drives[:, :, b:b + 1], cfg,
            slot_mask=mask[:, b:b + 1],
            plasticity_state=tnet.init_slot_plasticity(params, 1), **kw)
        for f in OUT_FIELDS:
            parity.assert_equal(f"row {b} {f}", getattr(alone, f),
                                getattr(together, f)[:, :, b:b + 1])
        for field in STATE_FIELDS:
            parity.assert_equal(
                f"row {b} {field}", getattr(alone.plasticity, field),
                getattr(together.plasticity, field)[:, b:b + 1])


def test_masked_slots_freeze_under_per_slot_plasticity():
    """A slot masked over a window emits nothing there (no events, no
    drops), and its traces and weights do not change over it."""
    cfg, params, plan = tsc.engine_network(
        "FULL_BACKPLANE", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    drives, _ = stream_inputs(cfg, STEPS, 81, p=0.6)
    drives = T(drives)
    mask = torch.ones((STEPS, BATCH), dtype=torch.bool)
    mask[2:6, 1] = False
    state = tnet.init_state(cfg, BATCH, device="cpu")
    kw = dict(fabric=plan, plasticity=tplas.STDPConfig(), device="cpu")
    ps = tnet.init_slot_plasticity(params, BATCH)
    head = tstream.run_stream(params, state, drives[:2], cfg,
                              plasticity_state=ps, slot_mask=mask[:2], **kw)
    mid = tstream.run_stream(params, head.state, drives[2:6], cfg,
                             plasticity_state=head.plasticity,
                             slot_mask=mask[2:6], **kw)
    assert float(mid.spikes[:, :, 1].sum()) == 0
    assert int(mid.dropped[:, :, 1].sum()) == 0
    assert float(mid.spikes[:, :, 0].sum()) > 0
    for field in STATE_FIELDS:
        parity.assert_equal(f"frozen {field}",
                            getattr(head.plasticity, field)[:, 1],
                            getattr(mid.plasticity, field)[:, 1])
        assert not torch.equal(getattr(head.plasticity, field)[:, 0],
                               getattr(mid.plasticity, field)[:, 0]), field


@pytest.mark.parametrize("per_slot", [False, True])
def test_run_stream_leaves_the_callers_state_untouched(per_slot):
    cfg, params, plan = tsc.engine_network(
        "FULL_BACKPLANE", chip=tchip.ChipConfig(**SMALL_CHIP), device="cpu")
    drives, mask = stream_inputs(cfg, STEPS, 91)
    state = tnet.init_state(cfg, BATCH, device="cpu")
    ps = (tnet.init_slot_plasticity if per_slot
          else tnet.init_stream_plasticity)(params, BATCH)
    ps = type(ps)(*(x + 0.25 for x in ps))       # non-zero traces
    before = [x.clone() for x in ps]
    weights = params.chips.weights.clone()
    out = tstream.run_stream(params, state, T(drives), cfg, fabric=plan,
                             plasticity=tplas.STDPConfig(),
                             plasticity_state=ps, slot_mask=T(mask),
                             device="cpu")
    for field, x, y in zip(STATE_FIELDS, before, ps, strict=True):
        parity.assert_equal(f"caller's {field}", x, y)
    parity.assert_equal("params weights", weights, params.chips.weights)
    assert not torch.equal(out.plasticity.weights, ps.weights)


@pytest.mark.parametrize("case", ["state_without_plasticity",
                                  "mask_shape", "fault_mode_first",
                                  "state_before_mask", "mask_before_overlap"])
def test_run_stream_plasticity_errors_match_reference(case):
    """The reference's ValueErrors, with its messages, in its order: after
    the fault_mode check, before the overlap checks."""
    cfg_j = jnet.NetworkConfig(n_chips=2, chip=jchip.ChipConfig(**SMALL_CHIP))
    cfg_t = tnet.NetworkConfig(n_chips=2, chip=tchip.ChipConfig(**SMALL_CHIP))
    params_j = jnet.init_feedforward(jax.random.PRNGKey(0), cfg_j)
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device="cpu")
    state_j = jnet.init_state(cfg_j, 2)
    state_t = convert.network_state_from_numpy(flatten(state_j), device="cpu")
    drives = np.zeros((3, 2, 2, 32), np.float32)
    ps_j = jnet.init_stream_plasticity(params_j, 2)
    ps_t = tnet.init_stream_plasticity(params_t, 2)
    bad_mask = np.ones((3, 3), bool)
    kw = {"state_without_plasticity": dict(plasticity_state=True),
          "mask_shape": dict(slot_mask=bad_mask),
          "fault_mode_first": dict(fault_mode="both", plasticity_state=True),
          "state_before_mask": dict(plasticity_state=True,
                                    slot_mask=bad_mask),
          "mask_before_overlap": dict(slot_mask=bad_mask,
                                      overlap=True)}[case]

    def args(pkg):
        out = dict(kw)
        if "plasticity_state" in out:
            out["plasticity_state"] = ps_j if pkg == "j" else ps_t
        if "slot_mask" in out:
            out["slot_mask"] = (jnp.asarray(bad_mask) if pkg == "j"
                                else T(bad_mask))
        return out

    with pytest.raises(ValueError) as ref:
        jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                           **args("j"))
    with pytest.raises(ValueError) as got:
        tstream.run_stream(params_t, state_t, T(drives), cfg_t, device="cpu",
                           **args("t"))
    assert str(got.value) == str(ref.value)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels); "
                    "run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_slot", [False, True])
def test_plastic_run_card_matches_cpu(cuda_device, per_slot):
    """The plastic, masked run on the card (the exchange and merge-pack
    kernels) against the CPU: integer outputs equal up to near-threshold
    flips on the evolving weights, plasticity state within
    PLASTICITY_ATOL."""
    runs = {}
    for dev in ("cpu", cuda_device):
        cfg, params, plan = tsc.engine_network(
            "EXT_4CASE_96CHIP", chip=tchip.ChipConfig(**SMALL_CHIP),
            device=dev)
        params = params._replace(chips=params.chips._replace(
            w_scale=torch.full_like(params.chips.w_scale, 2.0 ** -8)))
        drives, mask = stream_inputs(cfg, STEPS, 101)
        state = tnet.init_state(cfg, BATCH, device=dev)
        ps = (tnet.init_slot_plasticity if per_slot
              else tnet.init_stream_plasticity)(params, BATCH)
        runs[str(dev)] = (params, plan, state, ps, tstream.run_stream(
            params, state, T(drives), cfg, fabric=plan, timed=True,
            plasticity=tplas.STDPConfig(), plasticity_state=ps,
            slot_mask=T(mask), device=dev))
    params, plan, state, ps, cpu = runs["cpu"]

    def margin_at(t):
        before = (tstream.run_stream(
            params, state, T(drives[:t]), cfg, fabric=plan, device="cpu",
            plasticity=tplas.STDPConfig(), plasticity_state=ps,
            slot_mask=T(mask[:t])) if t else None)
        return parity.spike_margin(
            params, before.state if t else state, T(drives[t]), cfg,
            weights=before.plasticity.weights if t else ps.weights)

    print(parity.compare_streams(cpu, runs[str(cuda_device)][-1], margin_at))


def test_midpoint_finder_catches_the_double_rounding():
    """The card test's excuse, on a constructed case: ``a·b + c`` lies
    2^-70 under the float32 midpoint 1 + 3·2^-24, so one fused rounding
    gives 1 + 2^-23; the plain version's float64 sum lands on the
    midpoint and rounds to even, 1 + 2^-22.  The finder flags it, and
    neither an exact sum nor one that is itself a midpoint."""
    a = 1.0 + 2.0 ** -23
    b = torch.tensor([(1.0 - 2.0 ** -23) * 2.0 ** -24, 2.0 ** -24, 0.5])
    c = torch.full((3,), 1.0 + 2.0 ** -23)
    plain = tplas._fma(a, b, c)
    assert plain[0].item() == 1.0 + 2.0 ** -22
    assert float32_midpoint(a, b, c).tolist() == [True, False, False]


def test_midpoints_excuse_nothing_in_a_frozen_slot(monkeypatch):
    """``midpoints`` joins the midpoints behind each value (here every sum
    is taken for one) and clears the slots the mask freezes: a frozen
    slot's traces and weights are copies, never a rounding."""
    state, pre, post, mask = _slot_state(np.random.default_rng(15))
    monkeypatch.setattr(slot_ref, "float32_midpoint",
                        lambda a, b, c: torch.ones(torch.broadcast_shapes(
                            b.shape, c.shape), dtype=torch.bool))
    got = midpoints(state, pre, post, tplas.STDPConfig(), mask)
    for field in STATE_FIELDS:
        excused = got[field]
        assert excused.shape == getattr(state, field).shape, field
        assert bool(excused[:, mask].all()), field
        assert not bool(excused[:, ~mask].any()), field


def _card_slot_inputs(device, c, b, r, n, *, masked, on_bounds, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, hi):
        return torch.rand(shape, generator=g, device=device) * hi

    # Drives in multiples of 1/16 (as the stream's), 8x larger where the
    # updates are to clip at both bounds.
    top = 512 if on_bounds else 64
    pre = ((uniform((c, b, r), 1.0) < 0.5) * torch.randint(
        1, top, (c, b, r), generator=g, device=device) / 16).float()
    post = (uniform((c, b, n), 1.0) < 0.3).float()
    w = uniform((c, b, r, n), 63.0)
    if on_bounds:
        flat = w.view(-1)
        flat[::5] = 0.0
        flat[3::7] = 63.0
    state = tplas.SlotPlasticityState(uniform((c, b, r), 3.0),
                                      uniform((c, b, n), 3.0), w)
    mask = None
    if masked:
        mask = torch.arange(b, device=device) % 3 != 1
    return state, pre, post, mask


SLOT_CASES = {  # (chips, batch, rows, neurons, masked, on_bounds)
    "engine": (4, 8, 256, 512, False, False),
    "engine_masked": (4, 8, 256, 512, True, False),
    "batch1": (8, 1, 256, 512, False, False),
    "bounds_masked": (2, 4, 256, 512, True, True),
    "ragged_masked": (2, 3, 30, 62, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLOT_CASES)
def test_stdp_slot_kernel_equals_plain_bit_for_bit(cuda_device, case):
    """The kernel against its plain version on the same card inputs: the
    engine's layout at a reduced size and at batch 1, masked and not,
    weights on 0 and 63 with updates that clip at both bounds, and a
    ragged shape (rows and neurons not multiples of the kernel's tiles).
    Traces and weights equal bit for bit, except where a float64 sum of
    the plain version lies on a float32 rounding midpoint; each such
    difference is reported."""
    c, b, r, n, masked, on_bounds = SLOT_CASES[case]
    cfg = tplas.STDPConfig()
    state, pre, post, mask = _card_slot_inputs(
        cuda_device, c, b, r, n, masked=masked, on_bounds=on_bounds,
        seed=sum(SLOT_CASES[case][:4]))
    inputs = [x.clone() for x in (*state, pre, post)]
    before = slot_ops.stdp_slot.launches
    with torch.no_grad():
        got = tplas.stdp_slot_step(state, pre, post, cfg, mask=mask)
        want = stdp_slot_ref(state, pre, post, cfg, mask)
    torch.cuda.synchronize()
    assert slot_ops.stdp_slot.launches == before + 1
    for x, y in zip(inputs, (*state, pre, post), strict=True):
        assert torch.equal(x, y), "the kernel wrote an input"
    # Where the plain version's float64 sums lie on a float32 midpoint.
    allowed = midpoints(state, pre, post, cfg, mask)
    for field, may_differ in allowed.items():
        g, w = getattr(got, field), getattr(want, field)
        differ = g.view(torch.int32) != w.view(torch.int32)
        for at in differ.nonzero()[:16].tolist():
            print(f"{case} {field}{at}: kernel {g[tuple(at)].item()!r} "
                  f"plain {w[tuple(at)].item()!r} midpoint "
                  f"{bool(may_differ[tuple(at)])}")
        print(f"{case} {field}: {int(differ.sum())} of {differ.numel()} "
              f"differ, {int((differ & may_differ).sum())} on a midpoint")
        assert not bool((differ & ~may_differ).any()), field
    if on_bounds:
        w0, w1 = state.weights, got.weights
        assert bool(((w0 > 0) & (w1 == 0)).any())
        assert bool(((w0 < 63) & (w1 == 63)).any())
    if masked:
        frozen = ~mask.cpu()
        for field in STATE_FIELDS:
            assert torch.equal(getattr(got, field)[:, frozen],
                               getattr(state, field)[:, frozen]), field


@pytest.mark.cuda
def test_engine_window_launches_the_kernel_once_a_step(cuda_device):
    """One engine window with per-slot plasticity on the card launches the
    slot kernel once for each of its steps."""
    cfg, params, plan = tsc.engine_network(
        "EXT_4CASE_96CHIP", chip=tchip.ChipConfig(**SMALL_CHIP),
        device=cuda_device)
    window = 8
    eng = EmulationEngine(params, cfg, slots=4, max_steps=2 * window,
                          plan=plan, window=window, timed=True,
                          plasticity=tplas.STDPConfig(), device=cuda_device)
    rng = np.random.default_rng(5)
    for length in (5, 8, 12, 16):
        eng.submit((rng.random((length, cfg.chip.n_rows)) < 0.3)
                   .astype(np.float32))
    before = slot_ops.stdp_slot.launches
    eng.step()
    torch.cuda.synchronize()
    assert slot_ops.stdp_slot.launches == before + window
