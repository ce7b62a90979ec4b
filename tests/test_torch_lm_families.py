"""The port's RWKV6, dense and MoE LM families against the JAX package.

Six architectures: rwkv6-7b (the RWKV6 cell and the linear-scan kernel's
``bonus`` mode), smollm-135m, phi3-medium-14b, gemma-7b and qwen3-8b (the
GQA + MLP stack at head dims 16 under the smoke reduction, GQA groups,
GeGLU, qk-norm, tied heads) and grok-1-314b (the MoE layer).  Weights come
from the JAX ``init_params``, flattened to ``{pytree path: numpy}`` and
loaded by ``repro_torch.convert``; prompts and activations are drawn with
numpy.  The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="pallas"``) or its plain XLA path (``"xla"``); the port
runs the plain PyTorch versions of its kernels on the CPU.

Tolerances (``tests/test_torch_serve.py``): ``LOGIT_TOL`` 1e-4 on float32
logits, ``CACHE_TOL`` 1e-5 on float32 caches and module outputs (both
relative and absolute), ``BF16_LOGIT_TOL`` 3e-2 on bf16 prefill logits.
Greedy tokens are equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.base import count_params as jcount_params
from repro.core.events import CapacityPolicy as JCapacityPolicy
from repro.launch.serve import _splice_prefill as jsplice
from repro.launch.serve import generate as jgenerate
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.layers import Param
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig, count_params
from repro_torch.core.events import CapacityPolicy
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from test_torch_serve import (BF16_LOGIT_TOL, CACHE_TOL, LOGIT_TOL, _close,
                              _t, flatten)
from torch_threads import share_cores

share_cores()

KEY = jax.random.key(11)
ARCHS = ("rwkv6-7b", "smollm-135m", "phi3-medium-14b", "gemma-7b",
         "qwen3-8b", "grok-1-314b")
# Published sizes (count_params, both packages): the registry holds the
# full-size configs, not smoke ones.  The configs of deepseek-v2, whisper
# and llava are checked here, their modules in test_torch_lm_mla_encdec.py.
PARAMS_RANGE = {"rwkv6-7b": (7.5e9, 8.5e9), "smollm-135m": (1.3e8, 1.4e8),
                "phi3-medium-14b": (1.4e10, 1.5e10),
                "gemma-7b": (8.4e9, 8.6e9), "qwen3-8b": (8.1e9, 8.3e9),
                "grok-1-314b": (3.1e11, 3.2e11),
                "deepseek-v2-236b": (2.35e11, 2.36e11),
                "whisper-medium": (7.5e8, 7.6e8),
                "llava-next-mistral-7b": (7.1e9, 7.2e9)}
# Active parameters (routed top-k + shared experts) of the MoE configs.
ACTIVE_RANGE = {"deepseek-v2-236b": (2.13e10, 2.15e10)}


def configs(arch, dtype="float32", impl="pallas", **overrides):
    """The same smoke config of ``arch`` in both packages."""
    jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)), dtype=dtype,
                               attention_impl=impl, **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jp):
    return {k: torch.from_numpy(v) for k, v in flatten(jp).items()}


def _cache_leaves(caches) -> dict:
    """A port cache tree as ``{dotted path: tensor}``, the JAX tree's
    paths."""
    out = {}
    for seg, c in caches.items():
        for f, v in zip(c._fields, c):
            out[f"{seg}.{f}"] = v
    return out


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(PARAMS_RANGE))
def test_config_copies_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)
    assert count_params(cfg, active_only=True) == \
        jcount_params(jcfg, active_only=True)
    assert dataclasses.asdict(smoke_config(cfg)) == \
        dataclasses.asdict(jsmoke_config(jcfg))
    lo, hi = PARAMS_RANGE[arch]
    assert lo < count_params(cfg) < hi
    if arch in ACTIVE_RANGE:
        lo, hi = ACTIVE_RANGE[arch]
        assert lo < count_params(cfg, active_only=True) < hi


def test_capacity_policy_matches_jax():
    for mode in ("strict", "provisioned"):
        for headroom in (1.0, 1.5, 2.0):
            for n in (0, 3, 7, 8, 100, 1001):
                assert CapacityPolicy(mode, headroom).capacity_for(n) == \
                    JCapacityPolicy(mode, headroom).capacity_for(n)


# ---------------------------------------------------------------------------
# RWKV6 modules
# ---------------------------------------------------------------------------


def _rwkv6_params(jcfg, rng):
    """Time-mix parameters with a non-zero bonus u (the init's is zeros)."""
    jp = jssm.init_rwkv6(KEY, jcfg)
    u = (0.5 * rng.standard_normal(jp["u"].value.shape)).astype(np.float32)
    jp["u"] = Param(jnp.asarray(u), jp["u"].axes)
    return jp


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rwkv6_time_mix_matches_jax(impl):
    """Train, prefill (output, state and shift) and one decode step from
    the prefill's cache, with a non-zero bonus u."""
    jcfg, cfg = configs("rwkv6-7b", impl=impl)
    rng = np.random.default_rng(5)
    jp = _rwkv6_params(jcfg, rng)
    tp = _params(jp)
    b, s = 2, 19
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)

    jout, _ = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jcfg, mode="train")
    tout, tcache = tssm.rwkv6_time_mix(tp, _t(x), cfg, mode="train")
    assert tcache is None
    _close("train out", tout, jout, CACHE_TOL)

    jout, jcache = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jcfg,
                                       mode="prefill")
    tout, tcache = tssm.rwkv6_time_mix(tp, _t(x), cfg, mode="prefill")
    _close("prefill out", tout, jout, CACHE_TOL)
    _close("prefill shift", tcache.conv, jcache.conv, CACHE_TOL)
    _close("prefill state", tcache.state, jcache.state, CACHE_TOL)

    # The bonus term matters: the same input with u = 0 gives another out.
    tp0 = {**tp, "u": torch.zeros_like(tp["u"])}
    tout0, _ = tssm.rwkv6_time_mix(tp0, _t(x), cfg, mode="prefill")
    assert float((tout0 - tout).abs().max()) > 1e-3

    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jout, jnew = jssm.rwkv6_time_mix(jp, jnp.asarray(x1), jcfg, mode="decode",
                                     cache=jcache)
    tout, tnew = tssm.rwkv6_time_mix(tp, _t(x1), cfg, mode="decode",
                                     cache=tcache)
    _close("decode out", tout, jout, CACHE_TOL)
    _close("decode shift", tnew.conv, jnew.conv, CACHE_TOL)
    _close("decode state", tnew.state, jnew.state, CACHE_TOL)


@pytest.mark.parametrize("with_shift", [False, True])
def test_rwkv6_channel_mix_matches_jax(with_shift):
    jcfg, cfg = configs("rwkv6-7b")
    jp = jssm.init_rwkv6_channel_mix(KEY, jcfg)
    tp = _params(jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) \
        if with_shift else None
    jout, jshift = jssm.rwkv6_channel_mix(
        jp, jnp.asarray(x), jcfg,
        shift_state=None if shift is None else jnp.asarray(shift))
    tout, tshift = tssm.rwkv6_channel_mix(
        tp, _t(x), cfg, shift_state=None if shift is None else _t(shift))
    _close("channel mix out", tout, jout, CACHE_TOL)
    _close("channel mix shift", tshift, jshift, CACHE_TOL)


def test_rwkv6_cache_layout_matches_jax():
    jcfg, cfg = configs("rwkv6-7b", dtype="bfloat16")
    jc = jssm.init_rwkv6_cache(jcfg, 3, jnp.bfloat16)
    tc = tssm.init_rwkv6_cache(cfg, 3, torch.bfloat16, "cpu")
    assert tc.conv.dtype == torch.bfloat16 and tc.state.dtype == torch.float32
    assert tuple(tc.conv.shape) == jc.conv.shape
    assert tuple(tc.state.shape) == jc.state.shape
    jstack = JM.init_cache(jcfg, 3, 9)
    tstack = TM.init_cache(cfg, 3, 9, "cpu")
    want = flatten(jstack)
    got = _cache_leaves(tstack)
    assert set(got) == set(want) == {"layers.conv", "layers.state"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()


# ---------------------------------------------------------------------------
# The slices: prefill, decode and generate
# ---------------------------------------------------------------------------


def _slice(arch, dtype="float32", impl="pallas", **overrides):
    jcfg, cfg = configs(arch, dtype=dtype, impl=impl, **overrides)
    jparams = JM.init_params(KEY, jcfg)
    params = convert.lm_params_from_numpy(flatten(jparams), cfg, device="cpu")
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 20)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_matches_jax(arch, impl):
    """Prefill logits and every cache leaf, one decode step from the JAX
    side's spliced caches, and 4 greedy tokens of ``serve.generate``."""
    jcfg, cfg, jparams, params, prompts = _slice(arch, impl=impl)
    assert {n for n, _ in params.named_parameters()} == set(flatten(jparams))
    jlogits, jcaches, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                     jcfg)
    before = (tflash.flash_attention.launches, tscan.linear_scan.launches)
    logits, caches, _ = TM.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, cfg)
    assert (tflash.flash_attention.launches,
            tscan.linear_scan.launches) == before      # the CPU never launches
    _close("prefill logits", logits, jlogits, LOGIT_TOL)
    want, got = flatten(jcaches), _cache_leaves(caches)
    assert set(got) == set(want)
    for k in want:
        _close(f"cache {k}", got[k], want[k], CACHE_TOL)

    s, max_len = prompts.shape[1], prompts.shape[1] + 4
    jdec = jsplice(jcfg, JM.init_cache(jcfg, 2, max_len), jcaches, s)
    tdec = convert.lm_caches_from_numpy(flatten(jdec), cfg, device="cpu")
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jl2, jdec2 = JM.decode_step(jparams, jnp.asarray(tok), jdec, s, jcfg)
    tl2, tdec2 = TM.decode_step(params, torch.from_numpy(tok), tdec, s, cfg)
    _close("decode logits", tl2, jl2, LOGIT_TOL)
    want = flatten(jdec2)
    for k, v in _cache_leaves(tdec2).items():
        _close(f"decode cache {k}", v, want[k], CACHE_TOL)

    jtoks, _ = jgenerate(jcfg, jparams, jnp.asarray(prompts), 4)
    toks, stats = serve.generate(cfg, params, torch.from_numpy(prompts), 4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats.tokens == 8


@pytest.mark.parametrize("arch", ["rwkv6-7b", "gemma-7b"])
def test_slice_bf16_prefill(arch):
    """bf16 activations: the frameworks round at other places (XLA fuses
    elementwise chains and rounds once, PyTorch rounds after every op);
    ``BF16_LOGIT_TOL`` holds the logits."""
    jcfg, cfg, jparams, params, prompts = _slice(arch, dtype="bfloat16")
    jlogits, _, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                               jcfg)
    logits, caches, _ = TM.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, cfg)
    _close("bf16 prefill logits", logits, jlogits, BF16_LOGIT_TOL)
    leaves = _cache_leaves(caches)
    for k, v in leaves.items():
        want = torch.float32 if k.endswith(".state") else torch.bfloat16
        assert v.dtype == want, (k, v.dtype)


def test_moe_segments_run_the_moe_layer(monkeypatch):
    """A stack of a dense segment and a MoE segment: each layer takes its
    segment's ``moe`` flag (a MoE layer has no ``mlp``), so the port runs
    the MoE layer exactly once per MoE layer and its prefill equals the
    JAX package's."""
    jcfg, cfg, jparams, params, prompts = _slice(
        "grok-1-314b", n_layers=3, first_dense_layers=1)
    assert [n for n, _ in params.named_children()
            if n in ("dense", "moe")] == ["dense", "moe"]
    calls = []
    real = tmoe.moe_forward

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(float(out[1]["aux_loss"]))
        return out

    monkeypatch.setattr(tmoe, "moe_forward", counted)
    jlogits, _, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                               jcfg)
    logits, _, _ = TM.prefill(params, {"tokens": torch.from_numpy(prompts)},
                              cfg)
    assert len(calls) == 2 and all(a > 0 for a in calls)
    _close("prefill logits", logits, jlogits, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "grok-1-314b"])
def test_serve_cli_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "3"])
    assert "generated (2, 3) tokens on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


# (capacity_factor, config overrides): lossless, with drops, and the
# shared-expert, gate-free (gelu_plain) form.
MOE_CASES = [(8.0, {}), (1.0, {}),
             (1.0, {"n_shared_experts": 1, "mlp_act": "gelu_plain"})]


def _moe(overrides, cf):
    """The JAX layer's parameters, and the same loaded into the port's
    ``MoE`` module (names are the JAX paths, ``shared.w_up`` nested)."""
    jcfg, cfg = configs("grok-1-314b", capacity_factor=cf, **overrides)
    jp = jmoe.init_moe(KEY, jcfg)
    tp = tmoe.MoE(cfg, device="meta")
    tp.load_state_dict(_params(jp), strict=True, assign=True)
    return jcfg, cfg, jp, tp


def _moe_close(tout, tm, jout, jm):
    _close("moe out", tout, jout, CACHE_TOL)
    _close("aux_loss", tm["aux_loss"], jm["aux_loss"], CACHE_TOL)
    assert float(tm["dropped_frac"]) == float(jm["dropped_frac"])


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_forward_matches_jax(case):
    cf, overrides = case
    jcfg, cfg, jp, tp = _moe(overrides, cf)
    x = np.random.default_rng(8).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32)
    jout, jm = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    tout, tm = tmoe.moe_forward(tp, _t(x), cfg)
    _moe_close(tout, tm, jout, jm)
    if cf >= 8.0:
        assert float(tm["dropped_frac"]) == 0.0
    else:
        assert float(tm["dropped_frac"]) > 0.0


def test_moe_tied_router_probabilities():
    """All-zero token rows give exactly equal router probabilities; the
    port picks the lower expert indices first, as ``jax.lax.top_k`` does,
    so the tied rows fill the same experts' capacity and the same events
    drop."""
    jcfg, cfg, jp, tp = _moe({}, 1.0)
    x = np.random.default_rng(9).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    x[:, ::3] = 0.0
    jout, jm = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    tout, tm = tmoe.moe_forward(tp, _t(x), cfg)
    _moe_close(tout, tm, jout, jm)
    assert float(tm["dropped_frac"]) > 0.0
    probs = torch.full((5, cfg.n_experts), 1.0 / cfg.n_experts)
    _, idx = tmoe.top_k(probs, cfg.top_k)
    assert idx.tolist() == [[0, 1]] * 5


def test_top_k_ties_match_jax():
    """Probabilities on a coarse grid (many exact ties): values and indices
    equal ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(10)
    p = (rng.integers(0, 4, (64, 16)) / 4.0).astype(np.float32)
    for k in (1, 2, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = tmoe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_expert_capacity_matches_jax(cf):
    jcfg, cfg = configs("grok-1-314b", capacity_factor=cf)
    for n in (1, 4, 7, 40, 100, 8192):
        assert tmoe.expert_capacity(n, cfg) == jmoe.expert_capacity(n, jcfg)
    # Decode at batch 4 gets the floor of 8.
    assert tmoe.expert_capacity(4, get_config("grok-1-314b")) == 8
