"""The port's last three LM families against the JAX package: MLA
(deepseek-v2-236b), whisper-medium's encoder-decoder with cross-attention,
and llava-next-mistral-7b's embeddings input.

Weights come from the JAX ``init_params``, flattened to ``{pytree path:
numpy}`` and loaded by ``repro_torch.convert``; prompts, frames and
activations are drawn with numpy.  Tolerances are
``tests/test_torch_serve.py``'s: ``LOGIT_TOL`` 1e-4 on float32 logits,
``CACHE_TOL`` 1e-5 on float32 caches and module outputs,
``BF16_LOGIT_TOL`` 3e-2 on bf16 prefill logits; greedy tokens are equal
bit for bit.

MLA is held against the JAX ``"xla"`` path under both of the port's
impls: the JAX package's ``"pallas"`` MLA prefill hands its kernel a V
narrower than Q and K (v_head_dim against nope + rope), the kernel's
output takes q's shape, and the reshape after it raises.  The port pads V
with zero columns for its kernel and cuts the output back, which is the
plain path's result.  whisper and llava run both impls on both sides (the
JAX Pallas kernel in interpret mode, the port's plain version on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.serve import _splice_prefill as jsplice
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from test_torch_lm_families import _cache_leaves, _params, configs
from test_torch_serve import (BF16_LOGIT_TOL, CACHE_TOL, KEY, LOGIT_TOL,
                              _close, _t, flatten)
from torch_threads import share_cores

share_cores()

ARCHS = ("deepseek-v2-236b", "whisper-medium", "llava-next-mistral-7b")
IMPLS = ("xla", "pallas")
FRAMES = 24          # encoder frames of the whisper slices (!= the prompt)


def _jax_impl(arch, impl):
    """The JAX side's impl: MLA's Pallas path raises (module docstring)."""
    return "xla" if arch == "deepseek-v2-236b" else impl


def _pair(arch, impl, dtype="float32", **overrides):
    jcfg, cfg = configs(arch, dtype=dtype, impl=impl, **overrides)
    return dataclasses.replace(jcfg, attention_impl=_jax_impl(arch, impl)), cfg


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("q_lora_rank", [48, 0])
def test_mla_forward_matches_jax(q_lora_rank, impl):
    """Train, prefill (output, c_kv and k_rope) and one absorbed decode
    step from the prefill's cache, with the low-rank query and with one
    ``wq``."""
    jcfg, cfg = _pair("deepseek-v2-236b", impl, q_lora_rank=q_lora_rank)
    jp = jattn.init_mla(KEY, jcfg)
    tp = _params(jp)
    assert ("wq_a" in tp) == bool(q_lora_rank) == ("wq" not in tp)
    module = tattn.MLA(cfg, device="meta")
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == \
        {n: tuple(t.shape) for n, t in tp.items()}
    rng = np.random.default_rng(21)
    b, s, max_len = 2, 13, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)

    jout, _ = jattn.mla_forward(jp, jnp.asarray(x), jcfg, mode="train")
    tout, tcache = tattn.mla_forward(tp, _t(x), cfg, mode="train")
    assert tcache is None
    _close("train out", tout, jout, CACHE_TOL)

    jout, jcache = jattn.mla_forward(jp, jnp.asarray(x), jcfg, mode="prefill")
    tout, tcache = tattn.mla_forward(tp, _t(x), cfg, mode="prefill")
    _close("prefill out", tout, jout, CACHE_TOL)
    _close("prefill c_kv", tcache.k, jcache.k, CACHE_TOL)
    _close("prefill k_rope", tcache.v, jcache.v, CACHE_TOL)

    pad = ((0, 0), (0, max_len - s), (0, 0))
    kc, rc = (np.pad(np.asarray(a), pad) for a in jcache)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((b, 1), s, np.int32)
    jout, jnew = jattn.mla_forward(
        jp, jnp.asarray(x1), jcfg, mode="decode", positions=jnp.asarray(pos),
        cache=jattn.KVCache(jnp.asarray(kc), jnp.asarray(rc)), cache_index=s)
    tc = tattn.KVCache(_t(kc), _t(rc))
    before = tflash.flash_attention.launches
    tout, tnew = tattn.mla_forward(tp, _t(x1), cfg, mode="decode",
                                   positions=torch.from_numpy(pos), cache=tc,
                                   cache_index=s)
    assert tnew is tc                      # written in place
    assert tflash.flash_attention.launches == before
    _close("decode out", tout, jout, CACHE_TOL)
    _close("decode c_kv", tnew.k, jnew.k, CACHE_TOL)
    _close("decode k_rope", tnew.v, jnew.v, CACHE_TOL)


def test_mla_pallas_pads_v_for_the_kernel(monkeypatch):
    """Under ``"pallas"`` the kernel's wrapper sees q, k and v at one head
    dim (nope + rope), V's extra columns zero; the output it returns is
    cut back to ``v_head_dim``."""
    _, cfg = configs("deepseek-v2-236b", impl="pallas")
    tp = _params(jattn.init_mla(KEY, _pair("deepseek-v2-236b", "xla")[0]))
    seen = []
    real = tflash.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.clone()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    x = _t(np.random.default_rng(22).standard_normal((2, 9, cfg.d_model)))
    out, _ = tattn.mla_forward(tp, x, cfg, mode="prefill")
    width = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert len(seen) == 1
    q_shape, k_shape, v = seen[0]
    assert q_shape[-1] == k_shape[-1] == v.shape[-1] == width
    assert not v[..., cfg.v_head_dim:].any() and v[..., :cfg.v_head_dim].any()
    assert out.shape == (2, 9, cfg.d_model)


def test_mla_cache_layout_matches_jax():
    jcfg, cfg = _pair("deepseek-v2-236b", "xla", dtype="bfloat16")
    want = flatten(JM.init_cache(jcfg, 3, 11))
    got = _cache_leaves(TM.init_cache(cfg, 3, 11, "cpu"))
    assert set(got) == set(want) == {"dense.k", "dense.v", "moe.k", "moe.v"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and not got[k].any()
    assert got["dense.k"].shape[-1] == cfg.kv_lora_rank
    assert got["moe.v"].shape[-1] == cfg.qk_rope_head_dim


# ---------------------------------------------------------------------------
# Cross-attention and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_gqa_cross_attention_matches_jax(impl):
    """K/V from the encoder states (another length than the queries), no
    rope, no causal mask, no q/k norms; prefill returns the cross K/V as
    the JAX function does."""
    jcfg, cfg = _pair("whisper-medium", impl)
    jp = jattn.init_gqa(KEY, jcfg, cross=True)
    tp = _params(jp)
    assert set(tp) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)
    for mode in ("train", "prefill"):
        jout, jcache = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, mode=mode,
                                         kv_source=jnp.asarray(enc))
        tout, tcache = tattn.gqa_forward(tp, _t(x), cfg, mode=mode,
                                         kv_source=_t(enc))
        _close(f"{mode} out", tout, jout, CACHE_TOL)
        assert (tcache is None) == (jcache is None)
    _close("cross k", tcache.k, jcache.k, CACHE_TOL)
    _close("cross v", tcache.v, jcache.v, CACHE_TOL)
    with pytest.raises(ValueError, match="kv_source"):
        tattn.gqa_forward(tp, _t(x), cfg, mode="decode", kv_source=_t(enc),
                          cache=tcache, cache_index=0)


def _whisper(impl, dtype="float32"):
    jcfg, cfg = _pair("whisper-medium", impl, dtype=dtype)
    jparams = JM.init_params(KEY, jcfg)
    params = convert.lm_params_from_numpy(flatten(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_stack_matches_jax(impl):
    jcfg, cfg, jparams, params = _whisper(impl)
    frames = np.random.default_rng(24).standard_normal(
        (2, FRAMES, cfg.d_model)).astype(np.float32)
    want = JM._encoder_stack(jparams, jnp.asarray(frames), jcfg)
    got = TM._encoder_stack(params, _t(frames), cfg)
    _close("encoder out", got, want, CACHE_TOL)
    _close("sinusoidal positions", TM._sinusoidal_positions(FRAMES, 64),
           JM._sinusoidal_positions(FRAMES, 64), CACHE_TOL)


def test_encoder_attends_to_future_frames():
    """The twin of ``tests/test_models.py``'s: position 0's encoding depends
    on the last frame (no causal mask)."""
    _, cfg, _, params = _whisper("xla")
    gen = torch.Generator().manual_seed(25)
    embeds = torch.randn((1, 8, cfg.d_model), generator=gen,
                         requires_grad=True)
    # A random readout: a plain feature sum of the final LayerNorm output
    # is constant (zero mean x unit scale), so its gradient would be 0.
    w = torch.randn((cfg.d_model,), generator=gen)
    torch.dot(TM._encoder_stack(params, embeds, cfg)[0, 0], w).backward()
    assert float(embeds.grad[0, -1].abs().sum()) > 0.0


# ---------------------------------------------------------------------------
# The slices: prefill and 4 greedy decode steps
# ---------------------------------------------------------------------------


def _batch(cfg, rng, b=2, s=11):
    """numpy inputs of a prefill: frames and a decoder prompt (whisper),
    prompt embeddings (llava) or prompt tokens (deepseek)."""
    out = {}
    if cfg.input_mode == "embeddings":
        n = FRAMES if cfg.encoder_layers else s
        out["embeds"] = rng.standard_normal((b, n, cfg.d_model)).astype(
            np.float32)
    if cfg.input_mode == "tokens" or cfg.encoder_layers:
        out["tokens"] = rng.integers(1, cfg.vocab_size, (b, s)).astype(
            np.int32)
    return out


def _slice(arch, impl, dtype="float32"):
    jcfg, cfg = _pair(arch, impl, dtype=dtype)
    jparams = JM.init_params(KEY, jcfg)
    params = convert.lm_params_from_numpy(flatten(jparams), cfg, device="cpu")
    batch = _batch(cfg, np.random.default_rng(26))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jparams, params, jb, tb


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_matches_jax(arch, impl):
    """Prefill logits, every cache leaf and ``encoder_out``; then 4 greedy
    decode steps, each side from its own spliced caches and its own
    tokens: logits close, tokens equal bit for bit, the caches close
    after the last step.  llava's steps alternate [B, D] embeddings
    (steps 0 and 2) and token ids (1 and 3)."""
    jcfg, cfg, jparams, params, jb, tb = _slice(arch, impl)
    jlogits, jcaches, jenc = JM.prefill(jparams, jb, jcfg)
    before = tflash.flash_attention.launches
    logits, caches, enc = TM.prefill(params, tb, cfg)
    assert tflash.flash_attention.launches == before   # the CPU never launches
    _close("prefill logits", logits, jlogits, LOGIT_TOL)
    want, got = flatten(jcaches), _cache_leaves(caches)
    assert set(got) == set(want)
    for k in want:
        _close(f"cache {k}", got[k], want[k], CACHE_TOL)
    assert (enc is None) == (jenc is None) == (not cfg.encoder_layers)
    if enc is not None:
        _close("encoder_out", enc, jenc, CACHE_TOL)

    b, s = logits.shape[0], (tb.get("tokens", tb.get("embeds"))).shape[1]
    max_len = s + 4
    jdec = jsplice(jcfg, JM.init_cache(jcfg, b, max_len), jcaches, s)
    tdec = serve._splice_prefill(cfg, TM.init_cache(cfg, b, max_len, "cpu"),
                                 caches, s)
    rng = np.random.default_rng(27)
    for i in range(4):
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
        np.testing.assert_array_equal(
            torch.argmax(logits, -1).numpy(), tok, err_msg=f"step {i}")
        inp = tok
        if cfg.input_mode == "embeddings" and not cfg.encoder_layers \
                and i % 2 == 0:
            inp = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        jlogits, jdec = JM.decode_step(jparams, jnp.asarray(inp), jdec, s + i,
                                       jcfg, encoder_out=jenc)
        logits, tdec = TM.decode_step(params, torch.from_numpy(inp), tdec,
                                      s + i, cfg, encoder_out=enc)
        _close(f"decode logits {i}", logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(),
                                  np.argmax(np.asarray(jlogits), -1))
    want = flatten(jdec)
    for k, v in _cache_leaves(tdec).items():
        _close(f"decode cache {k}", v, want[k], CACHE_TOL)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_generate_takes_a_prefill_batch(arch):
    """``serve.generate`` on a batch dict (frames and decoder tokens, or
    prompt embeddings): the tokens of the JAX prefill, splice and greedy
    decode steps fed token ids, prefill's encoder output at every step,
    bit for bit."""
    jcfg, cfg, jparams, params, jb, tb = _slice(arch, "pallas")
    n = 4
    toks, stats = serve.generate(cfg, params, tb, n)
    jlogits, jcaches, jenc = JM.prefill(jparams, jb, jcfg)
    b, s = jlogits.shape[0], (jb.get("tokens", jb.get("embeds"))).shape[1]
    jdec = jsplice(jcfg, JM.init_cache(jcfg, b, s + n), jcaches, s)
    want = []
    for i in range(n):
        tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        jlogits, jdec = JM.decode_step(jparams, tok, jdec, s + i, jcfg,
                                       encoder_out=jenc)
    np.testing.assert_array_equal(toks.numpy(), np.stack(want, 1))
    assert toks.dtype == torch.int32 and stats.tokens == b * n


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_bf16_prefill(arch):
    """bf16 activations (``BF16_LOGIT_TOL``); caches in bf16."""
    jcfg, cfg, jparams, params, jb, tb = _slice(arch, "pallas", "bfloat16")
    jlogits, _, jenc = JM.prefill(jparams, jb, jcfg)
    logits, caches, enc = TM.prefill(params, tb, cfg)
    _close("bf16 prefill logits", logits, jlogits, BF16_LOGIT_TOL)
    assert all(v.dtype == torch.bfloat16
               for v in _cache_leaves(caches).values())
    if enc is not None:
        assert enc.dtype == torch.bfloat16
        _close("bf16 encoder_out", enc, jenc, BF16_LOGIT_TOL)


# ---------------------------------------------------------------------------
# Loading, splicing and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_load_strictly(arch):
    """``lm_params_from_numpy`` takes the JAX tree with no new mapping and
    refuses an extra key; ``lm_caches_from_numpy`` reads the decode cache
    of the JAX ``init_cache`` in the activation dtype."""
    jcfg, cfg = _pair(arch, "xla", dtype="bfloat16")
    arrays = flatten(JM.init_params(KEY, jcfg))
    params = convert.lm_params_from_numpy(arrays, cfg, device="cpu")
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == {n: a.shape for n, a in arrays.items()}
    with pytest.raises(KeyError, match="does not read"):
        convert.lm_params_from_numpy({**arrays, "extra": arrays["embed"]},
                                     cfg, device="cpu")
    jcache = flatten(JM.init_cache(jcfg, 2, 9))
    caches = convert.lm_caches_from_numpy(jcache, cfg, device="cpu")
    leaves = _cache_leaves(caches)
    assert set(leaves) == set(jcache)
    for k, v in leaves.items():
        assert tuple(v.shape) == jcache[k].shape and v.dtype == torch.bfloat16


def test_splice_prefill_mla_cache():
    """The MLA latent cache [L, B, S, rank] at a prompt length equal to
    ``kv_lora_rank``: the sequence axis is ndim - 2, not the rank axis."""
    _, cfg = _pair("deepseek-v2-236b", "xla")
    s = cfg.kv_lora_rank
    params = TM.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, s),
                           generator=torch.Generator().manual_seed(4))
    _, caches, _ = TM.prefill(params, {"tokens": tokens}, cfg)
    dec = serve._splice_prefill(cfg, TM.init_cache(cfg, 2, s + 5, "cpu"),
                                caches, s)
    for seg, c in caches.items():
        for got, want in zip(dec[seg], c):
            assert torch.equal(got[:, :, :s], want)
            assert not got[:, :, s:].any()


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-medium"])
def test_serve_main_refuses_embeddings_archs(arch, monkeypatch):
    """As the JAX launcher does, before it draws a weight or asks for a
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", arch, "--smoke"])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke"])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    assert str(got.value) == str(want.value)
    assert "token-input" in str(got.value)
