"""The port's LM serving slice (zamba2-7b) against the JAX package.

Weights come from the JAX ``init_params``, flattened to ``{pytree path:
numpy}`` and loaded by ``repro_torch.convert``; prompts and activations
are drawn with numpy.  The JAX side runs its Pallas kernels in interpret
mode (``attention_impl="pallas"``) or its plain XLA path (``"xla"``); the
port runs the plain PyTorch versions of its kernels on the CPU.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.configs.base import count_params as jcount_params
from repro.launch.serve import _splice_prefill as jsplice
from repro.launch.serve import generate as jgenerate
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.layers import Param
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig, count_params
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = jax.random.key(7)
LOGIT_TOL = 1e-4      # f32 logits (the two JAX paths differ by 7e-7)
CACHE_TOL = 1e-5      # f32 caches and module outputs
# bfloat16 activations: the frameworks round at other places (XLA fuses
# elementwise chains and rounds once; PyTorch rounds after every op), so
# the logits of the 5-layer smoke model drift by a few bf16 ulps of the
# hidden state: measured max |Δ| 0.0097 (pallas) and 0.0099 (xla) against
# logits up to 0.55, with the same argmax.
BF16_LOGIT_TOL = 3e-2


def flatten(tree, prefix=""):
    """A JAX tree (dicts, NamedTuples, tuples, ``Param`` leaves) as the
    ``{dotted path: float numpy array}`` dict that ``convert`` reads."""
    if isinstance(tree, Param):
        return flatten(tree.value, prefix)
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        a = np.array(tree)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return {prefix[:-1]: a}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def configs(dtype="float32", impl="pallas", n_layers=5, **overrides):
    """The same zamba2 smoke config in both packages."""
    jcfg = dataclasses.replace(jsmoke_config(jget_config("zamba2-7b")),
                               n_layers=n_layers, dtype=dtype,
                               attention_impl=impl, **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(name, got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_config_copy_matches_jax():
    jcfg = jget_config("zamba2-7b")
    cfg = get_config("zamba2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)
    assert dataclasses.asdict(smoke_config(cfg)) == \
        dataclasses.asdict(jsmoke_config(jcfg))
    assert 6.7e9 < count_params(cfg) < 6.8e9


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config("rwkv6-7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_act", ["silu", "gelu", "gelu_plain"])
def test_layers_match_jax(mlp_act):
    """Norms, RoPE and the three MLP forms."""
    jcfg, cfg = configs(mlp_act=mlp_act, norm="layernorm")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    scale, bias = (rng.standard_normal(cfg.d_model).astype(np.float32)
                   for _ in range(2))
    _close("rms_norm", tlayers.rms_norm(_t(x), _t(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), CACHE_TOL)
    _close("layer_norm", tlayers.apply_norm(
        _t(x), {"scale": _t(scale), "bias": _t(bias)}, cfg),
        jlayers.apply_norm(jnp.asarray(x), {"scale": Param(scale, ()),
                                            "bias": Param(bias, ())}, jcfg),
        CACHE_TOL)
    xh = rng.standard_normal((2, 3, 6, 16)).astype(np.float32)
    pos = np.arange(3, 9)[None, None, :]
    _close("rope", tlayers.apply_rope(_t(xh), torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e4),
           CACHE_TOL)
    jp = jlayers.init_mlp(KEY, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in flatten(jp).items()}
    _close("mlp", tlayers.apply_mlp(_t(x), tp, cfg),
           jlayers.apply_mlp(jnp.asarray(x), jp, jcfg), CACHE_TOL)


# (attention_impl, n_kv_heads, attn_block_kv, attn_score_dtype, tolerance):
# the dense and kernel branches of sdpa at GQA groups 1 and 2, and the
# KV-chunked branch; bf16 scores round the score tile to bf16 (8 bits of
# mantissa) in both packages, at other places (measured max |Δ| 0.011 on
# outputs up to 2.8).
SDPA_BRANCHES = [("xla", 4, 0, "float32", CACHE_TOL),
                 ("pallas", 4, 0, "float32", CACHE_TOL),
                 ("xla", 2, 0, "float32", CACHE_TOL),
                 ("pallas", 2, 0, "float32", CACHE_TOL),
                 ("xla", 2, 8, "float32", CACHE_TOL),
                 ("xla", 2, 8, "bfloat16", 3e-2)]


@pytest.mark.parametrize("branch", SDPA_BRANCHES)
def test_gqa_forward_prefill_and_decode(branch):
    impl, n_kv_heads, block_kv, score_dtype, tol = branch
    jcfg, cfg = configs(impl=impl, n_kv_heads=n_kv_heads,
                        attn_block_kv=block_kv, attn_score_dtype=score_dtype)
    jp = jattn.init_gqa(KEY, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in flatten(jp).items()}
    rng = np.random.default_rng(1)
    b, s, max_len = 2, 12, 16
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jout, jcache = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, mode="prefill")
    tout, tcache = tattn.gqa_forward(tp, _t(x), cfg, mode="prefill")
    _close("prefill out", tout, jout, tol)
    _close("prefill k", tcache.k, jcache.k, tol)
    _close("prefill v", tcache.v, jcache.v, tol)

    # Decode one token at position s against the spliced cache.
    pad = ((0, 0), (0, 0), (0, max_len - s), (0, 0))
    kc, vc = (np.pad(np.asarray(a), pad) for a in jcache)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((b, 1), s, np.int32)
    jout, jnew = jattn.gqa_forward(
        jp, jnp.asarray(x1), jcfg, mode="decode", positions=jnp.asarray(pos),
        cache=jattn.KVCache(jnp.asarray(kc), jnp.asarray(vc)), cache_index=s)
    tc = tattn.KVCache(_t(kc), _t(vc))
    tout, tnew = tattn.gqa_forward(tp, _t(x1), cfg, mode="decode",
                                   positions=torch.from_numpy(pos), cache=tc,
                                   cache_index=s)
    assert tnew is tc                      # written in place
    _close("decode out", tout, jout, tol)
    _close("decode k", tnew.k, jnew.k, tol)
    _close("decode v", tnew.v, jnew.v, tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba2_forward_prefill_and_decode(impl):
    jcfg, cfg = configs(impl=impl)
    jp = jssm.init_mamba2(KEY, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in flatten(jp).items()}
    rng = np.random.default_rng(2)
    b, s = 2, 21
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jout, jcache = jssm.mamba2_forward(jp, jnp.asarray(x), jcfg,
                                       mode="prefill")
    tout, tcache = tssm.mamba2_forward(tp, _t(x), cfg, mode="prefill")
    _close("prefill out", tout, jout, CACHE_TOL)
    _close("prefill conv", tcache.conv, jcache.conv, CACHE_TOL)
    _close("prefill state", tcache.state, jcache.state, CACHE_TOL)

    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jout, jnew = jssm.mamba2_forward(jp, jnp.asarray(x1), jcfg, mode="decode",
                                     cache=jcache)
    tout, tnew = tssm.mamba2_forward(tp, _t(x1), cfg, mode="decode",
                                     cache=tcache)
    _close("decode out", tout, jout, CACHE_TOL)
    _close("decode conv", tnew.conv, jnew.conv, CACHE_TOL)
    _close("decode state", tnew.state, jnew.state, CACHE_TOL)


# ---------------------------------------------------------------------------
# The slice: prefill, decode and generate
# ---------------------------------------------------------------------------


def _slice(dtype="float32", impl="pallas", **overrides):
    jcfg, cfg = configs(dtype=dtype, impl=impl, **overrides)
    jparams = JM.init_params(KEY, jcfg)
    params = convert.lm_params_from_numpy(flatten(jparams), cfg, device="cpu")
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 20)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_zamba2_slice_matches_jax(impl):
    """5 layers: two shared-attention groups and one tail layer."""
    jcfg, cfg, jparams, params, prompts = _slice(impl=impl)
    assert {n for n, _ in params.named_parameters()} == set(flatten(jparams))
    jlogits, jcaches, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                     jcfg)
    before = (tflash.flash_attention.launches, tscan.linear_scan.launches)
    logits, caches, _ = TM.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, cfg)
    assert (tflash.flash_attention.launches,
            tscan.linear_scan.launches) == before      # the CPU never launches
    _close("prefill logits", logits, jlogits, LOGIT_TOL)
    want = flatten(jcaches)
    got = {"0.conv": caches[0].conv, "0.state": caches[0].state,
           "1.k": caches[1].k, "1.v": caches[1].v}
    assert set(got) == set(want)
    for k in want:
        _close(f"cache {k}", got[k], want[k], CACHE_TOL)

    # One decode step from the spliced caches, converted from the JAX side.
    s, max_len = prompts.shape[1], prompts.shape[1] + 4
    jdec = JM.init_cache(jcfg, 2, max_len)
    jdec = jsplice(jcfg, jdec, jcaches, s)
    tdec = convert.lm_caches_from_numpy(flatten(jdec), cfg, device="cpu")
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jl2, _ = JM.decode_step(jparams, jnp.asarray(tok), jdec, s, jcfg)
    tl2, _ = TM.decode_step(params, torch.from_numpy(tok), tdec, s, cfg)
    _close("decode logits", tl2, jl2, LOGIT_TOL)

    jtoks, _ = jgenerate(jcfg, jparams, jnp.asarray(prompts), 4)
    toks, stats = serve.generate(cfg, params, torch.from_numpy(prompts), 4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats.tokens == 8


def test_zamba2_slice_bf16():
    jcfg, cfg, jparams, params, prompts = _slice(dtype="bfloat16")
    jlogits, _, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                               jcfg)
    logits, _, _ = TM.prefill(params, {"tokens": torch.from_numpy(prompts)},
                              cfg)
    _close("bf16 prefill logits", logits, jlogits, BF16_LOGIT_TOL)


def test_plain_gqa_stack_matches_jax():
    """The plain GQA + MLP decoder stack (no shared block, no SSM)."""
    jcfg, cfg, jparams, params, prompts = _slice(
        impl="pallas", ssm="none", attn_every=0, family="dense", n_layers=2,
        n_kv_heads=2)
    jlogits, jcaches, _ = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                     jcfg)
    logits, caches, _ = TM.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, cfg)
    _close("prefill logits", logits, jlogits, LOGIT_TOL)
    for f in ("k", "v"):
        _close(f"cache {f}", getattr(caches["layers"], f),
               getattr(jcaches["layers"], f), CACHE_TOL)
    jtoks, _ = jgenerate(jcfg, jparams, jnp.asarray(prompts), 3)
    toks, _ = serve.generate(cfg, params, torch.from_numpy(prompts), 3)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_generate_sampling_rules():
    _, cfg = configs()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(1))
    greedy, _ = serve.generate(cfg, params, prompts, 5)
    cold, _ = serve.generate(cfg, params, prompts, 5, greedy=False,
                             temperature=0.0)
    assert torch.equal(greedy, cold)                 # zero-entropy limit
    runs = [serve.generate(cfg, params, prompts, 5, greedy=False,
                           temperature=5.0,
                           key=torch.Generator().manual_seed(seed))[0]
            for seed in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])             # same state, same draw
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], greedy)
    # The warm pass leaves the generator's state alone.
    g = torch.Generator().manual_seed(1)
    cold_run, _ = serve.generate(cfg, params, prompts, 5, greedy=False,
                                 temperature=5.0, key=g, warm=False)
    assert torch.equal(cold_run, runs[0])


def test_splice_prefill_colliding_prompt_length():
    """The splice axis is the layout's sequence axis (ndim - 2), not the
    first axis whose size equals the prompt length (s == n_kv_heads)."""
    L, B, H, Dh, s, max_len = 2, 2, 4, 8, 4, 16
    src = torch.arange(L * B * H * s * Dh, dtype=torch.float32).reshape(
        L, B, H, s, Dh)
    out = serve._splice_prefill(None, {"k": torch.zeros((L, B, H, max_len,
                                                         Dh))},
                                {"k": src}, s)["k"]
    assert torch.equal(out[:, :, :, :s], src)
    assert not out[:, :, :, s:].any()
    src4 = torch.arange(L * B * s * s, dtype=torch.float32).reshape(L, B, s, s)
    out4 = serve._splice_prefill(None, {"k": torch.zeros((L, B, max_len, s))},
                                 {"k": src4}, s)["k"]
    assert torch.equal(out4[:, :, :s], src4)
    assert not out4[:, :, s:].any()
    st = torch.ones((L, B, 3, 5))
    assert torch.equal(serve._splice_prefill(
        None, {"k": torch.zeros_like(st)}, {"k": st}, s)["k"], st)
    with pytest.raises(ValueError):
        serve._splice_prefill(None, {"k": torch.zeros((L, B, 7, Dh))},
                              {"k": torch.zeros((L, B, 5, Dh + 1))}, 5)


def test_generate_at_prompt_length_colliding_with_kv_heads():
    """Generation at a prompt length equal to n_kv_heads decodes from the
    correctly spliced cache: token 1 is the teacher-forced argmax."""
    _, cfg = configs()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    s = cfg.n_kv_heads
    prompts = torch.randint(1, cfg.vocab_size, (2, s),
                            generator=torch.Generator().manual_seed(2))
    toks, _ = serve.generate(cfg, params, prompts, 2)
    logits, _, _ = TM.prefill(params, {"tokens": torch.cat(
        [prompts, toks[:, :1]], 1)}, cfg)
    assert torch.equal(toks[:, 1], torch.argmax(logits, -1).to(torch.int32))


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    assert "generated (2, 3) tokens on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The card rule and the package boundary
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs()
    for call in (lambda: TM.init_params(torch.Generator(), cfg),
                 lambda: TM.init_cache(cfg, 1, 8),
                 lambda: convert.lm_params_from_numpy({}, cfg),
                 lambda: serve.main(["--arch", "zamba2-7b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    return bad


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad
