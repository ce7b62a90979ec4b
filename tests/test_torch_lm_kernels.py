"""The LM kernels of the port against the JAX package: flash attention and
the chunked linear scan.

Inputs are drawn with numpy from fixed seeds and fed to both packages.  On
the CPU the port's wrappers run their plain PyTorch versions; they are held
against the JAX wrappers (the Pallas kernels in interpret mode) and against
the JAX ``ref.py`` oracles, in float32, within 1e-5.  The CUDA kernels are
held against the same plain versions on the card (``cuda``-marked tests
here, and ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.linear_scan import ref as jscan_ref
from repro.kernels.linear_scan.ops import linear_scan as jscan
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import check_row_layout
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention.ref import (attention_blocked_ref,
                                                     attention_ref,
                                                     attention_split_ref,
                                                     split_bounds)
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.kernels.linear_scan import ref as tscan_ref
from repro_torch.models import attention as tattn
from torch_threads import share_cores

share_cores()

TOL = 1e-5


def _close(name, got, want, rel=False):
    """Within TOL: absolute for attention outputs (softmax-weighted means of
    unit normals), relative to the output's scale for the scan."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# (batch, q_heads, kv_heads, seq_q, seq_kv, head_dim): groups 1, 2 and 4,
# head dims 16 and 112 (zamba2's), ragged lengths.
ATTN_SHAPES = [
    (2, 4, 4, 40, 40, 16),
    (1, 4, 2, 37, 37, 112),
    (1, 8, 2, 70, 70, 16),
    (2, 2, 1, 24, 24, 112),
]


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_attention_plain_matches_jax(shape, causal):
    q, k, v = _qkv(np.random.default_rng(sum(shape)), *shape)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    assert got.dtype == torch.float32 and got.is_contiguous()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close("vs pallas interpret", got,
           jflash(jq, jk, jv, causal=causal, interpret=True))
    _close("vs jax ref", got, jattention_ref(jq, jk, jv, causal=causal))


def test_flash_attention_cross_lengths_and_scale():
    """Non-causal with seq_q != seq_kv and an explicit sm_scale."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 4, 2, 24, 56, 16)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=False, sm_scale=0.3)
    _close("cross", got, jflash(*map(jnp.asarray, (q, k, v)), causal=False,
                                sm_scale=0.3, interpret=True))


def test_flash_attention_bf16_in_q_dtype():
    q, k, v = _qkv(np.random.default_rng(4), 1, 2, 2, 32, 32, 16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = attention_ref(tq.float(), tk.float(), tv.float())
    # bf16 output: one rounding of an f32 result.
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=8e-3)


# (batch, q_heads, kv_heads, seq, head_dim, causal): the Pallas wrapper's
# block_kv is 128 from 128 keys on, so up to d = 128 P rounds at the same
# boundaries; d = 192 and 256 take the warp-specialised body's 112- and
# 80-key tiles (block_kv_for), ragged against them and against 128.
BLOCKED_SHAPES = [(1, 4, 2, 300, 112, True), (1, 2, 2, 256, 64, False),
                  (2, 4, 4, 130, 16, True), (1, 2, 1, 200, 112, False),
                  (1, 2, 1, 190, 192, True), (1, 2, 2, 250, 192, False),
                  (1, 4, 2, 200, 256, True), (1, 2, 2, 170, 256, False)]


@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_attention_blocked_ref_matches_pallas(shape):
    """The wgmma body's plain twin, at the body's KV tile (block_kv_for),
    against the Pallas kernel in interpret mode at block_kv = 128.
    float32: P's cast to v's type is exact, and an online softmax over
    other block boundaries differs only in float32 rounding, so within
    1e-5.  bf16 inputs: the Pallas body casts v to float32 first, so in
    interpret mode its P stays float32 while the twin rounds P to bf16 as
    the card's tensor cores take it; each weight moves by at most half a
    bf16 ulp (2^-8 of itself, whatever the block's running max) and l sums
    the unrounded weights, so the output moves by at most 2^-8·max|v|,
    beside one bf16 ulp of rounding of each side's output (2^-7·|ref|)."""
    b, hq, hkv, s, d, causal = shape
    block = tflash.block_kv_for(d)
    q, k, v = _qkv(np.random.default_rng(sum(shape[:5])), b, hq, hkv, s, s, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close("f32", attention_blocked_ref(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal, block_kv=block),
           jflash(jq, jk, jv, causal=causal, interpret=True))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_blocked_ref(tq, tk, tv, causal=causal, block_kv=block)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jflash(*(jnp.asarray(t.float().numpy())
                               .astype(jnp.bfloat16) for t in (tq, tk, tv)),
                             causal=causal, interpret=True)).astype(np.float32)
    diff = np.abs(got.float().numpy() - want)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * float(tv.float().abs().max())
    assert np.isfinite(got.float().numpy()).all()
    assert (diff <= bound).all(), float((diff - bound).max())


def test_flash_attention_body_dispatch():
    """The wrapper's rule: all-bf16 operands with more than 16 query rows
    take the wgmma body, any other mix the f32 body; the wgmma body's KV
    tile by head dim; the TMA layout rule of the tensor-core bodies raises
    for a non-contiguous head dim, a stride off the 16-byte granule or a
    misaligned base, and replaces the strides of size-1 dims."""
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.zeros((1, 2, 32, 16))
    assert tflash.body_for(x.to(bf), x.to(bf), x.to(bf)) == "wgmma"
    for dtypes in ((f32, f32, f32), (bf, f32, bf), (bf, bf, f32)):
        assert tflash.body_for(*(x.to(t) for t in dtypes)) == "f32"
    assert tflash.block_kv_for(112) == 128 and tflash.block_kv_for(256) == 80
    assert tflash.block_kv_for(192) == 112
    # zamba2's v: a transposed view [b, s, h, d] -> [b, h, s, d].
    v = torch.zeros((2, 16, 4, 112), dtype=bf).transpose(1, 2)
    assert tflash.tma_strides(v, "v") == (16 * 4 * 112, 112, 4 * 112, 1)
    assert tflash.tma_strides(torch.zeros((1, 1, 8, 16), dtype=bf), "q") \
        == (128, 128, 16, 1)
    with pytest.raises(ValueError, match="last dim contiguous"):
        tflash.tma_strides(torch.zeros((1, 2, 16, 8), dtype=bf)
                           .transpose(2, 3), "k")
    with pytest.raises(ValueError, match="multiples of 16"):
        tflash.tma_strides(torch.zeros((1, 2, 8, 20), dtype=bf)[..., :16],
                           "k")
    with pytest.raises(ValueError, match="aligned"):
        tflash.tma_strides(torch.zeros(1 + 2 * 8 * 16, dtype=bf)[1:]
                           .reshape(1, 2, 8, 16), "k")


def test_flash_attention_argument_rules():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="seq_q == seq_kv"):
        tflash.flash_attention(q, torch.zeros((1, 2, 9, 16)),
                               torch.zeros((1, 2, 9, 16)))
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        tflash.flash_attention(torch.zeros((1, 3, 8, 16)), q, q)


# ---------------------------------------------------------------------------
# Linear scan
# ---------------------------------------------------------------------------

# (batch, heads, T, K, V): ragged T, K != V, the short-T chunk of 8.
SCAN_SHAPES = [(2, 3, 37, 16, 16), (1, 2, 64, 8, 12), (1, 2, 5, 16, 8)]


def _scan_inputs(rng, b, h, t, kd, vd, decay=1.0):
    q = rng.standard_normal((b, h, t, kd)).astype(np.float32)
    k = rng.standard_normal((b, h, t, kd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, h, t, vd)).astype(np.float32)
    w = -rng.uniform(0.0, decay, (b, h, t, kd)).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    return q, k, v, w, u


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_linear_scan_plain_matches_jax(shape, mode):
    q, k, v, w, u = _scan_inputs(np.random.default_rng(sum(shape)), *shape)
    u = u if mode == "bonus" else None
    tin = [None if a is None else torch.from_numpy(a) for a in (q, k, v, w, u)]
    jin = [None if a is None else jnp.asarray(a) for a in (q, k, v, w, u)]
    want = jscan_ref.linear_scan_ref(*jin, mode=mode)
    got = tscan.linear_scan(*tin, mode=mode)
    assert got.dtype == torch.float32
    _close("wrapper vs pallas interpret", got,
           jscan(*jin, mode=mode, interpret=True), rel=True)
    _close("wrapper vs jax sequential ref", got, want, rel=True)
    _close("sequential", tscan_ref.linear_scan_ref(*tin, mode=mode), want,
           rel=True)
    _close("chunked 16", tscan_ref.linear_scan_chunked(*tin, mode=mode),
           jscan_ref.linear_scan_chunked(*jin, mode=mode), rel=True)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_linear_scan_strong_decay_stays_finite(mode):
    """Decays up to e^-10 per step: the cumsum b reaches about -320 within
    a 64-step chunk, so a q·e^{b} / k·e^{-b} factorisation would overflow
    float32 (e^88); the stable form matches the sequential recurrence and
    the Pallas kernel.  (Far stronger decays stay finite too, but the
    cumsum's rounding at |b| ~ 1e3 then costs the chunked form, the JAX
    package's as much as the port's, more than 1e-5.)"""
    q, k, v, w, u = _scan_inputs(np.random.default_rng(9), 1, 2, 96, 16, 16,
                                 decay=10.0)
    assert float(np.cumsum(w[..., :64, :], axis=2).min()) < -300
    tin = list(map(torch.from_numpy, (q, k, v, w, u)))
    jin = list(map(jnp.asarray, (q, k, v, w, u)))
    got = tscan.linear_scan(*tin, mode=mode)
    _close("vs sequential", got, jscan_ref.linear_scan_ref(*jin, mode=mode),
           rel=True)
    _close("vs pallas interpret", got, jscan(*jin, mode=mode, interpret=True),
           rel=True)


def test_linear_scan_broadcast_views():
    """Mamba2's stride-0 views (q shared by heads, w by K channels) give
    the same result as their dense copies."""
    rng = np.random.default_rng(11)
    b, h, t, kd, vd = 2, 4, 19, 8, 8
    qb = torch.from_numpy(rng.standard_normal((b, 1, t, kd), np.float32))
    wb = torch.from_numpy(-rng.uniform(0, 1, (b, h, t, 1)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, h, t, kd), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, t, vd), np.float32))
    q, w = qb.expand(b, h, t, kd), wb.expand(b, h, t, kd)
    assert q.stride(1) == 0 and w.stride(3) == 0
    got = tscan.linear_scan(q, k, v, w)
    want = tscan.linear_scan(q.contiguous(), k, v, w.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# (batch, heads, T, K, V, strongest decay per step): ragged T, several
# chunks, decays down to e^-16 per step (zamba2's largest rate).
SCALAR_SHAPES = [(1, 2, 150, 16, 16, 1.0), (2, 3, 100, 32, 16, 16.0),
                 (1, 2, 5, 16, 8, 1.0), (1, 1, 200, 64, 64, 16.0)]


@pytest.mark.parametrize("shape", SCALAR_SHAPES)
def test_scalar_decay_ref_matches_jax(shape):
    """The scalar-decay twin (one decay per step, taken from w's first
    channel) against the per-channel chunked form on the same w broadcast
    over K and against the Pallas kernel in interpret mode: the same
    function, within 1e-5 of the output's scale in float32.  At decays up
    to e^-16 per step the cumsum inside a 64-step chunk reaches |b| ~ 500,
    where jnp.cumsum's association and torch.cumsum's differ by a few f32
    ulps (3e-5 each): against Pallas the twin and the port's per-channel
    chunked form then both sit about 1.6e-5 of the scale off, so that one
    comparison is held to 5e-5 and to the chunked form's own distance."""
    b, h, t, kd, vd, decay = shape
    rng = np.random.default_rng(sum(shape[:5]))
    q, k, v, _, _ = _scan_inputs(rng, b, h, t, kd, vd)
    w1 = -rng.uniform(0.0, decay, (b, h, t, 1)).astype(np.float32)
    w = np.ascontiguousarray(np.broadcast_to(w1, (b, h, t, kd)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tscan_ref.linear_scan_scalar_decay_ref(
        tq, tk, tv, torch.from_numpy(w1).expand(b, h, t, kd))
    assert got.dtype == torch.float32
    chunked = tscan_ref.linear_scan_chunked(tq, tk, tv, torch.from_numpy(w),
                                            chunk=tscan.SCALAR_CHUNK)
    _close("vs linear_scan_chunked", got, chunked, rel=True)
    pallas = np.asarray(jscan(*map(jnp.asarray, (q, k, v, w)),
                              interpret=True))
    scale = max(1.0, float(np.abs(pallas).max()))
    err = float(np.abs(got.numpy() - pallas).max()) / scale
    chunked_err = float(np.abs(chunked.numpy() - pallas).max()) / scale
    assert err <= (TOL if decay <= 1.0 else 5e-5), err
    assert err <= chunked_err + TOL / 10, (err, chunked_err)


# (batch, heads, T, K, V, decays): T of 1, one past a sub-chunk (17), one
# chunk, several and ragged; K, V of 16, 64 and 128, and K = 48 with V of
# 32 and 96, whose blocks take 16 value columns each.  "rwkv": RWKV6's
# per-channel decays w = -exp(base + 0.5·noise), base from -6 to -0.5
# across channels; "strong": w uniform down to -10 a step, where the
# sub-chunk factors e^{r - b} underflow.
CHANNEL_CASES = [(1, 2, 1, 16, 16, "rwkv"), (1, 2, 17, 16, 16, "strong"),
                 (1, 2, 17, 64, 64, "rwkv"), (2, 2, 64, 64, 64, "strong"),
                 (1, 2, 200, 128, 128, "rwkv"), (1, 1, 200, 64, 16, "strong"),
                 (1, 1, 1000, 64, 64, "rwkv"), (1, 1, 1000, 16, 128, "strong"),
                 (1, 1, 1000, 128, 64, "strong"), (1, 2, 130, 48, 32, "rwkv"),
                 (1, 1, 200, 48, 96, "strong")]


def _channel_inputs(rng, b, h, t, kd, vd, decays):
    q, k, v, w, u = _scan_inputs(rng, b, h, t, kd, vd, decay=10.0)
    if decays == "rwkv":
        base = np.linspace(-6.0, -0.5, h * kd).reshape(h, kd)
        noise = rng.standard_normal((b, h, t, kd))
        w = -np.exp(base[None, :, None, :] + 0.5 * noise).astype(np.float32)
    return q, k, v, w, u


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("case", CHANNEL_CASES)
def test_channel_decay_ref_matches_jax(case, mode):
    """The channel-decay twin (sub-chunks of 16, the intra-chunk matrix
    factored at sub-chunk boundaries, exact diagonal quadrants) against the
    JAX package's sequential recurrence and its chunked form at the
    kernel's chunk: the same function in float32, within 1e-5 of the
    output's scale (sums in another order).  With decays down to -10 a
    step the factors e^{r - b} underflow to 0 where the true terms are
    smaller still, and the output stays finite and within tolerance."""
    rng = np.random.default_rng(sum(case[:5]) + len(case[5]))
    q, k, v, w, u = _channel_inputs(rng, *case)
    u = u if mode == "bonus" else None
    tin = [None if a is None else torch.from_numpy(a) for a in (q, k, v, w, u)]
    jin = [None if a is None else jnp.asarray(a) for a in (q, k, v, w, u)]
    got = tscan_ref.linear_scan_channel_decay_ref(*tin, mode=mode)
    assert got.dtype == torch.float32 and got.shape == v.shape
    _close("vs jax sequential ref", got,
           jscan_ref.linear_scan_ref(*jin, mode=mode), rel=True)
    _close("vs jax chunked", got,
           jscan_ref.linear_scan_chunked(*jin, mode=mode,
                                         chunk=tscan.SCALAR_CHUNK), rel=True)


def test_linear_scan_body_dispatch():
    """The wrapper's rule: the scalar-decay body takes bf16 q, k, v, a w
    constant over K by construction (stride 0), inclusive mode and K, V
    multiples of 16 (K up to 128); the channel-decay body the other bf16
    calls with K, V multiples of 16 (K up to 128), in both modes, when
    q, k, v and w (f32 or bf16) are on the 16-byte row rule; anything else
    takes the per-channel body.  Its copy rule (``check_row_layout``, which
    the flash test drives to each of its errors) takes Mamba2's operands
    and RWKV6's [b, t, h, k] views."""
    bf = torch.bfloat16
    b, h, t, kd, vd = 1, 2, 8, 64, 32

    def args(dtype=bf, kd=kd, vd=vd, w_stride0=True, w_dtype=torch.float32):
        q = torch.zeros((b, 1, t, kd), dtype=dtype).expand(b, h, t, kd)
        k = torch.zeros((b, h, t, kd), dtype=dtype)
        v = torch.zeros((b, h, t, vd), dtype=dtype)
        w = torch.zeros((b, h, t, 1), dtype=w_dtype)
        w = w.expand(b, h, t, kd) if w_stride0 else w.repeat(1, 1, 1, kd)
        return q, k, v, w

    assert tscan.body_for(*args()) == "scalar_decay"
    assert tscan.body_for(*args(), mode="bonus") == "per_channel"
    assert tscan.body_for(*args(dtype=torch.float32)) == "per_channel"
    for mode in ("inclusive", "bonus"):
        for w_dtype in (torch.float32, bf):
            assert tscan.body_for(*args(w_stride0=False, w_dtype=w_dtype),
                                  mode=mode) == "channel_decay"
        dense = dict(w_stride0=False)
        assert tscan.body_for(*args(dtype=torch.float32, **dense),
                              mode=mode) == "per_channel"
        for bad in (dict(kd=40), dict(kd=144), dict(vd=24)):
            assert tscan.body_for(*args(**bad, **dense),
                                  mode=mode) == "per_channel"
            assert tscan.body_for(*args(**bad), mode=mode) == "per_channel"
    # RWKV6's operands: [b, t, h, k] tensors seen as [b, h, t, k], the
    # decay rounded to bf16 (rwkv6_time_mix) or dense float32.
    views = [torch.zeros((b, t, h, kd), dtype=bf).transpose(1, 2)
             for _ in range(4)]
    assert tscan.body_for(*views, mode="bonus") == "channel_decay"
    assert tscan.body_for(*views[:3], views[3].float().contiguous(),
                          mode="bonus") == "channel_decay"
    # A w off the row rule (a stride of 2 bytes) keeps the CUDA-core body.
    w_odd = torch.zeros((b, h, t, kd + 1), dtype=bf)[..., 1:]
    assert tscan.body_for(*views[:3], w_odd) == "per_channel"
    # Mamba2's q is a stride-0 view over heads: 0 is on the 16-byte rule.
    q, k, v, _ = args()
    for name, a in (("q", q), ("k", k), ("v", v), *zip("qkvw", views)):
        check_row_layout(a, name)


def test_linear_scan_decode_ref_matches_jax():
    rng = np.random.default_rng(12)
    b, h, kd, vd = 2, 3, 8, 6
    hs = rng.standard_normal((b, h, kd, vd)).astype(np.float32)
    q, k, w = (rng.standard_normal((b, h, kd)).astype(np.float32)
               for _ in range(3))
    w = -np.abs(w)
    v = rng.standard_normal((b, h, vd)).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    for mode, uu in (("inclusive", None), ("bonus", u)):
        args = (hs, q, k, v, w, uu)
        got = tscan_ref.linear_scan_decode_ref(
            *[None if a is None else torch.from_numpy(a) for a in args],
            mode=mode)
        want = jscan_ref.linear_scan_decode_ref(
            *[None if a is None else jnp.asarray(a) for a in args], mode=mode)
        for name, g, wnt in zip(("state", "y"), got, want):
            _close(f"{mode} {name}", g, wnt, rel=True)


def test_linear_scan_chunk_rule():
    """The JAX wrapper's chunk: min(64, max(8, next_pow2(T)))."""
    assert [tscan.chunk_for(t) for t in (1, 5, 8, 9, 33, 64, 65, 2048)] == \
        [8, 8, 8, 16, 64, 64, 64, 64]
    with pytest.raises(ValueError, match="mode"):
        tscan.linear_scan(*(torch.zeros((1, 1, 4, 4)),) * 4, mode="exclusive")


def test_cpu_tensors_never_launch():
    """On CPU tensors each wrapper runs its plain version: no launch is
    counted (and none could be: there is no card here)."""
    before = (tflash.flash_attention.launches, tscan.linear_scan.launches)
    x = torch.zeros((1, 1, 8, 8))
    tflash.flash_attention(x, x, x)
    tscan.linear_scan(x, x, x, x)
    assert (tflash.flash_attention.launches,
            tscan.linear_scan.launches) == before


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (run on a card only)
def test_flash_attention_decode_dispatch():
    """The decode body's rule: all-bf16 operands with at most 16 query
    rows, whatever the keys; 17 rows or another type go elsewhere."""
    bf, f32 = torch.bfloat16, torch.float32

    def qkv(sq, skv, types=(bf, bf, bf)):
        return (torch.zeros((2, 4, sq, 64), dtype=types[0]),
                torch.zeros((2, 2, skv, 64), dtype=types[1]),
                torch.zeros((2, 2, skv, 64), dtype=types[2]))
    for sq, skv in ((1, 1), (1, 1500), (16, 16), (16, 4096), (7, 300)):
        assert tflash.body_for(*qkv(sq, skv)) == "decode"
    assert tflash.body_for(*qkv(17, 1500)) == "wgmma"
    assert tflash.body_for(*qkv(1, 1500, (f32, f32, f32))) == "f32"
    assert tflash.body_for(*qkv(1, 1500, (bf, bf, f32))) == "f32"
    assert tflash.DECODE_MAX_Q == 16


# (batch · q_heads, seq_kv) -> splits: whisper's decode cross-attention
# (b4 h16, 1500 frames: 12 blocks of 128, two a split, 384 blocks), a
# single head (one block a split), the smoke prefill (one block), more
# heads than the card's SMs take three deep, ragged lengths, and a long
# cache at the cap of 64 splits (782 blocks in runs of 13).
DECODE_SPLITS = [((64, 1500), 6), ((1, 1500), 12), ((16, 16), 1),
                 ((4, 300), 3), ((1024, 1500), 1), ((512, 2048), 1),
                 ((132, 4096), 3), ((64, 1), 1), ((2, 129), 2),
                 ((1, 100_000), 61)]


@pytest.mark.parametrize("args, want", DECODE_SPLITS)
def test_decode_splits(args, want):
    """``decode_splits`` fills the card three blocks deep, never splits finer
    than one 128-key block nor into more than 64 runs, and leaves no split
    empty: ``split_bounds``
    cuts the keys into exactly that many runs of whole blocks."""
    bh, seq_kv = args
    n = tflash.decode_splits(bh, seq_kv)
    assert n == want
    bounds = split_bounds(seq_kv, tflash.DECODE_BLOCK_KV, n)
    assert len(bounds) == n
    assert bounds[0][0] == 0 and bounds[-1][1] == seq_kv
    assert all(lo % tflash.DECODE_BLOCK_KV == 0 and lo < hi
               for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


# (seq_q, seq_kv, group, causal): 1, 4 and 16 query rows against 1, 300 and
# 1500 keys (ragged at 128), GQA groups 1 and 4; causal with seq_q ==
# seq_kv <= 16, as the kernel takes it.
SPLIT_CASES = ([(sq, skv, grp, False) for sq in (1, 4, 16)
                for skv in (1, 300, 1500) for grp in (1, 4)]
               + [(s, s, grp, True) for s in (1, 5, 16) for grp in (1, 4)])


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "q{}-kv{}-g{}-{}".format(
                             *c[:3], "causal" if c[3] else "full"))
def test_attention_split_ref_matches_pallas(case):
    """The decode body's plain twin, at the body's splits
    (``decode_splits``) and at 5, against the Pallas kernel in interpret
    mode (one pass over 128-key blocks, no split).  float32: P's cast is
    exact and the combine rescales each split's (acc, l) by exp(m_i - M),
    which differs from one running max only in float32 rounding: within
    1e-5.  bf16 inputs: the twin rounds P to bf16 relative to its split's
    running max, the Pallas body in interpret mode keeps P in float32;
    each weight moves by at most half a bf16 ulp (2^-8 of itself) and l
    sums the unrounded weights, so the output moves by at most
    2^-8·max|v|, beside one bf16 ulp of each side's output (2^-7·|ref|) —
    the bound of the blocked twin's test."""
    sq, skv, group, causal = case
    b, hq, d = 2, 4, 64
    q, k, v = _qkv(np.random.default_rng(sq * 7919 + skv * 31 + group),
                   b, hq, hq // group, sq, skv, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want32 = jflash(jq, jk, jv, causal=causal, interpret=True)
    bq, bk, bv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want16 = np.asarray(jflash(*(jnp.asarray(t.float().numpy())
                                 .astype(jnp.bfloat16) for t in (bq, bk, bv)),
                               causal=causal, interpret=True)
                        ).astype(np.float32)
    bound = (2.0 ** -7 * np.abs(want16)
             + 2.0 ** -8 * float(bv.float().abs().max()))
    for n in (tflash.decode_splits(b * hq, skv), 5):
        _close(f"f32, {n} splits", attention_split_ref(
            *map(torch.from_numpy, (q, k, v)), n_splits=n, causal=causal),
            want32)
        got = attention_split_ref(bq, bk, bv, n_splits=n, causal=causal)
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - want16)
        assert np.isfinite(got.float().numpy()).all()
        assert (diff <= bound).all(), (n, float((diff - bound).max()))


def test_flash_attention_twin_by_body():
    """``twin`` picks the plain twin of the body a bf16 call takes: the
    split twin at the body's splits for <= 16 rows, the blocked twin at the
    body's tile otherwise."""
    rng = np.random.default_rng(33)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 2, 4, 2, 3, 700, 64))
    n = tflash.decode_splits(8, 700)
    assert n == 6
    torch.testing.assert_close(
        tflash.twin(q, k, v, causal=False),
        attention_split_ref(q, k, v, n_splits=n, causal=False), rtol=0,
        atol=0)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 2, 2, 90, 90, 256))
    torch.testing.assert_close(
        tflash.twin(q, k, v), attention_blocked_ref(q, k, v, block_kv=80),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py checks them on the card)")
    return torch.device("cuda")


KERNEL_ATTN_SHAPES = ATTN_SHAPES + [(1, 8, 2, 130, 130, 128),
                                   (1, 2, 2, 65, 65, 256),
                                   (1, 2, 2, 190, 190, 192),
                                   (1, 2, 1, 300, 300, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", KERNEL_ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, shape, causal):
    """The f32 body (float32 operands) against the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in
               _qkv(np.random.default_rng(sum(shape)), *shape))
    before = dict(tflash.flash_attention.launches_by_path)
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches_by_path == \
        {**before, "f32": before["f32"] + 1}
    # f32 sums in another order than the plain version's.
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 2, 24, 56, 16),
                                   (2, 4, 4, 300, 129, 112)])
def test_flash_attention_wgmma_body_cross_lengths(cuda_device, shape):
    """Non-causal, seq_q != seq_kv and an explicit sm_scale on the wgmma
    body; tolerance as in the test below."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16)
               for a in _qkv(np.random.default_rng(sum(shape)), *shape))
    got = tflash.flash_attention(q, k, v, causal=False, sm_scale=0.3)
    want = attention_blocked_ref(q, k, v, causal=False, sm_scale=0.3,
                                 block_kv=tflash.block_kv_for(shape[-1]))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(v.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", KERNEL_ATTN_SHAPES)
def test_flash_attention_wgmma_body_matches_plain(cuda_device, shape, causal):
    """The wgmma body (bf16 operands) against its blocked twin and the
    plain version: one bf16 ulp of each output (2^-7·|ref|) and 2^-8·max|v|
    for P's rounding to bf16 (the twin rounds P too, but a weight whose f32
    value differs in the last bits between the two sides' sums may round
    one ulp apart)."""
    b, hq, hkv, sq, skv, d = shape
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16)
               for a in _qkv(np.random.default_rng(sum(shape)), *shape))
    before = dict(tflash.flash_attention.launches_by_path)
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches_by_path == \
        {**before, "wgmma": before["wgmma"] + 1}
    abs_tol = 2.0 ** -8 * float(v.float().abs().max())
    for want in (attention_blocked_ref(q, k, v, causal=causal,
                                       block_kv=tflash.block_kv_for(d)),
                 attention_ref(q, k, v, causal=causal)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=abs_tol)


# The serving shapes of the last three LM families, reduced in batch and
# heads: (name, (b, hq, hkv, seq_q, seq_kv, d), v's head dim, causal).  MLA
# hands the kernel V zero-padded from v_head_dim to the q/k head dim
# (deepseek-v2: 128 → 192); whisper's encoder runs non-causal over 1500
# frames (ragged at 64- and 128-key tiles), its decoder's cross-attention
# 256 prompt rows and single decode rows against them.
FAMILY_ATTN_CASES = [
    ("mla d192, v 128 zero-padded", (1, 4, 4, 300, 300, 192), 128, True,
     "wgmma"),
    ("encoder s1500 d64", (1, 2, 2, 1500, 1500, 64), 64, False, "wgmma"),
    ("cross q256 kv1500 d64", (1, 2, 2, 256, 1500, 64), 64, False, "wgmma"),
    ("cross q1 kv1500 d64", (2, 2, 2, 1, 1500, 64), 64, False, "decode"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", FAMILY_ATTN_CASES, ids=lambda c: c[0])
def test_flash_attention_family_shapes_match_plain(cuda_device, case, dtype):
    """Each body at the new shapes against ``attention_ref`` on the unpadded
    V: the tensor-core bodies (bf16: wgmma, or decode for one query row)
    within the tolerance of the test above, the f32 body within 1e-5."""
    _, shape, dv, causal, bf16_body = case
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(getattr(torch, dtype))
               for a in _qkv(np.random.default_rng(sum(shape)), *shape))
    v = v[..., :dv]
    body = bf16_body if dtype == "bfloat16" else "f32"
    before = dict(tflash.flash_attention.launches_by_path)
    got = tflash.flash_attention(
        q, k, torch.nn.functional.pad(v, (0, shape[-1] - dv)),
        causal=causal)[..., :dv]
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches_by_path == \
        {**before, body: before[body] + 1}
    want = attention_ref(q, k, v, causal=causal)
    if body == "f32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2.0 ** -7,
            atol=2.0 ** -8 * float(v.float().abs().max()))


def _launch_one(q, k, v, body, **kw):
    """One flash_attention call, which must launch once through ``body``."""
    before = dict(tflash.flash_attention.launches_by_path)
    got = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches_by_path == \
        {**before, body: before[body] + 1}
    return got


def _bf16_close(got, want, v):
    """One bf16 ulp of each output and 2^-8·max|v| for P's rounding, as in
    test_flash_attention_wgmma_body_matches_plain."""
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(v.float().abs().max()))


# The wgmma body above d = 128: ragged lengths against its 112- and 80-key
# tiles and the 128-row Q tile, GQA groups 1 and 2, causal and not, and
# cross-length calls (not causal).
WIDE_HEAD_CASES = ([((1, 4, 2, s, s, d), causal) for d in (192, 256)
             for s in (65, 190, 1000) for causal in (True, False)]
            + [((2, 2, 2, 300, 129, 256), False),
               ((1, 4, 4, 97, 1000, 192), False)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape, causal", WIDE_HEAD_CASES, ids=str)
def test_flash_attention_wgmma_body_wide_heads(cuda_device, shape, causal):
    """The wgmma body at d = 192 and 256 against its blocked twin
    (block_kv_for's tile) and the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16)
               for a in _qkv(np.random.default_rng(sum(shape)), *shape))
    got = _launch_one(q, k, v, "wgmma", causal=causal)
    for want in (tflash.twin(q, k, v, causal=causal),
                 attention_ref(q, k, v, causal=causal)):
        _bf16_close(got, want, v)


def _heads_view(rng, b, h, s, d):
    """A [b, h, s, d] transposed view of a [b, s, h, d] tensor, as
    ``_split_heads`` hands q, k and v to the kernel."""
    return (torch.from_numpy(rng.standard_normal((b, s, h, d))
                             .astype(np.float32)).to(torch.bfloat16)
            .transpose(1, 2))


# (seq_q, seq_kv, group, causal, d): 1 to 16 query rows, 1 to 1500 keys
# (ragged at 128), GQA groups 1 and 4, causal at seq_q == seq_kv, the five
# head-dim instantiations (16, 32, 64, 128, 256; 40 and 112 padded), and
# 9000 or 5000 keys, where a split holds several 128-key tiles (two stages
# of K and V up to d = 128, one at 256).
DECODE_CASES = ([(sq, skv, grp, False, 64) for sq in (1, 3, 16)
                 for skv in (1, 100, 1500) for grp in (1, 4)]
                + [(s, s, grp, True, 64) for s in (1, 9, 16) for grp in (1, 4)]
                + [(1, 1500, 1, False, d) for d in (16, 40, 112, 128, 256)]
                + [(16, 16, 4, True, 16), (4, 700, 2, False, 256),
                   (2, 9000, 4, False, 64), (1, 9000, 1, False, 128),
                   (1, 5000, 1, False, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_flash_attention_decode_body_matches_plain(cuda_device, case, views):
    """The decode body against its split twin (``decode_splits``) and the
    plain version, on contiguous operands and on whisper's transposed
    [b, s, h, d] views; a second call checks that the split counters were
    left at zero."""
    sq, skv, group, causal, d = case
    b, hq = 4, 8
    rng = np.random.default_rng(sum(case[:3]) + d)
    if views:
        q, k, v = (_heads_view(rng, b, h, s, d).to(cuda_device)
                   for h, s in ((hq, sq), (hq // group, skv),
                                (hq // group, skv)))
    else:
        q, k, v = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16)
                   for a in _qkv(rng, b, hq, hq // group, sq, skv, d))
    got = _launch_one(q, k, v, "decode", causal=causal)
    for want in (tflash.twin(q, k, v, causal=causal),
                 attention_ref(q, k, v, causal=causal)):
        _bf16_close(got, want, v)
    again = _launch_one(q, k, v, "decode", causal=causal)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_mla_forward_card_matches_cpu(cuda_device):
    """``mla_forward`` under ``"pallas"`` in float32 at deepseek-v2's smoke
    size, on the card (the f32 body on the zero-padded V) against the CPU:
    prefill output and latent caches, then one absorbed decode step,
    within 1e-4 of each output's largest value (cuBLAS and the kernel sum
    in another order than the CPU)."""
    cfg = dataclasses.replace(smoke_config(get_config("deepseek-v2-236b")),
                              dtype="float32", attention_impl="pallas")
    cpu = tattn.MLA(cfg, torch.Generator().manual_seed(28), device="cpu")
    rng = np.random.default_rng(28)
    b, s, max_len = 2, 70, 72
    x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model),
                                             dtype=np.float32))
    x1 = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model),
                                              dtype=np.float32))
    pos = torch.full((b, 1), s, dtype=torch.int32)
    outs = {}
    for dev in ("cpu", cuda_device):
        params = {n: p.to(dev) for n, p in cpu.named_parameters()}
        before = dict(tflash.flash_attention.launches_by_path)
        out, cache = tattn.mla_forward(params, x.to(dev), cfg, mode="prefill")
        launched = {k: n - before[k] for k, n in
                    tflash.flash_attention.launches_by_path.items()}
        assert launched == {"decode": 0, "wgmma": 0,
                            "f32": int(dev != "cpu")}
        dec = tattn.KVCache(*(torch.nn.functional.pad(
            c, (0, 0, 0, max_len - s)) for c in cache))
        out1, dec = tattn.mla_forward(params, x1.to(dev), cfg, mode="decode",
                                      positions=pos.to(dev), cache=dec,
                                      cache_index=s)
        outs[str(dev)] = [t.cpu() for t in (out, *cache, out1, *dec)]
    for name, got, want in zip(("prefill out", "c_kv", "k_rope",
                                "decode out", "decode c_kv", "decode k_rope"),
                               outs[str(cuda_device)], outs["cpu"],
                               strict=True):
        torch.testing.assert_close(
            got, want, rtol=0.0, atol=1e-4 * float(want.abs().max()),
            msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("shape", SCAN_SHAPES + [(2, 4, 200, 64, 64)])
def test_linear_scan_kernel_matches_plain(cuda_device, shape, mode):
    """The per-channel body (float32 operands) against the sequential
    recurrence."""
    q, k, v, w, u = (torch.from_numpy(a).to(cuda_device) for a in
                     _scan_inputs(np.random.default_rng(sum(shape)), *shape))
    u = u if mode == "bonus" else None
    before = dict(tscan.linear_scan.launches_by_path)
    got = tscan.linear_scan(q, k, v, w, u, mode=mode)
    want = tscan_ref.linear_scan_ref(q, k, v, w, u, mode=mode)
    torch.cuda.synchronize()
    assert tscan.linear_scan.launches_by_path == \
        {**before, "per_channel": before["per_channel"] + 1}
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("case", CHANNEL_CASES)
def test_linear_scan_channel_decay_body_matches_plain(cuda_device, case,
                                                      mode):
    """The channel-decay body (bf16 q, k, v; w rounded to bf16 as RWKV6
    hands it) against its twin and the per-channel chunked form, each
    launch counted under its body: one bf16 ulp of the output (2^-7·|ref|)
    and 1e-3 of the output's scale for TF32 products, ex2.approx and sums
    in another order."""
    rng = np.random.default_rng(sum(case[:5]) + len(case[5]))
    q, k, v, w, u = (torch.from_numpy(a).to(cuda_device) for a in
                     _channel_inputs(rng, *case))
    q, k, v, w = (a.to(torch.bfloat16) for a in (q, k, v, w))
    u = u if mode == "bonus" else None
    before = dict(tscan.linear_scan.launches_by_path)
    got = tscan.linear_scan(q, k, v, w, u, mode=mode)
    torch.cuda.synchronize()
    assert tscan.linear_scan.launches_by_path == \
        {**before, "channel_decay": before["channel_decay"] + 1}
    for want in (tscan_ref.linear_scan_channel_decay_ref(q, k, v, w, u,
                                                         mode=mode),
                 tscan_ref.linear_scan_chunked(q, k, v, w, u, mode=mode,
                                               chunk=tscan.SCALAR_CHUNK)):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(b, h, t, kd, vd) for b, h, t, kd, vd, _
                                   in SCALAR_SHAPES if kd % 16 == 0
                                   and vd % 16 == 0]
                         + [(2, 4, 200, 128, 48), (1, 3, 77, 48, 32)])
def test_linear_scan_scalar_decay_body_matches_plain(cuda_device, shape):
    """The scalar-decay body (bf16 operands, w a stride-0 view over K)
    against its twin and the per-channel chunked form: one bf16 ulp of the
    output (2^-7·|ref|) and 1e-3 of the output's scale for TF32 products
    and sums in another order."""
    b, h, t, kd, vd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v, _, _ = _scan_inputs(rng, b, h, t, kd, vd)
    w1 = -rng.uniform(0.0, 16.0, (b, h, t, 1)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda_device).to(torch.bfloat16)
               for a in (q, k, v))
    w = torch.from_numpy(w1).to(cuda_device).expand(b, h, t, kd)
    before = dict(tscan.linear_scan.launches_by_path)
    got = tscan.linear_scan(q, k, v, w)
    torch.cuda.synchronize()
    assert tscan.linear_scan.launches_by_path == \
        {**before, "scalar_decay": before["scalar_decay"] + 1}
    for want in (tscan_ref.linear_scan_scalar_decay_ref(q, k, v, w),
                 tscan_ref.linear_scan_chunked(q, k, v, w, chunk=64)):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-3 * scale)
