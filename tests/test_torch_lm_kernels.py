"""The LM kernels of the port against the JAX package: flash attention and
the chunked linear scan.

Inputs are drawn with numpy from fixed seeds and fed to both packages.  On
the CPU the port's wrappers run their plain PyTorch versions; they are held
against the JAX wrappers (the Pallas kernels in interpret mode) and against
the JAX ``ref.py`` oracles, in float32, within 1e-5.  The CUDA kernels are
held against the same plain versions on the card (``cuda``-marked tests
here, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.linear_scan import ref as jscan_ref
from repro.kernels.linear_scan.ops import linear_scan as jscan
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.kernels.linear_scan import ref as tscan_ref

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
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py checks them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 8, 2, 130, 130, 128),
                                                 (1, 2, 2, 65, 65, 256)])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in
               _qkv(np.random.default_rng(sum(shape)), *shape))
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    # f32 sums in another order than the plain version's.
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("shape", SCAN_SHAPES + [(2, 4, 200, 64, 64)])
def test_linear_scan_kernel_matches_plain(cuda_device, shape, mode):
    q, k, v, w, u = (torch.from_numpy(a).to(cuda_device) for a in
                     _scan_inputs(np.random.default_rng(sum(shape)), *shape))
    u = u if mode == "bonus" else None
    got = tscan.linear_scan(q, k, v, w, u, mode=mode)
    want = tscan_ref.linear_scan_ref(q, k, v, w, u, mode=mode)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
