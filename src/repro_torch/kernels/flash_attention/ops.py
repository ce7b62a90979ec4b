"""Public wrapper of the flash-attention kernel.

``flash_attention`` runs the plain version (``ref.attention_ref``) on CPU
tensors and launches ``csrc/flash_attention.cu`` on CUDA tensors.  The
kernel has three bodies, picked by ``body_for`` from the operands' type and
the number of query rows:

* ``"decode"`` when q, k and v are all bfloat16 and seq_q <= 16
  (``DECODE_MAX_Q``): split-KV flash decoding, ``decode_splits`` runs of
  whole 128-key blocks a (batch, q-head), ``mma.sync``, combined in one
  launch (its plain twin is ``ref.attention_split_ref``);
* ``"wgmma"`` for the other all-bfloat16 calls: a warp-specialised kernel
  (a TMA producer warpgroup, two consumer warpgroups), P rounded to bf16
  before P·V (its plain twin is ``ref.attention_blocked_ref`` at
  ``block_kv_for(d)``);
* ``"f32"`` for every other operand type: the CUDA-core body, products and
  P in float32.

This is a dispatch by type and shape, not a fallback: a call whose launch
fails raises.  A call that would need a gradient raises on either device
(``kernels.refuse_autograd``).  Each launch counts in
``flash_attention.launches`` and in
``flash_attention.launches_by_path[body]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (FLOAT, INT, PTR, check, check_row_layout,
                                 dtype_code, launcher, on_card,
                                 refuse_autograd, stream)
from repro_torch.kernels.flash_attention.ref import (
    attention_blocked_ref, attention_ref, attention_split_ref)

BLOCK_Q = BLOCK_KV = 64          # the f32 body's tiles
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the f32 body: f32 Q, K and V
    tiles with rows padded by one word, and the probability tile."""
    return 4 * (3 * BLOCK_Q * (head_dim + 1) + BLOCK_Q * (BLOCK_KV + 1))


DECODE_MAX_Q = 16                # query rows of one mma.sync m16 tile
DECODE_BLOCK_KV = 128            # the decode body's tile: the TPU kernel's
SMS = 132                        # streaming multiprocessors of an H100
DECODE_BLOCKS_PER_SM = 3         # two-tile decode blocks an SM holds at
                                 # d <= 64 (67.6 KB of shared memory each)
DECODE_MAX_SPLITS = 64           # the kernel's kMaxSplits


def body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel body a call runs: ``"decode"`` if q, k and v are all
    bfloat16 and q has at most ``DECODE_MAX_Q`` rows, ``"wgmma"`` for other
    all-bfloat16 calls, else ``"f32"``."""
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return "f32"
    return "decode" if q.shape[2] <= DECODE_MAX_Q else "wgmma"


def block_kv_for(head_dim: int) -> int:
    """The wgmma body's KV tile: 128 keys (the Pallas kernel's
    DEFAULT_BLOCK_KV) up to d = 128.  Above, the largest tile with two
    stages of K and V beside the 128-row Q tile in the 232448 bytes of
    shared memory a block may use (64-column 128-byte rows; 1 KB of
    alignment slack and 128 B of barriers):

    * d <= 192: Q 48 KB + 2 · (K + V) of 112 keys (2 · 2 · 112 · 384 B =
      168 KB) = 217 KB (128 keys: 241 KB);
    * d <= 256: Q 64 KB + 2 · 2 · 80 · 512 B = 160 KB = 225 KB (96 keys:
      257 KB)."""
    if head_dim <= 128:
        return 128
    return 112 if head_dim <= 192 else 80


def decode_splits(bh: int, seq_kv: int) -> int:
    """Splits of the decode body's keys a (batch, q-head), ``bh`` of them:
    enough blocks to fill the card's SMs ``DECODE_BLOCKS_PER_SM`` deep, at
    most ``DECODE_MAX_SPLITS``, each a run of whole 128-key blocks and none
    empty (``ref.split_bounds`` gives the same runs).  At whisper's decode
    cross-attention (64 heads, 12 blocks of keys) that is 6 splits of two
    blocks, 384 blocks in one wave, each copying its second tile while it
    computes its first."""
    blocks = max(1, -(-seq_kv // DECODE_BLOCK_KV))
    want = min(DECODE_MAX_SPLITS, -(-SMS * DECODE_BLOCKS_PER_SM // max(1, bh)))
    per = -(-blocks // min(blocks, want))
    return -(-blocks // per)


def twin(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, sm_scale: float | None = None
         ) -> torch.Tensor:
    """The plain twin of the tensor-core body a bf16 call takes, at that
    body's blocks and splits."""
    if body_for(q, k, v) == "decode":
        n = decode_splits(q.shape[0] * q.shape[1], k.shape[2])
        return attention_split_ref(q, k, v, block_kv=DECODE_BLOCK_KV,
                                   n_splits=n, causal=causal,
                                   sm_scale=sm_scale)
    return attention_blocked_ref(
        q, k, v, block_kv=block_kv_for(q.shape[-1]), causal=causal,
        sm_scale=sm_scale)


_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode body's per-(batch, q-head) counters for launches on the
    current stream of ``device``: zeros, which every launch leaves zero
    (its last block resets them).  Launches on one stream run one after
    the other; each stream has its own counters."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def tma_strides(t: torch.Tensor, name: str) -> tuple[int, ...]:
    """``t``'s strides as a TMA tensor map takes them, under
    ``check_row_layout``'s rule.  A dim of size 1 is never stepped, so its
    stride is replaced by the contiguous one."""
    check_row_layout(t, name)
    strides, inner = [], t.shape[-1]
    for size, stride in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        strides.append(inner if size == 1 else stride)
        inner *= size
    return (*reversed(strides), 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Flash attention with GQA and causal masking.

    q: [batch, q_heads, seq_q, d];  k, v: [batch, kv_heads, seq_kv, d].
    Scores and the softmax in float32, masked scores at -1e30 (the TPU
    kernel's NEG_INF); the result in q's dtype, contiguous.  The ``"f32"``
    body takes any strides; the ``"wgmma"`` body (all bf16) takes those of
    ``check_row_layout`` and raises for others: it copies nothing.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [batch, heads, seq, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    batch, q_heads, seq_q, d = q.shape
    _, kv_heads, seq_kv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != d:
        raise ValueError(f"k, v must be [{batch}, kv_heads, seq_kv, {d}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q_heads % kv_heads:
        raise ValueError(f"q_heads {q_heads} must be a multiple of kv_heads "
                         f"{kv_heads}")
    if causal and seq_q != seq_kv:
        raise ValueError("causal kernel requires seq_q == seq_kv; "
                         "use the decode path for single-token queries")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    refuse_autograd("flash_attention", q, k, v)
    if not on_card(q, k, v):
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal)
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head dim that is a multiple of "
                         f"8 up to {MAX_HEAD_DIM}, got {d}")
    out = torch.empty((batch, q_heads, seq_q, d), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    body = body_for(q, k, v)
    if body == "f32":
        strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(),
                                        *v.stride())
        launch = launcher("flash_attention", "flash_attention_launch",
                          (PTR,) * 4 + (INT,) * 4 + (INT,) * 6
                          + (PTR, FLOAT, INT, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     dtype_code(q), dtype_code(k), dtype_code(v),
                     dtype_code(out), batch, q_heads, kv_heads, seq_q, seq_kv,
                     d, strides, float(sm_scale), int(causal), stream())
    elif seq_kv == 0:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            check_row_layout(t, name)
        return out.zero_()               # no key: acc / 1 = 0, as the TPU's
    elif body == "decode":
        err = _launch_decode(q, k, v, out, causal, float(sm_scale))
    else:
        strides = (ctypes.c_int64 * 12)(*tma_strides(q, "q"),
                                        *tma_strides(k, "k"),
                                        *tma_strides(v, "v"))
        launch = launcher("flash_attention", "flash_attention_wgmma_launch",
                          (PTR,) * 4 + (INT,) * 6 + (PTR, FLOAT, INT, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     batch, q_heads, kv_heads, seq_q, seq_kv, d, strides,
                     float(sm_scale), int(causal), stream())
    check(err, f"flash_attention ({body})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[body] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = {"decode": 0, "wgmma": 0, "f32": 0}


def _launch_decode(q, k, v, out, causal: bool, sm_scale: float) -> int:
    strides = (ctypes.c_int64 * 12)(*tma_strides(q, "q"),
                                    *tma_strides(k, "k"),
                                    *tma_strides(v, "v"))
    batch, q_heads, seq_q, d = q.shape
    seq_kv = k.shape[2]
    n_splits = decode_splits(batch * q_heads, seq_kv)
    part = torch.empty(batch * q_heads * n_splits * seq_q * (d + 2)
                       if n_splits > 1 else 0, dtype=torch.float32,
                       device=q.device)
    counters = _split_counters(q.device, batch * q_heads)
    launch = launcher("flash_attention", "flash_attention_decode_launch",
                      (PTR,) * 6 + (INT,) * 6 + (PTR, FLOAT, INT, INT, PTR))
    return launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  part.data_ptr(), counters.data_ptr(), batch, q_heads,
                  k.shape[1], seq_q, seq_kv, d, strides, sm_scale,
                  int(causal), n_splits, stream())
