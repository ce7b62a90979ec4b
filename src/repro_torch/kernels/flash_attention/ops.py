"""Public wrapper of the flash-attention kernel.

``flash_attention`` runs the plain version (``ref.attention_ref``) on CPU
tensors and launches ``csrc/flash_attention.cu`` on CUDA tensors.  The
kernel has two bodies, picked by ``body_for``:

* ``"wgmma"`` when q, k and v are all bfloat16: tensor cores, TMA loads,
  P rounded to bf16 before P·V (its plain twin is
  ``ref.attention_blocked_ref`` at ``block_kv_for(d)``);
* ``"f32"`` for every other operand type: the CUDA-core body, products and
  P in float32.

This is a dispatch by type, not a fallback: a bf16 call whose tensor-core
launch fails raises.  A call that would need a gradient raises on either
device (``kernels.refuse_autograd``).  Each launch counts in
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
from repro_torch.kernels.flash_attention.ref import attention_ref

BLOCK_Q = BLOCK_KV = 64          # the f32 body's tiles
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the f32 body: f32 Q, K and V
    tiles with rows padded by one word, and the probability tile."""
    return 4 * (3 * BLOCK_Q * (head_dim + 1) + BLOCK_Q * (BLOCK_KV + 1))


def body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel body a call runs: ``"wgmma"`` if q, k and v are all
    bfloat16, else ``"f32"``."""
    return ("wgmma" if q.dtype == k.dtype == v.dtype == torch.bfloat16
            else "f32")


def block_kv_for(head_dim: int) -> int:
    """The wgmma body's KV tile: 128 keys (the Pallas kernel's
    DEFAULT_BLOCK_KV), 64 where d > 128 leaves no room for two 128-key
    stages of K and V in shared memory."""
    return 128 if head_dim <= 128 else 64


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
    if body == "wgmma":
        strides = (ctypes.c_int64 * 12)(*tma_strides(q, "q"),
                                        *tma_strides(k, "k"),
                                        *tma_strides(v, "v"))
        if seq_kv == 0:
            return out.zero_()           # no key: acc / 1 = 0, as the TPU's
        launch = launcher("flash_attention", "flash_attention_wgmma_launch",
                          (PTR,) * 4 + (INT,) * 6 + (PTR, FLOAT, INT, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     batch, q_heads, kv_heads, seq_q, seq_kv, d, strides,
                     float(sm_scale), int(causal), stream())
    else:
        strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(),
                                        *v.stride())
        launch = launcher("flash_attention", "flash_attention_launch",
                          (PTR,) * 4 + (INT,) * 4 + (INT,) * 6
                          + (PTR, FLOAT, INT, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     dtype_code(q), dtype_code(k), dtype_code(v),
                     dtype_code(out), batch, q_heads, kv_heads, seq_q, seq_kv,
                     d, strides, float(sm_scale), int(causal), stream())
    check(err, f"flash_attention ({body})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[body] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = {"wgmma": 0, "f32": 0}
