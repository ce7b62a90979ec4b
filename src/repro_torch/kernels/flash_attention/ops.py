"""Public wrapper of the flash-attention kernel.

``flash_attention`` runs the plain version (``ref.attention_ref``) on CPU
tensors and launches ``csrc/flash_attention.cu`` on CUDA tensors, counting
each launch in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (FLOAT, INT, PTR, check, dtype_code,
                                 launcher, on_card, stream)
from repro_torch.kernels.flash_attention.ref import attention_ref

BLOCK_Q = BLOCK_KV = 64          # the kernel's tiles (csrc/flash_attention.cu)
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block: f32 Q, K and V tiles with rows
    padded by one word, and the probability tile."""
    return 4 * (3 * BLOCK_Q * (head_dim + 1) + BLOCK_Q * (BLOCK_KV + 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Flash attention with GQA and causal masking.

    q: [batch, q_heads, seq_q, d];  k, v: [batch, kv_heads, seq_kv, d], any
    strides.  Scores and the softmax in float32, masked scores at -1e30 (the
    TPU kernel's NEG_INF); the result in q's dtype, contiguous.
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
    if not on_card(q, k, v):
        return attention_ref(q, k, v, sm_scale=sm_scale, causal=causal)
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head dim that is a multiple of "
                         f"8 up to {MAX_HEAD_DIM}, got {d}")
    out = torch.empty((batch, q_heads, seq_q, d), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*q.stride(), *k.stride(), *v.stride())
    launch = launcher("flash_attention", "flash_attention_launch",
                      (PTR,) * 4 + (INT,) * 4 + (INT,) * 6
                      + (PTR, FLOAT, INT, PTR))
    check(launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dtype_code(q), dtype_code(k), dtype_code(v), dtype_code(out),
                 batch, q_heads, kv_heads, seq_q, seq_kv, d, strides,
                 float(sm_scale), int(causal), stream()),
          "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
