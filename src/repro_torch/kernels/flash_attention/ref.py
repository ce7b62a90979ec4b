"""Plain PyTorch version of flash attention (causal + GQA): the twin of the
JAX package's ``kernels/flash_attention/ref.py``."""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, sm_scale: float | None = None,
                  causal: bool = True):
    """Reference attention.

    q: [batch, q_heads, seq_q, d];  k, v: [batch, kv_heads, seq_kv, d].
    GQA: q_heads must be a multiple of kv_heads.  Scores, softmax and the
    weighted sum in float32; the result in q's dtype.
    """
    _, q_heads, seq_q, d = q.shape
    kv_heads, seq_kv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = q_heads // kv_heads
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        # Causal alignment for seq_q != seq_kv (decode): query i attends to
        # keys [0, seq_kv - seq_q + i].
        qi = torch.arange(seq_q, device=q.device)[:, None] + (seq_kv - seq_q)
        ki = torch.arange(seq_kv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
