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


NEG_INF = -1e30                  # the TPU kernel's masked score


def _online_softmax(q, k, v, kv_lo: int, kv_hi: int, block_kv: int,
                    causal: bool, sm_scale: float):
    """The Pallas body's online softmax over keys [kv_lo, kv_hi) in blocks
    of ``block_kv`` keys from kv_lo, P rounded to ``v.dtype`` before P·V:
    (m, l, acc) of every query row, float32."""
    _, q_heads, seq_q, _ = q.shape
    group = q_heads // k.shape[1]
    q32 = q.float()
    q_pos = torch.arange(seq_q, device=q.device)[:, None]
    m = torch.full((*q.shape[:3], 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*q.shape[:3], v.shape[-1]), device=q.device)
    for kv0 in range(kv_lo, kv_hi, block_kv):
        kv1 = min(kv0 + block_kv, kv_hi)
        kb = k[:, :, kv0:kv1].repeat_interleave(group, dim=1)
        vb = v[:, :, kv0:kv1].repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb.float()) * sm_scale
        if causal:
            kv_pos = kv0 + torch.arange(kb.shape[2], device=q.device)[None]
            mask = kv_pos <= q_pos
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - torch.where(m_new <= NEG_INF / 2, 0.0, m_new))
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    return m, l, acc


def attention_blocked_ref(q, k, v, *, block_kv: int = 128, causal: bool = True,
                          sm_scale: float | None = None):
    """The Pallas body's online softmax over KV blocks of ``block_kv`` keys,
    with P rounded to ``v.dtype`` before P·V: the plain twin of the wgmma
    body.

    Per block: scores times sm_scale in float32, masked (keys at or past
    seq_kv, and after the query if causal) to -1e30; the running max m, the
    normalizer l (summed from the unrounded P) and the accumulator with the
    TPU kernel's guards for fully masked rows; acc / (l == 0 ? 1 : l) in
    q's dtype.  Causal requires seq_q == seq_kv, as the kernel does.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _, l, acc = _online_softmax(q, k, v, 0, k.shape[2], block_kv, causal,
                                sm_scale)
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def split_bounds(seq_kv: int, block_kv: int, n_splits: int
                 ) -> list[tuple[int, int]]:
    """The key ranges of a split-KV call: the ``ceil(seq_kv / block_kv)``
    blocks dealt in runs of ``ceil(blocks / n_splits)`` whole blocks (so a
    split starts on a block boundary; trailing splits may be empty and are
    left out)."""
    blocks = -(-seq_kv // block_kv)
    per = max(1, -(-blocks // n_splits))
    return [(b0 * block_kv, min(seq_kv, (b0 + per) * block_kv))
            for b0 in range(0, blocks, per)]


def attention_split_ref(q, k, v, *, block_kv: int = 128, n_splits: int = 1,
                        causal: bool = True, sm_scale: float | None = None):
    """The decode body's plain twin: the keys cut into ``split_bounds``
    runs of whole ``block_kv``-key blocks, each an online softmax as in
    ``attention_blocked_ref`` (P rounded to ``v.dtype``), then the float32
    combine: M = max_i m_i, w_i = exp(m_i - M) (0 for a split whose row is
    all masked), acc = Σ w_i acc_i, l = Σ w_i l_i, acc / (l == 0 ? 1 : l)
    in q's dtype.  One split is ``attention_blocked_ref``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    parts = [_online_softmax(q, k, v, lo, hi, block_kv, causal, sm_scale)
             for lo, hi in split_bounds(k.shape[2], block_kv, n_splits)]
    if not parts:                    # no key: acc / 1 = 0
        return torch.zeros((*q.shape[:3], v.shape[-1]), dtype=q.dtype,
                           device=q.device)
    m_all = torch.stack([m for m, _, _ in parts])
    top = m_all.amax(dim=0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m, l_i, acc_i in parts:
        w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - top))
        l = l + w * l_i
        acc = acc + w * acc_i
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
