"""Attention: GQA/MQA/MHA self-attention and the scaled dot-product core.

Three entry modes share one parameter set:
  * ``train``   — full causal self-attention over the sequence;
  * ``prefill`` — as train, but also returns the populated KV cache;
  * ``decode``  — one query token against the cache, written at
                  ``cache_index``.

MLA (DeepSeek-V2) and cross-attention are still to port (ROADMAP.md queue 1
item 10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (NOT_PORTED, Params, apply_rope, dense,
                                       new_param, rms_norm)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, n_kv, S_max, hd]
    v: torch.Tensor   # [B, n_kv, S_max, hd]


# ---------------------------------------------------------------------------
# Scaled dot-product attention (plain PyTorch or the hand-written kernel)
# ---------------------------------------------------------------------------


def _chunked_attention(q, k, v, *, causal: bool, sm_scale: float,
                       block_kv: int, score_dtype=torch.float32):
    """Flash-style online-softmax attention in plain PyTorch (a loop over KV
    blocks): materializes only [*, Sq, block_kv] score tiles."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pad = (-skv) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nb = (skv + pad) // block_kv
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    neg_big = NEG_INF if score_dtype == torch.float32 else -3e38

    m = torch.full((b, hq, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq, 1), device=q.device)
    acc = torch.zeros((b, hq, sq, v.shape[-1]), device=q.device)
    for idx in range(nb):
        k_blk = k[:, :, idx * block_kv:(idx + 1) * block_kv]
        v_blk = v[:, :, idx * block_kv:(idx + 1) * block_kv]
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(score_dtype),
                         k_blk.to(score_dtype)) * sm_scale
        kv_pos = idx * block_kv + torch.arange(block_kv, device=q.device)
        mask = kv_pos[None, :] < skv
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, neg_big)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True).float())
        p = torch.exp(s - m_new.to(score_dtype))
        p = torch.where(mask, p, 0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True).float()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.float(),
                                         v_blk.float())
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def sdpa(q, k, v, *, causal: bool, impl: str = "xla",
         sm_scale: float | None = None, decode_index=None,
         block_kv: int = 0, score_dtype=torch.float32):
    """q: [B,Hq,Sq,hd]; k,v: [B,Hkv,Skv,hd].

    ``impl="pallas"`` outside decode runs this repository's flash-attention
    kernel (``kernels.flash_attention``); ``"xla"`` the plain composites.
    ``decode_index``: when set, mask keys at positions > index (decode with
    a statically sized cache).  ``block_kv`` > 0 selects the chunked
    online-softmax path for train/prefill.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl == "pallas" and decode_index is None:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    if decode_index is not None:
        # Decode: grouped-query attention against the cache, no head
        # repetition; scores in ``score_dtype``.
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        assert sq == 1, "decode path expects a single query position"
        g = hq // hkv
        qg = q.reshape(b, hkv, g, d)
        s = torch.einsum("bhgd,bhkd->bhgk", qg.to(score_dtype),
                         k.to(score_dtype)) * sm_scale
        neg = NEG_INF if score_dtype == torch.float32 else -3e38
        kpos = torch.arange(skv, device=q.device)
        s = torch.where(kpos <= decode_index, s, neg)
        p = torch.softmax(s.float() if score_dtype == torch.float32
                          else s, dim=-1)
        out = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype).float(),
                           v.float())
        return out.reshape(b, hq, sq, d).to(q.dtype)

    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    if block_kv:
        return _chunked_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  block_kv=block_kv, score_dtype=score_dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        s = torch.where(torch.arange(skv, device=q.device)[None, :] <= qpos,
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class GQA(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        if cfg.attention == "mla":
            raise NotImplementedError(f"MLA attention {NOT_PORTED}")
        d, hd = cfg.d_model, cfg.head_dim_
        self.wq = dense(gen, stack, d, cfg.n_heads * hd, device)
        self.wk = dense(gen, stack, d, cfg.n_kv_heads * hd, device)
        self.wv = dense(gen, stack, d, cfg.n_kv_heads * hd, device)
        self.wo = dense(gen, stack, cfg.n_heads * hd, d, device,
                        scale=1.0 / (cfg.n_heads * hd) ** 0.5)
        if cfg.qk_norm:
            self.q_norm = new_param(None, (*stack, hd), device, fill=1.0)
            self.k_norm = new_param(None, (*stack, hd), device, fill=1.0)


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)


def gqa_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", positions: torch.Tensor | None = None,
                cache: KVCache | None = None, cache_index=None,
                kv_source=None, use_rope: bool = True):
    """Returns (out [B,S,D], new_cache | None).

    In decode, this step's K/V are written into ``cache`` in place at
    ``cache_index`` (a saving over the JAX package's functional update: the
    caches are the decode loop's own), and the returned cache is ``cache``.
    """
    if kv_source is not None:
        raise NotImplementedError(f"cross-attention {NOT_PORTED}")
    b, s, _ = x.shape
    hd = cfg.head_dim_
    dt = x.dtype
    score_dtype = {"float32": torch.float32,
                   "bfloat16": torch.bfloat16}[cfg.attn_score_dtype]

    q = _split_heads(x @ params["wq"].to(dt), cfg.n_heads, hd)
    k = _split_heads(x @ params["wk"].to(dt), cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"].to(dt), cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)

    new_cache = None
    if mode == "decode" and cache is not None:
        cache.k[:, :, cache_index:cache_index + s] = k.to(cache.k.dtype)
        cache.v[:, :, cache_index:cache_index + s] = v.to(cache.v.dtype)
        new_cache = cache
        out = sdpa(q, cache.k.to(dt), cache.v.to(dt), causal=False,
                   impl=cfg.attention_impl, decode_index=cache_index,
                   score_dtype=score_dtype)
    else:
        out = sdpa(q, k, v, causal=True, impl=cfg.attention_impl,
                   block_kv=cfg.attn_block_kv, score_dtype=score_dtype)
        if mode == "prefill":
            new_cache = KVCache(k=k, v=v)

    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return out @ params["wo"].to(dt), new_cache
