"""Attention variants: GQA/MQA/MHA, MLA (DeepSeek-V2), cross-attention, and
the scaled dot-product core.

Three entry modes share one parameter set:
  * ``train``   — full causal self-attention over the sequence;
  * ``prefill`` — as train, but also returns the populated KV cache;
  * ``decode``  — one query token against the cache, written at
                  ``cache_index``.

MLA decode uses the *absorbed* formulation: queries are projected into the
kv_lora latent space (q_eff = q_nope · W_uk), scores are taken directly
against the cached compressed latent, and the attention-weighted latent is
expanded through W_uv afterwards — the cache stays at (kv_lora + rope_dim)
per token.

``constrain`` marks the activations' layouts where the JAX package's
``with_sharding_constraint``s stand; it is a no-op outside a sharding
scope (``parallel.sharding.activation_shardings``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (Params, apply_rope, dense, dtype_of,
                                       new_param, rms_norm, split_heads)
from repro_torch.parallel.sharding import (constrain, heads_layout,
                                           replicate_dim, shard_offset,
                                           splittable, write_at)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, n_kv, S_max, hd]   (MLA: c_kv [B, S_max, kv_lora])
    v: torch.Tensor   # [B, n_kv, S_max, hd]   (MLA: k_rope [B, S_max, rope])


# ---------------------------------------------------------------------------
# Scaled dot-product attention (plain PyTorch or the hand-written kernel)
# ---------------------------------------------------------------------------


def _chunked_attention(q, k, v, *, causal: bool, sm_scale: float,
                       block_kv: int, score_dtype=torch.float32,
                       q_offset: int | None = None):
    """Flash-style online-softmax attention in plain PyTorch (a loop over KV
    blocks): materializes only [*, Sq, block_kv] score tiles."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pad = (-skv) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nb = (skv + pad) // block_kv
    q_pos = torch.arange(sq, device=q.device) + (
        skv - sq if q_offset is None else q_offset)
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


def _sdpa_shards(q, k, v, *, decode_index=None, **kw):
    """``sdpa`` of DTensors on each rank's shards: attention is independent
    for each batch row and head, and for each query row given every key.
    q keeps its layout (batch, heads and, where the heads miss the model
    axis, the sequence split as ``constrain`` lays it out); K and V are
    laid out on q's batch and head shards, whole on the sequence; each rank
    runs the plain ``sdpa`` on its pieces, its query rows offset by their
    place in the sequence.  (DTensor's own einsums flatten [B, H], which
    torch 2.11 refuses where both are sharded.)  In decode each rank takes
    the K/V heads of its query heads from the whole cache."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = q.device_mesh
    q = replicate_dim(q, 3)
    if decode_index is None:
        layout = heads_layout(q)
        # Where q's rows are split, each rank's K/V gradient covers its own
        # rows only: a partial sum over those mesh dimensions.
        grads = [Partial() if p.is_shard(2) else l
                 for p, l in zip(q.placements, layout)]
        k, v = (t.redistribute(mesh, layout).to_local(grad_placements=grads)
                for t in (k, v))
        out = sdpa(q.to_local(), k, v,
                   q_offset=shard_offset(q, 2) + k.shape[2] - q.shape[2],
                   **kw)
    else:
        q = replicate_dim(q, 2)
        batch = [p if p.is_shard(0) else Replicate() for p in q.placements]
        ql = q.to_local()
        group = q.shape[1] // k.shape[1]
        heads = (torch.arange(ql.shape[1], device=ql.device)
                 + shard_offset(q, 1)) // group
        k, v = (t.redistribute(mesh, batch).to_local().index_select(1, heads)
                for t in (k, v))
        out = sdpa(ql, k, v, decode_index=decode_index, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def sdpa(q, k, v, *, causal: bool, impl: str = "xla",
         sm_scale: float | None = None, decode_index=None,
         block_kv: int = 0, score_dtype=torch.float32,
         q_offset: int | None = None):
    """q: [B,Hq,Sq,hd]; k,v: [B,Hkv,Skv,hd].

    ``impl="pallas"`` outside decode runs this repository's flash-attention
    kernel (``kernels.flash_attention``); ``"xla"`` the plain composites.
    ``decode_index``: when set, mask keys at positions > index (decode with
    a statically sized cache).  ``block_kv`` > 0 selects the chunked
    online-softmax path for train/prefill.  ``q_offset``: the causal
    position of q's first row (default: q ends where the keys end).
    DTensors run on each rank's shards (``_sdpa_shards``), so the JAX
    package's constraints on the score tiles have no counterpart: the
    scores are local to a rank.
    """
    from torch.distributed.tensor import DTensor

    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl == "pallas" and decode_index is None:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    kw = dict(causal=causal, impl=impl, sm_scale=sm_scale,
              block_kv=block_kv, score_dtype=score_dtype)
    if isinstance(q, DTensor) and decode_index is not None:
        return _sdpa_shards(constrain(q, "bhsk"), k, v,
                            decode_index=decode_index, **kw)

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
    q = constrain(q, "bhsk")
    k = constrain(k, "bhsk")
    v = constrain(v, "bhsk")
    if isinstance(q, DTensor):
        return _sdpa_shards(q, k, v, **kw)
    if block_kv:
        return _chunked_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  block_kv=block_kv, score_dtype=score_dtype,
                                  q_offset=q_offset)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (
            skv - sq if q_offset is None else q_offset)
        s = torch.where(torch.arange(skv, device=q.device)[None, :] <= qpos,
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class GQA(Params):
    """GQA projections; ``cross=True`` (cross-attention) has no q/k norms."""

    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        proj = ("embed", "heads")
        self.wq = dense(gen, stack, d, cfg.n_heads * hd, device, axes=proj)
        self.wk = dense(gen, stack, d, cfg.n_kv_heads * hd, device, axes=proj)
        self.wv = dense(gen, stack, d, cfg.n_kv_heads * hd, device, axes=proj)
        self.wo = dense(gen, stack, cfg.n_heads * hd, d, device,
                        scale=1.0 / (cfg.n_heads * hd) ** 0.5,
                        axes=("heads", "embed"))
        if cfg.qk_norm and not cross:
            self.q_norm = new_param(None, (*stack, hd), device, fill=1.0,
                                    axes=(None,))
            self.k_norm = new_param(None, (*stack, hd), device, fill=1.0,
                                    axes=(None,))


def gqa_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", positions: torch.Tensor | None = None,
                cache: KVCache | None = None, cache_index=None,
                kv_source=None, use_rope: bool = True):
    """Returns (out [B,S,D], new_cache | None).

    ``kv_source``: cross-attention source (encoder states); K/V come from
    it, no causal mask or rope applies, and no decode cache is read.

    In decode, this step's K/V are written into ``cache`` in place at
    ``cache_index`` (a saving over the JAX package's functional update: the
    caches are the decode loop's own), and the returned cache is ``cache``.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    dt = x.dtype
    cross = kv_source is not None
    if cross and cache is not None:
        raise ValueError("cross-attention takes its K/V from kv_source, "
                         "not from a cache")
    kv_in = kv_source if cross else x
    score_dtype = dtype_of(cfg.attn_score_dtype)

    q = constrain(split_heads(x @ params["wq"].to(dt), cfg.n_heads), "bhsk")
    k = split_heads(kv_in @ params["wk"].to(dt), cfg.n_kv_heads)
    v = split_heads(kv_in @ params["wv"].to(dt), cfg.n_kv_heads)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if use_rope and not cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)

    new_cache = None
    if mode == "decode" and cache is not None:
        write_at(cache.k, k, 2, cache_index)
        write_at(cache.v, v, 2, cache_index)
        new_cache = cache
        out = sdpa(q, cache.k.to(dt), cache.v.to(dt), causal=False,
                   impl=cfg.attention_impl, decode_index=cache_index,
                   score_dtype=score_dtype)
    else:
        out = sdpa(q, k, v, causal=not cross, impl=cfg.attention_impl,
                   block_kv=cfg.attn_block_kv, score_dtype=score_dtype)
        if mode == "prefill":
            new_cache = KVCache(k=k, v=v)

    out = constrain(out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd),
                    "bsh")
    return out @ params["wo"].to(dt), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLA(Params):
    """MLA projections: the query either through the low-rank ``wq_a`` →
    ``q_norm`` → ``wq_b`` (``q_lora_rank`` set) or one ``wq``; the joint
    K/V latent ``wkv_a`` → ``kv_norm`` → ``wkv_b``; the output ``wo``."""

    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
        if cfg.q_lora_rank:
            self.wq_a = dense(gen, stack, d, cfg.q_lora_rank, device,
                              axes=("embed", None))
            self.q_norm = new_param(None, (*stack, cfg.q_lora_rank), device,
                                    fill=1.0, axes=(None,))
            self.wq_b = dense(gen, stack, cfg.q_lora_rank, h * (nope + rope_d),
                              device, axes=(None, "heads"))
        else:
            self.wq = dense(gen, stack, d, h * (nope + rope_d), device,
                            axes=("embed", "heads"))
        self.wkv_a = dense(gen, stack, d, lora + rope_d, device,
                           axes=("embed", None))
        self.kv_norm = new_param(None, (*stack, lora), device, fill=1.0,
                                 axes=(None,))
        self.wkv_b = dense(gen, stack, lora, h * (nope + vd), device,
                           axes=(None, "heads"))
        self.wo = dense(gen, stack, h * vd, d, device,
                        scale=1.0 / (h * vd) ** 0.5, axes=("heads", "embed"))


def _mla_q(params, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, nope = cfg.n_heads, cfg.qk_nope_head_dim
    dt = x.dtype
    if cfg.q_lora_rank:
        cq = rms_norm(x @ params["wq_a"].to(dt), params["q_norm"])
        q = cq @ params["wq_b"].to(dt)
    else:
        q = x @ params["wq"].to(dt)
    q = split_heads(q, h)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)
    return q_nope, q_rope


def mla_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "train", positions: torch.Tensor | None = None,
                cache: KVCache | None = None, cache_index=None):
    """MLA attention.  Cache layout: KVCache(c_kv [B,S,kv_lora],
    k_rope [B,S,rope_d]) — the compressed latent, not expanded K/V.

    Train/prefill expand K/V and run ``sdpa`` with q/k head dim nope + rope
    and v head dim ``v_head_dim``.  The flash-attention kernel takes one
    head dim, so under ``"pallas"`` V is padded with zero columns to the
    q/k head dim and the output cut back to ``v_head_dim``: zero columns
    of V add nothing to P·V, so this computes what the plain path
    computes.  (The JAX package's ``"pallas"`` path passes the unpadded V
    to its kernel, whose output takes q's shape, and raises at the
    reshape.)  Decode is the absorbed form, in float32 scores against the
    latent and rope caches, and launches no kernel; this step's latent is
    written into ``cache`` in place at ``cache_index``.
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    lora = cfg.kv_lora_rank
    dt = x.dtype
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    q_nope, q_rope = _mla_q(params, x, cfg, positions)

    kv_a = x @ params["wkv_a"].to(dt)                     # [B,S,lora+rope]
    c_kv = rms_norm(kv_a[..., :lora], params["kv_norm"])
    k_rope = apply_rope(kv_a[..., lora:], positions, cfg.rope_theta)

    sm_scale = 1.0 / ((nope + rope_d) ** 0.5)
    w_kv_b = splittable(params["wkv_b"].to(dt), 1, h).reshape(lora, h,
                                                             nope + vd)
    w_uk, w_uv = w_kv_b[..., :nope], w_kv_b[..., nope:]

    new_cache = None
    if mode == "decode" and cache is not None:
        write_at(cache.k, c_kv, 1, cache_index)
        write_at(cache.v, k_rope, 1, cache_index)
        new_cache = cache
        # Absorbed decode: q_eff[b,h,q,lora] = q_nope · W_uk
        q_eff = constrain(torch.einsum("bhqn,lhn->bhql", q_nope, w_uk),
                          "bhsk")
        c32 = cache.k.float()
        scores = (torch.einsum("bhql,bsl->bhqs", q_eff.float(), c32)
                  + torch.einsum("bhqr,bsr->bhqs", q_rope.float(),
                                 cache.v.float())) * sm_scale
        scores = constrain(scores, "bhss")
        kpos = torch.arange(cache.k.shape[1], device=x.device)
        scores = torch.where(kpos <= cache_index, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        latent = torch.einsum("bhqs,bsl->bhql", p, c32).to(dt)
        out = torch.einsum("bhql,lhv->bhqv", latent, w_uv)
    else:
        # Train/prefill: expand K/V.
        kv = constrain(torch.einsum("bsl,lhx->bhsx", c_kv, w_kv_b),
                       "bhsk")                          # [B,H,S,nope+vd]
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, rope_d)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        kw = dict(causal=True, impl=cfg.attention_impl, sm_scale=sm_scale,
                  block_kv=cfg.attn_block_kv,
                  score_dtype=dtype_of(cfg.attn_score_dtype))
        if cfg.attention_impl == "pallas" and vd < nope + rope_d:
            out = sdpa(q, k, F.pad(v, (0, nope + rope_d - vd)), **kw)[..., :vd]
        else:
            out = sdpa(q, k, v, **kw)
        if mode == "prefill":
            new_cache = KVCache(k=c_kv, v=k_rope)

    out = constrain(out.transpose(1, 2).reshape(b, s, h * vd), "bsh")
    return out @ params["wo"].to(dt), new_cache
