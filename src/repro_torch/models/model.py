"""Model top level: init / prefill / decode.

The port runs the decoder-only stacks: zamba2's hybrid stack (Mamba2
layers with one shared attention + MLP block applied every ``attn_every``
layers) and a plain stack of GQA + MLP layers.  Where the JAX package scans
over a stacked layer axis, the port loops over it in Python; parameters
and caches keep the stacked layout.  Training, MoE, MLA, RWKV6 and the
encoder-decoder stack are still to port (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attnlib
from repro_torch.models import ssm as ssmlib
from repro_torch.models.layers import (MLP, NOT_PORTED, Norm, Params,
                                       apply_mlp, apply_norm, dtype_of,
                                       embed_tokens, init_embedding,
                                       logits_from_hidden)
from repro_torch.models.transformer import DecoderLayers, decoder_layer


class StackSegment(NamedTuple):
    """A homogeneous segment of the layer stack."""
    name: str
    n_layers: int
    moe: bool


def _segments(cfg: ModelConfig) -> list[StackSegment]:
    if cfg.n_experts and cfg.first_dense_layers:
        return [StackSegment("dense", cfg.first_dense_layers, False),
                StackSegment("moe", cfg.n_layers - cfg.first_dense_layers,
                             True)]
    if cfg.n_experts:
        return [StackSegment("moe", cfg.n_layers, True)]
    return [StackSegment("layers", cfg.n_layers, False)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class LMParams(Params):
    """Every parameter of the model, named by its JAX pytree path."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        if cfg.encoder_layers:
            raise NotImplementedError(
                f"the encoder-decoder stack {NOT_PORTED}")
        self.embed = init_embedding(gen, cfg, device)
        if not cfg.tie_embeddings:
            self.head = init_embedding(gen, cfg, device)  # [vocab, d]
        self.final_norm = Norm(cfg, (), device)
        for seg in _segments(cfg):
            self.add_module(seg.name, DecoderLayers(cfg, seg.n_layers, gen,
                                                    device, seg.moe))
        if cfg.attn_every:                  # zamba2 shared block
            self.shared_attn = attnlib.GQA(cfg, gen, (), device)
            self.shared_mlp = MLP(cfg, gen, (), device)
            self.shared_norm1 = Norm(cfg, (), device)
            self.shared_norm2 = Norm(cfg, (), device)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> LMParams:
    """Random float32 parameters drawn from ``gen`` on ``device`` (the card
    unless the caller asks for the CPU); ``gen`` must live there too."""
    return LMParams(cfg, gen, resolve_device(device))


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _layer_cache(caches, i):
    """Layer i's view of a layer-stacked cache, or None."""
    if caches is None:
        return None
    return type(caches)(*(c[i] for c in caches))


def _store(caches, i, new) -> None:
    """Write a layer's new decode cache into the stacked caches in place."""
    for dst, src in zip(caches, new):
        dst[i].copy_(src)


def _stacked(new_caches: list):
    return type(new_caches[0])(*(torch.stack(cs) for cs in zip(*new_caches)))


def _run_layer(layers: Params, i: int, x, cfg, caches, new, *, mode,
               positions, cache_index):
    cache = _layer_cache(caches, i)
    x, nc, _ = decoder_layer(layers.layer(i), x, cfg, moe=False, mode=mode,
                             positions=positions, cache=cache,
                             cache_index=cache_index)
    if mode == "decode" and nc is not cache:  # KV caches are written in place
        _store(caches, i, nc)
    elif mode == "prefill":
        new.append(nc)
    return x


def _zamba_stack(params, x, cfg: ModelConfig, *, mode: str, positions,
                 caches, cache_index):
    """Mamba backbone with the shared attention + MLP block after every
    ``attn_every`` layers (zamba2), then the remaining tail layers.  The
    shared block's parameters are one set reused by every application; its
    KV caches are per application."""
    per = cfg.attn_every
    groups = cfg.n_layers // per
    layers = params["layers"]
    mamba_caches, attn_caches = caches if caches is not None else (None, None)
    new_mamba, new_attn = [], []
    kw = dict(mode=mode, positions=positions, cache_index=cache_index)
    for g in range(groups):
        for i in range(g * per, (g + 1) * per):
            x = _run_layer(layers, i, x, cfg, mamba_caches, new_mamba, **kw)
        h, a_cache = attnlib.gqa_forward(
            params["shared_attn"], apply_norm(x, params["shared_norm1"], cfg),
            cfg, cache=_layer_cache(attn_caches, g), **kw)
        x = x + h
        x = x + apply_mlp(apply_norm(x, params["shared_norm2"], cfg),
                          params["shared_mlp"], cfg)
        new_attn.append(a_cache)
    for i in range(groups * per, cfg.n_layers):
        x = _run_layer(layers, i, x, cfg, mamba_caches, new_mamba, **kw)
    if mode == "prefill":
        return x, (_stacked(new_mamba), _stacked(new_attn))
    return x, caches


def apply_stack(params, x, cfg: ModelConfig, *, mode: str, positions,
                caches, cache_index):
    """Run the decoder stack.  Returns (x, caches): prefill's new stacked
    caches, decode's ``caches`` updated in place, or None in train mode."""
    if cfg.attn_every:
        return _zamba_stack(params, x, cfg, mode=mode, positions=positions,
                            caches=caches, cache_index=cache_index)
    new_caches = {}
    for seg in _segments(cfg):
        seg_caches = None if caches is None else caches[seg.name]
        new = []
        for i in range(seg.n_layers):
            x = _run_layer(params[seg.name], i, x, cfg, seg_caches, new,
                           mode=mode, positions=positions,
                           cache_index=cache_index)
        if mode == "prefill":
            new_caches[seg.name] = _stacked(new)
    if mode == "decode":
        return x, caches
    return x, (new_caches or None)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Layer-stacked decode caches, zeros: for zamba2 (Mamba2 caches
    [n_layers, ...], shared-block KV caches [groups, ...]); otherwise
    {segment: KV cache [n_layers, ...]}."""
    device = resolve_device(device)
    dt = dtype_of(cfg.dtype)

    def kv(n):
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        return attnlib.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                               v=torch.zeros(shape, dtype=dt, device=device))

    if cfg.attn_every:
        one = ssmlib.init_mamba2_cache(cfg, batch, dt, device)
        mamba = ssmlib.SSMCache(*(torch.zeros((cfg.n_layers, *c.shape),
                                              dtype=c.dtype, device=device)
                                  for c in one))
        return (mamba, kv(cfg.n_layers // cfg.attn_every))
    if cfg.ssm != "none" or cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.ssm}/{cfg.attention} caches {NOT_PORTED}")
    return {seg.name: kv(seg.n_layers) for seg in _segments(cfg)}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _tokens_only(cfg: ModelConfig) -> None:
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode={cfg.input_mode!r} {NOT_PORTED}")


@torch.no_grad()
def prefill(params, batch: dict, cfg: ModelConfig):
    """Full-sequence forward building the decode cache.

    Returns (logits_last [B, vocab] float32, caches, None) — the last is
    the JAX signature's encoder output, which token-input models lack.
    """
    _tokens_only(cfg)
    x = embed_tokens(batch["tokens"], params["embed"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, caches = apply_stack(params, x, cfg, mode="prefill",
                            positions=positions, caches=None, cache_index=None)
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_from_hidden(x[:, -1], _head(params, cfg)), caches, None


@torch.no_grad()
def decode_step(params, tokens, caches, cache_index: int, cfg: ModelConfig):
    """One decode step.  tokens: [B] int.  Writes this step's K/V and
    recurrent state into ``caches`` in place.

    Returns (logits [B, vocab] float32, caches).
    """
    _tokens_only(cfg)
    x = embed_tokens(tokens[:, None], params["embed"], cfg)
    positions = torch.full((x.shape[0], 1), cache_index, dtype=torch.int32,
                           device=x.device)
    x, caches = apply_stack(params, x, cfg, mode="decode",
                            positions=positions, caches=caches,
                            cache_index=cache_index)
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_from_hidden(x[:, 0], _head(params, cfg)), caches
