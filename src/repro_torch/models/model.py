"""Model top level: init / train loss / prefill / decode for every arch.

The stacks: zamba2's hybrid stack (Mamba2 layers with one shared attention
+ MLP block applied every ``attn_every`` layers), RWKV6's attention-free
stack, stacks of GQA or MLA layers with an MLP or the MoE layer (a segment
of each kind, as the JAX package splits them), and whisper's
encoder-decoder (a bidirectional encoder over frame embeddings, decoder
layers with cross-attention to its output).  Embeddings-input archs
(llava) take ``embeds`` in place of tokens.  Where the JAX package scans
over a stacked layer axis, the port loops over it in Python; parameters
and caches keep the stacked layout, and a stack is taken apart once a call
(``Params.per_layer``).  Training runs ``train_loss`` under ``torch.autograd``
with per-layer remat where the JAX package has it.  On a device mesh the
parameters and the batch are DTensors (``parallel.sharding``), and
``constrain`` marks the activations' layouts at the JAX package's places
inside an ``activation_shardings`` scope.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attnlib
from repro_torch.models import ssm as ssmlib
from repro_torch.models.layers import (MLP, Norm, Params, apply_mlp,
                                       apply_norm, cross_entropy, dtype_of,
                                       embed_tokens, init_embedding,
                                       logits_from_hidden)
from repro_torch.models.transformer import DecoderLayers, decoder_layer
from repro_torch.parallel.sharding import constrain


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


class EncoderLayers(Params):
    """whisper's encoder layers, stacked: pre-norm bidirectional attention
    (no q/k norms) and an MLP."""

    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        stack = (cfg.encoder_layers,)
        self.norm1 = Norm(cfg, stack, device)
        self.attn = attnlib.GQA(dataclasses.replace(cfg, qk_norm=False), gen,
                                stack, device)
        self.norm2 = Norm(cfg, stack, device)
        self.mlp = MLP(cfg, gen, stack, device)


class LMParams(Params):
    """Every parameter of the model, named by its JAX pytree path."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        # Embeddings-input archs still embed generated tokens in decode.
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
        if cfg.encoder_layers:              # whisper encoder
            self.encoder = EncoderLayers(cfg, gen, device)
            self.encoder_norm = Norm(cfg, (), device)


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


def _remat(fn, on: bool):
    """``fn``, recomputed in the backward pass instead of keeping its
    activations (the JAX package's ``jax.checkpoint``) when ``on`` and grad
    mode is on; as it is otherwise."""
    if not (on and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _run_layer(lp: dict, i: int, x, cfg, caches, new, *, mode, positions,
               cache_index, moe: bool = False, encoder_out=None,
               remat: bool = False):
    """Decoder layer i (parameters ``lp``); returns (x, its aux loss)."""
    cache = _layer_cache(caches, i)

    def body(x):
        return decoder_layer(lp, x, cfg, moe=moe, mode=mode,
                             positions=positions, cache=cache,
                             cache_index=cache_index, encoder_out=encoder_out)

    x, nc, aux = _remat(body, remat)(x)
    if mode == "decode" and nc is not cache:  # KV caches are written in place
        _store(caches, i, nc)
    elif mode == "prefill":
        new.append(nc)
    return x, aux


def _zamba_stack(params, x, cfg: ModelConfig, *, mode: str, positions,
                 caches, cache_index):
    """Mamba backbone with the shared attention + MLP block after every
    ``attn_every`` layers (zamba2), then the remaining tail layers.  The
    shared block's parameters are one set reused by every application; its
    KV caches are per application.  In train mode with ``cfg.remat`` each
    group (its layers and the shared block) is recomputed in the backward
    pass, as the JAX package's scan body is."""
    per = cfg.attn_every
    groups = cfg.n_layers // per
    layers = params["layers"].per_layer()
    mamba_caches, attn_caches = caches if caches is not None else (None, None)
    new_mamba, new_attn = [], []
    kw = dict(mode=mode, positions=positions, cache_index=cache_index)

    def group(x, g):
        for i in range(g * per, (g + 1) * per):
            x, _ = _run_layer(layers[i], i, x, cfg, mamba_caches, new_mamba,
                              **kw)
        h, a_cache = attnlib.gqa_forward(
            params["shared_attn"], apply_norm(x, params["shared_norm1"], cfg),
            cfg, cache=_layer_cache(attn_caches, g), **kw)
        x = x + h
        x = x + apply_mlp(apply_norm(x, params["shared_norm2"], cfg),
                          params["shared_mlp"], cfg)
        return x, a_cache

    for g in range(groups):
        x, a_cache = _remat(functools.partial(group, g=g),
                            cfg.remat and mode == "train")(x)
        new_attn.append(a_cache)
    for i in range(groups * per, cfg.n_layers):
        x, _ = _run_layer(layers[i], i, x, cfg, mamba_caches, new_mamba, **kw)
    if mode == "prefill":
        return x, (_stacked(new_mamba), _stacked(new_attn))
    return x, caches


def _sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1)[:, :d]


def _encoder_stack(params, x, cfg: ModelConfig):
    """Whisper encoder: bidirectional attention over (stub) frame embeddings
    with sinusoidal positions.  Full attention is expressed through the
    cross-attention path (kv_source = normed x → no causal mask, no rope)."""
    x = x + _sinusoidal_positions(x.shape[1], x.shape[-1],
                                  x.device).to(x.dtype)

    def body(x, lp):
        normed = apply_norm(x, lp["norm1"], cfg)
        h, _ = attnlib.gqa_forward(lp["attn"], normed, cfg, mode="train",
                                   kv_source=normed)
        x = x + h
        return x + apply_mlp(apply_norm(x, lp["norm2"], cfg), lp["mlp"], cfg)

    for lp in params["encoder"].per_layer():
        x = _remat(body, cfg.remat)(x, lp)
    return apply_norm(x, params["encoder_norm"], cfg)


def apply_stack(params, x, cfg: ModelConfig, *, mode: str, positions,
                caches, cache_index, encoder_out=None):
    """Run the decoder stack, each layer attending to ``encoder_out`` where
    it has cross-attention.  Returns (x, caches, aux): prefill's new
    stacked caches, decode's ``caches`` updated in place, or None in train
    mode; and the MoE layers' load-balancing loss summed over the stack
    (float32, 0 without MoE).  In train mode with ``cfg.remat`` each
    decoder layer is recomputed in the backward pass."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.attn_every:
        x, caches = _zamba_stack(params, x, cfg, mode=mode,
                                 positions=positions, caches=caches,
                                 cache_index=cache_index)
        return x, caches, aux
    new_caches = {}
    for seg in _segments(cfg):
        seg_caches = None if caches is None else caches[seg.name]
        new = []
        for i, lp in enumerate(params[seg.name].per_layer()):
            x, layer_aux = _run_layer(
                lp, i, x, cfg, seg_caches, new, mode=mode,
                positions=positions, cache_index=cache_index, moe=seg.moe,
                encoder_out=encoder_out, remat=cfg.remat and mode == "train")
            if seg.moe:
                aux = aux + layer_aux
        if mode == "prefill":
            new_caches[seg.name] = _stacked(new)
    if mode == "decode":
        return x, caches, aux
    return x, (new_caches or None), aux


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Layer-stacked decode caches, zeros: for zamba2 (Mamba2 caches
    [n_layers, ...], shared-block KV caches [groups, ...]); otherwise
    {segment: cache [n_layers, ...]}, RWKV6's ``SSMCache``, MLA's latent
    cache ``KVCache(k=c_kv [n, B, S_max, kv_lora], v=k_rope [n, B, S_max,
    rope])`` or a KV cache."""
    device = resolve_device(device)
    dt = dtype_of(cfg.dtype)

    def kv(n):
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        return attnlib.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                               v=torch.zeros(shape, dtype=dt, device=device))

    def mla(n):
        return attnlib.KVCache(
            k=torch.zeros((n, batch, max_len, cfg.kv_lora_rank), dtype=dt,
                          device=device),
            v=torch.zeros((n, batch, max_len, cfg.qk_rope_head_dim),
                          dtype=dt, device=device))

    def ssm(one, n):
        return ssmlib.SSMCache(*(torch.zeros((n, *c.shape), dtype=c.dtype,
                                             device=device) for c in one))

    if cfg.attn_every:
        mamba = ssm(ssmlib.init_mamba2_cache(cfg, batch, dt, device),
                    cfg.n_layers)
        return (mamba, kv(cfg.n_layers // cfg.attn_every))
    if cfg.ssm == "rwkv6":
        one = ssmlib.init_rwkv6_cache(cfg, batch, dt, device)
        return {seg.name: ssm(one, seg.n_layers) for seg in _segments(cfg)}
    if cfg.attention == "mla":
        return {seg.name: mla(seg.n_layers) for seg in _segments(cfg)}
    return {seg.name: kv(seg.n_layers) for seg in _segments(cfg)}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _inputs_to_hidden(params, batch: dict, cfg: ModelConfig):
    """(x, labels): ``embeds`` and their ``labels`` (None if absent) for an
    embeddings-input arch, else the embedded ``tokens[:, :-1]`` and
    ``tokens[:, 1:]``."""
    if cfg.input_mode == "embeddings":
        return batch["embeds"].to(dtype_of(cfg.dtype)), batch.get("labels")
    tokens = batch["tokens"]
    return embed_tokens(tokens[:, :-1], params["embed"], cfg), tokens[:, 1:]


def train_loss(params, batch: dict, cfg: ModelConfig):
    """The training objective: cross-entropy of the next token plus 0.01 x
    the MoE load-balancing loss.  The encoder-decoder's decoder reads
    ``tokens[:, :-1]`` against the encoder's output over ``embeds``.

    Returns (loss, {"ce_loss", "aux_loss"}), float32 scalars.  Gradients
    come from ``torch.autograd``; under ``attention_impl="pallas"`` the
    kernels refuse them (``kernels.refuse_autograd``), as the JAX
    package's do.
    """
    encoder_out = None
    if cfg.encoder_layers:
        encoder_out = _encoder_stack(
            params, batch["embeds"].to(dtype_of(cfg.dtype)), cfg)
        tokens = batch["tokens"]
        x = embed_tokens(tokens[:, :-1], params["embed"], cfg)
        labels = tokens[:, 1:]
    else:
        x, labels = _inputs_to_hidden(params, batch, cfg)
    if labels is None:
        raise ValueError("training batch needs labels")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = constrain(x, "bsd")
    x, _, aux = apply_stack(params, x, cfg, mode="train", positions=positions,
                            caches=None, cache_index=None,
                            encoder_out=encoder_out)
    x = apply_norm(x, params["final_norm"], cfg)
    logits = constrain(logits_from_hidden(x, _head(params, cfg)), "bsv")
    loss = cross_entropy(logits, labels)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


@torch.no_grad()
def prefill(params, batch: dict, cfg: ModelConfig):
    """Full-sequence forward building the decode cache.

    ``batch``: ``tokens`` [B, S] for token-input archs, ``embeds`` [B, S, D]
    for embeddings-input ones, and both for the encoder-decoder (the
    encoder's frames and the decoder's prompt).

    Returns (logits_last [B, vocab] float32, caches, encoder_out | None).
    """
    encoder_out = None
    if cfg.encoder_layers:
        encoder_out = _encoder_stack(
            params, batch["embeds"].to(dtype_of(cfg.dtype)), cfg)
        x = embed_tokens(batch["tokens"], params["embed"], cfg)
    elif cfg.input_mode == "embeddings":
        x = batch["embeds"].to(dtype_of(cfg.dtype))
    else:
        x = embed_tokens(batch["tokens"], params["embed"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = constrain(x, "bsd")
    x, caches, _ = apply_stack(params, x, cfg, mode="prefill",
                            positions=positions, caches=None, cache_index=None,
                            encoder_out=encoder_out)
    x = apply_norm(x, params["final_norm"], cfg)
    logits = constrain(logits_from_hidden(x[:, -1], _head(params, cfg)), "bv")
    return logits, caches, encoder_out


@torch.no_grad()
def decode_step(params, tokens, caches, cache_index: int, cfg: ModelConfig,
                *, encoder_out=None):
    """One decode step.  tokens: [B] int, or [B, D] embeds for an
    embeddings-input decoder-only arch.  Writes this step's K/V and
    recurrent state into ``caches`` in place; ``encoder_out`` is the
    encoder-decoder's prefill output.

    Returns (logits [B, vocab] float32, caches).
    """
    if cfg.input_mode == "embeddings" and tokens.dim() == 2 \
            and not cfg.encoder_layers:
        x = tokens[:, None, :].to(dtype_of(cfg.dtype))
    else:
        x = embed_tokens(tokens[:, None], params["embed"], cfg)
    positions = torch.full((x.shape[0], 1), cache_index, dtype=torch.int32,
                           device=x.device)
    x, caches, _ = apply_stack(params, x, cfg, mode="decode",
                            positions=positions, caches=caches,
                            cache_index=cache_index, encoder_out=encoder_out)
    x = apply_norm(x, params["final_norm"], cfg)
    logits = constrain(logits_from_hidden(x[:, 0], _head(params, cfg)), "bv")
    return logits, caches
