"""Decoder layer bodies: the Mamba2 cell (zamba2's backbone), the RWKV6 cell
(time mix + channel mix), and the attention block (GQA or MLA) with an MLP
or the MoE layer, and cross-attention to the encoder's output in an
encoder-decoder stack (whisper)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.models.layers import MLP, Norm, Params, apply_mlp, apply_norm


class DecoderLayers(Params):
    """``n_layers`` decoder layers, stacked on a leading layer axis."""

    def __init__(self, cfg: ModelConfig, n_layers: int, gen=None,
                 device=None, moe: bool = False):
        super().__init__()
        stack = (n_layers,)
        self.norm1 = Norm(cfg, stack, device)
        if cfg.ssm == "rwkv6":
            self.norm2 = Norm(cfg, stack, device)
            self.time_mix = ssmlib.RWKV6TimeMix(cfg, gen, stack, device)
            self.channel_mix = ssmlib.RWKV6ChannelMix(cfg, gen, stack, device)
            return
        if cfg.ssm == "mamba2":
            # Hybrid (zamba2): the MLP lives in the shared block.
            self.mamba = ssmlib.Mamba2(cfg, gen, stack, device)
            return
        self.attn = (attn.MLA if cfg.attention == "mla" else attn.GQA)(
            cfg, gen, stack, device)
        self.norm2 = Norm(cfg, stack, device)
        if moe:
            self.moe = moelib.MoE(cfg, gen, stack, device)
        else:
            self.mlp = MLP(cfg, gen, stack, device)
        if cfg.encoder_layers:
            self.cross_attn = attn.GQA(cfg, gen, stack, device, cross=True)
            self.norm_cross = Norm(cfg, stack, device)


def _rwkv6_layer(params, x, cfg: ModelConfig, *, mode: str, cache):
    tm_cache_in = cm_shift_in = None
    if cache is not None and mode == "decode":
        tm_cache_in = ssmlib.SSMCache(conv=cache.conv[:, 0:1],
                                      state=cache.state)
        cm_shift_in = cache.conv[:, 1:2]
    h, tm_cache_out = ssmlib.rwkv6_time_mix(
        params["time_mix"], apply_norm(x, params["norm1"], cfg), cfg,
        mode=mode, cache=tm_cache_in)
    x = x + h
    h, cm_shift_out = ssmlib.rwkv6_channel_mix(
        params["channel_mix"], apply_norm(x, params["norm2"], cfg), cfg,
        shift_state=cm_shift_in)
    x = x + h
    new_cache = None
    if tm_cache_out is not None:          # prefill or decode
        new_cache = ssmlib.SSMCache(
            conv=torch.cat([tm_cache_out.conv, cm_shift_out], 1),
            state=tm_cache_out.state)
    return x, new_cache


def decoder_layer(params, x, cfg: ModelConfig, *, moe: bool, mode: str,
                  positions, cache, cache_index, encoder_out=None):
    """Returns (x, new_cache, aux_loss): the MoE router's load-balancing
    loss, 0.0 for every other layer.  With ``encoder_out``, a layer that
    has cross-attention attends to it after its self-attention."""
    if cfg.ssm == "rwkv6":
        x, new_cache = _rwkv6_layer(params, x, cfg, mode=mode, cache=cache)
        return x, new_cache, 0.0
    if cfg.ssm == "mamba2":
        h, new_cache = ssmlib.mamba2_forward(
            params["mamba"], apply_norm(x, params["norm1"], cfg), cfg,
            mode=mode, cache=cache)
        return x + h, new_cache, 0.0

    h, new_cache = (attn.mla_forward if cfg.attention == "mla"
                    else attn.gqa_forward)(
        params["attn"], apply_norm(x, params["norm1"], cfg), cfg,
        mode=mode, positions=positions, cache=cache, cache_index=cache_index)
    x = x + h
    if "cross_attn" in params and encoder_out is not None:
        h, _ = attn.gqa_forward(
            params["cross_attn"], apply_norm(x, params["norm_cross"], cfg),
            cfg, mode="train", kv_source=encoder_out)
        x = x + h
    aux = 0.0
    if moe:
        h, metrics = moelib.moe_forward(
            params["moe"], apply_norm(x, params["norm2"], cfg), cfg)
        aux = metrics["aux_loss"]
    else:
        h = apply_mlp(apply_norm(x, params["norm2"], cfg), params["mlp"], cfg)
    return x + h, new_cache, aux
