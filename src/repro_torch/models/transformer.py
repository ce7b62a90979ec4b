"""Decoder layer bodies: the Mamba2 cell (zamba2's backbone) and the plain
GQA + MLP block.  MoE, MLA, RWKV6 and cross-attention layers are still to
port (ROADMAP.md queue 1 item 10)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssmlib
from repro_torch.models.layers import (MLP, NOT_PORTED, Norm, Params,
                                       apply_mlp, apply_norm)


def _check_ported(cfg: ModelConfig, moe: bool) -> None:
    if cfg.ssm == "rwkv6":
        raise NotImplementedError(f"the RWKV6 layer {NOT_PORTED}")
    if moe or cfg.n_experts:
        raise NotImplementedError(f"the MoE layer {NOT_PORTED}")
    if cfg.attention == "mla":
        raise NotImplementedError(f"the MLA layer {NOT_PORTED}")
    if cfg.encoder_layers:
        raise NotImplementedError(f"the cross-attention layer {NOT_PORTED}")


class DecoderLayers(Params):
    """``n_layers`` decoder layers, stacked on a leading layer axis."""

    def __init__(self, cfg: ModelConfig, n_layers: int, gen=None,
                 device=None, moe: bool = False):
        super().__init__()
        _check_ported(cfg, moe)
        stack = (n_layers,)
        self.norm1 = Norm(cfg, stack, device)
        if cfg.ssm == "mamba2":
            # Hybrid (zamba2): the MLP lives in the shared block.
            self.mamba = ssmlib.Mamba2(cfg, gen, stack, device)
            return
        self.attn = attn.GQA(cfg, gen, stack, device)
        self.norm2 = Norm(cfg, stack, device)
        self.mlp = MLP(cfg, gen, stack, device)


def decoder_layer(params, x, cfg: ModelConfig, *, moe: bool, mode: str,
                  positions, cache, cache_index, encoder_out=None):
    """Returns (x, new_cache, aux_loss)."""
    _check_ported(cfg, moe)
    if encoder_out is not None:
        raise NotImplementedError(f"cross-attention {NOT_PORTED}")
    if cfg.ssm == "mamba2":
        h, new_cache = ssmlib.mamba2_forward(
            params["mamba"], apply_norm(x, params["norm1"], cfg), cfg,
            mode=mode, cache=cache)
        return x + h, new_cache, 0.0

    h, new_cache = attn.gqa_forward(
        params["attn"], apply_norm(x, params["norm1"], cfg), cfg,
        mode=mode, positions=positions, cache=cache, cache_index=cache_index)
    x = x + h
    h = apply_mlp(apply_norm(x, params["norm2"], cfg), params["mlp"], cfg)
    return x + h, new_cache, 0.0
