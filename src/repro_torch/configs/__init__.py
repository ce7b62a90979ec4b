"""Architecture registry of the LM harness, with the smoke reductions: the
same ten architectures as the JAX package registers."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, count_params  # noqa: F401

# Architecture → config module.
_ARCH_MODULES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "smollm-135m": "smollm_135m",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma-7b": "gemma_7b",
    "qwen3-8b": "qwen3_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-medium": "whisper_medium",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests.

    Keeps every structural feature (attention variant, MoE, SSM, hybrid
    interleave, enc-dec) while shrinking widths/depths/tables — the same
    reduction as the JAX package's ``smoke_config``.
    """
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    overrides = dict(
        n_layers=4 if cfg.attn_every else 2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, n_heads // kv_ratio),
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else None,
        remat=False,
    )
    if cfg.attention == "mla":
        overrides.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16)
    if cfg.n_experts:
        overrides.update(n_experts=8, top_k=min(cfg.top_k, 2),
                         moe_d_ff=64,
                         n_shared_experts=min(cfg.n_shared_experts, 1),
                         first_dense_layers=min(cfg.first_dense_layers, 1),
                         capacity_factor=8.0)
    if cfg.ssm != "none":
        overrides.update(ssm_state=16, ssm_head_dim=16, d_inner=128)
    if cfg.attn_every:
        overrides.update(attn_every=2)
    if cfg.encoder_layers:
        overrides.update(encoder_layers=2)
    return dataclasses.replace(cfg, **overrides)
