"""Architecture registry of the LM harness, with the smoke reductions.

The JAX package registers ten architectures.  The port carries the config
of each family it has ported; asking for one whose family is still to port
raises ``NotImplementedError`` naming the ROADMAP item that covers it.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, count_params  # noqa: F401

# Ported architectures → config module.
_ARCH_MODULES = {
    "zamba2-7b": "zamba2_7b",
}
# Known architectures whose family the port does not run yet.
_UNPORTED = (
    "llava-next-mistral-7b", "smollm-135m", "phi3-medium-14b", "gemma-7b",
    "qwen3-8b", "deepseek-v2-236b", "grok-1-314b", "rwkv6-7b",
    "whisper-medium",
)

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet: ROADMAP.md queue 1 item 11 (LM "
            f"workload harness) lists the families still to port")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCH_NAMES + list(_UNPORTED)}")
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
