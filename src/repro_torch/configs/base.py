"""Model configuration schema shared by all assigned architectures.

A copy of the JAX package's ``configs/base.py`` (which imports no JAX but
lives in that package): the port keeps its own so that it never imports
``repro``.  The two must stay field for field the same.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None    # default d_model // n_heads (gemma: 256)

    # -- attention ------------------------------------------------------------
    attention: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # -- MLA (deepseek-v2) ----------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # -- MLP ------------------------------------------------------------------
    mlp_act: str = "silu"          # silu → SwiGLU; gelu → GeGLU; gelu_plain

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # routed-expert hidden dim
    first_dense_layers: int = 0    # deepseek: layer 0 stays dense
    capacity_factor: float = 1.25  # event-frame capacity headroom (core.events)

    # -- SSM / hybrid ----------------------------------------------------------
    ssm: str = "none"              # mamba2 | rwkv6
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0               # mamba inner width (default 2·d_model)
    conv_kernel: int = 4
    attn_every: int = 0            # zamba2: shared attn block every N layers

    # -- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    decoder_len_ratio: int = 8     # decoder seq = seq // ratio in train

    # -- modality frontend ------------------------------------------------------
    input_mode: str = "tokens"     # tokens | embeddings (vlm/audio stubs)

    # -- numerics / structure ---------------------------------------------------
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attention_impl: str = "xla"    # xla | pallas
    # -- §Perf hillclimb knobs (0/False = paper-faithful baseline) -------------
    attn_block_kv: int = 0         # >0: chunked online-softmax attention
    moe_local_dispatch: bool = False  # per-data-shard dispatch (Aggregator star)
    attn_score_dtype: str = "float32"  # bfloat16: halve score-tile traffic

    # ---------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing → long_500k shape runs."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def params_per_token_active(self) -> int:
        """Approximate active parameter count (MoE: routed top-k + shared)."""
        return count_params(self, active_only=True)

    def params_total(self) -> int:
        return count_params(self, active_only=False)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.attention == "mla":
        q = (d * cfg.q_lora_rank
             + cfg.q_lora_rank * cfg.n_heads
             * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)) if cfg.q_lora_rank \
            else d * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        kv = (d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
              + cfg.kv_lora_rank * cfg.n_heads
              * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        o = cfg.n_heads * cfg.v_head_dim * d
        return q + kv + o
    hd = cfg.head_dim_
    return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)


def _mlp_params(d: int, ff: int, act: str) -> int:
    gates = 3 if act in ("silu", "gelu") else 2
    return gates * d * ff


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, st = cfg.d_model, cfg.d_inner_, cfg.ssm_state
    h = cfg.n_ssm_heads
    if cfg.ssm == "rwkv6":
        # r,k,v,g,w projections + output (v/ffn counted separately)
        return 5 * d * d + d * d
    # mamba2: in_proj (z, x, B, C, dt; B/C shared across heads) + out + conv
    return d * (2 * di + 2 * st + h) + di * d \
        + cfg.conv_kernel * (di + 2 * st)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.input_mode == "embeddings":
        total = cfg.vocab_size * d  # output head only; frontend is a stub

    def layer_params(moe: bool) -> int:
        p = 0
        if cfg.ssm != "none":
            p += _ssm_params(cfg)
            if cfg.ssm == "rwkv6":
                p += 2 * d * cfg.d_ff + d * d  # channel-mix (k, v, r)
        else:
            p += _attn_params(cfg)
        if cfg.ssm == "none":
            if moe and cfg.n_experts:
                experts = cfg.top_k if active_only else cfg.n_experts
                p += experts * _mlp_params(d, cfg.moe_d_ff or cfg.d_ff,
                                           cfg.mlp_act)
                p += cfg.n_shared_experts * _mlp_params(
                    d, cfg.moe_d_ff or cfg.d_ff, cfg.mlp_act)
                p += d * cfg.n_experts  # router
            else:
                p += _mlp_params(d, cfg.d_ff, cfg.mlp_act)
        return p

    n_moe = max(0, cfg.n_layers - cfg.first_dense_layers) if cfg.n_experts else 0
    n_dense = cfg.n_layers - n_moe
    total += n_moe * layer_params(True) + n_dense * layer_params(False)
    if cfg.attn_every:
        # One shared attention + MLP block (zamba2), reused across groups.
        total += _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.mlp_act)
    if cfg.encoder_layers:
        enc = _attn_params(cfg) + _mlp_params(d, cfg.d_ff, "gelu_plain")
        total += cfg.encoder_layers * enc
        total += cfg.n_layers * _attn_params(cfg)  # decoder cross-attention
    return total
