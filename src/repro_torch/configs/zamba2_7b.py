"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block every 6
layers. [arXiv:2411.15242; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm="mamba2",
    ssm_state=64,
    ssm_head_dim=64,
    d_inner=7168,
    attn_every=6,
    mlp_act="silu",
)
