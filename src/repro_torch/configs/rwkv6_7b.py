"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d_model / ssm_head_dim (wkv heads)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    ssm="rwkv6",
    ssm_head_dim=64,
    norm="layernorm",
)
