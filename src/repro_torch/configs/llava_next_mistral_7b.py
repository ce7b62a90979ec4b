"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, anyres vision frontend
stubbed (input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    input_mode="embeddings",
)
