"""smollm-135m [dense]: llama-architecture small model.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    mlp_act="silu",
    tie_embeddings=True,
)
