"""gemma-7b [dense]: GeGLU, head_dim=256, tied embeddings.
[arXiv:2403.08295; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    mlp_act="gelu",
    tie_embeddings=True,
)
