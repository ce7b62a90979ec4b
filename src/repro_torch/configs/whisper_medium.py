"""whisper-medium [audio]: encoder-decoder; conv frontend stubbed
(input_specs provides frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,             # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=24,
    mlp_act="gelu_plain",
    norm="layernorm",
    input_mode="embeddings",
)
