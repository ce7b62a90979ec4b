"""deepseek-v2-236b [moe]: MLA (kv_lora=512), 2 shared + 160 routed experts
top-6, first layer dense. [arXiv:2405.04434; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense-layer FFN width
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    mlp_act="silu",
)
