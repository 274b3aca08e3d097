"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (MHA kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    mlp_type="swiglu",
    num_experts=64,
    num_experts_per_tok=8,
    source="arXiv:2409.02060; hf",
))
