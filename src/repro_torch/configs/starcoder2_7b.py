"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152. GQA + RoPE, 4x gelu MLP. [arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173; hf",
))
