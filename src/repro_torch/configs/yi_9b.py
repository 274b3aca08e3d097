"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-arch GQA with SwiGLU. [arXiv:2403.04652; hf]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    mlp_type="swiglu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
))
