"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE + dynamic resolution. [arXiv:2409.12191; hf]

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings merged as a prefix; M-RoPE consumes 3-channel
(temporal, height, width) position ids, also provided by ``input_specs()``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mlp_type="swiglu",
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_tokens=64,
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191; hf",
))
