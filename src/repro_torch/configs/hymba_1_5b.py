"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per block.
[arXiv:2411.13676; hf]

Sliding-window (1024) attention everywhere except layers {0, mid, last},
which are full attention (the published layout); meta-token prefix is
omitted (stub noted in DESIGN.md). ``subquadratic=True``: decode state is
SWA KV (<=1024) + SSM state.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp_type="swiglu",
    sliding_window=1024,
    full_attn_layers=(0, 15, 31),
    ssm_state=16,
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2411.13676; hf",
))
