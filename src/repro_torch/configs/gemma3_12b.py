"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144. 5:1 local(window=1024):global attention interleave, 128k
context. [hf:google/gemma-3-1b-pt; unverified]

``subquadratic=True``: 40/48 layers are windowed; the 8 global layers' 500k
KV cache is sharded over the data axis with the shard_map LSE-combine decode
(see DESIGN.md §Arch-applicability) — included as the long-context stress
case.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    mlp_type="swiglu",
    sliding_window=1024,
    global_every=6,            # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,
    source="hf:google/gemma-3-1b-pt; unverified",
))
