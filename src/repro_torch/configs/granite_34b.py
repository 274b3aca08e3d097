"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576
vocab=49152. Code model, gpt_bigcode-lineage ("llama-arch" per pool listing).
[arXiv:2405.04324; hf]

Assumption recorded (DESIGN.md): MQA (kv=1) and 4x gelu MLP match the
published gpt_bigcode config; we pair them with RoPE as the pool entry labels
it llama-arch. Shape-defining fields are exact.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    source="arXiv:2405.04324; hf",
))
