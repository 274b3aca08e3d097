"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304, sLSTM + mLSTM
blocks at the paper's 7:1 ratio. [arXiv:2405.04517; unverified]

Attention-free: the technique-bearing transport layer is unaffected (it ships
parameter bytes); ``subquadratic=True`` so long_500k runs with O(1)/token
recurrent state. d_ff=0: xLSTM blocks carry their own up/down projections
instead of a separate FFN.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,             # 7 mLSTM : 1 sLSTM
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
))
