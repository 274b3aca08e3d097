"""whisper-tiny [audio] — enc-dec, 4L (each side) d_model=384 6H (kv=6 MHA)
d_ff=1536 vocab=51865, conv audio frontend STUBBED (input_specs() provides
precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]

decode_32k exceeds the model's trained 448-token horizon but is mechanically
supported; long_500k is skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    encoder_seq=1500,          # 30 s of audio at 20 ms hop after conv stub
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    source="arXiv:2212.04356; unverified",
))
