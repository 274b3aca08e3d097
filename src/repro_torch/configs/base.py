"""Config system: model architecture, input shapes, training.

The port's own copy of the reference's plain dataclasses (the port never
imports the reference).  Every architecture is a ``ModelConfig`` in
``repro_torch/configs/<id>.py``
and registers itself; ``get_config(name)`` / ``--arch <id>`` resolve from the
registry. Shape presets (train_4k / prefill_32k / decode_32k / long_500k) are
``ShapeConfig`` objects paired with the entry point they lower.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"       # swiglu | gelu
    # -- attention pattern -------------------------------------------------
    sliding_window: int = 0        # 0 = full attention
    global_every: int = 0          # gemma3: 1 global layer per N (5 local : 1)
    full_attn_layers: tuple = ()   # hymba: explicit full-attention layer ids
    rope_theta: float = 10_000.0
    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # -- enc-dec (whisper) ---------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed frame count from the audio frontend
    # -- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 0           # xLSTM: 1 sLSTM block per N (7 mLSTM : 1)
    # -- VLM -------------------------------------------------------------------
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    vision_tokens: int = 0         # patch-embedding prefix length (stub)
    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # -- capability flags ---------------------------------------------------------
    subquadratic: bool = False     # may run long_500k
    has_decoder: bool = True       # encoder-only archs skip decode shapes
    source: str = ""               # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded so the 'model' mesh axis always
        divides the vocab (the MaxText convention)."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping).
        Matches what init() allocates (asserted in tests)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.family in ("ssm",):
            att = 0
        if self.mlp_type == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.num_experts:
            mlp = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        per_layer = att + mlp + 2 * d
        total = emb + self.num_layers * per_layer
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            total += self.encoder_layers * per_layer
            total += self.num_layers * (d * self.num_heads * hd
                                        + 2 * d * self.num_kv_heads * hd
                                        + self.num_heads * hd * d)
        if self.family == "ssm":
            # mLSTM: w_up+w_z (2*2d^2) + q/k/v (3*(2d*2d)) + w_down (2d^2)
            # sLSTM: w_gates (4d^2) + r_gates (4d^2/nh) + w_down (d^2)
            n_s = self.num_layers // max(self.slstm_every, 1)
            n_m = self.num_layers - n_s
            total = emb + n_m * 18 * d * d \
                + n_s * (5 * d * d + 4 * d * d // self.num_heads)
        if self.family == "hybrid":
            # SSM path: w_in + w_gate_ssm + w_out_ssm (3d^2) + dt proj (d^2)
            # + B/C/A (3*d*n) + fuse norms
            n = self.ssm_state
            total += self.num_layers * (4 * d * d + 3 * d * n + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * (
            self.num_experts * 3 * d * self.d_ff)
        return dense + self.num_layers * (
            self.num_experts_per_tok * 3 * d * self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str              # train | prefill | decode
    kv_len: int = 0        # decode: populated cache length (== seq_len)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode",
                              kv_len=32_768),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode",
                             kv_len=524_288),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"
    remat_policy: str = "full"     # none | full | dots
    loss_chunk: int = 0            # 0 = unchunked; >0 = vocab-loss seq chunking
    grad_accum: int = 1            # microbatches per step (memory / step)
    accum_dtype: str = "float32"   # grad-accumulation buffer dtype
    moments_dtype: str = "float32"  # Adam m/v dtype (bf16 for huge models)
    moe_impl: str = "scan"         # scan (baseline) | ragged (dropless)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # Import side-effect registration.
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow
    width, tiny vocab/experts — preserves every structural feature."""
    updates: dict = dict(
        num_layers=max(2, (cfg.slstm_every or cfg.global_every or 2)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // cfg.num_heads)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        dtype="float32",
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        encoder_seq=min(cfg.encoder_seq, 24) if cfg.encoder_seq else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        num_experts=min(cfg.num_experts, 8),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        vision_tokens=min(cfg.vision_tokens, 8),
        full_attn_layers=tuple(
            i for i in (0, 1) if cfg.full_attn_layers) or cfg.full_attn_layers,
    )
    if cfg.global_every:
        updates["num_layers"] = 2 * cfg.global_every
    if cfg.slstm_every:
        updates["num_layers"] = 2 * cfg.slstm_every
    if cfg.mrope:
        # rescale the per-channel frequency sections to the smoke head_dim
        half = updates["head_dim"] // 2
        base = cfg.mrope_sections
        scale = half / sum(base)
        secs = [max(1, int(s * scale)) for s in base]
        secs[0] += half - sum(secs)
        updates["mrope_sections"] = tuple(secs)
    return dataclasses.replace(cfg, **updates)
