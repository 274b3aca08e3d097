"""Architecture registry: one module per assigned arch (import = register);
the same configurations as the reference's ``configs`` package."""

from repro_torch.configs.base import (ModelConfig, ShapeConfig, TrainConfig, SHAPES,
                                get_config, list_configs, register,
                                smoke_variant)

# Import side effects populate the registry.
from repro_torch.configs import (granite_34b, starcoder2_7b, yi_9b, gemma3_12b,
                           whisper_tiny, qwen3_moe_235b_a22b, olmoe_1b_7b,
                           qwen2_vl_72b, xlstm_350m, hymba_1_5b)  # noqa: F401

ARCH_IDS = [
    "granite-34b", "starcoder2-7b", "yi-9b", "gemma3-12b", "whisper-tiny",
    "qwen3-moe-235b-a22b", "olmoe-1b-7b", "qwen2-vl-72b", "xlstm-350m",
    "hymba-1.5b",
]

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES",
           "get_config", "list_configs", "register", "smoke_variant",
           "ARCH_IDS"]
