"""Optimizers (functional ``init`` / ``update`` over parameter trees) and
learning-rate schedules, the reference's ``repro.optim`` in PyTorch."""

from repro_torch.optim.optimizers import (Adafactor, AdamW, Optimizer, Sgd,
                                          TrainState, clip_by_global_norm,
                                          global_norm, make_optimizer)
from repro_torch.optim.schedules import (constant, cosine_schedule,
                                         linear_warmup)

__all__ = ["Adafactor", "AdamW", "Optimizer", "Sgd", "TrainState",
           "clip_by_global_norm", "global_norm", "make_optimizer",
           "constant", "cosine_schedule", "linear_warmup"]
