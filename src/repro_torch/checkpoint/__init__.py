"""Checkpoints (the FLCK v2 container, readable by either package) and
the FL round journal."""

from repro_torch.checkpoint.checkpointer import (CheckpointManager,
                                                 load_pytree, save_pytree)
from repro_torch.checkpoint.journal import FLJournal

__all__ = ["CheckpointManager", "load_pytree", "save_pytree", "FLJournal"]
