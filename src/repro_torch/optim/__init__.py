"""AdamW on tensors (the JAX package's ``repro.optim.adamw``).  Its
``compression`` (int8 gradients with error feedback) comes with the
model-side mesh (ROADMAP A12)."""
from . import adamw
from .adamw import AdamWConfig, apply_updates, init_state, schedule_lr

__all__ = ["AdamWConfig", "adamw", "apply_updates", "init_state",
           "schedule_lr"]
