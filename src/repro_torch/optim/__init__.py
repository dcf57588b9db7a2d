"""AdamW on tensors (the JAX package's ``repro.optim.adamw``) and the
int8 gradient compression with error feedback
(``repro.optim.compression``: :mod:`.compression`, over a
``torch.distributed`` group)."""
from . import adamw, compression
from .adamw import AdamWConfig, apply_updates, init_state, schedule_lr

__all__ = ["AdamWConfig", "adamw", "apply_updates", "compression",
           "init_state", "schedule_lr"]
