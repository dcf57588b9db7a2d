"""The dense LM stack of the port: config, layers, model assembly (the
training loss and the serving entry points) and the JAX parameter
conversion."""
from .config import ModelConfig
from .model import (Model, decode_step, decode_step_paged, forward, init,
                    init_cache, init_paged_cache, logits_fn, loss_fn,
                    prefill, scatter_prefill_pages)

__all__ = ["ModelConfig", "Model", "decode_step", "decode_step_paged",
           "forward", "init", "init_cache", "init_paged_cache", "logits_fn",
           "loss_fn", "prefill", "scatter_prefill_pages"]
