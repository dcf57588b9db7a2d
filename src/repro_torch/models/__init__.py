"""The LM stacks of the port (GQA, MLA or Mamba mixers, dense or MoE
FFNs, zamba2's shared block, token or embedding inputs): config, layers,
the MLA, MoE and SSM blocks, model assembly (the training loss and the
serving entry points) and the JAX parameter conversion."""
from .config import ModelConfig
from .mla import MLA, mla_block, mla_decode
from .model import (Model, decode_step, decode_step_paged, forward, init,
                    init_cache, init_paged_cache, logits_fn, loss_fn,
                    prefill, scatter_prefill_pages)
from .moe import MoE, moe_block, moe_block_dense_ref

__all__ = ["ModelConfig", "MLA", "MoE", "Model", "decode_step",
           "decode_step_paged", "forward", "init", "init_cache",
           "init_paged_cache", "logits_fn", "loss_fn", "mla_block",
           "mla_decode", "moe_block", "moe_block_dense_ref", "prefill",
           "scatter_prefill_pages"]
