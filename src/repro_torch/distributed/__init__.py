"""Fault tolerance outside the step function (``Heartbeat``,
``PreemptionGuard``, ``retry_step``), and the gloo collectives of the
block-space mesh (:mod:`.collectives`).

The JAX package's ``distributed`` also exports its sharding helpers
(``sharding``, ``param_spec_tree``, ``named_sharding_tree``, ...) and
``elastic``: they come with the model-side mesh (ROADMAP A12).
"""
from . import fault_tolerance
from .fault_tolerance import (Heartbeat, PreemptionGuard,
                              accelerator_runtime_errors, retry_step)

__all__ = ["Heartbeat", "PreemptionGuard", "accelerator_runtime_errors",
           "fault_tolerance", "retry_step"]
