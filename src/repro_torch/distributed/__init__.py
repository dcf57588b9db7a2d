"""Fault tolerance outside the step function (``Heartbeat``,
``PreemptionGuard``, ``retry_step``), the sharding rules and the
placement of tensors on a mesh (:mod:`.sharding`), elastic re-layout
(:mod:`.elastic`), the serving mesh's tensor parallelism
(:mod:`.tensor_parallel`) and the gloo collectives (:mod:`.collectives`).

The JAX package's ``distributed`` also exports ``activation_specs`` and
``constrain``: they come with the trainer on a mesh (ROADMAP A12).
"""
from . import elastic, fault_tolerance, sharding
from .fault_tolerance import (Heartbeat, PreemptionGuard,
                              accelerator_runtime_errors, retry_step)
from .sharding import (act_specs, batch_specs, cache_spec_tree, dp_axes,
                       named_sharding_tree, param_spec_tree)

__all__ = ["Heartbeat", "PreemptionGuard", "accelerator_runtime_errors",
           "act_specs", "batch_specs", "cache_spec_tree", "dp_axes",
           "elastic", "fault_tolerance", "named_sharding_tree",
           "param_spec_tree", "retry_step", "sharding"]
