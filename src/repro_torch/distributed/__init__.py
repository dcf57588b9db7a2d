"""Fault tolerance outside the step function (``Heartbeat``,
``PreemptionGuard``, ``retry_step``), the sharding rules, the activation
layouts and the placement of tensors on a mesh (:mod:`.sharding`),
elastic re-layout (:mod:`.elastic`), the mesh's tensor parallelism and
the collectives' gradients (:mod:`.tensor_parallel`) and the gloo
collectives (:mod:`.collectives`).
"""
from . import elastic, fault_tolerance, sharding
from .fault_tolerance import (Heartbeat, PreemptionGuard,
                              accelerator_runtime_errors, retry_step)
from .sharding import (act_specs, activation_specs, batch_specs,
                       cache_spec_tree, constrain, dp_axes,
                       named_sharding_tree, param_spec_tree)

__all__ = ["Heartbeat", "PreemptionGuard", "accelerator_runtime_errors",
           "act_specs", "activation_specs", "batch_specs", "cache_spec_tree",
           "constrain", "dp_axes", "elastic", "fault_tolerance",
           "named_sharding_tree", "param_spec_tree", "retry_step",
           "sharding"]
