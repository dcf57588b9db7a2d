"""Guarded execution + deterministic fault injection.

:mod:`repro_torch.runtime.guard` is the detection/recovery layer
(GuardedCall, classification, backoff, validators, degradation ladder,
failure reports); :mod:`repro_torch.runtime.chaos` is the seeded fault
injector and the ``python -m repro_torch.runtime.chaos --matrix`` proof
that every fault class is caught (the collective faults at the halo
exchange of :mod:`repro_torch.core.shard`).
"""
from .chaos import (ALL_FAULTS, ChaosInjector, FaultPlan, FaultSpec,
                    corrupt_tune_cache, tear_checkpoint)
from .guard import (Backoff, DeadlineExceeded, DegradationLadder,
                    FailureReport, GuardedCall, GuardEvent, GuardExhausted,
                    ServerState, TransientFault, ValidationError,
                    classify_error, sample_key, spot_check, validate_finite)

__all__ = [
    "ALL_FAULTS", "Backoff", "ChaosInjector", "DeadlineExceeded",
    "DegradationLadder", "FailureReport", "FaultPlan", "FaultSpec",
    "GuardEvent", "GuardExhausted", "GuardedCall", "ServerState",
    "TransientFault", "ValidationError", "classify_error",
    "corrupt_tune_cache", "sample_key", "spot_check", "tear_checkpoint",
    "validate_finite",
]
