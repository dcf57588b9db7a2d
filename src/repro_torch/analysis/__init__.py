"""Static and dynamic verification of block-space execution plans.

``verifier``  -- host-side static checks over any GridPlan/ShardedPlan:
                 race freedom, exactly-once coverage, fidelity of the
                 tables a launch reads, index bounds, aliasing safety,
                 flash key windows; and the paged KV page-table check.
``sanitizer`` -- the access sanitizer: the trace builds of the write,
                 sum and CA kernels (the plain versions on the CPU) record
                 what each grid step decoded, stored and loaded, and the
                 rows are cross-checked against the static sets.
``verify``    -- the CLI: ``python -m repro_torch.analysis.verify
                 --matrix`` sweeps the feature matrix and emits a JSON
                 report.
"""
from .sanitizer import AccessTrace, verify_launches
from .verifier import (Finding, PlanVerificationError, Report,
                       verify_or_raise, verify_page_table, verify_plan)

__all__ = [
    "AccessTrace",
    "Finding",
    "PlanVerificationError",
    "Report",
    "verify_launches",
    "verify_or_raise",
    "verify_page_table",
    "verify_plan",
]
