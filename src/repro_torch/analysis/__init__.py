"""Host-side verification of the port's execution tables.

So far only the paged-KV page-table check of the serving scheduler
(:func:`verify_page_table`); the plan verifier of the JAX package's
``repro.analysis`` is not ported yet (ROADMAP A13).
"""
from .verifier import (Finding, PlanVerificationError, Report,
                       verify_page_table)

__all__ = ["Finding", "PlanVerificationError", "Report",
           "verify_page_table"]
