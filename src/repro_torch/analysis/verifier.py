"""Page-table verification of the paged KV pool: the serving
scheduler's host invariants, re-derived from first principles (the table
*is* a decode LUT pointed at physical memory).

A copy of the JAX package's ``repro.analysis.verifier.verify_page_table``
with the ``Finding`` / ``Report`` it returns; the rest of that module
(the static plan verifier) is not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class PlanVerificationError(ValueError):
    """A table failed verification (a ``ValueError``)."""


@dataclasses.dataclass
class Finding:
    """One verified invariant violation."""

    check: str
    detail: str
    device: Optional[int] = None

    def __str__(self) -> str:
        where = f" [device {self.device}]" if self.device is not None \
            else ""
        return f"{self.check}{where}: {self.detail}"

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """Result of one verification run."""

    plan: Dict[str, Any]
    checks: Tuple[str, ...]
    findings: List[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_on_findings(self) -> "Report":
        if self.findings:
            lines = "\n  ".join(str(f) for f in self.findings)
            raise PlanVerificationError(
                f"plan verification failed for {self.plan}:\n  {lines}")
        return self

    def to_json(self) -> Dict[str, Any]:
        return {"plan": self.plan, "checks": list(self.checks),
                "ok": self.ok,
                "findings": [f.to_json() for f in self.findings]}


def verify_page_table(table, seq_lens, *, page_size: int,
                      num_pages: int, free_pages=(),
                      null_page: int = 0) -> Report:
    """Check the page-table invariants of the paged KV pool; raise
    :class:`PlanVerificationError` naming every violation.

    table:      (num_slots, max_pages) i32; seq_lens: per-slot live
    token counts (0 = inactive).  Each slot's *active extent* is its
    first ``ceil(len / page_size)`` entries.  Checks:

    * **bounds** -- every entry in [0, num_pages);
    * **null-in-extent** -- no active extent maps the null page;
    * **double-map** -- no physical page owned by two active extents;
    * **stale-free** -- no active extent maps a page on the free list;
    * **tail-null** -- entries past the active extent are the null page.
    """
    table = np.asarray(table)
    findings: List[Finding] = []
    if table.ndim != 2:
        raise ValueError(f"page table must be 2-D, got {table.shape}")
    if len(seq_lens) != table.shape[0]:
        raise ValueError(f"{len(seq_lens)} seq_lens for "
                         f"{table.shape[0]} slots")
    free = set(int(p) for p in free_pages)
    bad = (table < 0) | (table >= num_pages)
    if bad.any():
        s, j = map(int, np.argwhere(bad)[0])
        findings.append(Finding(
            "bounds", f"slot {s} entry {j} = {int(table[s, j])} outside "
            f"[0, {num_pages})"))
    owner: Dict[int, int] = {}
    for s, n in enumerate(seq_lens):
        ext = -(-int(n) // page_size)
        for j in range(ext):
            p = int(table[s, j])
            if p == null_page:
                findings.append(Finding(
                    "null-in-extent",
                    f"slot {s} ({n} tokens) maps the null page at "
                    f"entry {j}"))
                continue
            if p in owner and owner[p] != s:
                findings.append(Finding(
                    "double-map",
                    f"page {p} mapped by slots {owner[p]} and {s}"))
            owner[p] = s
            if p in free:
                findings.append(Finding(
                    "stale-free",
                    f"slot {s} entry {j} maps freed page {p}"))
        tail = table[s, ext:]
        if (tail != null_page).any():
            j = ext + int(np.argmax(tail != null_page))
            findings.append(Finding(
                "tail-null",
                f"slot {s} ({n} tokens, extent {ext}) still maps page "
                f"{int(table[s, j])} at entry {j}"))
    plan_sig = {"kind": "page-table", "slots": int(table.shape[0]),
                "max_pages": int(table.shape[1]),
                "page_size": int(page_size),
                "num_pages": int(num_pages)}
    return Report(plan=plan_sig,
                  checks=("bounds", "null-in-extent", "double-map",
                          "stale-free", "tail-null"),
                  findings=findings).raise_on_findings()
