"""Access sanitizer: the dynamic backstop to the static verifier.

:class:`AccessTrace` installs itself as the launch hook of
:mod:`repro_torch.kernels._cuda` (restoring the previous hook on exit),
so every write, sum and CA launch run inside the ``with`` block hands it
a :class:`~repro_torch.kernels._cuda.LaunchRecord`.  For each launch of
an unsharded plan it allocates the launch's trace rows on the state's
device and sets them in the record: on the card the wrapper then
launches the kernel's trace build (``-DREPRO_TRACE``), whose kernel
writes one row per grid step from the very values its body addresses
memory with (the step's block, the supertile it stores, the partial it
writes, the nine origins the CA's ring loader gathers); on the CPU the
plain version fills the same rows from the index tensors it scatters and
gathers with.  The body runs as ever: a traced output is the untraced
one, bit for bit.

``crosscheck()`` then holds the rows to the verifier's *static* sets --
``decode_steps``, ``storage_tiles``, ``neighbor_tiles`` evaluated on the
host through host-built tables (:func:`~repro_torch.analysis.verifier.
host_tables`), never through the device copies the launch read:

* every grid step is visited exactly once (the CA: every live step once,
  a discarded bounding step never), and its live bit and block are the
  static decode's;
* the stored tiles equal the static write set, pairwise distinct, and
  every stored or loaded tile lies in bounds;
* the loads are held slot by slot: origin slot (dy + 1) * 3 + dx + 1 of
  a step loads exactly when the block at offset (dx, dy) is in range
  and a member, and it loads that slot's static tile (slot 4 the
  centre's storage tile, the sum's only load; the others neighbour j of
  ``NEIGHBOR_OFFSETS8``), in bounds;
* the sum's partial slot of a step is the step's linear id.

Under embedded storage the CA kernel gathers a halo window around its
own block and keeps no origin per slot: its trace build writes the
slots' tiles worked out from the step's block, (bx + dx, by + dy) where
that block is a member, not addresses recorded from the gather.  For an
embedded CA launch the load columns therefore check the decoded block
and the membership test; the compact gather's nine origins are recorded
as the ring loader resolved them.

Launches of a :class:`~repro_torch.core.shard.ShardedPlan` are observed
but not traced, as in the JAX package: the static verifier covers those
per rank.

``verify_launches(fn, *args, kernel=...)`` is the convenience wrapper:
run ``fn`` under a trace and raise
:class:`~repro_torch.analysis.verifier.PlanVerificationError` on any
mismatch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compact import NEIGHBOR_OFFSETS8
from repro_torch.core.shard import ShardedPlan
from repro_torch.kernels import _cuda

from .verifier import (ACCESS_MODELS, Finding, PlanVerificationError,
                       decode_steps, host_tables, host_view,
                       neighbor_grid, neighbor_tiles, plan_signature,
                       storage_grid, storage_tiles)

#: a launch record's kernel -> its access model (ACCESS_MODELS)
MODELS = {"sierpinski_write": "write", "sierpinski_sum": "sum",
          "sierpinski_ca": "ca"}

_C = {name: i for i, name in enumerate(_cuda.TRACE_COLUMNS)}
_LOADS = _cuda.TRACE_LOADS


class TracedLaunch:
    """One launch the trace observed: its record and, for an unsharded
    plan, its trace rows."""

    def __init__(self, lid: int, record):
        self.lid = lid
        self.kernel = record.kernel
        self.plan = record.plan
        self.block = record.block
        self.trace: Optional[torch.Tensor] = None


def _device(record) -> torch.device:
    """The device a launch runs on: its in-place output's, else the
    plan's target (the current card, or the CPU)."""
    if record.dst is not None:
        return record.dst.device
    if record.plan.target.name == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class AccessTrace:
    """Context manager recording the access-trace rows of every write,
    sum and CA launch run inside the ``with`` block.

    >>> with AccessTrace() as tr:
    ...     out = sierpinski_write(m, 1.0, block=4)
    >>> findings = tr.crosscheck()

    ``static``: a dict that keeps each plan's host view and static sets
    (keyed by its geometry and tables); traces, and
    :func:`~repro_torch.analysis.verifier.verify_models` given it as
    ``decodes``, decode a plan once.
    """

    def __init__(self, kernel: str = "generic",
                 static: Optional[Dict[Any, Any]] = None):
        self.kernel = kernel
        self.launches: List[TracedLaunch] = []
        self._prev_hook = None
        #: the host views and static sets per plan geometry and tables
        self._static = {} if static is None else static

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "AccessTrace":
        self._prev_hook = _cuda.set_launch_hook(self)
        return self

    def __exit__(self, *exc):
        _cuda.set_launch_hook(self._prev_hook)
        return False

    # -- launch-hook protocol ------------------------------------------------

    def __call__(self, record, run):
        launch = TracedLaunch(len(self.launches), record)
        self.launches.append(launch)
        if not isinstance(record.plan, ShardedPlan):
            record.trace = _cuda.trace_rows(record.plan.steps_per_launch,
                                            _device(record))
            launch.trace = record.trace
        return run()

    # -- crosscheck ----------------------------------------------------------

    def crosscheck(self, kernel: Optional[str] = None) -> List[Finding]:
        """Diff every traced launch's rows against its static access
        sets, under the access model of its kernel (``kernel``, when
        given, names the model of launches of any other kind); returns
        the findings (empty = the traces match)."""
        if any(ln.trace is not None and ln.trace.is_cuda
               for ln in self.launches):
            torch.cuda.synchronize()
        findings: List[Finding] = []
        for launch in self.launches:
            if launch.trace is None:
                continue        # a sharded launch: observed, not traced
            model = MODELS.get(launch.kernel, kernel or self.kernel)
            self._check(launch, model, findings)
        return findings

    def static_sets(self, plan) -> Dict[str, np.ndarray]:
        """The static decode and tiles of ``plan``'s launch through
        host-built tables, kept with the plan's host view in the
        ``static`` dict (:func:`~repro_torch.analysis.verifier.
        host_view`'s ``decodes``)."""
        view = host_view(plan, host_tables(plan), self._static)
        out = getattr(view, "_static_sets", None)
        if out is None:
            ids, bx, by, live = decode_steps(view)
            r, c = storage_tiles(view)
            out = {"bx": bx, "by": by, "live": live, "row": r, "col": c,
                   "nbrs": [neighbor_tiles(view, j)
                            for j in range(len(NEIGHBOR_OFFSETS8))]}
            view._static_sets = out
        return out

    def _check(self, launch, model_name, findings):
        plan = launch.plan
        sig = plan_signature(plan)
        st = self.static_sets(plan)
        rows = launch.trace.detach().to("cpu").numpy().astype(np.int64)
        n = len(st["live"])
        live = st["live"]

        def add(what, idx, msg):
            for i in idx[:3]:
                findings.append(Finding("sanitizer", f"{sig}: {msg(i)}"))
            if len(idx) > 3:
                findings.append(Finding(
                    "sanitizer", f"{sig}: ... {len(idx)} {what} total"))

        if rows.shape[0] != n:
            findings.append(Finding(
                "sanitizer", f"{sig}: {rows.shape[0]} trace rows for {n} "
                f"grid steps"))
            return
        visits = rows[:, _C["visits"]]
        want = live.astype(np.int64) if model_name == "ca" \
            else np.ones(n, np.int64)
        add("mis-visited steps", np.nonzero(visits != want)[0],
            lambda i: f"step {i} visited {visits[i]} times, expected "
            f"{want[i]}")
        seen = visits > 0
        tlive = rows[:, _C["live"]] == 1
        add("steps of the wrong liveness",
            np.nonzero(seen & (tlive != live))[0],
            lambda i: f"step {i} ran as live={bool(tlive[i])}; the static "
            f"decode says live={bool(live[i])}")
        ok = seen & tlive & live
        tbx, tby = rows[:, _C["bx"]], rows[:, _C["by"]]
        add("mis-decoded steps",
            np.nonzero(ok & ((tbx != st["bx"]) | (tby != st["by"])))[0],
            lambda i: f"step {i} decoded block ({tbx[i]}, {tby[i]}); the "
            f"static decode gives ({st['bx'][i]}, {st['by'][i]})")
        wr, wc = st["row"][live], st["col"][live]
        nr, nc = storage_grid(plan)
        if model_name in ("write", "ca"):
            sr = rows[ok, _C["store_row"]]
            sc = rows[ok, _C["store_col"]]
            out = np.nonzero((sr < 0) | (sr >= nr) | (sc < 0) | (sc >= nc))[0]
            add("out-of-bounds stores", out,
                lambda i: f"store to tile ({sr[i]}, {sc[i]}) out of bounds "
                f"for the ({nr}, {nc}) tile grid")
            ks, kw = _keys((sr, sc), (wr, wc))
            _, first, counts = np.unique(ks, return_index=True,
                                         return_counts=True)
            twice = first[counts > 1]
            add("tiles stored twice", twice,
                lambda i: f"tile ({sr[i]}, {sc[i]}) stored by more than one "
                f"step of one launch")
            extra = np.nonzero(~np.isin(ks, kw))[0]
            add("stores outside the static write set", extra,
                lambda i: f"store to tile ({sr[i]}, {sc[i]}) is outside the "
                f"static write set")
            missing = np.nonzero(~np.isin(kw, ks))[0]
            add("static write tiles never stored", missing,
                lambda i: f"static write set expects a store to tile "
                f"({wr[i]}, {wc[i]}) that never happened")
        hr, hc = neighbor_grid(plan)
        step = np.nonzero(ok)[0]
        for o in (4,) if model_name == "sum" else \
                tuple(range(9)) if model_name == "ca" else ():
            self._check_slot(plan, st, rows, step, o, (hr, hc), add)
        if model_name == "sum":
            slot = rows[:, _C["slot"]]
            add("partials in the wrong slot",
                np.nonzero(seen & (slot != np.arange(n)))[0],
                lambda i: f"step {i} wrote partial slot {slot[i]}")

    @staticmethod
    def _check_slot(plan, st, rows, step, o, grid, add):
        """Origin slot ``o`` = (dy + 1) * 3 + dx + 1 of the checked steps
        ``step``: it loads exactly when the block at offset (dx, dy) is
        in range and a member, the tile it loads lies in the ``grid``
        and is the static one of that slot (the centre's storage tile
        for slot 4, else neighbour j of NEIGHBOR_OFFSETS8 = (dx, dy))."""
        dx, dy = o % 3 - 1, o // 3 - 1
        lr = rows[step, _LOADS + 2 * o]
        lc = rows[step, _LOADS + 2 * o + 1]
        took = (lr != -1) | (lc != -1)
        if o == 4:
            er, ec = st["row"][step], st["col"][step]
            want = np.ones(len(step), bool)
        else:
            j = NEIGHBOR_OFFSETS8.index((dx, dy))
            er, ec = st["nbrs"][j][0][step], st["nbrs"][j][1][step]
            nbx, nby = plan.sched_domain.bounding_box
            x, y = st["bx"][step] + dx, st["by"][step] + dy
            member = np.broadcast_to(np.asarray(plan.sched_domain.contains(
                np.clip(x, 0, nbx - 1), np.clip(y, 0, nby - 1))), x.shape)
            want = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) & member
        at = f"origin slot {o} ({dx:+d}, {dy:+d})"
        add("slots loaded against the static decode",
            np.nonzero(took != want)[0],
            lambda i: f"step {step[i]} {'loaded' if took[i] else 'skipped'} "
            f"{at}; the static decode "
            f"{'has a member there' if want[i] else 'has no member there'}")
        hr, hc = grid
        bad = np.nonzero(took & ((lr < 0) | (lr >= hr) | (lc < 0) |
                                 (lc >= hc)))[0]
        add("out-of-bounds loads", bad,
            lambda i: f"load of tile ({lr[i]}, {lc[i]}) at {at} out of "
            f"bounds for the ({hr}, {hc}) tile grid")
        wrong = np.nonzero(took & want & ((lr != er) | (lc != ec)))[0]
        add("loads of another tile than the slot's", wrong,
            lambda i: f"step {step[i]} loaded tile ({lr[i]}, {lc[i]}) at "
            f"{at}; the static tile of that slot is ({er[i]}, {ec[i]})")


def _keys(*pairs):
    """One int64 key per (row, col), consistent across the pairs."""
    rows = np.concatenate([r for r, _ in pairs])
    cols = np.concatenate([c for _, c in pairs])
    if not len(rows):
        return [np.empty(0, np.int64) for _ in pairs]
    r0, c0 = min(rows.min(), 0), min(cols.min(), 0)
    w = int(cols.max() - c0) + 1
    return [(r - r0) * w + (c - c0) for r, c in pairs]


def plain_trace(plan, kernel: str, device) -> torch.Tensor:
    """The trace rows a ``kernel`` ("write", "sum" or "ca") launch of
    ``plan`` must fill, from the plain version's index tensors on
    ``device`` (no state is touched): what the trace build's rows are
    held to, entry for entry."""
    import importlib
    if kernel == "ca":
        ca = importlib.import_module("repro_torch.kernels.sierpinski_ca")
        return ca.ca_trace_plain(plan, device)
    sw = importlib.import_module("repro_torch.kernels.sierpinski_write")
    return sw.trace_plain(plan, kernel, device)


def verify_launches(fn, *args, kernel: str = "generic",
                    strict: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an :class:`AccessTrace` and
    cross-check.  Returns ``(result, findings)``; with ``strict`` (the
    default) raises :class:`PlanVerificationError` on any finding
    instead."""
    with AccessTrace(kernel=kernel) as tr:
        out = fn(*args, **kwargs)
    findings = tr.crosscheck()
    if strict and findings:
        lines = "\n  ".join(str(f) for f in findings)
        raise PlanVerificationError(
            f"access sanitizer found mismatches:\n  {lines}")
    return out, findings
