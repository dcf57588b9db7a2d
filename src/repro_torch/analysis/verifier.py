"""Static plan verification: machine-checked proofs of the block-space
invariants, per plan a kernel launches.

Given any :class:`~repro_torch.core.plan.GridPlan` (or
:class:`~repro_torch.core.shard.ShardedPlan`), every decode the kernels
run -- the plain versions' ``step_coords``, ``storage_index`` and
``neighbor_index``, which the CUDA kernels match bit for bit -- is
evaluable on host tensors, so the verifier enumerates the *entire* launch
grid of every rank and checks, exhaustively:

``coverage``
    Every block of the scheduled domain is decoded by exactly one live
    grid step per launch (union over ranks for sharded plans), against a
    ground-truth enumeration built only from ``domain.contains`` over the
    bounding box -- never from the decode path under test.

``race``
    The storage tile write-set is pairwise disjoint across live steps of
    one launch (per rank): the kernels store at computed offsets from
    persistent CTAs in no fixed order, so a storage-index collision is a
    data race, not just a perf bug.

``table``
    The decode tables a launch reads -- the 28-column LUT, the supertile
    permutation, the mma chains' tensor-core operands, shard parameters,
    ghost maps, halo rounds, phase lists -- are re-derived from
    ``linear_index`` / ``lambda_inverse`` / membership and diffed entry
    by entry.  The neighbour check is semantic: a neighbour slot must
    *invert* (via the slot -> coords table) to exactly the embedded
    neighbour.

``bounds``
    ``storage_index`` / ``neighbor_index`` are evaluated over **all**
    grid steps (a discarded bounding step still decodes) and the exact
    [min, max] hull per axis is checked against the state's tile grid.

``alias``
    In-place aliasing: for each aliased input, its modelled read tiles
    at live step ``s`` must never intersect the write tile of a
    different live step ``t`` (the CA's double buffer -- the stale
    buffer is written but never read -- is what makes the 9-point
    stencil safe; aliasing the state instead is flagged).

``hull``
    Flash attention's per-row key-block windows: every block row is one
    contiguous span, and each row-extents source a lowering reads equals
    the hull re-derived from membership.

The tables are checked as the launch reads them.  For a plan whose tables
lie on the card the verifier copies to the host the very tensors
:meth:`~repro_torch.core.plan.GridPlan.launch_params` hands the kernel
(its ``lut``, ``tile_perm`` and ``mma_ops``) and a rank's
:meth:`~repro_torch.core.shard.ShardedPlan.shard_params` (its ghost map
and phase list), and decodes through those copies (:func:`launch_tables`,
:func:`host_view`): the device copies are memoized, so a check of
``lut_host()`` against itself would miss a corrupt device table.

:func:`verify_plan` runs everything applicable and returns a
:class:`Report`; :func:`verify_or_raise` raises
:class:`PlanVerificationError` (a ``ValueError``, so the tuner treats a
failing candidate as inviable) on any finding.  The report's JSON is the
JAX package's (``repro.analysis.verifier``), with the port's target
(``"cuda"`` / ``"cpu"``) under ``plan["backend"]``.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import memo, mma
from repro_torch.core.compact import NEIGHBOR_OFFSETS8
from repro_torch.core.plan import (_LUT_BX, _LUT_BY, _LUT_COLS, _LUT_NBR,
                                   _LUT_SX, _LUT_SY, GridPlan)
from repro_torch.core.shard import (PART_CODES, SHARD_COUNT, SHARD_GMAP,
                                    SHARD_LO, SHARD_PARAMS, ShardedPlan)


class PlanVerificationError(ValueError):
    """A plan (or a page table) failed verification.  Subclasses
    ``ValueError`` so :func:`repro_torch.core.tune.autotune` rejects the
    candidate as inviable instead of measuring it."""


@dataclasses.dataclass
class Finding:
    """One verified invariant violation."""

    check: str                      # coverage|race|table|bounds|alias|hull
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
    """Result of one :func:`verify_plan` run."""

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


#: per-kernel access models: whether the storage write-set must be
#: race-free (reductions to per-step partials are exempt), whether the
#: kernel reads the 8 halo tiles, and the read model of each aliased
#: input ("none" = never read, e.g. the CA stale buffer; "center" =
#: read at the step's own storage tile; "center+neighbors" = the stencil
#: gather).
ACCESS_MODELS: Dict[str, Dict[str, Any]] = {
    "generic": {"race": True, "neighbors": False, "storage": True,
                "alias_reads": ()},
    "write": {"race": True, "neighbors": False, "storage": True,
              "alias_reads": ("center",)},
    "sum": {"race": False, "neighbors": False, "storage": True,
            "alias_reads": ()},
    "ca": {"race": True, "neighbors": True, "storage": True,
           "alias_reads": ("none",)},
    "flash": {"race": False, "neighbors": False, "storage": False,
              "alias_reads": (), "hulls": True},
}

#: the checks :func:`verify_plan` runs by default
CHECKS = ("coverage", "race", "table", "bounds", "alias", "hull")


class HostMesh:
    """Geometry-only stand-in for a mesh: enough to build a
    :class:`ShardedPlan` for host-side verification (its tables and
    decodes never need a process group)."""

    def __init__(self, num_shards: int, axis: str = "data"):
        self.shape = {axis: int(num_shards)}


# ---------------------------------------------------------------------------
# the tables a launch reads, and host views that decode through them
# ---------------------------------------------------------------------------

def _is_sharded(plan) -> bool:
    return isinstance(plan, ShardedPlan)


def _phase(plan):
    return getattr(plan, "phase", None)


def plan_signature(plan: GridPlan) -> Dict[str, Any]:
    sig: Dict[str, Any] = {
        "domain": plan.domain.name,
        "lowering": plan.lowering,
        "storage": plan.storage,
        "coarsen": plan.coarsen,
        "backend": plan.target.name,
    }
    if _is_sharded(plan):
        sig["shards"] = plan.num_shards
        sig["partition"] = plan.partition
        if plan.phase is not None:
            sig["phase"] = plan.phase
    return sig


def num_devices(plan: GridPlan) -> int:
    return plan.num_shards if _is_sharded(plan) else 1


def launch_device(plan: GridPlan, device=None) -> torch.device:
    """The device whose tables a launch of ``plan`` reads: ``device``,
    else the plan's target (the current card, or the CPU)."""
    dev = torch.device(device if device is not None else plan.target.name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().to("cpu").numpy()


def launch_tables(plan: GridPlan, device) -> Dict[str, Any]:
    """The tables one launch of ``plan`` (a rank-bound view for a
    sharded plan) reads on ``device``, copied to the host: the memoized
    tensors ``launch_params`` hands the kernel (``lut``, ``tile_perm``,
    ``mma_ops``) and, for a fractal kernel's rank, its ``shard_params``
    (``shard``: the parameters by name; ``gmap``; ``phase``: a phase
    view's step list).  Absent tables are None."""
    dev = torch.device(device)
    out: Dict[str, Any] = {"lut": None, "tile_perm": None, "mma_ops": None,
                           "shard": None, "gmap": None, "phase": None}
    if plan.lowering == "prefetch_lut":
        out["lut"] = _host(plan.lut(dev))
    out["tile_perm"] = _host(plan.tile_perm(dev))
    if plan.lowering == "mma":
        out["mma_ops"] = _host(plan.mma_operand_tensor(dev))
    if _is_sharded(plan) and plan.partition in PART_CODES:
        arr, gmap, ph = plan.shard_params(dev)
        out["shard"] = dict(zip(SHARD_PARAMS, (int(v) for v in arr)))
        out["gmap"] = _host(gmap)
        if plan.phase is not None:
            out["phase"] = _host(ph)[:len(plan._phase_steps())]
    return out


def host_tables(plan: GridPlan) -> Dict[str, Any]:
    """The tables of :func:`launch_tables` built afresh on the host
    (``lut_host``, the rank's chunk of ``lut_sharded_host``, the halo
    plan's ghost map and step lists), never read from a device copy:
    the yardstick the access sanitizer holds a launch's trace to."""
    out: Dict[str, Any] = {"lut": None, "tile_perm": None, "mma_ops": None,
                           "shard": None, "gmap": None, "phase": None}
    if plan.lowering == "prefetch_lut":
        out["lut"] = plan._chunk(plan.lut_sharded_host()) \
            if _is_sharded(plan) else plan.lut_host()
    if _is_sharded(plan) and plan.partition == "storage-rows":
        out["gmap"] = plan.halo.ghost_map[plan._need_rank()]
        if plan.phase is not None:
            out["phase"] = np.asarray(plan._phase_steps(), np.int64)
    return out


def _decode_key(plan: GridPlan, tables: Dict[str, Any]):
    """What a host view of an unsharded ``plan`` decodes from: the plan's
    geometry and a digest of the tables the view reads (None for a
    sharded plan, or a domain without a cache key)."""
    dk = memo.domain_key(plan.domain)
    if _is_sharded(plan) or dk is None:
        return None
    digest = hashlib.blake2b(digest_size=16)
    for name in ("lut", "gmap", "phase"):
        if tables.get(name) is not None:
            digest.update(name.encode())
            digest.update(np.ascontiguousarray(tables[name]).tobytes())
    return (dk, plan.lowering, plan.storage, plan.coarsen,
            plan.batch_dims, digest.digest())


def host_view(plan: GridPlan, tables: Dict[str, Any],
              decodes: Optional[Dict[Any, GridPlan]] = None) -> GridPlan:
    """A copy of ``plan`` whose decodes (``step_coords``,
    ``storage_index``, ``neighbor_index`` on the CPU) read ``tables``:
    its LUT (or LUT chunk), ghost map and phase list.  The view keeps
    its decode of the whole grid and the tiles :func:`storage_tiles` /
    :func:`neighbor_tiles` evaluate, so the checks (and the index
    functions, which decode first) share one evaluation.

    ``decodes``: a dict the caller keeps; an unsharded plan's view is
    kept there under its geometry and the digest of ``tables``, so the
    verifier and the access sanitizer (``AccessTrace(static=)``) given
    one dict decode a plan once, and a corrupt table is never answered
    by a clean table's decode."""
    key = _decode_key(plan, tables) if decodes is not None else None
    if key is not None and key in decodes:
        return decodes[key]
    view = copy.copy(plan)
    view._host_tiles = {}
    # the view's own decode (reading the tables above), or a decode the
    # caller put on the plan object
    decode = view.__dict__.get("step_coords") or \
        type(view).step_coords.__get__(view)
    whole = {}
    if plan.lowering == "mma" and not _is_sharded(plan) \
            and "step_coords" not in view.__dict__:
        # an unsharded plan's whole-grid mma decode is its chains' table
        # (the same chain on the same step ids, memoized with the plan)
        rows = torch.from_numpy(plan.mma_table_host()[:, :2].astype(
            np.int64))
        whole["coords"] = (rows[:, 0], rows[:, 1], None)

    def step_coords(start, stop, device):
        if (start, stop) != (0, _steps(view)):
            return decode(start, stop, device)
        if "coords" not in whole:
            whole["coords"] = decode(start, stop, device)
        return whole["coords"]
    view.step_coords = step_coords
    if tables.get("lut") is not None:
        lut = np.ascontiguousarray(tables["lut"])
        lut = torch.from_numpy(lut if lut.flags.writeable else lut.copy())
        view.lut = lambda device=None: lut
    if tables.get("gmap") is not None:
        gmap = torch.from_numpy(np.asarray(tables["gmap"], np.int64))
        view._gmap = lambda device=None: gmap
    if tables.get("phase") is not None:
        steps = [int(t) for t in tables["phase"]]
        view._phase_steps = lambda: steps
    if key is not None:
        decodes[key] = view
    return view


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def _steps(plan) -> int:
    return int(plan.steps_per_launch)


def decode_steps(plan: GridPlan):
    """(ids, bx, by, live) of one launch of a host view: every grid step
    of the domain (batch dims pinned: the decode is batch-invariant),
    decoded on the CPU, as int64 / bool numpy arrays."""
    steps = _steps(plan)
    ids = np.arange(steps, dtype=np.int64)
    bx, by, valid = plan.step_coords(0, steps, "cpu")
    bx = np.broadcast_to(_np(bx).astype(np.int64), ids.shape)
    by = np.broadcast_to(_np(by).astype(np.int64), ids.shape)
    live = np.ones(ids.shape, bool) if valid is None else \
        np.broadcast_to(_np(valid).astype(bool), ids.shape)
    return ids, bx, by, live


def _tiles(plan: GridPlan, key, index):
    """``index(0, steps, "cpu")`` as int64 numpy (row, col), kept in a
    host view's cache under ``key``."""
    cache = getattr(plan, "_host_tiles", None)
    if cache is not None and key in cache:
        return cache[key]
    steps = _steps(plan)
    r, c = index(0, steps, "cpu")
    out = (np.broadcast_to(_np(r).astype(np.int64), (steps,)),
           np.broadcast_to(_np(c).astype(np.int64), (steps,)))
    if cache is not None:
        cache[key] = out
    return out


def storage_tiles(plan: GridPlan):
    """(row, col) storage tile index per grid step of a host view."""
    return _tiles(plan, "storage", plan.storage_index)


def neighbor_tiles(plan: GridPlan, j: int):
    """(row, col) tile index of the j-th halo tile per grid step."""
    return _tiles(plan, j, lambda *a: plan.neighbor_index(j, *a))


def members_host(domain) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth member blocks from membership alone (independent of
    the enumeration/decode under test)."""
    nbx, nby = domain.bounding_box
    gy, gx = np.mgrid[0:nby, 0:nbx]
    gx = gx.astype(np.int64).ravel()
    gy = gy.astype(np.int64).ravel()
    if getattr(domain, "always_member", False):
        return gx, gy
    m = np.broadcast_to(_np(domain.contains(gx, gy)), gx.shape).astype(bool)
    return gx[m], gy[m]


def storage_grid(plan: GridPlan) -> Tuple[int, int]:
    """(rows, cols) of the tile grid the *center* storage index
    addresses (the local slab for sharded compact plans)."""
    if _is_sharded(plan) and plan.storage == "compact":
        return plan.rpd, plan.ncols
    if plan.storage == "compact":
        scols, srows = plan.layout.grid_shape
        if plan._tiling is not None:
            bw, bh = plan._tiling.sub_shape
            return srows // bh, scols // bw
        return srows, scols
    nbx, nby = plan.sched_domain.bounding_box
    return nby, nbx


def neighbor_grid(plan: GridPlan) -> Tuple[int, int]:
    """(rows, cols) tile-grid bound for the halo tile indices: the
    halo-extended slab (ghost rows + dump) under sharded compact."""
    if _is_sharded(plan) and plan.storage == "compact":
        h_max = plan.halo.h_max if plan.halo is not None else 0
        return plan.rpd + h_max + 1, plan.ncols
    return storage_grid(plan)


def _keys(*pairs):
    """One int64 key per (row, col) pair, consistent across the arrays
    given (each a (rows, cols) pair of equal-length arrays)."""
    rows = np.concatenate([r for r, _ in pairs]) if pairs else np.empty(0)
    cols = np.concatenate([c for _, c in pairs]) if pairs else np.empty(0)
    if not len(rows):
        return [np.empty(0, np.int64) for _ in pairs]
    r0, c0 = rows.min(), cols.min()
    w = int(cols.max() - c0) + 1
    return [(r - r0) * w + (c - c0) for r, c in pairs]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _check_coverage(plan, per_device, findings):
    gx, gy = members_host(plan.sched_domain)
    pts = [(bx[live], by[live]) for _, bx, by, live in per_device]
    truth_k, *seen_k = _keys((gx, gy), *pts)
    for d, k in enumerate(seen_k):
        uniq, first, counts = np.unique(k, return_index=True,
                                        return_counts=True)
        for i in np.sort(first[counts > 1]):
            p = (int(pts[d][0][i]), int(pts[d][1][i]))
            findings.append(Finding(
                "coverage", f"block {p} decoded by two live steps of one "
                f"launch", device=d))
    allk = np.concatenate(seen_k) if seen_k else np.empty(0, np.int64)
    allx = np.concatenate([x for x, _ in pts]) if pts else allk
    ally = np.concatenate([y for _, y in pts]) if pts else allk
    uniq, first, counts = np.unique(allk, return_index=True,
                                    return_counts=True)
    extra = first[~np.isin(uniq, truth_k)]
    missing = np.nonzero(~np.isin(truth_k, uniq))[0]
    double = first[counts > 1]
    dcount = counts[counts > 1]
    for i in np.sort(extra)[:3]:
        findings.append(Finding(
            "coverage", f"live step decodes non-member block "
            f"{(int(allx[i]), int(ally[i]))}"))
    for i in missing[:3]:
        findings.append(Finding(
            "coverage", f"member block {(int(gx[i]), int(gy[i]))} is never "
            f"covered"))
    order = np.argsort(double)
    for i, c in zip(double[order][:3], dcount[order][:3]):
        findings.append(Finding(
            "coverage", f"member block {(int(allx[i]), int(ally[i]))} "
            f"covered {int(c)} times across the mesh"))
    if len(extra) > 3 or len(missing) > 3 or len(double) > 3:
        findings.append(Finding(
            "coverage", f"... {len(extra)} extra / {len(missing)} "
            f"missing / {len(double)} multiply-covered blocks total"))


def _check_race(views, per_device, findings):
    for d, (view, (_, _, _, live)) in enumerate(zip(views, per_device)):
        r, c = storage_tiles(view)
        (keys,) = _keys((r[live], c[live]))
        uniq, first, counts = np.unique(keys, return_index=True,
                                        return_counts=True)
        dup = np.sort(first[counts > 1])
        for i in dup[:3]:
            findings.append(Finding(
                "race", f"storage tile ({int(r[live][i])}, "
                f"{int(c[live][i])}) written by multiple live steps of one "
                f"launch", device=d))
        if len(dup) > 3:
            findings.append(Finding(
                "race", f"... {len(dup)} colliding storage tiles total",
                device=d))


def _check_bounds(views, model, findings):
    for d, view in enumerate(views):
        if _steps(view) == 0:
            continue
        nr, nc = storage_grid(view)
        hr, hc = neighbor_grid(view)
        r, c = storage_tiles(view)
        if r.min() < 0 or r.max() >= nr or c.min() < 0 or c.max() >= nc:
            findings.append(Finding(
                "bounds", f"storage index hull rows [{r.min()}, {r.max()}] "
                f"x cols [{c.min()}, {c.max()}] exceeds the ({nr}, {nc}) "
                f"tile grid (some load/store may go out of bounds)",
                device=d))
        if not model["neighbors"]:
            continue
        for j in range(len(NEIGHBOR_OFFSETS8)):
            r, c = neighbor_tiles(view, j)
            if r.min() < 0 or r.max() >= hr or c.min() < 0 or c.max() >= hc:
                findings.append(Finding(
                    "bounds", f"neighbor {j} index hull rows "
                    f"[{r.min()}, {r.max()}] x cols [{c.min()}, {c.max()}] "
                    f"exceeds the ({hr}, {hc}) halo tile grid", device=d))


def _check_alias(views, per_device, model, findings):
    for read_model in model["alias_reads"]:
        # "none": never read; "center": step s reads its own write tile,
        # so a cross-step hazard is exactly a write-set collision, which
        # the race check reports
        if read_model != "center+neighbors":
            continue
        for d, (view, (_, _, _, live)) in enumerate(zip(views, per_device)):
            steps = np.nonzero(live)[0]
            r, c = storage_tiles(view)
            nbrs = [neighbor_tiles(view, j)
                    for j in range(len(NEIGHBOR_OFFSETS8))]
            wk, *nk = _keys((r[live], c[live]),
                            *[(nr_[live], nc_[live]) for nr_, nc_ in nbrs])
            order = np.argsort(wk, kind="stable")
            sk, ss = wk[order], steps[order]
            hit = None
            for j, k in enumerate(nk if len(sk) else ()):
                pos = np.clip(np.searchsorted(sk, k), 0, len(sk) - 1)
                bad = np.nonzero((sk[pos] == k) & (ss[pos] != steps))[0]
                if len(bad):
                    hit = (int(steps[bad[0]]), j, int(ss[pos[bad[0]]]))
                    break
            if hit:
                s, j, t = hit
                findings.append(Finding(
                    "alias", f"aliased input is read at neighbor {j} of "
                    f"step {s}, which is the write tile of step {t}: "
                    f"in-place aliasing makes this a read-after-write hazard "
                    f"within the launch", device=d))


def _expected_coords(plan, findings):
    """(n, 2) coords table placed by ``linear_index`` (the inverse map),
    or None after a finding."""
    dom = plan.sched_domain
    gx, gy = members_host(dom)
    n = dom.num_blocks
    if len(gx) != n:
        findings.append(Finding(
            "table", f"membership enumerates {len(gx)} blocks but "
            f"num_blocks = {n}"))
        return None
    li = np.broadcast_to(_np(dom.linear_index(gx, gy)).astype(np.int64),
                         gx.shape)
    if li.min() < 0 or li.max() >= n or len(np.unique(li)) != n:
        findings.append(Finding(
            "table", "linear_index over the member set is not a "
            "permutation of [0, num_blocks)"))
        return None
    exp = np.zeros((n, 2), np.int64)
    exp[li, 0] = gx
    exp[li, 1] = gy
    return exp


def _check_coords(what, lut, exp, findings):
    lut = np.asarray(lut)
    if lut.shape[0] != exp.shape[0]:
        findings.append(Finding(
            "table", f"{what} has {lut.shape[0]} rows for "
            f"{exp.shape[0]} blocks"))
        return False
    bad = np.nonzero((lut[:, _LUT_BX] != exp[:, 0])
                     | (lut[:, _LUT_BY] != exp[:, 1]))[0]
    for i in bad[:3]:
        findings.append(Finding(
            "table", f"{what} row {i} decodes to ({lut[i, _LUT_BX]}, "
            f"{lut[i, _LUT_BY]}); linear_index places ({exp[i, 0]}, "
            f"{exp[i, 1]}) there"))
    if len(bad) > 3:
        findings.append(Finding(
            "table", f"... {len(bad)} corrupted {what} coordinate rows"))
    return True


def _check_tables(plan, tables, findings):
    """The decode table the launch reads (the LUT under prefetch_lut),
    the host tables and the mma chains against the ground truth."""
    exp = _expected_coords(plan, findings)
    if exp is None:
        return
    if plan.lowering == "mma":
        # the plain versions' chains, then what the kernels' tensor-core
        # operands decode to
        sources = [("LUT", plan.mma_table_host())]
        if tables is not None and tables.get("mma_ops") is not None:
            sources.append(("mma operand decode",
                            _mma_ops_table(plan, tables["mma_ops"])))
    elif tables is not None and tables.get("lut") is not None:
        sources = [("LUT", tables["lut"])]
    else:
        sources = [("LUT", plan.lut_host())]
    for what, lut in sources:
        if lut is None:
            continue
        if not _check_coords(what, lut, exp, findings):
            continue
        if plan.storage == "compact" and np.asarray(lut).shape[1] == \
                _LUT_COLS:
            _check_compact_tables(plan, np.asarray(lut), exp, findings,
                                  what)
    if tables is not None and tables.get("tile_perm") is not None:
        _check_tile_perm(plan, tables["tile_perm"], findings)


def _check_compact_tables(plan, lut, exp, findings, what="LUT"):
    dom = plan.sched_domain
    n = dom.num_blocks
    if plan._tiling is not None:
        sx, sy = plan._tiling.tile_index(exp[:, 0], exp[:, 1])
    else:
        sx, sy = plan.layout.slot(exp[:, 0], exp[:, 1])
    sx = np.broadcast_to(_np(sx).astype(np.int64), (n,))
    sy = np.broadcast_to(_np(sy).astype(np.int64), (n,))
    bad = np.nonzero((lut[:, _LUT_SX] != sx) | (lut[:, _LUT_SY] != sy))[0]
    for i in bad[:3]:
        findings.append(Finding(
            "table", f"{what} row {i}: packed slot ({lut[i, _LUT_SX]}, "
            f"{lut[i, _LUT_SY]}) != lambda^-1 slot ({sx[i]}, {sy[i]})"))
    if len(bad) > 3:
        findings.append(Finding(
            "table", f"... {len(bad)} corrupted slot rows"))
    nr, nc = storage_grid(plan) if not _is_sharded(plan) else \
        (lambda g: (g[1], g[0]))(plan._storage_grid())
    if len(np.unique(sy * nc + sx)) != n or sx.min() < 0 \
            or sx.max() >= nc or sy.min() < 0 or sy.max() >= nr:
        findings.append(Finding(
            "table", "lambda^-1 slots are not an injection into the "
            "storage grid"))
        return
    # semantic neighbour check: every valid neighbour slot must invert
    # (via the slot -> coords table) to exactly the embedded neighbour
    slot2coord = np.full((nr, nc, 2), -1, np.int64)
    slot2coord[sy, sx, 0] = exp[:, 0]
    slot2coord[sy, sx, 1] = exp[:, 1]
    nbx, nby = dom.bounding_box
    nbrs = lut[:, _LUT_NBR:].reshape(n, 8, 3).astype(np.int64)
    for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
        ex = exp[:, 0] + dx
        ey = exp[:, 1] + dy
        inb = (ex >= 0) & (ex < nbx) & (ey >= 0) & (ey < nby)
        mem = np.zeros(n, bool)
        if inb.any():
            mem[inb] = np.broadcast_to(
                _np(dom.contains(ex[inb], ey[inb])),
                ex[inb].shape).astype(bool)
        ok = nbrs[:, j, 2] == 1
        bad = np.nonzero(ok != mem)[0]
        for i in bad[:2]:
            findings.append(Finding(
                "table", f"neighbor table row {i} offset {j}: "
                f"valid={bool(ok[i])} but membership says {bool(mem[i])}"))
        if len(bad) > 2:
            findings.append(Finding(
                "table", f"... {len(bad)} wrong neighbour-validity entries "
                f"at offset {j}"))
        nsx, nsy = nbrs[:, j, 0], nbrs[:, j, 1]
        if nsx.min() < 0 or nsx.max() >= nc or nsy.min() < 0 \
                or nsy.max() >= nr:
            findings.append(Finding(
                "table", f"neighbour slots at offset {j} leave the storage "
                f"grid (clamped reads would alias wrong tiles)"))
            continue
        sel = np.nonzero(ok & mem)[0]
        got = slot2coord[nsy[sel], nsx[sel]]
        bad = sel[np.nonzero((got[:, 0] != ex[sel])
                             | (got[:, 1] != ey[sel]))[0]]
        for i in bad[:2]:
            findings.append(Finding(
                "table", f"neighbor slot of row {i} offset {j} resolves to "
                f"block {tuple(slot2coord[nbrs[i, j, 1], nbrs[i, j, 0]])}, "
                f"expected ({exp[i, 0] + dx}, {exp[i, 1] + dy})"))
        if len(bad) > 2:
            findings.append(Finding(
                "table", f"... {len(bad)} mis-resolved neighbour slots at "
                f"offset {j}"))


def _check_tile_perm(plan, perm, findings):
    """The supertile permutation a compact coarsened launch reads: the
    packed position of each embedded fine block of a superblock must be
    where ``layout.slot`` puts that fine block inside its superblock's
    supertile, for every member superblock."""
    t = plan._tiling
    s = plan.coarsen
    bw, bh = t.sub_shape
    nfine = bw * bh
    perm = np.asarray(perm, np.int64)
    if perm.shape != (2 * nfine + s * s,):
        findings.append(Finding(
            "table", f"tile permutation has {perm.size} entries, expected "
            f"{2 * nfine + s * s}"))
        return
    fwd = perm[:2 * nfine].reshape(nfine, 2)
    inv = perm[2 * nfine:]
    coarse = plan.sched_domain.coords_host().astype(np.int64)
    tx, ty = t.tile_index(coarse[:, 0], coarse[:, 1])
    tx, ty = _np(tx).astype(np.int64), _np(ty).astype(np.int64)
    want = np.full(s * s, -1, np.int64)
    for e in range(s * s):
        ey, ex = divmod(e, s)
        fx, fy = coarse[:, 0] * s + ex, coarse[:, 1] * s + ey
        mem = np.broadcast_to(_np(plan.domain.contains(fx, fy)),
                              fx.shape).astype(bool)
        if not mem.any():
            continue
        sx, sy = plan.layout.slot(fx[mem], fy[mem])
        q = (_np(sy) - ty[mem] * bh) * bw + (_np(sx) - tx[mem] * bw)
        if not mem.all() or np.any(q != q[0]):
            findings.append(Finding(
                "table", f"fine block (ey, ex) = ({ey}, {ex}) does not land "
                f"at one packed position in every supertile"))
            return
        want[e] = q[0]
    bad = np.nonzero(inv != want)[0]
    for e in bad[:3]:
        findings.append(Finding(
            "table", f"tile permutation: embedded fine block {divmod(e, s)} "
            f"maps to packed {inv[e]}, the layout puts it at {want[e]}"))
    for e in np.nonzero(want >= 0)[0]:
        q = want[e]
        if 0 <= q < nfine and tuple(fwd[q]) != divmod(int(e), s):
            findings.append(Finding(
                "table", f"tile permutation: packed fine block {q} holds "
                f"embedded {tuple(int(v) for v in fwd[q])}, the layout "
                f"puts {divmod(int(e), s)} there"))
            break


def _unfragment(frag: np.ndarray, k: int, width: int) -> np.ndarray:
    """The (k, width) integer basis that ``mma.tensor_core_operand`` of
    ``mma.exact_split`` laid out as B fragments (its inverse)."""
    ks = frag.shape[0]
    words = frag.astype(np.int64) & 0xFFFFFFFF
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    bits = np.zeros((ks * mma.MMA_K, mma.MMA_N), np.int64)
    for s in range(ks):
        rows = s * mma.MMA_K + 2 * t
        bits[rows, g] = words[s, :, 0] & 0xFFFF
        bits[rows + 1, g] = words[s, :, 0] >> 16
        bits[rows + 8, g] = words[s, :, 1] & 0xFFFF
        bits[rows + 9, g] = words[s, :, 1] >> 16
    pieces = (bits.astype(np.uint32) << 16).view(np.float32)
    return mma.recombine(np.rint(pieces[:k]).astype(np.int64), width)


def _split_ops(ops: np.ndarray, sizes) -> List[np.ndarray]:
    out, at = [], 0
    for n in sizes:
        out.append(ops[at:at + n])
        at += n
    return out


def _digits(v: np.ndarray, base: int, levels: int) -> np.ndarray:
    return (v[:, None] // base ** np.arange(levels)) % base


def _mma_ops_table(plan, ops) -> np.ndarray:
    """The decode table the kernels' tensor-core chains compute from the
    operands ``ops`` a launch reads (``mma_operand_tensor``), evaluated
    in integers: the block coords of every step and, for a compact
    fractal, its slot and its neighbours' (sx, sy, valid) -- the layout
    of :meth:`GridPlan.lut_host`."""
    ops = np.asarray(ops, np.int64)
    dom = plan.sched_domain
    n = dom.num_blocks
    t = np.arange(n, dtype=np.int64)
    frac = mma.fractal_of(dom)
    if frac is None:
        nbx, nby = dom.bounding_box
        ks = mma.ksteps(nby)
        starts, frag = _split_ops(ops, (ks * mma.MMA_K + 2, ks * 64))
        basis = _unfragment(frag.reshape(ks, 32, 2), nby, 2)
        ones, diff = basis[:, 0], basis[:, 1]
        st = starts[:nby]
        # the chain's row is the count of row starts at or below t
        if np.any(np.diff(st) < 0):
            return np.full((n, 2), -1, np.int64)   # not a row chain
        ge = np.searchsorted(st, t, side="right")
        row = np.clip(ge - 1, 0, nby - 1)
        by = np.concatenate([[0], np.cumsum(ones)])[ge] - 1
        bx = t + np.where(ge > 0, diff[row], 0)
        return np.stack([bx, by], -1)
    spec, r = frac
    k, m = spec.k, spec.m
    mm = m * m
    sizes = [mma.ksteps(r * k) * 64, mma.ksteps(r * k) * 64,
             mma.ksteps(r * mm) * 64]
    cf, sf, nf = _split_ops(ops, sizes)
    cb = _unfragment(cf.reshape(-1, 32, 2), r * k, 2)
    sb = _unfragment(sf.reshape(-1, 32, 2), r * k, 2)
    nb = _unfragment(nf.reshape(-1, 32, 2), r * mm, 3)
    lv = np.arange(r)
    rows = lv * k + _digits(t, k, r)             # (n, r) one-hot columns
    bx, by = cb[rows, 0].sum(1), cb[rows, 1].sum(1)
    cols = [bx, by]
    if plan.storage == "compact":
        sx, sy = sb[rows, 0].sum(1), sb[rows, 1].sum(1)
        if plan._swap:
            sx, sy = sy, sx
        cols += [sx, sy]
        nbx, nby = dom.bounding_box
        for dx, dy in NEIGHBOR_OFFSETS8:
            x, y = bx + dx, by + dy
            inr = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby)
            xc, yc = np.clip(x, 0, nbx - 1), np.clip(y, 0, nby - 1)
            pr = lv * mm + _digits(yc, m, r) * m + _digits(xc, m, r)
            nsx, nsy, match = (nb[pr, c].sum(1) for c in range(3))
            if plan._swap:
                nsx, nsy = nsy, nsx
            ok = inr & (match == r)
            cols += [np.where(ok, nsx, 0), np.where(ok, nsy, 0),
                     ok.astype(np.int64)]
    return np.stack(cols, -1)


# -- sharded table checks ----------------------------------------------------

def _rederived_partition(plan):
    """Independent (lo, count) per device from the partition rule."""
    D = plan.num_shards
    N = plan.sched_domain.num_blocks
    if plan.partition == "storage-rows":
        lo = np.minimum(np.arange(D) * plan.rpd * plan.ncols, N)
        return lo, np.minimum(N - lo, plan.rpd * plan.ncols).clip(min=0)
    if plan.partition == "rows":
        nby = plan.sched_domain.bounding_box[1]
        by = np.sort(members_host(plan.sched_domain)[1])
        row_lo = np.minimum(np.arange(D + 1) * plan.rbd, nby)
        lo = np.searchsorted(by, row_lo, side="left")
        return lo[:-1], np.diff(lo)
    if plan.partition == "zigzag":
        # the snake: block row y goes to min(y mod 2D, 2D - 1 - y mod 2D),
        # and every rank's table starts at 0 (the JAX package's verifier
        # re-derives this partition as "linear" and flags every zigzag
        # plan)
        r = members_host(plan.sched_domain)[1] % (2 * D)
        return np.zeros(D, np.int64), np.bincount(
            np.minimum(r, 2 * D - 1 - r), minlength=D)
    per = -(-N // D)
    lo = np.minimum(np.arange(D) * per, N)
    return lo, np.minimum(N - lo, per).clip(min=0)


def _rederive_halo(plan):
    """(ghost classes, interior steps, boundary steps, column spans) per
    device, re-derived from the (already verified) neighbour tables.
    Spans map (ghost row, class) -> the half-open slot-column span of
    that row's readers."""
    if plan._tiling is not None:
        own = plan._tiling.tiles_host()
        nbrs = plan._tiling.neighbor_tiles_host()
    else:
        own = plan.layout.slots_host()
        nbrs = plan.layout.neighbor_slots_host()
    D, rpd = plan.num_shards, plan.rpd
    strips = plan.tile_map() is None
    ghosts, ints, bnds, spans = [], [], [], []
    for d in range(D):
        lo, hi = d * rpd, min((d + 1) * rpd, plan.nrows)
        sel = (own[:, 1] >= lo) & (own[:, 1] < hi)
        nb, mine = nbrs[sel], own[sel]
        cls: Dict[int, set] = {}
        span: Dict[tuple, tuple] = {}
        for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
            rem = (nb[:, j, 2] == 1) \
                & ((nb[:, j, 1] < lo) | (nb[:, j, 1] >= hi))
            gr, gc = nb[:, j, 1][rem], nb[:, j, 0][rem]
            c = "top" if strips and dy == 1 else \
                "bot" if strips and dy == -1 else "full"
            for g in np.unique(gr):
                cols = gc[gr == g]
                cls.setdefault(int(g), set()).add(c)
                key = (int(g), c)
                clo, chi = int(cols.min()), int(cols.max()) + 1
                if key in span:
                    plo, phi = span[key]
                    span[key] = (min(plo, clo), max(phi, chi))
                else:
                    span[key] = (clo, chi)
        for g, s in cls.items():
            if "full" in s:
                merged = [span.pop((g, c)) for c in s if (g, c) in span]
                cls[g] = {"full"}
                span[(g, "full")] = (min(x for x, _ in merged),
                                     max(y for _, y in merged))
        ghosts.append(cls)
        spans.append(span)
        remote = (nb[..., 2] == 1) \
            & ((nb[..., 1] < lo) | (nb[..., 1] >= hi))
        t_ids = (mine[:, 1].astype(np.int64) - lo) * plan.ncols + mine[:, 0]
        bnd = remote.any(axis=1)
        ints.append(np.sort(t_ids[~bnd]).tolist())
        bnds.append(np.sort(t_ids[bnd]).tolist())
    return ghosts, ints, bnds, spans


def _check_shard_tables(plan, rank_tables, findings):
    D = plan.num_shards
    tbl = np.asarray(plan.shard_table_host())
    lo, count = _rederived_partition(plan)
    exp_lo = np.arange(D) * plan.rpd \
        if plan.partition == "storage-rows" else lo
    if not np.array_equal(tbl[:, SHARD_LO], exp_lo):
        findings.append(Finding(
            "table", f"shard table lo column {tbl[:, SHARD_LO]} != "
            f"re-derived {exp_lo}"))
    if not np.array_equal(tbl[:, SHARD_COUNT], count):
        findings.append(Finding(
            "table", f"shard table count column {tbl[:, SHARD_COUNT]} != "
            f"re-derived {count}"))
    for d, tables in enumerate(rank_tables):
        sh = tables.get("shard") if tables else None
        if sh is None:
            continue
        want_lo = int(exp_lo[d]) * plan.ncols \
            if plan.partition == "storage-rows" else int(lo[d])
        if sh["count"] != int(count[d]) or sh["lo"] != want_lo:
            findings.append(Finding(
                "table", f"launch shard parameters (lo {sh['lo']}, count "
                f"{sh['count']}) != re-derived ({want_lo}, "
                f"{int(count[d])})", device=d))
    if plan.partition != "storage-rows":
        return
    ghosts, ints, bnds, spans = _rederive_halo(plan)
    halo = plan.halo
    rpd = plan.rpd
    with_halo = halo is not None and halo.int_steps is not None
    if not with_halo and any(g for g in ghosts):
        # write/sum plans skip the halo: nothing more to check
        ghosts = [dict() for _ in range(D)]
    h_max = max((len(g) for g in ghosts), default=0)
    dump = rpd + h_max
    for d in range(D):
        exp = np.full(plan.nrows_pad, dump, np.int64)
        own = np.arange(rpd) + d * rpd
        keep = own < plan.nrows_pad
        exp[own[keep]] = np.arange(rpd)[keep]
        for p, g in enumerate(sorted(ghosts[d])):
            exp[g] = rpd + p
        maps = [("ghost map", tbl[d, SHARD_GMAP:])]
        if rank_tables[d] and rank_tables[d].get("gmap") is not None:
            maps.append(("launch ghost map", rank_tables[d]["gmap"]))
        for what, gmap in maps:
            gmap = np.asarray(gmap, np.int64)
            if gmap.shape != exp.shape or not np.array_equal(gmap, exp):
                bad = np.nonzero(gmap != exp)[0] \
                    if gmap.shape == exp.shape else np.arange(5)
                findings.append(Finding(
                    "table", f"{what} rows {bad[:5].tolist()} disagree with "
                    f"the re-derived map (got "
                    f"{gmap[bad[:5]].tolist() if gmap.shape == exp.shape else gmap.shape}, "
                    f"expected {exp[bad[:5]].tolist()})", device=d))
    if with_halo:
        _check_halo_rounds(plan, ghosts, spans, findings)
        _check_phase_tables(plan, ints, bnds, findings)
    if plan.lowering in ("prefetch_lut", "mma"):
        _check_sharded_lut(plan, rank_tables, findings)


def _check_halo_rounds(plan, ghosts, spans, findings):
    """Simulate the exchange rounds and check every ghost row's strip
    requirement is delivered to its slot exactly, with a column window
    that covers its readers' span."""
    halo, D, rpd = plan.halo, plan.num_shards, plan.rpd
    order = [sorted(g) for g in ghosts]
    delivered: List[Dict[int, set]] = [dict() for _ in range(D)]
    for delta, cls, send, recv, scol, rcol, wc in halo.rounds:
        m = send.shape[1]
        for d in range(D):
            src = (d - delta) % D
            for i in range(m):
                slot = int(recv[d, i])
                if slot == halo.h_max:
                    continue  # padding -> dump row
                g = int(send[src, i]) + src * rpd
                if slot >= len(order[d]) or order[d][slot] != g:
                    findings.append(Finding(
                        "table", f"halo round (delta={delta}, {cls}): ghost "
                        f"slot {slot} receives global row {g}, expected "
                        f"{order[d][slot] if slot < len(order[d]) else 'dump'}",
                        device=d))
                    continue
                c0 = int(rcol[d, i])
                if int(scol[src, i]) != c0:
                    findings.append(Finding(
                        "table", f"halo round (delta={delta}, {cls}): ghost "
                        f"row {g} gathered at source column "
                        f"{int(scol[src, i])} but scattered at {c0}",
                        device=d))
                lo_, hi_ = spans[d].get((g, cls), (0, 0))
                if c0 < 0 or c0 + wc > plan.ncols \
                        or not (c0 <= lo_ and hi_ <= c0 + wc):
                    findings.append(Finding(
                        "table", f"halo round (delta={delta}, {cls}): ghost "
                        f"row {g} window [{c0}, {c0 + wc}) misses its reader "
                        f"span [{lo_}, {hi_}) or exceeds [0, {plan.ncols})",
                        device=d))
                delivered[d].setdefault(g, set()).add(cls)
    for d in range(D):
        for g, need in ghosts[d].items():
            got = delivered[d].get(g, set())
            if not need <= got:
                findings.append(Finding(
                    "table", f"ghost row {g} needs strips {sorted(need)} but "
                    f"the rounds deliver {sorted(got)}", device=d))


def _check_phase_tables(plan, ints, bnds, findings):
    tabs = plan.phase_tables_host()
    halo = plan.halo
    count = _rederived_partition(plan)[1]
    for d in range(plan.num_shards):
        if list(halo.int_steps[d]) != ints[d] \
                or list(halo.bnd_steps[d]) != bnds[d]:
            findings.append(Finding(
                "table", "interior/boundary step partition disagrees with "
                "the re-derived remote-neighbour classification", device=d))
            continue
        owned = sorted(ints[d] + bnds[d])
        if owned != list(range(int(count[d]))):
            findings.append(Finding(
                "table", f"phase step lists do not partition the "
                f"{int(count[d])} owned steps", device=d))
    if tabs is None:
        return
    it, bt = tabs
    for d in range(plan.num_shards):
        for name, tab, ref in (("interior", it, ints),
                               ("boundary", bt, bnds)):
            k = int(tab[d, 0])
            if k != len(ref[d]) or tab[d, 1:1 + k].tolist() != ref[d]:
                findings.append(Finding(
                    "table", f"{name} phase table row disagrees with the "
                    f"re-derived step list", device=d))


def _check_sharded_lut(plan, rank_tables, findings):
    """Each rank's decode-table chunk (the one its launch reads, or the
    mma chains' table under mma) must decode its slab row-major: chunk
    row t (t < count) is the member block whose packed slot is
    (t % ncols, lo + t // ncols)."""
    if plan.partition != "storage-rows":
        return
    per = plan.rpd * plan.ncols
    host = plan.lut_sharded_host()
    if host is None:
        host = plan.mma_table_sharded_host()
    slot = plan._tiling.tile_index if plan._tiling is not None \
        else plan.layout.slot
    tbl = np.asarray(plan.shard_table_host())
    _, count = _rederived_partition(plan)
    for d in range(plan.num_shards):
        lut = rank_tables[d].get("lut") if rank_tables[d] else None
        chunk = np.asarray(lut) if lut is not None \
            else np.asarray(host[d * per:(d + 1) * per])
        c = int(count[d])
        if c == 0:
            continue
        t = np.arange(c)
        sx, sy = slot(chunk[:c, _LUT_BX].astype(np.int64),
                      chunk[:c, _LUT_BY].astype(np.int64))
        sx = _np(sx).astype(np.int64)
        sy = _np(sy).astype(np.int64)
        row0 = int(tbl[d, SHARD_LO])
        bad = np.nonzero((sx != t % plan.ncols)
                         | (sy != row0 + t // plan.ncols))[0]
        for i in bad[:3]:
            findings.append(Finding(
                "table", f"sharded LUT chunk row {i} decodes to slot "
                f"({sx[i]}, {sy[i]}), expected ({i % plan.ncols}, "
                f"{row0 + i // plan.ncols})", device=d))
        if len(bad) > 3:
            findings.append(Finding(
                "table", f"... {len(bad)} misplaced sharded LUT rows",
                device=d))


def _check_phase_views(plan, device, findings):
    """Interior + boundary launches together must cover each owned step
    exactly once, with decodes equal to the base launch's."""
    if plan.phase_tables_host() is None:
        return
    for d in range(plan.num_shards):
        base, _ = _rank(plan, d, device)
        _, bx, by, live = decode_steps(base)
        covered = np.zeros(len(bx), np.int64)
        for which in ("interior", "boundary"):
            view, _ = _rank(plan.phase_view(which), d, device)
            _, vbx, vby, vlive = decode_steps(view)
            t = np.asarray(view._phase_steps(), np.int64)[np.nonzero(vlive)[0]]
            s = np.nonzero(vlive)[0]
            ok = (t >= 0) & (t < len(bx))
            np.add.at(covered, t[ok], 1)
            bad = s[~ok]
            if not len(bad):
                tt = t[ok]
                bad = s[ok][(bx[tt] != vbx[s[ok]]) | (by[tt] != vby[s[ok]])]
            for i in bad[:1]:
                tb = int(np.asarray(view._phase_steps())[i])
                findings.append(Finding(
                    "coverage", f"phase {which} step {int(i)} decodes "
                    f"{(int(vbx[i]), int(vby[i]))} but base step {tb} "
                    f"decodes "
                    f"{(int(bx[tb]), int(by[tb])) if 0 <= tb < len(bx) else None}",
                    device=d))
        if not np.array_equal(covered, live.astype(np.int64)):
            findings.append(Finding(
                "coverage", "interior+boundary phases do not cover each "
                "owned step exactly once", device=d))


def _check_flash_hulls(plan, findings, extents=None):
    """Flash q/k window hulls.  The flash kernels walk key blocks
    ``start..end`` of each query row in one loop, so correctness needs
    (a) every block row of the domain to be a *contiguous* span -- a hole
    would be visited and attended to -- and (b) the row-extents source
    the lowering reads to equal the hull re-derived from membership: the
    host ``row_extents`` table (copied to the card under
    ``prefetch_lut``), for ``mma`` plans the digit-basis chain
    (:func:`repro_torch.core.mma.row_extents_chain`), and ``extents``,
    the table a launch reads, when given.  ``closed_form`` computes the
    bounds analytically in-kernel; its hull is implied by (a) plus the
    coverage check, and ``bounding`` walks the full range with guards.
    Every source must also stay inside the block grid (an out-of-range
    extent would clamp KV loads onto wrong tiles)."""
    dom = plan.sched_domain
    gx, gy = members_host(dom)
    nbx, nby = dom.bounding_box
    exp = np.zeros((nby, 2), np.int64)
    exp[:, 1] = -1
    cnt = np.bincount(gy, minlength=nby)
    occ = cnt > 0
    lo = np.full(nby, nbx, np.int64)
    hi = np.full(nby, -1, np.int64)
    np.minimum.at(lo, gy, gx)
    np.maximum.at(hi, gy, gx)
    exp[occ, 0], exp[occ, 1] = lo[occ], hi[occ]
    for row in np.nonzero(occ & (hi - lo + 1 != cnt))[0]:
        findings.append(Finding(
            "hull", f"block row {row} has holes: the flash key loop over "
            f"[{exp[row, 0]}, {exp[row, 1]}] would attend to non-member "
            f"tiles"))
    sources = [("row_extents", plan.row_extents())]
    if plan.lowering == "mma":
        sources.append(("mma.row_extents_chain",
                        _np(mma.row_extents_chain(plan.domain))))
    if extents is not None:
        sources.append(("launch row_extents", _np(extents)))
    for name, ext in sources:
        ext = np.asarray(ext).astype(np.int64)
        if ext.shape != (nby, 2):
            findings.append(Finding(
                "hull", f"{name} has shape {ext.shape}, expected "
                f"{(nby, 2)}"))
            continue
        if np.any((ext[occ, 0] < 0) | (ext[occ, 1] >= nbx)):
            findings.append(Finding(
                "hull", f"{name} leaves the {nbx}-wide block grid"))
        bad = np.nonzero((ext[:, 0] != exp[:, 0])
                         | (ext[:, 1] != exp[:, 1]))[0]
        for row in bad[:3]:
            findings.append(Finding(
                "hull", f"{name} row {row} = [{ext[row, 0]}, "
                f"{ext[row, 1]}] but the membership hull is "
                f"[{exp[row, 0]}, {exp[row, 1]}]"))
        if len(bad) > 3:
            findings.append(Finding(
                "hull", f"... {len(bad)} wrong {name} rows"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _rank(plan, rank, device, decodes=None):
    """(host view, launch tables) of rank ``rank`` (or of the unsharded
    plan): the tables its launch reads on ``device`` for the plan's own
    rank (every rank of a plan bound to none), on the CPU for the other
    ranks of a rank-bound plan."""
    view = plan.for_rank(rank) if _is_sharded(plan) else plan
    own = not _is_sharded(plan) or plan.rank in (None, rank)
    tables = launch_tables(view, device if own else "cpu")
    return host_view(view, tables, decodes), tables


def verify_plan(plan: GridPlan, *, kernel: str = "generic",
                checks: Optional[Sequence[str]] = None, device=None,
                row_extents=None) -> Report:
    """Run every applicable static check for ``plan`` under the named
    kernel access model (see :data:`ACCESS_MODELS`); returns a
    :class:`Report` (``.ok`` / ``.findings``).

    ``device``: whose tables to check (default: the plan's target -- the
    current card, or the CPU); a sharded plan is checked rank by rank.
    ``row_extents``: the extents table a flash launch reads (checked
    beside the host sources by ``hull``)."""
    return verify_models(plan, (kernel,), checks=checks, device=device,
                         row_extents=row_extents)[kernel]


def verify_models(plan: GridPlan, kernels: Sequence[str], *,
                  checks: Optional[Sequence[str]] = None, device=None,
                  row_extents=None,
                  decodes: Optional[Dict[Any, GridPlan]] = None
                  ) -> Dict[str, Report]:
    """:func:`verify_plan` under each access model of ``kernels`` (one
    report each, as separate calls give), decoding the grid and running
    the model-independent checks once.  ``decodes``: as in
    :func:`host_view` (an unsharded plan's decode kept for later
    calls)."""
    selected = tuple(checks) if checks is not None else CHECKS
    dev = launch_device(plan, device)
    views, rank_tables = zip(*[_rank(plan, d, dev, decodes)
                               for d in range(num_devices(plan))])
    per_device = [decode_steps(v) for v in views]
    head: List[Finding] = []
    if "coverage" in selected and _phase(plan) is None:
        _check_coverage(plan, per_device, head)
    if "table" in selected:
        _check_tables(plan, None if _is_sharded(plan) else rank_tables[0],
                      head)
        if _is_sharded(plan) and _phase(plan) is None:
            _check_shard_tables(plan, rank_tables, head)
    tail: List[Finding] = []
    if "coverage" in selected and _is_sharded(plan) \
            and _phase(plan) is None \
            and plan.partition == "storage-rows" \
            and plan.halo is not None \
            and plan.halo.int_steps is not None \
            and plan.lowering != "bounding":
        _check_phase_views(plan, dev, tail)
    reports = {}
    for kernel in kernels:
        model = ACCESS_MODELS[kernel]
        findings = list(head)
        if model["storage"]:
            if "race" in selected and model["race"]:
                _check_race(views, per_device, findings)
            if "bounds" in selected:
                _check_bounds(views, model, findings)
            if "alias" in selected and model["alias_reads"]:
                _check_alias(views, per_device, model, findings)
        if "hull" in selected and model.get("hulls"):
            _check_flash_hulls(plan, findings, row_extents)
        reports[kernel] = Report(plan=plan_signature(plan), checks=selected,
                                 findings=findings + tail)
    return reports


def verify_or_raise(plan: GridPlan, *, kernel: str = "generic",
                    checks: Optional[Sequence[str]] = None, device=None,
                    row_extents=None) -> Report:
    """``verify_plan`` + raise :class:`PlanVerificationError` on any
    finding -- the ``verify=`` entry point of the kernels, called after
    the plan is built and before any launch."""
    return verify_plan(plan, kernel=kernel, checks=checks, device=device,
                       row_extents=row_extents).raise_on_findings()


# ---------------------------------------------------------------------------
# paged KV page tables (the serving scheduler's host invariants)
# ---------------------------------------------------------------------------

def verify_page_table(table, seq_lens, *, page_size: int,
                      num_pages: int, free_pages=(),
                      null_page: int = 0) -> Report:
    """Check the page-table invariants of the paged KV pool; raise
    :class:`PlanVerificationError` naming every violation (the host-side
    analogue of the plan LUT checks -- the table *is* a decode LUT
    pointed at physical memory).

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
