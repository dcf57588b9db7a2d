"""Mesh-aware block-space execution: :class:`ShardedPlan` partitions a
block domain across one axis of a mesh (:mod:`repro_torch.launch.mesh`)
and lowers each rank's sub-domain through the existing GridPlan paths
(closed_form / prefetch_lut / bounding / mma).

The host geometry -- partitions, shard tables, LUT chunks, the halo
plan -- is the JAX package's (``repro/core/shard.py``), table for table.
Where the JAX package traces one SPMD program that reads per-device
tables inside ``shard_map``, the port binds a plan to one rank
(:meth:`ShardedPlan.for_rank`) and gives that rank:

* plain-torch index functions (:meth:`~ShardedPlan.step_coords`,
  :meth:`~ShardedPlan.storage_index`, :meth:`~ShardedPlan.neighbor_index`)
  that the kernels' plain versions run unchanged, and
* the launch parameters the CUDA kernels read
  (:meth:`~ShardedPlan.launch_params`, :meth:`~ShardedPlan.shard_params`:
  the partition, the rank's first step and count, the storage grid and
  the ghost map).

Partitions
----------

``"storage-rows"`` (compact storage)
    The packed orthotope (supertile rows under ``coarsen``) is split into
    D contiguous slabs of ``rpd`` slot rows, padded to a common height.
    Each rank holds only its slab -- O(n^H / D) + halo -- and enumerates
    its slots row-major: lambda evaluated directly on the orthotope
    coordinate.  The fractal orthotope is dense (Lemma 2), so equal row
    slabs balance the work exactly.

``"linear"`` (embedded storage)
    The lambda-order enumeration [0, num_blocks) is split into D
    contiguous ranges -- sharding the paper's parallel space itself.
    States stay replicated; each rank computes its range and the ranks
    combine with an ownership-masked sum (exact: every cell has exactly
    one owner).

``"rows"`` (attention: the query-block axis)
    D contiguous bands of query-block rows; Q and O shard along the
    sequence, K and V stay replicated.

``"zigzag"`` (attention: balanced causal bands)
    Rank d owns rows ``{j : min(r, 2D-1-r) == d}``, ``r = j mod 2D``,
    pairing light and heavy rows of the causal triangle so every rank
    holds the same number of blocks (``nby % 2D == 0`` is enforced);
    callers permute Q block rows into snake order
    (:func:`zigzag_row_order`) and O back.

Halo exchange (compact CA)
--------------------------

A slab's blocks have embedded neighbours whose lambda^-1-resolved slots
may lie in other ranks' slabs, and orthotope row distance is not
embedded distance, so a slab's ghost rows are a scattered set of remote
rows.  :class:`HaloPlan` resolves them on the host from the layout's
neighbour tables and exchanges exactly those rows between launches, one
point-to-point batch per active (rank offset, strip class) round; the
kernel then reads ``[slab ++ ghost rows ++ dump row]`` through the ghost
map.
"""
from __future__ import annotations

import copy
import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.launch.mesh import axis_size

from . import memo
from . import mma
from .compact import NEIGHBOR_OFFSETS8, fractal_spec_of
from .domain import BlockDomain
from .plan import _LUT_BX, _LUT_BY, _LUT_NBR, GridPlan

PARTITIONS = ("linear", "rows", "storage-rows", "zigzag")

#: shard-table column layout (i32): [0] the device's linear offset
#: (linear/rows) or first owned storage row (storage-rows); [1] the
#: number of valid grid steps / owned blocks; [2] the first owned
#: query-block row ("rows") or the device index ("zigzag") -- then, for
#: "storage-rows", the ghost map (global storage row -> row of the
#: device's extended local array).
SHARD_LO = 0
SHARD_COUNT = 1
SHARD_ROWLO = 2
SHARD_DEV = 2
SHARD_GMAP = 2

#: kernel-side partition codes (``ShardPart`` in csrc/fractal_common.cuh)
PART_CODES = {"linear": 0, "storage-rows": 1}
#: order of a rank's integer shard parameters (``ShardParam`` in
#: csrc/fractal_common.cuh)
SHARD_PARAMS = ("part", "lo", "count", "ncols", "nrows", "lo_row", "rpd",
                "nrows_pad")

#: ``hook(round_fn, payload) -> received``: called around every halo
#: round of :meth:`HaloPlan.exchange` (the fault injector's); None: none.
EXCHANGE_HOOK: Optional[Callable] = None


def set_exchange_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install the halo-round hook (see :data:`EXCHANGE_HOOK`); returns
    the previous one.  ``None`` uninstalls."""
    global EXCHANGE_HOOK
    prev = EXCHANGE_HOOK
    EXCHANGE_HOOK = hook
    return prev


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _widen(spans: dict, key, lo: int, hi: int) -> None:
    """Grow ``spans[key]`` to cover the half-open column span
    [lo, hi)."""
    if key in spans:
        plo, phi = spans[key]
        spans[key] = (min(plo, lo), max(phi, hi))
    else:
        spans[key] = (lo, hi)


class HaloPlan:
    """Host-resolved ghost-row exchange for a storage-row partition.

    For each rank: which global storage rows (supertile rows under
    coarsening) its halo needs (``ghost_rows``), and the padded
    send/recv index tables of the exchange rounds.  ``h_max`` ghost rows
    (+1 dump row for padding traffic and never-needed rows) bound the
    halo memory.

    Rounds are keyed (rank offset ``delta``, strip class): the trapezoid
    update reads a ``dy = +1`` neighbour's *top* ``h`` cell rows and a
    ``dy = -1`` neighbour's *bottom* ``h`` rows (``h`` = the fuse
    depth), so a ghost row whose readers all sit on one side ships only
    that strip.  ``dy = 0`` readers (and packed supertiles, whose cell
    rows are not embedded-ordered) force the full row.  Each entry ships
    only the *occupied column window* its receiver's readers resolve
    (``col_span``), widened to the round's max width ``wcols`` and
    clamped into ``[0, ncols)``.  Unshipped cells stay zero and are
    never read by a valid step.  ``int_steps`` / ``bnd_steps`` split
    each rank's steps into *interior* (all 8 neighbour rows local) and
    *boundary* (any ghost neighbour), which lets a run overlap the
    exchange with interior compute (:meth:`ShardedPlan.phase_view`).
    """

    def __init__(self, plan: "ShardedPlan", with_halo: bool):
        D, rpd, nrows = plan.num_shards, plan.rpd, plan.nrows
        self.ghost_rows = [[] for _ in range(D)]
        self.row_class = [dict() for _ in range(D)]
        self.col_span = [dict() for _ in range(D)]  # (g, cls) -> (lo, hi)
        self.int_steps = None
        self.bnd_steps = None
        if with_halo:
            if plan._tiling is not None:
                own = plan._tiling.tiles_host()
                nbrs = plan._tiling.neighbor_tiles_host()
            else:
                own = plan.layout.slots_host()
                nbrs = plan.layout.neighbor_slots_host()
            rows = own[:, 1]
            strips = plan.tile_map() is None
            self.int_steps = [[] for _ in range(D)]
            self.bnd_steps = [[] for _ in range(D)]
            for d in range(D):
                lo, hi = d * rpd, min((d + 1) * rpd, nrows)
                sel = (rows >= lo) & (rows < hi)
                nb, mine = nbrs[sel], own[sel]
                cls = self.row_class[d]
                span = self.col_span[d]
                for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
                    rem = (nb[:, j, 2] == 1) \
                        & ((nb[:, j, 1] < lo) | (nb[:, j, 1] >= hi))
                    gr, gc = nb[:, j, 1][rem], nb[:, j, 0][rem]
                    c = "top" if strips and dy == 1 else \
                        "bot" if strips and dy == -1 else "full"
                    for g in np.unique(gr):
                        cols = gc[gr == g]
                        cls.setdefault(int(g), set()).add(c)
                        _widen(span, (int(g), c),
                               int(cols.min()), int(cols.max()) + 1)
                for g, s in cls.items():
                    if "full" in s:
                        merged = [span.pop((g, c)) for c in s
                                  if (g, c) in span]
                        cls[g] = {"full"}
                        span[(g, "full")] = (
                            min(x for x, _ in merged),
                            max(y for _, y in merged))
                self.ghost_rows[d] = sorted(cls)
                remote = (nb[..., 2] == 1) \
                    & ((nb[..., 1] < lo) | (nb[..., 1] >= hi))
                t_ids = (mine[:, 1] - lo) * plan.ncols + mine[:, 0]
                bnd = remote.any(axis=1)
                self.int_steps[d] = sorted(int(t) for t in t_ids[~bnd])
                self.bnd_steps[d] = sorted(int(t) for t in t_ids[bnd])
        self.h_max = max((len(g) for g in self.ghost_rows), default=0)
        # ghost map: global row -> row of [slab ++ ghosts ++ dump]
        dump = rpd + self.h_max
        gmap = np.full((D, plan.nrows_pad), dump, np.int32)
        for d in range(D):
            lo = d * rpd
            for i in range(rpd):
                if lo + i < plan.nrows_pad:
                    gmap[d, lo + i] = i
            for p, g in enumerate(self.ghost_rows[d]):
                gmap[d, g] = rpd + p
        self.ghost_map = gmap
        # one round per (rank offset, strip class) with any traffic
        self.rounds = []   # [(delta, cls, send (D, m), recv (D, m),
        #                     scol (D, m), rcol (D, m), wcols)]
        for delta in range(1, D):
            for cls in ("full", "top", "bot"):
                needs = [[g for g in self.ghost_rows[d]
                          if g // rpd == (d - delta) % D
                          and cls in self.row_class[d][g]]
                         for d in range(D)]
                m = max(len(x) for x in needs)
                if m == 0:
                    continue
                wc = max(hi_ - lo_ for d in range(D) for g in needs[d]
                         for lo_, hi_ in (self.col_span[d][(g, cls)],))
                send = np.zeros((D, m), np.int32)
                recv = np.full((D, m), self.h_max, np.int32)  # pad -> dump
                scol = np.zeros((D, m), np.int32)
                rcol = np.zeros((D, m), np.int32)
                for d in range(D):
                    for i, g in enumerate(needs[(d + delta) % D]):
                        send[d, i] = g - d * rpd  # local row at source
                        sp = self.col_span[(d + delta) % D][(g, cls)]
                        scol[d, i] = min(sp[0], plan.ncols - wc)
                    for i, g in enumerate(needs[d]):
                        recv[d, i] = self.ghost_rows[d].index(g)
                        sp = self.col_span[d][(g, cls)]
                        rcol[d, i] = min(sp[0], plan.ncols - wc)
                self.rounds.append(
                    (delta, cls, send, recv, scol, rcol, wc))

    def send_recv_host(self):
        """((send, recv, scol, rcol), ...) host tables, one 4-tuple per
        round.  ``scol``/``rcol`` are the clamped first slot column of
        each entry's shipped window (source / receiver side; equal by
        construction -- both resolve the receiver's span)."""
        return tuple((s, r, sc, rc)
                     for _, _, s, r, sc, rc, _ in self.rounds)

    def _strip(self, cls: str, RU: int, h: int):
        """(row offset, height) of one class's strip within a row."""
        if cls == "top":
            return 0, h
        if cls == "bot":
            return RU - h, h
        return 0, RU

    @staticmethod
    def _windows(col0, wc, tw, device):
        """(m, wc*tw) cell-column indices of the entries' windows."""
        c = torch.from_numpy(np.asarray(col0, np.int64)).to(device)
        return c[:, None] * tw + torch.arange(wc * tw, device=device)

    def exchange(self, plan: "ShardedPlan", local: torch.Tensor, rank: int,
                 h: Optional[int] = None, group=None,
                 out: Optional[torch.Tensor] = None, between=None):
        """Run every round of the exchange for ``rank`` and return the
        ghost block ((h_max + 1) * RU, W): exchanged ghost rows ++ a
        dump row.  ``local`` is the rank's slab (rpd * RU, W); ``h`` the
        strip height in cells (the launch's fuse depth; ``None`` ships
        full rows).  Each entry ships its ``wcols``-slot-column window
        (gathered at the sender's ``scol``, scattered at the receiver's
        ``rcol``); the rest stays as ``out`` held it (zeros in a new
        block).  Every round's batch is started before any is waited
        for; ``between()``, when given, runs while they are in flight
        (the interior launch of an overlapped step).  Each round passes
        through :data:`EXCHANGE_HOOK` when one is installed."""
        rpd, RU = plan.rpd, plan.row_unit
        h = RU if h is None else min(int(h), RU)
        W = local.shape[-1]
        tw = W // plan.ncols  # cell columns per slot column
        rows = local.reshape(rpd, RU, W)
        if out is None:
            out = torch.zeros(((self.h_max + 1) * RU, W), dtype=local.dtype,
                              device=local.device)
        ghost = out.view(self.h_max + 1, RU, W)
        D = plan.num_shards
        pending = []
        for delta, cls, send, recv, scol, rcol, wc in self.rounds:
            off, nr = self._strip(cls, RU, h)
            srows = torch.from_numpy(send[rank].astype(np.int64)).to(
                local.device)
            cidx = self._windows(scol[rank], wc, tw, local.device)
            base = rows[srows, off:off + nr]                 # (m, nr, W)
            payload = torch.gather(
                base, 2, cidx[:, None, :].expand(-1, nr, -1)).contiguous()
            dst, src = (rank + delta) % D, (rank - delta) % D

            def round_fn(x, dst=dst, src=src):
                return collectives.start(
                    [(dst, x)], [(src, tuple(x.shape))], x.dtype,
                    local.device, group)

            pending.append((round_fn, payload, recv, rcol, wc, off, nr))
        started = []
        for round_fn, payload, *rest in pending:
            if EXCHANGE_HOOK is None:
                started.append((round_fn(payload), None, rest))
            else:
                started.append((None, EXCHANGE_HOOK(
                    lambda x, f=round_fn: f(x).wait()[0], payload), rest))
        if between is not None:
            between()
        for work, got, (recv, rcol, wc, off, nr) in started:
            if got is None:
                got = work.wait()[0]
            ri = torch.from_numpy(recv[rank].astype(np.int64)).to(
                local.device)
            cc = self._windows(rcol[rank], wc, tw, local.device)
            rr = off + torch.arange(nr, device=local.device)
            ghost[ri[:, None, None], rr[None, :, None],
                  cc[:, None, :]] = got
        return out

    def cat(self, plan: "ShardedPlan", local: torch.Tensor,
            ghost: torch.Tensor) -> torch.Tensor:
        """local slab (rpd*RU, W) ++ ghost block -> the extended array
        ((rpd + h_max + 1)*RU, W) the kernels address through the ghost
        map."""
        return torch.cat([local, ghost], 0)

    def extend(self, plan: "ShardedPlan", local: torch.Tensor, rank: int,
               h: Optional[int] = None, group=None) -> torch.Tensor:
        """exchange + cat: the synchronous (non-overlapped) path."""
        return self.cat(plan, local, self.exchange(plan, local, rank, h,
                                                   group))

    def bytes_exchanged(self, plan: "ShardedPlan", block: int,
                        h: Optional[int] = None,
                        itemsize: int = 4) -> dict:
        """Payload bytes one exchange moves across the whole mesh:
        ``trimmed`` (what :meth:`exchange` ships -- strip height ``h`` x
        the per-round occupied column window, padding included) vs
        ``strips`` (strip-trimmed but full-width rows) vs ``full_rows``
        (every ghost row at full row_unit height and width)."""
        plan.bind_block(block)
        RU = plan.row_unit
        tw = plan.supertile_shape((block, block))[1]
        W = plan.ncols * tw
        h = RU if h is None else min(int(h), RU)
        D, rpd = plan.num_shards, plan.rpd
        trimmed = sum(D * s.shape[1] * self._strip(cls, RU, h)[1]
                      * wc * tw * itemsize
                      for _, cls, s, _, _, _, wc in self.rounds)
        strips = sum(D * s.shape[1] * self._strip(cls, RU, h)[1] * W
                     * itemsize for _, cls, s, *_ in self.rounds)
        full = 0
        for delta in range(1, D):
            m = max(len([g for g in self.ghost_rows[d]
                         if g // rpd == (d - delta) % D])
                    for d in range(D))
            full += D * m * RU * W * itemsize
        return {"trimmed": trimmed, "strips": strips,
                "full_rows": full}


class ShardedPlan(GridPlan):
    """A GridPlan whose grid is one rank's share of the domain.

    Parameters beyond :class:`GridPlan`:

    mesh, axis:  the mesh (a DeviceMesh, or any object whose ``shape``
                 maps ``axis`` to its size) and the axis to shard over.
    num_shards:  the shard count, in place of ``mesh`` (the host
                 geometry alone, no process group).
    partition:   "storage-rows" | "linear" | "rows" | "zigzag" (default:
                 by storage -- compact shards its packed rows, embedded
                 the canonical enumeration).
    halo:        build the ghost-row exchange plan (CA stencils under
                 compact storage; write/sum leave it off).
    rank:        the rank the per-rank methods answer for (or bind one
                 later with :meth:`for_rank`).

    The per-rank methods address *local* arrays: under "storage-rows"
    the rank's slab (a halo plan's: its extended array, whose first rows
    are the slab), under "rows" / "zigzag" the rank's query-row band,
    under "linear" the replicated global array.
    """

    def __init__(self, domain: BlockDomain, lowering: str = "closed_form",
                 batch_dims: Sequence[int] = (), storage: str = "embedded",
                 coarsen: int = 1, backend=None, *, mesh=None,
                 axis: str = "data", num_shards: Optional[int] = None,
                 partition: Optional[str] = None, halo: bool = False,
                 rank: Optional[int] = None):
        super().__init__(domain, lowering, batch_dims, storage, coarsen,
                         backend)
        if (mesh is None) == (num_shards is None):
            raise ValueError("ShardedPlan takes a mesh or a shard count, "
                             "not both or neither")
        self.mesh, self.axis = mesh, axis
        self.num_shards = int(num_shards) if mesh is None \
            else axis_size(mesh, axis)
        self.rank = rank
        if partition is None:
            partition = "storage-rows" if self.storage == "compact" \
                else "linear"
        if partition not in PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}; expected "
                             f"one of {PARTITIONS}")
        #: None, or "interior" / "boundary" on a :meth:`phase_view`
        self.phase = None
        if partition == "storage-rows" and self.storage != "compact":
            raise ValueError("storage-rows partition requires compact "
                             "storage")
        if partition != "storage-rows" and self.storage == "compact":
            raise ValueError("compact storage shards its packed rows; "
                             f"partition {partition!r} is embedded-only")
        self.partition = partition
        D = self.num_shards
        if partition == "storage-rows":
            self.ncols, self.nrows = self._storage_grid()
            self.rpd = _ceil_div(self.nrows, D)
            self.nrows_pad = self.rpd * D
            N = self.sched_domain.num_blocks
            lo = np.minimum(np.arange(D) * self.rpd * self.ncols, N)
            self._lo = lo.astype(np.int64)
            self._count = np.minimum(
                N - lo, self.rpd * self.ncols).clip(min=0)
            self.steps_per_shard = self.rpd * self.ncols
            self.halo = memo.cached(
                "halo-plan", domain,
                (self.storage, self.coarsen, D, bool(halo)),
                lambda: HaloPlan(self, with_halo=halo))
        elif partition == "rows":
            nbx, nby = self.sched_domain.bounding_box
            by = self.sched_domain.coords_host()[:, 1]
            if np.any(np.diff(by) < 0):
                raise ValueError(
                    f"'rows' partition needs a query-row-major "
                    f"enumeration; {self.sched_domain.name} is not")
            self.rbd = _ceil_div(nby, D)
            row_lo = np.minimum(np.arange(D + 1) * self.rbd, nby)
            lo = np.searchsorted(by, row_lo, side="left")
            self._row_lo = row_lo[:-1].astype(np.int64)
            self._lo = lo[:-1].astype(np.int64)
            self._count = np.diff(lo).astype(np.int64)
            self.steps_per_shard = int(self._count.max())
            self.halo = None
        elif partition == "zigzag":
            nbx, nby = self.sched_domain.bounding_box
            coords = self.sched_domain.coords_host()
            by = coords[:, 1]
            if np.any(np.diff(by) < 0):
                raise ValueError(
                    f"'zigzag' partition needs a query-row-major "
                    f"enumeration; {self.sched_domain.name} is not")
            if nby % (2 * D):
                raise ValueError(
                    f"'zigzag' partition needs the query-block row count "
                    f"({nby}) divisible by 2 * num_shards ({2 * D}) for "
                    f"an exactly balanced snake")
            r = by % (2 * D)
            dev = np.minimum(r, 2 * D - 1 - r)
            local = 2 * (by // (2 * D)) + (r >= D)
            key = local.astype(np.int64) * nbx + coords[:, 0]
            self.rbd = nby // D
            self._zz_idx = []
            for d in range(D):
                sel = np.nonzero(dev == d)[0]
                self._zz_idx.append(
                    sel[np.argsort(key[sel], kind="stable")].astype(
                        np.int64))
            self._count = np.asarray(
                [len(s) for s in self._zz_idx], np.int64)
            self._lo = np.zeros(D, np.int64)
            self.steps_per_shard = int(self._count.max())
            self.halo = None
        else:  # linear
            N = self.sched_domain.num_blocks
            per = _ceil_div(N, D)
            lo = np.minimum(np.arange(D) * per, N)
            self._lo = lo.astype(np.int64)
            self._count = np.minimum(N - lo, per).clip(min=0)
            self.steps_per_shard = per
            self.halo = None

    def for_rank(self, rank: int) -> "ShardedPlan":
        """A view of this plan bound to ``rank``."""
        if not 0 <= rank < self.num_shards:
            raise ValueError(f"rank {rank} outside [0, {self.num_shards})")
        view = copy.copy(self)
        view.rank = int(rank)
        return view

    def _need_rank(self) -> int:
        if self.rank is None:
            raise ValueError("this per-rank method needs a plan bound to a "
                             "rank (ShardedPlan.for_rank)")
        return self.rank

    # -- storage geometry ----------------------------------------------------

    def _storage_grid(self) -> Tuple[int, int]:
        """(ncols, nrows) of the scheduled storage grid: supertiles
        under coarsening, packed slots otherwise."""
        if self._tiling is not None:
            scols, srows = self.layout.grid_shape
            bw, bh = self._tiling.sub_shape
            return scols // bw, srows // bh
        return self.layout.grid_shape

    @property
    def row_unit(self) -> int:
        """Cells per storage row of one fine block row -- set by
        :meth:`bind_block`."""
        return self._row_unit

    def bind_block(self, block: int) -> "ShardedPlan":
        """Record the fine block size (cells); needed to convert storage
        rows to array rows for padding / halo exchange."""
        th, _ = self.supertile_shape((block, block))
        self._row_unit = th if self.storage == "compact" else block
        self._block = block
        return self

    def local_storage_shape(self, block: int) -> Tuple[int, int]:
        """Cell shape of one rank's storage-array shard."""
        if self.storage == "embedded":
            return self.layout.embedded_shape(block)
        self.bind_block(block)
        _, tw = self.supertile_shape((block, block))
        return (self.rpd * self.row_unit, self.ncols * tw)

    def extended_shape(self, block: int) -> Tuple[int, int]:
        """Cell shape of a halo plan's extended local array: the slab,
        the ghost rows and the dump row."""
        rows, cols = self.local_storage_shape(block)
        return (rows + (self.halo.h_max + 1) * self.row_unit, cols)

    def global_padded_rows(self, block: int) -> int:
        self.bind_block(block)
        return self.nrows_pad * self.row_unit

    def pad_rows(self, arr: torch.Tensor, block: int) -> torch.Tensor:
        """Zero-pad a global packed array to D-divisible storage rows."""
        rows = self.global_padded_rows(block)
        pad = rows - arr.shape[0]
        if pad == 0:
            return arr
        return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])

    def unpad_rows(self, arr: torch.Tensor, block: int) -> torch.Tensor:
        scols, srows = self.layout.grid_shape
        return arr[:srows * block]

    def slab(self, arr: torch.Tensor, block: int) -> torch.Tensor:
        """This rank's slab of a global packed array (a view when no
        padding is needed, else a padded copy of its rows)."""
        rank = self._need_rank()
        rows = self.rpd * self.bind_block(block).row_unit
        lo = rank * rows
        if lo + rows <= arr.shape[0]:
            return arr[lo:lo + rows]
        out = arr.new_zeros((rows,) + tuple(arr.shape[1:]))
        have = max(0, arr.shape[0] - lo)
        out[:have] = arr[lo:lo + have]
        return out

    def extended(self, arr: torch.Tensor, block: int) -> torch.Tensor:
        """This rank's extended array ``[slab ++ ghost rows ++ dump]`` of
        a global packed array, each ghost row copied whole from its
        owner's rows: what the exchange ships, and more (the per-rank
        kernel checks, which need no process group)."""
        rank = self._need_rank()
        rows, ru = self.rpd * self.bind_block(block).row_unit, self.row_unit
        ext = arr.new_zeros(self.extended_shape(block))
        ext[:rows] = self.slab(arr, block)
        glob = self.pad_rows(arr, block)
        for p, g in enumerate(self.halo.ghost_rows[rank]):
            ext[rows + p * ru:rows + (p + 1) * ru] = \
                glob[g * ru:(g + 1) * ru]
        return ext

    # -- per-device host tables (the JAX package's) --------------------------

    def shard_table_host(self) -> np.ndarray:
        """(D, L) i32: one shard-table row per device (see SHARD_*);
        memoized per (domain, plan axes, D, partition, halo)."""
        return memo.cached(
            "shard-table", self.domain,
            (self.storage, self.coarsen, self.num_shards, self.partition,
             self.halo.h_max if self.halo is not None else -1),
            self._shard_table_host)

    def _shard_table_host(self) -> np.ndarray:
        cols = [self._row_lo_col(), self._count]
        if self.partition == "rows":
            cols.append(self._row_lo)
        elif self.partition == "zigzag":
            cols.append(np.arange(self.num_shards))
        tbl = np.stack([np.asarray(c, np.int64) for c in cols], -1)
        if self.partition == "storage-rows":
            tbl = np.concatenate([tbl, self.halo.ghost_map], axis=1)
        tbl = tbl.astype(np.int32)
        tbl.setflags(write=False)
        return tbl

    def _row_lo_col(self):
        if self.partition == "storage-rows":
            return np.arange(self.num_shards) * self.rpd
        return self._lo

    def lut_sharded_host(self) -> Optional[np.ndarray]:
        """(D * steps_per_shard, C) i32 decode table under prefetch_lut:
        the parent LUT re-ordered into each device's enumeration order,
        chunked per device and padded (pad rows repeat the chunk head;
        validity comes from the count).  Memoized per (domain, plan
        axes, D, partition)."""
        if self.lowering != "prefetch_lut":
            return None
        return memo.cached(
            "shard-lut", self.domain,
            (self.storage, self.coarsen, self.num_shards, self.partition),
            lambda: GridPlan.lut_host(self)[self._shard_index()])

    def _slot_order(self) -> np.ndarray:
        """The scheduled blocks in storage-row-major slot order."""
        if self._tiling is not None:
            slots = self._tiling.tiles_host()
        else:
            slots = self.layout.slots_host()
        return np.argsort(
            slots[:, 1].astype(np.int64) * self.ncols + slots[:, 0],
            kind="stable")

    def _shard_index(self) -> np.ndarray:
        """(D * steps_per_shard,) i64: the canonical block index of each
        device's (padded) step -- the gather that builds the LUT chunks
        and the sharded mma table."""
        return memo.cached(
            "shard-mma-index", self.domain,
            (self.storage, self.coarsen, self.num_shards, self.partition),
            self._mma_shard_index)

    def mma_table_sharded_host(self) -> Optional[np.ndarray]:
        """(D * steps_per_shard, C) i32: the ``mma`` chains' decode table
        (:meth:`GridPlan.mma_table_host`) in the per-device enumeration
        order of :meth:`lut_sharded_host`; None under other lowerings."""
        if self.lowering != "mma":
            return None
        return GridPlan.mma_table_host(self)[self._shard_index()]

    def _mma_shard_index(self) -> np.ndarray:
        n = self.sched_domain.num_blocks
        order = np.arange(n, dtype=np.int64)
        if self.partition == "storage-rows":
            order = self._slot_order()
        per = self.steps_per_shard
        out = np.zeros((self.num_shards, per), np.int64)
        for d in range(self.num_shards):
            if self.partition == "zigzag":
                idx = self._zz_idx[d]
                c = len(idx)
                out[d] = idx[0] if c else 0
                out[d, :c] = idx
            else:
                lo, c = int(self._lo[d]), int(self._count[d])
                out[d] = order[lo] if c else order[0]
                out[d, :c] = order[lo:lo + c]
        out = out.reshape(self.num_shards * per)
        out.setflags(write=False)
        return out

    # -- interior/boundary phase views ---------------------------------------

    def phase_widths(self) -> Tuple[int, int]:
        """(max interior, max boundary) step counts over the devices."""
        h = self.halo
        if h is None or h.int_steps is None:
            return 0, 0
        return (max((len(s) for s in h.int_steps), default=0),
                max((len(s) for s in h.bnd_steps), default=0))

    def phase_tables_host(self):
        """(interior, boundary) ``(D, 1 + max)`` i32 phase tables --
        ``[count, step ids...]`` per device, zero-padded -- or ``None``
        when either phase is empty everywhere (nothing to overlap)."""
        mi, mb = self.phase_widths()
        if mi == 0 or mb == 0:
            return None

        def tbl(lists, m):
            out = np.zeros((self.num_shards, 1 + m), np.int32)
            for d, s in enumerate(lists):
                out[d, 0] = len(s)
                out[d, 1:1 + len(s)] = s
            out.setflags(write=False)
            return out
        return (tbl(self.halo.int_steps, mi),
                tbl(self.halo.bnd_steps, mb))

    def phase_view(self, which: str) -> "ShardedPlan":
        """A view of this plan whose grid covers only the interior or
        boundary steps of its rank.  Both launches visit each owned step
        exactly once between them with unchanged operands, so the pair
        is bit-identical to the single synchronous launch."""
        if which not in ("interior", "boundary"):
            raise ValueError(f"unknown phase {which!r}")
        if self.partition != "storage-rows" or self.halo is None \
                or self.halo.int_steps is None:
            raise ValueError("phase views need a storage-rows plan "
                             "built with halo=True")
        if self.lowering == "bounding":
            raise ValueError("phase views reorder the step grid; the "
                             "bounding lowering is not step-indexed")
        pv = copy.copy(self)
        pv.phase = which
        mi, mb = self.phase_widths()
        pv.steps_per_shard = mi if which == "interior" else mb
        return pv

    def _phase_steps(self) -> Optional[List[int]]:
        """The bound rank's step ids of a phase view, else None."""
        if self.phase is None:
            return None
        lists = self.halo.int_steps if self.phase == "interior" \
            else self.halo.bnd_steps
        return lists[self._need_rank()]

    # -- the rank's grid -----------------------------------------------------

    @property
    def grid(self):
        if self.lowering == "bounding":
            nbx, nby = self.sched_domain.bounding_box
            if self.partition in ("rows", "zigzag"):
                return self.batch_dims + (self.rbd, nbx)
            return self.batch_dims + (nby, nbx)
        if self.rank is None:
            return self.batch_dims + (self.steps_per_shard,)
        phase = self._phase_steps()
        count = len(phase) if phase is not None \
            else int(self._count[self.rank])
        return self.batch_dims + (count,)

    def _sched(self, start: int, stop: int, device) -> torch.Tensor:
        """Local steps [start, stop) -> the rank's scheduled step ids
        (the phase list on a phase view)."""
        t = torch.arange(start, stop, dtype=torch.int64, device=device)
        phase = self._phase_steps()
        if phase is None:
            return t
        return torch.as_tensor(phase, dtype=torch.int64, device=device)[t]

    def _chunk(self, table: np.ndarray) -> np.ndarray:
        """The bound rank's rows of a (D * steps_per_shard, C) table."""
        per, rank = table.shape[0] // self.num_shards, self._need_rank()
        return table[rank * per:(rank + 1) * per]

    def lut(self, device) -> torch.Tensor:
        """The bound rank's chunk of :meth:`lut_sharded_host` on
        ``device``, memoized per (domain, plan axes, D, rank, device)."""
        rank = self._need_rank()
        return memo.cached(
            "shard-lut-device", self.domain,
            (self.storage, self.coarsen, self.num_shards, self.partition,
             rank, str(torch.device(device))),
            lambda: torch.from_numpy(
                self._chunk(self.lut_sharded_host()).copy()).to(device))

    # -- per-rank decode (the plain versions' index math) --------------------

    def _zz_global_row(self, local, dev):
        """Local band row -> global query-block row of the snake."""
        two_d = 2 * self.num_shards
        return (local // 2) * two_d + torch.where(
            local % 2 == 0, torch.as_tensor(dev), two_d - 1 - dev)

    def _place_coords(self, bx, by):
        """Global block coords -> the rank's local band coords."""
        if self.partition == "rows":
            return bx, by - int(self._row_lo[self._need_rank()])
        if self.partition == "zigzag":
            two_d = 2 * self.num_shards
            return bx, 2 * (by // two_d) + (by % two_d >= self.num_shards)
        return bx, by

    def _storage_coords(self, col, row):
        """Storage grid position (col, row) -> scheduled embedded block
        coords: lambda on the orthotope coordinate (fractals), the
        linear-order block_coords of a row-major layout."""
        if self._tiling is not None:
            t = self._tiling
            wx, wy = (col, row) if t.j % 2 == 0 else (row, col)
            if self.lowering == "mma":
                bx, by = mma.decode_orthotope(t.spec, t.coarse.r_b, wx, wy)
                return bx.long(), by.long()
            return t.spec.lambda_map(wx, wy, t.coarse.r_b)
        spec = fractal_spec_of(self.domain)
        if spec is not None:
            if self.lowering == "mma":
                bx, by = mma.decode_orthotope(spec, self.domain.r_b, col,
                                              row)
                return bx.long(), by.long()
            return spec.lambda_map(col, row, self.domain.r_b)
        i = torch.clamp(row * self.ncols + col, 0,
                        self.sched_domain.num_blocks - 1)
        if self.lowering == "mma":
            bx, by = mma.decode_rows(self.sched_domain, i)
            return bx.long(), by.long()
        return self.sched_domain.block_coords(i)

    def _storage_row(self, bx, by):
        """Scheduled block coords -> its global storage row."""
        if self._tiling is not None:
            return self._tiling.tile_index(bx, by)[1]
        return self.layout.slot(bx, by)[1]

    def _storage_col(self, bx, by):
        if self._tiling is not None:
            return self._tiling.tile_index(bx, by)[0]
        return self.layout.slot(bx, by)[0]

    def owned(self, bx, by) -> torch.Tensor:
        """Does the bound rank own scheduled block (bx, by)?  Garbage for
        non-member coords (mask with membership first)."""
        rank = self._need_rank()
        if self.partition == "storage-rows":
            row = self._storage_row(bx, by)
            lo = rank * self.rpd
            return (row >= lo) & (row < lo + self.rpd)
        nby = self.sched_domain.bounding_box[1]
        if self.partition == "rows":
            lo = int(self._row_lo[rank])
            return (by >= lo) & (by < lo + self.rbd) & (by < nby)
        if self.partition == "zigzag":
            two_d = 2 * self.num_shards
            r = by % two_d
            return (torch.minimum(r, two_d - 1 - r) == rank) & (by < nby)
        li = self.sched_domain.linear_index(bx, by)
        lo = int(self._lo[rank])
        return (li >= lo) & (li < lo + int(self._count[rank]))

    def step_coords(self, start: int, stop: int, device):
        """The bound rank's local steps [start, stop) decoded the
        lowering's own way: ``(bx, by, valid)`` int64 tensors of
        scheduled block coords, ``valid`` None when every step is an
        owned member block (only the bounding grid discards)."""
        nb = self.sched_domain.bounding_box[0]
        if self.lowering == "bounding":
            t = torch.arange(start, stop, dtype=torch.int64, device=device)
            bx, by = t % nb, t // nb
            rank = self._need_rank()
            if self.partition == "rows":
                by = by + int(self._row_lo[rank])
            elif self.partition == "zigzag":
                by = self._zz_global_row(by, rank)
            member = self.sched_domain.contains(bx, by)
            return bx, by, member & self.owned(bx, by)
        t = self._sched(start, stop, device)
        rank = self._need_rank()
        if self.lowering == "prefetch_lut":
            rows = self.lut(device)[t].to(torch.int64)
            return rows[:, _LUT_BX], rows[:, _LUT_BY], None
        if self.partition == "zigzag":
            i = torch.from_numpy(self._zz_idx[rank]).to(device)[t]
        elif self.partition == "storage-rows":
            col = t % self.ncols
            row = torch.clamp(rank * self.rpd + t // self.ncols,
                              max=self.nrows - 1)
            bx, by = self._storage_coords(col, row)
            return bx, by, None
        else:
            i = int(self._lo[rank]) + t
        if self.lowering == "mma":
            bx, by = self._mma_decode(i)
            return bx.long(), by.long(), None
        bx, by = self.sched_domain.block_coords(i)
        return bx, by, None

    def storage_index(self, start: int, stop: int, device):
        """(row, col) supertile index of the rank's local state array
        for its steps [start, stop): the embedded (super)block, or --
        under compact storage -- the slot in the rank's slab."""
        if self.storage == "embedded":
            bx, by, _ = self.step_coords(start, stop, device)
            return by, bx
        if self.lowering == "bounding":
            bx, by, _ = self.step_coords(start, stop, device)
            row = torch.clamp(self._storage_row(bx, by), 0,
                              self.nrows_pad - 1)
            gmap = self._gmap(device)
            return (torch.clamp(gmap[row], 0, self.rpd - 1),
                    self._storage_col(bx, by))
        t = self._sched(start, stop, device)
        return t // self.ncols, t % self.ncols

    def _gmap(self, device) -> torch.Tensor:
        """The bound rank's ghost map on ``device`` (int64)."""
        return torch.from_numpy(
            self.halo.ghost_map[self._need_rank()].astype(np.int64)).to(
                device)

    def neighbor_index(self, j: int, start: int, stop: int, device):
        """(row, col) supertile index of the j-th halo tile of the rank's
        steps in its local (extended) array: the clamped embedded
        neighbour, or the neighbour's slot with its row through the
        ghost map."""
        if self.storage == "embedded":
            return super().neighbor_index(j, start, stop, device)
        dx, dy = NEIGHBOR_OFFSETS8[j]
        if self.lowering == "prefetch_lut":
            t = self._sched(start, stop, device)
            rows = self.lut(device)[t].to(torch.int64)
            nsx = rows[:, _LUT_NBR + 3 * j]
            nsy = rows[:, _LUT_NBR + 3 * j + 1]
        else:
            bx, by, _ = self.step_coords(start, stop, device)
            frac = self._frac if self.lowering == "mma" else None
            if frac is not None:
                nsx, nsy, _ok = mma.neighbor_slots(
                    frac[0], frac[1], self.sched_domain, bx, by, dx, dy,
                    swap=self._swap)
                nsx, nsy = nsx.long(), nsy.long()
            elif self._tiling is not None:
                nsx, nsy, _ok = self._tiling.neighbor_tile(bx, by, dx, dy)
            else:
                nsx, nsy, _ok = self.layout.neighbor_slot(bx, by, dx, dy)
        row = torch.clamp(nsy, 0, self.nrows_pad - 1)
        return self._gmap(device)[row], nsx

    def state_shape(self, block: int) -> Tuple[int, int]:
        """Cell shape of the rank's local state array: the replicated
        embedded array, the slab, or a halo plan's extended array."""
        if self.storage == "compact" and self.halo.int_steps is not None:
            return self.extended_shape(block)
        return self.local_storage_shape(block)

    # -- ownership masks for the embedded combine ----------------------------

    def owned_cell_mask(self, n: int, block: int, device) -> torch.Tensor:
        """(n, n) bool: cells of member fine blocks whose *scheduled*
        block the bound rank owns.  Ownership is disjoint and complete
        over member blocks, so masked sums combine exactly."""
        fb = torch.arange(n, device=device) // block
        fbx, fby = fb[None, :].expand(n, n), fb[:, None].expand(n, n)
        member = self.domain.contains(fbx, fby)
        return member & self.owned(fbx // self.coarsen,
                                   fby // self.coarsen)

    def member_cell_block_mask(self, n: int, block: int,
                               device) -> torch.Tensor:
        """(n, n) bool: cells belonging to member fine blocks."""
        fb = torch.arange(n, device=device) // block
        return self.domain.contains(fb[None, :].expand(n, n),
                                    fb[:, None].expand(n, n))

    # -- the sharded kernels' parameters -------------------------------------
    # (GridPlan.launch_params gives the rest: the local array's shape from
    # state_shape, the rank's steps from grid, its LUT chunk from lut)

    def shard_params(self, device):
        """(int64 ctypes array in SHARD_PARAMS order, ghost map, phase
        list) of the bound rank for the sharded kernels: the ghost map
        an int32 tensor on ``device`` under storage-rows (else None),
        the phase list the rank's step ids on a phase view (else
        None)."""
        rank = self._need_rank()
        if self.partition not in PART_CODES:
            raise ValueError(f"the fractal kernels shard 'linear' or "
                             f"'storage-rows', not {self.partition!r}")
        rows = self.partition == "storage-rows"
        lo_row = rank * self.rpd if rows else 0
        phase = self._phase_steps()
        vals = dict(part=PART_CODES[self.partition],
                    lo=lo_row * self.ncols if rows else int(self._lo[rank]),
                    count=int(self._count[rank]),
                    ncols=self.ncols if rows else 0,
                    nrows=self.nrows if rows else 0, lo_row=lo_row,
                    rpd=self.rpd if rows else 0,
                    nrows_pad=self.nrows_pad if rows else 0)
        arr = (ctypes.c_longlong * len(SHARD_PARAMS))(
            *[int(vals[k]) for k in SHARD_PARAMS])
        gmap = None
        if rows:
            gmap = memo.cached(
                "shard-gmap-device", self.domain,
                (self.storage, self.coarsen, self.num_shards,
                 self.halo.h_max, rank, str(torch.device(device))),
                lambda: torch.from_numpy(
                    self.halo.ghost_map[rank].copy()).to(device))
        ph = None
        if phase is not None:
            ph = memo.cached(
                "shard-phase-device", self.domain,
                (self.storage, self.coarsen, self.num_shards, self.phase,
                 rank, str(torch.device(device))),
                lambda: torch.tensor(phase if phase else [0],
                                     dtype=torch.int32, device=device))
        return arr, gmap, ph


def zigzag_row_order(nby: int, num_shards: int) -> np.ndarray:
    """(nby,) permutation: position ``d * (nby // D) + l`` holds the
    global query-block row that device ``d``'s band row ``l`` owns under
    the snake assignment.  A caller gathers Q block rows by this
    permutation before the sharded launch and scatters O back through
    its inverse (``np.argsort``) after."""
    D = num_shards
    if nby % (2 * D):
        raise ValueError(f"zigzag needs nby ({nby}) divisible by 2*D "
                         f"({2 * D})")
    perm = np.empty(nby, np.int64)
    rbd = nby // D
    for d in range(D):
        l = np.arange(rbd)  # noqa: E741
        perm[d * rbd:(d + 1) * rbd] = \
            (l // 2) * (2 * D) + np.where(l % 2 == 0, d, 2 * D - 1 - d)
    return perm


def device_tables(plan: ShardedPlan, device="cpu"):
    """(shard_table, lut_tuple) int32 tensors on ``device``: the (D, L)
    shard table plus, under the table-backed lowerings (prefetch_lut,
    mma), the per-device decode table -- one function shared by every
    sharded path, so the tables cannot drift between kernels."""
    tbl = torch.from_numpy(plan.shard_table_host().copy()).to(device)
    for host in (plan.lut_sharded_host(), plan.mma_table_sharded_host()):
        if host is not None:
            return tbl, (torch.from_numpy(host.copy()).to(device),)
    return tbl, ()
