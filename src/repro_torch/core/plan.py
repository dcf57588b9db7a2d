"""GridPlan: a block domain bound to a launch strategy (host side).

A ``GridPlan`` binds a :class:`~repro_torch.core.domain.BlockDomain`
(the paper's compact parallel space and its lambda map) to one of three
*lowerings*, and gives a kernel everything it needs to run over that
domain: the launch grid, the decode tables, the step order, and the
scalar launch parameters the CUDA kernels take.

``closed_form``
    The paper's per-block map: the grid has ``domain.num_blocks`` steps
    and each step decodes ``domain.block_coords(t)`` itself (the base-k
    digit loop, in registers on the card).

``prefetch_lut``
    The lookup-table realization (Navarro et al., "Efficient GPU Thread
    Mapping on Embedded 2D Fractals"): the host ``coords_host()`` table,
    copied once to the device, makes each decode an O(1) table read.
    Bit-identical to ``closed_form`` by construction.

``bounding``
    The paper's baseline: launch the full bounding-box grid and discard
    non-member blocks at run time via ``domain.contains``.

``mma``
    The same member-block grid as ``closed_form``, with every decode a
    digit-basis matrix product (:mod:`repro_torch.core.mma`): the lambda
    decode, the own compact slot and the neighbour slots of a fractal,
    or the row-comparison chain of a row-major domain.  On the card the
    products run on the tensor cores inside the kernels; the plain
    version evaluates the same chains as tensor contractions.  Exact
    below 2**24 (a plan beyond that bound raises ``ValueError``).

``"compact"`` is accepted as an alias of ``closed_form``.  The tuner's
``"auto"`` is not a lowering: the kernel entry points resolve it from
the tune cache (:mod:`repro_torch.core.tune`) before a plan is made, and
a plan given it raises ``ValueError``, as in the JAX package.

Domains: the fractals (gasket, any FractalSpec) and the row-major
domains of attention (triangular, band, bounding box) all have a
device-side decode, membership test and compact slot; a bounding box
closed over a membership callable has none.

Storage (``storage=``): ``"embedded"`` state is the dense bounding-box
array; ``"compact"`` state lives in the packed Lemma 2 orthotope of
:class:`~repro_torch.core.compact.CompactLayout`, and every state access
goes through the packed slot of its block (lambda^-1, or the 28-column
LUT under ``prefetch_lut``).

Superblock coarsening (``coarsen=s``): each grid step owns an s x s
embedded tile of fine blocks (s a power of the fractal's subdivision
factor), so the grid enumerates the *coarse* domain and the decode is
amortized over the tile's ``k**j`` member blocks.  Under compact storage
the members of one superblock are a contiguous sub-rectangle of fine
slots (a *supertile*), permuted by the static ``tile_map``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import backend as backend_lib
from . import fractal as F
from . import memo
from . import mma
from .compact import (NEIGHBOR_OFFSETS8, CompactLayout, compact_layout,
                      super_tiling)
from .domain import (BandDomain, BlockDomain, BoundingBoxDomain,
                     GeneralizedFractalDomain, SierpinskiDomain,
                     TriangularDomain)

LOWERINGS = ("closed_form", "prefetch_lut", "bounding", "mma")
_ALIASES = {"compact": "closed_form"}

STORAGES = ("embedded", "compact")

#: LUT column layout under ``storage="compact"``: the embedded (coarse)
#: block coords, the block's own packed slot / supertile index, then per
#: N/S/W/E/NW/NE/SW/SE neighbour (NEIGHBOR_OFFSETS8 order) the
#: (sx, sy, valid) triple -- 2 + 2 + 8*3 = 28 i32 columns.
_LUT_BX, _LUT_BY, _LUT_SX, _LUT_SY, _LUT_NBR = 0, 1, 2, 3, 4
_LUT_COLS = 28

#: kernel-side codes of the launch parameters (csrc/fractal_common.cuh)
FAMILY_GASKET, FAMILY_SPEC = 0, 1
FAMILY_TRIANGULAR, FAMILY_BAND, FAMILY_BOX = 2, 3, 4
#: the families whose cells are all live (no intra-block structure)
GENERIC_FAMILIES = (FAMILY_TRIANGULAR, FAMILY_BAND, FAMILY_BOX)
LOWERING_CODES = {"closed_form": 0, "prefetch_lut": 1, "bounding": 2,
                  "mma": 3}
STORAGE_CODES = {"embedded": 0, "compact": 1}
#: order of the integer launch parameters the kernels take as one int64
#: array (``Param`` in csrc/fractal_common.cuh)
C_PARAMS = ("family", "lowering", "r_b", "k", "m", "r_cell", "n", "block",
            "steps", "nbx", "allow", "oxs", "oys", "storage", "pitch",
            "th", "tw", "bw", "nfine", "coarsen", "swap", "r_fine",
            "lut_cols", "nby", "dom_w", "dom_off", "dom_tw", "nblocks",
            "scols", "mk", "mk2")


def normalize_lowering(name: str) -> str:
    """Map user-facing lowering names (incl. the alias) to canonical."""
    name = _ALIASES.get(name, name)
    if name not in LOWERINGS:
        raise ValueError(
            f"unknown lowering {name!r}; expected one of {LOWERINGS} "
            f"or aliases {tuple(_ALIASES)}")
    return name


def normalize_storage(name: str) -> str:
    if name not in STORAGES:
        raise ValueError(
            f"unknown storage {name!r}; expected one of {STORAGES}")
    return name


def xla_schedule(lowering: str) -> str:
    """The plain-tensor flash-attention schedule equivalent to a lowering.

    ``closed_form``/``prefetch_lut``/``mma`` only launch member blocks
    -- the mirror is the ``triangular`` (compact) schedule; ``bounding``
    mirrors the ``dense`` masked schedule."""
    return "dense" if normalize_lowering(lowering) == "bounding" else \
        "triangular"


@dataclasses.dataclass(frozen=True)
class LaunchParams:
    """The launch parameters of the fractal kernels (write, sum, CA).

    family:   FAMILY_GASKET (bit-test membership, base-3 lambda),
              FAMILY_SPEC (a FractalSpec: base-k digit decode over
              ``offsets``, base-m digit membership test), or one of the
              row-major GENERIC_FAMILIES (every cell of a member block
              is live): FAMILY_TRIANGULAR (integer-sqrt decode),
              FAMILY_BAND (triangular head then rows of width w, or the
              rectangular band), FAMILY_BOX (row-major nbx x nby).
    lowering: a LOWERING_CODES value.
    r_b, k, m: scale level of the *scheduled* (coarse) block grid, copies
              per level, subdivision factor.
    r_cell:   log_m(coarsen * block), the digit levels inside one
              superblock (FractalSpec membership; 0 for the gasket, whose
              bit test needs none).
    offsets:  the k (dx, dy) copy offsets.
    n, block: embedded side in cells, fine tile side in cells.
    steps:    grid steps (num_blocks of the scheduled domain, or
              nbx * nby under bounding).
    nbx:      scheduled blocks per side of the bounding box.
    storage:  a STORAGE_CODES value.
    rows, pitch: cell shape of the state array ((n, n) embedded, the
              packed orthotope's compact).
    th, tw:   cell shape of one storage supertile.
    bw, nfine: fine blocks per supertile row and per supertile in
              storage arrangement.
    coarsen:  fine blocks per superblock side (1: no coarsening).
    swap:     1 when the coarse orthotope coordinate lands transposed
              (compact storage, coarsening by an odd number of levels).
    r_fine:   scale level of the fine block grid.
    lut:      under prefetch_lut the int32 device decode table,
              (steps, 2) embedded or (steps, 28) compact; else None.
    tile_perm: under compact coarsening a flat int32 device table: the
              embedded fine-block offset (ey, ex) of each of the
              ``nfine`` packed fine blocks, then for each of the
              coarsen**2 embedded fine blocks its packed index (or -1
              for a non-member); else None (identity arrangement).
    nby:      scheduled blocks per column of the bounding box.
    dom_w, dom_off, dom_tw: the band's window w, key-row offset
              off = m_k - m_q and triangular head T(w) (0 otherwise).
    nblocks:  member blocks of the scheduled domain.
    scols:    slot columns of a generic compact layout (the near-square
              row-major grid; 0 for the fractals).
    mk, mk2:  under mma the k-steps (of 16) of the primary chain (the
              digit one-hots, or the block rows of a row-major domain)
              and of the neighbour chain; 0 otherwise.
    mma_ops:  under mma a flat int32 device tensor of the chains'
              tensor-core operands (``mma_operand_tensor``); else None.
    """

    family: int
    lowering: int
    r_b: int
    k: int
    m: int
    r_cell: int
    offsets: Tuple[Tuple[int, int], ...]
    n: int
    block: int
    steps: int
    nbx: int
    storage: int
    rows: int
    pitch: int
    th: int
    tw: int
    bw: int
    nfine: int
    coarsen: int
    swap: int
    r_fine: int
    lut: Optional[torch.Tensor]
    tile_perm: Optional[torch.Tensor]
    nby: int = 0
    dom_w: int = 0
    dom_off: int = 0
    dom_tw: int = 0
    nblocks: int = 0
    scols: int = 0
    mk: int = 0
    mk2: int = 0
    mma_ops: Optional[torch.Tensor] = None

    @property
    def span(self) -> int:
        """Embedded side of one superblock in cells."""
        return self.coarsen * self.block

    @property
    def lut_cols(self) -> int:
        return 0 if self.lut is None else int(self.lut.shape[1])

    @property
    def allow(self) -> int:
        """Bit (dy * m + dx) set for each copy offset."""
        return sum(1 << (oy * self.m + ox) for ox, oy in self.offsets)

    @property
    def oxs(self) -> int:
        return sum(ox << (4 * c) for c, (ox, _) in enumerate(self.offsets))

    @property
    def oys(self) -> int:
        return sum(oy << (4 * c) for c, (_, oy) in enumerate(self.offsets))

    def c_params(self) -> list:
        """The integer parameters in ``C_PARAMS`` order."""
        return [int(getattr(self, name)) for name in C_PARAMS]


class GridPlan:
    """Execution plan for one kernel launch over a block domain.

    Parameters
    ----------
    domain:      the block domain to enumerate.
    lowering:    "closed_form" | "prefetch_lut" | "bounding" | "mma" (or
                 the alias "compact").
    batch_dims:  leading grid dimensions iterated outside the domain
                 (e.g. ``(batch * heads,)`` for attention).
    storage:     "embedded" (state arrays are the dense bounding-box
                 layout) or "compact" (state arrays live in the packed
                 O(n^H) orthotope layout of
                 :class:`~repro_torch.core.compact.CompactLayout`).
    coarsen:     s >= 1 embedded fine blocks per superblock side; s > 1
                 requires a fractal domain with s a power of its
                 subdivision factor.  The grid then enumerates the
                 coarse domain.
    backend:     a :class:`~repro_torch.core.backend.BackendTarget`, a
                 device or a tensor (see ``backend.resolve``).
    """

    def __init__(self, domain: BlockDomain, lowering: str = "closed_form",
                 batch_dims: Sequence[int] = (), storage: str = "embedded",
                 coarsen: int = 1, backend=None):
        self.domain = domain
        self.lowering = normalize_lowering(lowering)
        self.batch_dims = tuple(int(d) for d in batch_dims)
        self.storage = normalize_storage(storage)
        self.target = backend_lib.resolve(backend)
        self.coarsen = int(coarsen)
        if self.coarsen < 1:
            raise ValueError(f"coarsen must be >= 1, got {coarsen}")
        if self.coarsen == 1:
            self._tiling = None
            #: the domain the *grid* enumerates (coarse under coarsening)
            self.sched_domain: BlockDomain = domain
        else:
            self._tiling = super_tiling(domain, self.coarsen)
            self.sched_domain = self._tiling.coarse
        self._layout = None
        if self.lowering == "mma":
            mma.check_domain(self.sched_domain)

    @property
    def _frac(self):
        """``(spec, r_b)`` of the scheduled domain when it is a fractal
        (the digit-basis chains apply), else None (row chains)."""
        return mma.fractal_of(self.sched_domain)

    @property
    def _swap(self) -> bool:
        """The odd-level transpose of the coarse orthotope coordinate."""
        return self._tiling is not None and self._tiling.j % 2 == 1

    @property
    def layout(self) -> CompactLayout:
        """The domain's :class:`CompactLayout` (memoized per domain;
        available under either storage so callers can pack/unpack)."""
        if self._layout is None:
            self._layout = compact_layout(self.domain)
        return self._layout

    # -- grid ---------------------------------------------------------------

    @property
    def domain_dims(self) -> int:
        """How many trailing grid dimensions the domain occupies."""
        return 2 if self.lowering == "bounding" else 1

    @property
    def grid(self) -> Tuple[int, ...]:
        if self.lowering == "bounding":
            nbx, nby = self.sched_domain.bounding_box
            return self.batch_dims + (nby, nbx)
        return self.batch_dims + (self.sched_domain.num_blocks,)

    @property
    def num_steps(self) -> int:
        return int(np.prod(self.grid))

    # -- decode table -------------------------------------------------------

    def lut_host(self) -> np.ndarray:
        """Host-built i32 decode table, one row per scheduled (member /
        coarse) block, memoized per (domain, storage, coarsen).

        embedded storage: (num_blocks, 2) of (bx, by).
        compact storage:  (num_blocks, 28): (bx, by, sx, sy) plus the
        eight (sx, sy, valid) neighbour-slot triples (NEIGHBOR_OFFSETS8
        order).  Under ``coarsen`` the rows are coarse blocks and the
        slot columns are supertile indices."""
        return memo.cached("gridplan-lut", self.domain,
                           (self.storage, self.coarsen), self._lut_host)

    def _lut_host(self) -> np.ndarray:
        coords = np.asarray(self.sched_domain.coords_host(), np.int32)
        if self.storage == "embedded":
            return coords
        if self._tiling is not None:
            slots = self._tiling.tiles_host()
            nbrs = self._tiling.neighbor_tiles_host()
        else:
            slots = self.layout.slots_host()
            nbrs = self.layout.neighbor_slots_host()
        nbrs = nbrs.reshape(len(coords), 24)
        table = np.concatenate([coords, slots, nbrs],
                               axis=1).astype(np.int32)
        assert table.shape[1] == _LUT_COLS
        table.setflags(write=False)
        return table

    def lut(self, device) -> torch.Tensor:
        """The decode table as an int32 tensor on ``device``, copied
        once per device and memoized beside the host table."""
        device = torch.device(device)
        return memo.cached(
            "gridplan-lut-device", self.domain,
            (self.storage, self.coarsen, str(device)),
            lambda: torch.from_numpy(self.lut_host().copy()).to(device))

    def mma_table_host(self) -> np.ndarray:
        """Decode table of the ``mma`` lowering: the same row and column
        layout as :meth:`lut_host`, but every lambda / lambda^-1 entry
        is a :mod:`repro_torch.core.mma` chain instead of a host integer
        loop.  The kernels run the chains themselves; this host copy is
        what the tests (and a verifier) compare with :meth:`lut_host`.
        Memoized per (domain, storage, coarsen)."""
        return memo.cached("gridplan-mma-table", self.domain,
                           (self.storage, self.coarsen), self._mma_table)

    def mma_table(self, device) -> torch.Tensor:
        """:meth:`mma_table_host` as an int32 tensor on ``device``."""
        return torch.from_numpy(self.mma_table_host().copy()).to(device)

    def _mma_decode(self, t: torch.Tensor):
        """Linear steps -> scheduled (bx, by) int32 via the digit-basis
        chain (fractal domains) or the row-comparison chain (row-major
        domains)."""
        frac = self._frac
        if frac is not None:
            return mma.decode_linear(frac[0], frac[1], t)
        return mma.decode_rows(self.sched_domain, t)

    def _mma_table(self) -> np.ndarray:
        dom = self.sched_domain
        t = torch.arange(dom.num_blocks, dtype=torch.int64)
        frac = self._frac
        bx, by = self._mma_decode(t)
        cols = [bx, by]
        if self.storage == "compact":
            if frac is not None:
                sx, sy = mma.slots_of_linear(frac[0], frac[1], t,
                                             swap=self._swap)
            else:
                # generic near-square layouts have no lambda to
                # accelerate: slots stay the integer row-major slot
                sx, sy = self.layout.slot(bx.long(), by.long())
            cols += [sx, sy]
            for dx, dy in NEIGHBOR_OFFSETS8:
                if frac is not None:
                    nsx, nsy, ok = mma.neighbor_slots(
                        frac[0], frac[1], dom, bx, by, dx, dy,
                        swap=self._swap)
                else:
                    nsx, nsy, ok = self.layout.neighbor_slot(
                        bx.long(), by.long(), dx, dy)
                cols += [nsx, nsy, ok]
        table = torch.stack([c.to(torch.int32) for c in cols], -1).numpy()
        assert table.shape[1] in (2, _LUT_COLS)
        table.setflags(write=False)
        return table

    # -- grid-step helpers --------------------------------------------------

    @property
    def steps_per_launch(self) -> int:
        """Grid steps per batch element (the domain grid volume): the
        length of the sum kernel's partials, one slot per step, before
        the in-order combine."""
        nb = len(self.batch_dims)
        out = 1
        for d in self.grid[nb:]:
            out *= int(d)
        return out

    def linear_step(self, grid_ids):
        """Flatten the (possibly 2-D, under ``bounding``) domain grid
        indices of one step to a linear step id in
        [0, steps_per_launch): row-major ``by * nbx + bx`` under
        bounding.  This is the order the sum adds its tiles in."""
        nb = len(self.batch_dims)
        if self.lowering == "bounding":
            nbx = int(self.grid[nb + 1])
            return grid_ids[nb] * nbx + grid_ids[nb + 1]
        return grid_ids[nb]

    def grid_ids_at(self, lin, batch=()):
        """Inverse of :meth:`linear_step`: the full grid-index tuple of
        linear domain step ``lin`` under the given batch ids."""
        batch = tuple(batch)
        if len(batch) != len(self.batch_dims):
            raise ValueError(
                f"expected {len(self.batch_dims)} batch ids, "
                f"got {len(batch)}")
        if self.lowering == "bounding":
            nbx = int(self.grid[len(batch) + 1])
            return batch + (lin // nbx, lin % nbx)
        return batch + (lin,)

    def step_coords(self, start: int, stop: int, device):
        """Decode linear steps [start, stop) the lowering's own way, as
        tensor index math on ``device``: ``(bx, by, valid)`` int64
        tensors of *scheduled* (coarse) block coords, ``valid`` None
        when every step is a member block.

        closed_form runs the digit loop on ``arange``, prefetch_lut
        reads the device table, mma runs the decode chain, bounding
        splits the row-major step id and tests ``domain.contains``."""
        if self.lowering == "prefetch_lut":
            rows = self.lut(device)[start:stop].to(torch.int64)
            return rows[:, _LUT_BX], rows[:, _LUT_BY], None
        t = torch.arange(start, stop, dtype=torch.int64, device=device)
        if self.lowering == "closed_form":
            bx, by = self.sched_domain.block_coords(t)
            return bx, by, None
        if self.lowering == "mma":
            bx, by = self._mma_decode(t)
            return bx.long(), by.long(), None
        nbx, _ = self.sched_domain.bounding_box
        bx, by = t % nbx, t // nbx
        valid = None
        if not getattr(self.sched_domain, "always_member", False):
            valid = self.sched_domain.contains(bx, by)
        return bx, by, valid

    # -- storage addressing (embedded vs compact) ---------------------------

    def supertile_shape(self, block_shape) -> Tuple[int, int]:
        """Cell shape of one storage supertile for fine ``block_shape``
        tiles: (s*b0, s*b1) embedded, (bh*b0, bw*b1) packed."""
        b0, b1 = block_shape
        if self.storage == "embedded" or self._tiling is None:
            return (self.coarsen * b0, self.coarsen * b1)
        bw, bh = self._tiling.sub_shape
        return (bh * b0, bw * b1)

    def tile_map(self):
        """Static packed->embedded fine-block permutation of one storage
        supertile as ``((oy, ox), (ey, ex))`` pairs, or ``None`` when
        the supertile is already embedded-arranged (embedded storage, or
        coarsen=1 where the tile is a single block)."""
        if self.storage == "embedded" or self._tiling is None:
            return None
        return self._tiling.tile_map()

    def cell_offset_grids(self, block: int):
        """(OY, OX) host i32 arrays shaped like the storage supertile:
        the embedded cell offset of every supertile cell relative to the
        superblock's embedded origin ``(by*s*block, bx*s*block)``.  For
        the trivial layouts this is a plain meshgrid; under compact
        coarsening it bakes the fine-block permutation in, so masks are
        evaluated directly on the packed arrangement."""
        tm = self.tile_map()
        h, w = self.supertile_shape((block, block))
        if tm is None:
            oy, ox = np.mgrid[0:h, 0:w]
            return oy.astype(np.int32), ox.astype(np.int32)
        oy = np.zeros((h, w), np.int32)
        ox = np.zeros((h, w), np.int32)
        cy, cx = np.mgrid[0:block, 0:block]
        for (py, px), (ey, ex) in tm:
            oy[py * block:(py + 1) * block,
               px * block:(px + 1) * block] = ey * block + cy
            ox[py * block:(py + 1) * block,
               px * block:(px + 1) * block] = ex * block + cx
        return oy, ox

    def storage_index(self, start: int, stop: int, device):
        """(row, col) supertile index of the state array for the steps
        [start, stop), as int64 tensors: embedded -> the (super)block's
        (by, bx) in the bounding-box array; compact -> the packed slot
        (sy, sx) of the layout (the supertile index under coarsening).
        Under ``prefetch_lut`` the slot is read from the 28-column LUT;
        under ``mma`` a fractal's slot is the slots chain of the step id
        (the compact enumeration is lambda-linear); the other cases
        evaluate lambda^-1 on the decoded coords."""
        if self.storage == "compact" and self.lowering == "prefetch_lut":
            rows = self.lut(device)[start:stop].to(torch.int64)
            return rows[:, _LUT_SY], rows[:, _LUT_SX]
        if (self.storage == "compact" and self.lowering == "mma"
                and self._frac is not None):
            t = torch.arange(start, stop, dtype=torch.int64, device=device)
            sx, sy = mma.slots_of_linear(*self._frac, t, swap=self._swap)
            return sy.long(), sx.long()
        bx, by, _ = self.step_coords(start, stop, device)
        if self.storage == "embedded":
            return by, bx
        if self._tiling is not None:
            tx, ty = self._tiling.tile_index(bx, by)
            return ty, tx
        sx, sy = self.layout.slot(bx, by)
        return sy, sx

    def neighbor_index(self, j: int, start: int, stop: int, device):
        """(row, col) supertile index of the j-th halo tile
        (``NEIGHBOR_OFFSETS8`` order) for the steps [start, stop): the
        embedded neighbour (super)block clamped into range, or -- under
        compact storage -- its lambda^-1-resolved packed slot (slot
        (0, 0) for out-of-range / non-member neighbours; the kernels
        mask those contributions)."""
        dx, dy = NEIGHBOR_OFFSETS8[j]
        if self.storage == "compact" and self.lowering == "prefetch_lut":
            rows = self.lut(device)[start:stop].to(torch.int64)
            return (rows[:, _LUT_NBR + 3 * j + 1],
                    rows[:, _LUT_NBR + 3 * j])
        bx, by, _ = self.step_coords(start, stop, device)
        if self.storage == "embedded":
            nbx, nby = self.sched_domain.bounding_box
            return (torch.clamp(by + dy, 0, nby - 1),
                    torch.clamp(bx + dx, 0, nbx - 1))
        if self.lowering == "mma" and self._frac is not None:
            sx, sy, _ok = mma.neighbor_slots(
                *self._frac, self.sched_domain, bx, by, dx, dy,
                swap=self._swap)
            return sy.long(), sx.long()
        if self._tiling is not None:
            tx, ty, _ok = self._tiling.neighbor_tile(bx, by, dx, dy)
            return ty, tx
        sx, sy, _ok = self.layout.neighbor_slot(bx, by, dx, dy)
        return sy, sx

    def state_shape(self, block: int) -> Tuple[int, int]:
        """Cell shape of the state array under this plan's storage."""
        if self.storage == "compact":
            return self.layout.array_shape(block)
        return self.layout.embedded_shape(block)

    # -- kernel launch parameters -------------------------------------------

    def tile_perm(self, device) -> Optional[torch.Tensor]:
        """The supertile permutation table of :class:`LaunchParams` on
        ``device`` (None for the identity arrangement), memoized per
        (domain, storage, coarsen, device)."""
        tm = self.tile_map()
        if tm is None:
            return None

        def build():
            s = self.coarsen
            inv = np.full(s * s, -1, np.int32)
            fwd = np.zeros((len(tm), 2), np.int32)
            bw = self._tiling.sub_shape[0]
            for (py, px), (ey, ex) in tm:
                fwd[py * bw + px] = (ey, ex)
                inv[ey * s + ex] = py * bw + px
            flat = np.concatenate([fwd.ravel(), inv])
            return torch.from_numpy(flat).to(torch.device(device))
        return memo.cached("gridplan-tile-perm", self.domain,
                           (self.storage, self.coarsen, str(device)), build)

    def mma_operand_tensor(self, device) -> torch.Tensor:
        """The tensor-core operands of the ``mma`` lowering as one flat
        int32 tensor on ``device``, memoized per (domain, coarsen,
        device).  A fractal's holds the B fragments of the coords, slots
        and neighbour bases (:func:`mma.fractal_operands`), one after
        the other; a row-major domain's the padded row starts and the
        (ones, diff) fragments (:func:`mma.rows_operands`)."""
        def build():
            frac = self._frac
            parts = mma.fractal_operands(*frac) if frac is not None \
                else mma.rows_operands(self.sched_domain)
            flat = np.concatenate([a.ravel() for a in parts])
            return torch.from_numpy(flat).to(torch.device(device))
        return memo.cached("gridplan-mma-operands", self.domain,
                           (self.coarsen, str(device)), build)

    def _family(self, n: int):
        """(family, spec or None, r_cell, extra params) of the scheduled
        domain's device-side decode."""
        dom = self.sched_domain
        if isinstance(dom, SierpinskiDomain):
            return FAMILY_GASKET, F.SIERPINSKI, 0, {}
        if isinstance(dom, GeneralizedFractalDomain):
            # the digit test needs n = m**r (raises like spec.is_member)
            return (FAMILY_SPEC, dom.spec,
                    dom.spec.scale_level(n) - dom.r_b, {})
        scols = self.layout.grid_shape[0]
        if isinstance(dom, TriangularDomain):
            return FAMILY_TRIANGULAR, None, 0, dict(scols=scols)
        if isinstance(dom, BandDomain):
            return FAMILY_BAND, None, 0, dict(
                scols=scols, dom_w=dom.w, dom_off=dom.off, dom_tw=dom._tw)
        if isinstance(dom, BoundingBoxDomain) and dom._member is None:
            return FAMILY_BOX, None, 0, dict(scols=scols)
        raise ValueError(
            f"no device-side decode for the {dom.name!r} domain: a "
            f"bounding box closed over a membership callable has no "
            f"kernel form")

    def launch_params(self, n: int, block: int, device) -> LaunchParams:
        """The CUDA kernels' launch parameters for a state of embedded
        side ``n`` tiled by ``block`` under this plan's storage."""
        dom = self.sched_domain
        family, spec, r_cell, extra = self._family(n)
        nbx, nby = dom.bounding_box
        lut = self.lut(device) if self.lowering == "prefetch_lut" else None
        th, tw = self.supertile_shape((block, block))
        if self._tiling is not None and self.storage == "compact":
            bw, bh = self._tiling.sub_shape
            swap = int(self._tiling.swap)
        else:
            bw = bh = self.coarsen
            swap = 0
        mk = mk2 = 0
        ops = None
        if self.lowering == "mma":
            ops = self.mma_operand_tensor(device)
            if spec is not None:
                mk = mma.ksteps(dom.r_b * spec.k)
                mk2 = mma.ksteps(dom.r_b * spec.m * spec.m)
            else:
                mk = mma.ksteps(nby)
        return LaunchParams(
            family=family, lowering=LOWERING_CODES[self.lowering],
            r_b=dom.r_b if spec is not None else 0,
            k=spec.k if spec is not None else 0,
            m=spec.m if spec is not None else 0, r_cell=r_cell,
            offsets=spec.offsets if spec is not None else (),
            n=int(n), block=int(block), steps=self.steps_per_launch,
            nbx=int(nbx), storage=STORAGE_CODES[self.storage],
            rows=self.state_shape(block)[0],
            pitch=self.state_shape(block)[1], th=th, tw=tw, bw=bw,
            nfine=bw * bh, coarsen=self.coarsen, swap=swap,
            r_fine=self.domain.r_b if spec is not None else 0, lut=lut,
            tile_perm=self.tile_perm(device), nby=int(nby),
            nblocks=dom.num_blocks, mk=mk, mk2=mk2, mma_ops=ops, **extra)

    # -- host-side geometry helpers ----------------------------------------

    def row_extents(self) -> np.ndarray:
        """(nby, 2) i32 host array of [min_bx, max_bx] per block row.

        Rows with no member blocks get [0, -1].  This is the per-row
        k-extent the attention schedules consume (the block-space
        work-saving of Theorem 2 applied row-wise)."""
        nbx, nby = self.domain.bounding_box
        lo = np.full((nby,), nbx, np.int64)
        hi = np.full((nby,), -1, np.int64)
        coords = self.domain.coords_host()
        np.minimum.at(lo, coords[:, 1], coords[:, 0])
        np.maximum.at(hi, coords[:, 1], coords[:, 0])
        lo[hi < 0] = 0
        return np.stack([lo, hi], -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Domain registry: every compact domain the engine knows how to lower.
# ---------------------------------------------------------------------------

def registered_domains(size: str = "small") -> dict:
    """Representative instances of every registered domain family.

    size: "small" or "medium"."""
    if size == "small":
        return {
            "sierpinski": SierpinskiDomain(8),
            "carpet": GeneralizedFractalDomain(F.CARPET, 9),
            "vicsek": GeneralizedFractalDomain(F.VICSEK, 9),
            "triangular": TriangularDomain(6),
            "band": BandDomain(8, 3),
            "bounding-box": BoundingBoxDomain(4, 3),
        }
    return {
        "sierpinski": SierpinskiDomain(32),
        "carpet": GeneralizedFractalDomain(F.CARPET, 27),
        "vicsek": GeneralizedFractalDomain(F.VICSEK, 27),
        "triangular": TriangularDomain(17),
        "band": BandDomain(24, 5),
        "bounding-box": BoundingBoxDomain(7, 5),
    }
