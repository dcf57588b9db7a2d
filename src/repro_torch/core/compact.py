"""Compact n^H storage: fractal (and general block-domain) state resident
in the packed orthotope layout of Lemma 2.

A :class:`CompactLayout` moves the state itself into the compact layout,
so memory is O(n^H) like the launch:

* fractal domains pack block-for-block into the Lemma 2 orthotope
  (``k**ceil(r/2) x k**floor(r/2)`` blocks, k = 3 for the gasket) using
  the alternating base-k digit addressing of ``lambda``/``lambda^-1``;
* every other block domain packs block-linearly (slot ``i`` of the
  domain's canonical enumeration at row-major position ``i`` of a
  near-square grid).

The layout answers three questions:

* ``slot(bx, by)``         -- which packed block holds embedded block
                              (bx, by) (integer math on ints, numpy
                              arrays and int64 tensors);
* ``pack`` / ``unpack``    -- bridges between the embedded and packed
                              tensors;
* ``neighbor_slots_host`` -- per compact block, the compact slots of its
                              8 *embedded* neighbours (the
                              lambda^-1-resolved halo addressing a CA
                              stencil needs), built on the host and
                              shipped through GridPlan's ``prefetch_lut``
                              table.

``key_block_support`` and ``pack_kv`` give the compact KV of the
attention kernels: the 1-D analogue of the packing, a K/V tensor trimmed
to the key blocks its domain touches.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import fractal as F
from . import memo
from .domain import (BlockDomain, GeneralizedFractalDomain,
                     SierpinskiDomain)

#: halo order shared by the layout tables, the GridPlan neighbour
#: indices and the CA kernel: north, south, west, east (dx, dy).
NEIGHBOR_OFFSETS = ((0, -1), (0, 1), (-1, 0), (1, 0))

#: full 8-neighbour halo (the first four rows are NEIGHBOR_OFFSETS, so
#: 4-neighbour consumers index the same table): N S W E, then the
#: corners NW NE SW SE.  Temporal CA fusion needs the corners: after T
#: fused steps a block's footprint is every cell within L1 distance T,
#: which reaches into the diagonal blocks for T >= 2.
NEIGHBOR_OFFSETS8 = NEIGHBOR_OFFSETS + ((-1, -1), (1, -1), (-1, 1), (1, 1))


def _clip(x, lo, hi):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return np.clip(x, lo, hi)


def fractal_spec_of(domain: BlockDomain):
    """The FractalSpec of a fractal domain, or None for other domains."""
    if isinstance(domain, SierpinskiDomain):
        return F.SIERPINSKI
    if isinstance(domain, GeneralizedFractalDomain):
        return domain.spec
    return None


class CompactLayout:
    """Packed storage layout for a :class:`BlockDomain`'s member blocks.

    The packed array holds ``num_slots >= num_blocks`` blocks arranged as
    a 2-D grid of ``grid_shape = (scols, srows)`` blocks; member block
    ``i`` of the domain's canonical enumeration lives at ``slot_linear(i)``.
    For fractal domains this is exactly the Lemma 2 orthotope
    (``num_slots == num_blocks``); generic domains get a near-square
    row-major grid with at most ``scols - 1`` unused pad slots.
    """

    def __init__(self, domain: BlockDomain):
        self.domain = domain
        spec = fractal_spec_of(domain)
        if spec is not None:
            self._k, self._r = spec.k, domain.r_b
            self.grid_shape = spec.orthotope_shape(domain.r_b)
        else:
            self._k = self._r = None
            n = domain.num_blocks
            scols = max(1, math.isqrt(n))
            if scols * scols < n:
                scols += 1
            srows = -(-n // scols)
            self.grid_shape = (scols, srows)
        self._slots_host = None
        self._neighbors_host = None

    @property
    def num_slots(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]

    # -- addressing (host ints, numpy arrays and int64 tensors) -------------

    def slot_linear(self, i):
        """Linear enumeration index -> (sx, sy) packed block coords."""
        if self._k is not None:
            return F.deinterleave_linear(i, self._k, self._r)
        scols = self.grid_shape[0]
        return i % scols, i // scols

    def slot(self, bx, by):
        """Embedded block coords -> (sx, sy) packed block coords.

        Non-member coords decode to *some* in-range slot (the kernels
        discard those steps); members decode to their true slot.
        """
        if isinstance(self.domain, SierpinskiDomain):
            return F.lambda_inverse(bx, by, self._r)
        spec = fractal_spec_of(self.domain)
        if spec is not None:
            return spec.lambda_inverse(bx, by, self._r)
        i = _clip(self.domain.linear_index(bx, by), 0,
                  self.domain.num_blocks - 1)
        return self.slot_linear(i)

    def neighbor_slot(self, bx, by, dx, dy):
        """(sx, sy, valid) of embedded neighbour (bx+dx, by+dy); invalid
        (out of range / non-member) neighbours point at slot (0, 0)
        with valid false."""
        nbx, nby = self.domain.bounding_box
        x, y = bx + dx, by + dy
        xc = _clip(x, 0, nbx - 1)
        yc = _clip(y, 0, nby - 1)
        ok = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) \
            & self.domain.contains(xc, yc)
        sx, sy = self.slot(xc, yc)
        where = F._where(bx, by)
        return where(ok, sx, 0), where(ok, sy, 0), ok

    # -- host tables ---------------------------------------------------------

    def slots_host(self) -> np.ndarray:
        """(num_blocks, 2) int32 (sx, sy) per canonical enumeration index."""
        if self._slots_host is None:
            i = np.arange(self.domain.num_blocks, dtype=np.int64)
            sx, sy = self.slot_linear(i)
            t = np.stack([np.asarray(sx), np.asarray(sy)], -1)
            t = t.astype(np.int32)
            t.setflags(write=False)
            self._slots_host = t
        return self._slots_host

    def neighbor_slots_host(self) -> np.ndarray:
        """(num_blocks, 8, 3) int32: per compact block and
        N/S/W/E/NW/NE/SW/SE neighbour (``NEIGHBOR_OFFSETS8`` order, so
        rows [:4] are the von-Neumann halo) the (sx, sy, valid) triple;
        invalid neighbours point at slot (0, 0) with valid = 0."""
        if self._neighbors_host is None:
            coords = self.domain.coords_host().astype(np.int64)
            out = np.zeros((len(coords), 8, 3), np.int32)
            for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
                sx, sy, ok = self.neighbor_slot(coords[:, 0], coords[:, 1],
                                                dx, dy)
                out[:, j, 0] = np.asarray(sx)
                out[:, j, 1] = np.asarray(sy)
                out[:, j, 2] = np.asarray(ok)
            out.setflags(write=False)
            self._neighbors_host = out
        return self._neighbors_host

    # -- shapes / accounting -------------------------------------------------

    def array_shape(self, block: int, trailing: Tuple[int, ...] = ()):
        """Cell shape of the packed array for block x block tiles."""
        scols, srows = self.grid_shape
        return (srows * block, scols * block) + tuple(trailing)

    def embedded_shape(self, block: int, trailing: Tuple[int, ...] = ()):
        nbx, nby = self.domain.bounding_box
        return (nby * block, nbx * block) + tuple(trailing)

    def num_cells(self, block: int) -> int:
        return self.num_slots * block * block

    def embedded_cells(self, block: int) -> int:
        nbx, nby = self.domain.bounding_box
        return nbx * nby * block * block

    # -- pack / unpack bridges ----------------------------------------------

    def _index(self, device):
        """Member block coords and their slots as int64 tensors."""
        coords = torch.from_numpy(self.domain.coords_host().astype(np.int64))
        slots = torch.from_numpy(self.slots_host().astype(np.int64))
        return coords.to(device), slots.to(device)

    def pack(self, arr: torch.Tensor, block: int, fill=0) -> torch.Tensor:
        """Gather an embedded (nby*block, nbx*block, ...) tensor into the
        packed (srows*block, scols*block, ...) layout."""
        nbx, nby = self.domain.bounding_box
        scols, srows = self.grid_shape
        trailing = tuple(arr.shape[2:])
        if tuple(arr.shape[:2]) != (nby * block, nbx * block):
            raise ValueError(
                f"embedded array shape {tuple(arr.shape[:2])} does not "
                f"match the domain's {nby}x{nbx} grid of {block}x{block} "
                f"blocks")
        blocks = arr.reshape((nby, block, nbx, block) + trailing) \
            .movedim(1, 2)
        coords, slots = self._index(arr.device)
        out = torch.full((srows, scols, block, block) + trailing, fill,
                         dtype=arr.dtype, device=arr.device)
        out[slots[:, 1], slots[:, 0]] = blocks[coords[:, 1], coords[:, 0]]
        return out.movedim(2, 1).reshape(
            (srows * block, scols * block) + trailing)

    def unpack(self, packed: torch.Tensor, block: int,
               fill=0) -> torch.Tensor:
        """Scatter the packed layout back into the embedded tensor; cells
        outside the domain's member blocks get ``fill``."""
        nbx, nby = self.domain.bounding_box
        scols, srows = self.grid_shape
        trailing = tuple(packed.shape[2:])
        if tuple(packed.shape[:2]) != (srows * block, scols * block):
            raise ValueError(
                f"packed array shape {tuple(packed.shape[:2])} does not "
                f"match the layout's {srows}x{scols} grid of "
                f"{block}x{block} blocks")
        blocks = packed.reshape((srows, block, scols, block) + trailing) \
            .movedim(1, 2)
        coords, slots = self._index(packed.device)
        out = torch.full((nby, nbx, block, block) + trailing, fill,
                         dtype=packed.dtype, device=packed.device)
        out[coords[:, 1], coords[:, 0]] = blocks[slots[:, 1], slots[:, 0]]
        return out.movedim(2, 1).reshape(
            (nby * block, nbx * block) + trailing)


# ---------------------------------------------------------------------------
# Superblock coarsening geometry: each coarse grid step owns an s x s
# embedded tile of fine blocks (s = m**j), amortizing the lambda decode
# by the tile's member count (k**j for a fractal).  In the packed
# orthotope the members of one coarse block occupy a contiguous
# k**ceil(j/2) x k**floor(j/2) sub-rectangle of fine slots, because the
# low j base-k digits of the lambda-linear index deinterleave into the
# LOW digits of (w_x, w_y) while the high digits are exactly the coarse
# domain's own orthotope coordinate (transposed when j is odd, since the
# alternating unrolling flips parity by j levels).
# ---------------------------------------------------------------------------


class SuperTiling:
    """Coarsened schedule geometry for a *fractal* block domain.

    Parameters
    ----------
    domain:  a SierpinskiDomain / GeneralizedFractalDomain at level r.
    s:       embedded fine blocks per superblock side; must be m**j for
             the fractal's subdivision factor m, with 1 <= j <= r.

    Exposes the coarse domain (same fractal family at level r - j), the
    packed sub-rectangle shape, coarse-tile addressing, and the static
    fine-block permutation between packed and embedded arrangement of
    one supertile.
    """

    def __init__(self, domain: BlockDomain, s: int):
        spec = fractal_spec_of(domain)
        if spec is None:
            raise ValueError(
                f"coarsen={s} needs a fractal domain (the lambda decode "
                f"being amortized); got {domain.name!r}")
        j = int(round(math.log(s, spec.m)))
        if s < 2 or spec.m ** j != s:
            raise ValueError(
                f"coarsen={s} must be a power >= {spec.m} of the "
                f"fractal's subdivision factor m={spec.m}")
        if j > domain.r_b:
            raise ValueError(
                f"coarsen={s} exceeds the domain's {spec.m ** domain.r_b} "
                f"blocks per side")
        self.fine = domain
        self.spec = spec
        self.s, self.j = s, j
        n_b = spec.m ** domain.r_b
        if isinstance(domain, SierpinskiDomain):
            self.coarse: BlockDomain = SierpinskiDomain(n_b // s)
        else:
            self.coarse = GeneralizedFractalDomain(spec, n_b // s)
        k = spec.k
        #: packed sub-rectangle of one supertile, in fine blocks
        #: (cols = w_x gets the even low levels, rows = w_y the odd).
        self.sub_shape = (k ** (j // 2), k ** ((j + 1) // 2))  # (bw, bh)
        self._coarse_layout = CompactLayout(self.coarse)
        self._tile_map = None
        self._tiles_host = None
        self._neighbor_tiles_host = None

    @property
    def members_per_tile(self) -> int:
        return self.spec.k ** self.j

    @property
    def swap(self) -> bool:
        """Whether the coarse orthotope coordinate lands transposed."""
        return self.j % 2 == 1

    def tile_index(self, BX, BY):
        """Coarse embedded block coords -> (tx, ty) packed supertile
        index (the fine orthotope is tiled by supertiles of ``sub_shape``
        fine slots).  When j is odd the alternating digit unrolling
        flips parity, so the coarse orthotope coordinate lands
        transposed."""
        wx, wy = self._coarse_layout.slot(BX, BY)
        return (wy, wx) if self.swap else (wx, wy)

    def neighbor_tile(self, BX, BY, dx, dy):
        """(tx, ty, valid) of the coarse neighbour supertile (clamped to
        tile (0, 0) when out of range / non-member)."""
        nbx, nby = self.coarse.bounding_box
        x, y = BX + dx, BY + dy
        xc = _clip(x, 0, nbx - 1)
        yc = _clip(y, 0, nby - 1)
        ok = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) \
            & self.coarse.contains(xc, yc)
        tx, ty = self.tile_index(xc, yc)
        where = F._where(BX, BY)
        return where(ok, tx, 0), where(ok, ty, 0), ok

    def tile_map(self):
        """Static fine-block permutation of one supertile: a tuple of
        ``((oy, ox), (ey, ex))`` pairs mapping packed sub-rect position
        (ox, oy) to embedded offset (ex, ey) in fine-block units, one
        per member (the same for every supertile: the low lambda digits
        do not depend on the coarse block)."""
        if self._tile_map is None:
            k, j = self.spec.k, self.j
            pairs = []
            for i in range(k ** j):
                ox, oy = F.deinterleave_linear(i, k, j)
                ex, ey = self.spec.lambda_map_linear(i, j)
                pairs.append(((int(oy), int(ox)), (int(ey), int(ex))))
            self._tile_map = tuple(pairs)
        return self._tile_map

    # -- host tables (the prefetch_lut payload under coarsening) -------------

    def tiles_host(self) -> np.ndarray:
        """(coarse.num_blocks, 2) int32 (tx, ty) per coarse enumeration
        index."""
        if self._tiles_host is None:
            c = self.coarse.coords_host().astype(np.int64)
            tx, ty = self.tile_index(c[:, 0], c[:, 1])
            t = np.stack([np.asarray(tx), np.asarray(ty)], -1)
            t = t.astype(np.int32)
            t.setflags(write=False)
            self._tiles_host = t
        return self._tiles_host

    def neighbor_tiles_host(self) -> np.ndarray:
        """(coarse.num_blocks, 8, 3) int32 of (tx, ty, valid) per
        NEIGHBOR_OFFSETS8 coarse neighbour."""
        if self._neighbor_tiles_host is None:
            c = self.coarse.coords_host().astype(np.int64)
            out = np.zeros((len(c), 8, 3), np.int32)
            for jj, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
                tx, ty, ok = self.neighbor_tile(c[:, 0], c[:, 1], dx, dy)
                out[:, jj, 0] = np.asarray(tx)
                out[:, jj, 1] = np.asarray(ty)
                out[:, jj, 2] = np.asarray(ok)
            out.setflags(write=False)
            self._neighbor_tiles_host = out
        return self._neighbor_tiles_host


# ---------------------------------------------------------------------------
# Cell-level neighbour tables (block = 1 cell): the gather oracle of the
# CA at scales where even a dense n x n scratch array is too large.
# ---------------------------------------------------------------------------

def cell_neighbor_tables(r: int, spec: F.FractalSpec = F.SIERPINSKI,
                         device=None):
    """(4, k**r) int32: for each member cell (linear lambda order) the
    packed index of its N/S/W/E embedded neighbour, or ``k**r`` (a zero
    ghost slot) when absent.  Sort-based lookup: O(k^r log k^r) time and
    O(k^r) memory -- no dense n x n scratch, so it scales to n = 2**16
    where the embedded grid is unallocatable.

    ``device=None`` builds a host numpy array; a device builds the same
    table as an int32 tensor there (sort and search on that device)."""
    n = spec.m ** r
    vol = spec.k ** r
    if device is None:
        i = np.arange(vol, dtype=np.int64)
        lx, ly = spec.lambda_map_linear(i, r)
        lx, ly = np.asarray(lx, np.int64), np.asarray(ly, np.int64)
        keys = ly * n + lx
        order = np.argsort(keys)
        skeys = keys[order]
        tables = np.full((4, vol), vol, np.int32)
        for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
            x, y = lx + dx, ly + dy
            ok = (x >= 0) & (x < n) & (y >= 0) & (y < n)
            nk = y * n + x
            pos = np.clip(np.searchsorted(skeys, nk), 0, vol - 1)
            hit = ok & (skeys[pos] == nk)
            tables[j] = np.where(hit, order[pos], vol).astype(np.int32)
        return tables
    i = torch.arange(vol, dtype=torch.int64, device=device)
    lx, ly = spec.lambda_map_linear(i, r)
    keys = ly * n + lx
    skeys, order = torch.sort(keys)
    tables = torch.full((4, vol), vol, dtype=torch.int32, device=device)
    for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
        x, y = lx + dx, ly + dy
        ok = (x >= 0) & (x < n) & (y >= 0) & (y < n)
        nk = y * n + x
        pos = torch.clamp(torch.searchsorted(skeys, nk), 0, vol - 1)
        hit = ok & (skeys[pos] == nk)
        tables[j] = torch.where(hit, order[pos], vol).to(torch.int32)
    return tables


# ---------------------------------------------------------------------------
# Compact KV support for the attention kernels: the 1-D analogue of the
# packing above.  An attention block domain touches key blocks [lo, hi);
# storing only that support is the sliding-window KV-cache truncation
# (exact for the rectangular decode-convention BandDomain, identity for
# causal / full / square-band whose support is all of m_k).
# ---------------------------------------------------------------------------

def key_block_support(domain: BlockDomain) -> Tuple[int, int]:
    """[lo, hi) key-block (column) support of an attention block domain."""
    c = domain.coords_host()
    if len(c) == 0:
        return 0, 0
    return int(c[:, 0].min()), int(c[:, 0].max()) + 1


def pack_kv(kv: torch.Tensor, domain: BlockDomain, block: int) -> torch.Tensor:
    """Trim a (..., sk, d) K or V tensor to the domain's key-block
    support: the compact KV the ``storage='compact'`` flash path reads
    (a view of ``kv``)."""
    lo, hi = key_block_support(domain)
    return kv[..., lo * block:hi * block, :]


# ---------------------------------------------------------------------------
# Memoized constructors: layout/tiling geometry (and the host tables the
# instances cache) is pure in the domain, so repeated launches share one
# instance per (domain[, s]) instead of rebuilding.
# ---------------------------------------------------------------------------

def compact_layout(domain: BlockDomain) -> CompactLayout:
    """The (memoized) :class:`CompactLayout` of a domain."""
    return memo.cached("compact-layout", domain, (),
                       lambda: CompactLayout(domain))


def super_tiling(domain: BlockDomain, s: int) -> SuperTiling:
    """The (memoized) :class:`SuperTiling` of (domain, s)."""
    return memo.cached("super-tiling", domain, (int(s),),
                       lambda: SuperTiling(domain, s))
