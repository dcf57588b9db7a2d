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

``"compact"`` is accepted as an alias of ``closed_form``.  The ``mma``
lowering, compact storage and superblock coarsening are not ported yet
and raise ``NotImplementedError`` naming the roadmap item that brings
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import backend as backend_lib
from . import fractal as F
from . import memo
from .domain import (BandDomain, BlockDomain, BoundingBoxDomain,
                     GeneralizedFractalDomain, SierpinskiDomain,
                     TriangularDomain)

LOWERINGS = ("closed_form", "prefetch_lut", "bounding")
_ALIASES = {"compact": "closed_form"}
#: lowerings the JAX package has and this port does not yet, with the
#: roadmap item that brings each.
_UNPORTED_LOWERINGS = {"mma": "A9", "auto": "A8"}

STORAGES = ("embedded",)
_UNPORTED_STORAGES = {"compact": "A4"}

#: kernel-side codes of the launch parameters (csrc/sierpinski_write.cu)
FAMILY_GASKET, FAMILY_SPEC = 0, 1
LOWERING_CODES = {"closed_form": 0, "prefetch_lut": 1, "bounding": 2}


def normalize_lowering(name: str) -> str:
    """Map user-facing lowering names (incl. the alias) to canonical."""
    name = _ALIASES.get(name, name)
    if name in _UNPORTED_LOWERINGS:
        raise NotImplementedError(
            f"lowering {name!r} is not ported yet (ROADMAP "
            f"{_UNPORTED_LOWERINGS[name]})")
    if name not in LOWERINGS:
        raise ValueError(
            f"unknown lowering {name!r}; expected one of {LOWERINGS} "
            f"or aliases {tuple(_ALIASES)}")
    return name


def normalize_storage(name: str) -> str:
    if name in _UNPORTED_STORAGES:
        raise NotImplementedError(
            f"storage {name!r} is not ported yet (ROADMAP "
            f"{_UNPORTED_STORAGES[name]})")
    if name not in STORAGES:
        raise ValueError(
            f"unknown storage {name!r}; expected one of {STORAGES}")
    return name


@dataclasses.dataclass(frozen=True)
class LaunchParams:
    """The scalar launch parameters of a fractal write/sum kernel.

    family:   FAMILY_GASKET (bit-test membership, base-3 lambda) or
              FAMILY_SPEC (a FractalSpec: base-k digit decode over
              ``offsets``, base-m digit membership test).
    lowering: a LOWERING_CODES value.
    r_b, k, m: block scale level, copies per level, subdivision factor.
    r_cell:   log_m(block), the digit levels inside one tile (FractalSpec
              membership; 0 for the gasket, whose bit test needs none).
    offsets:  the k (dx, dy) copy offsets.
    n, block: embedded side in cells, tile side in cells.
    steps:    grid steps (num_blocks, or nbx * nby under bounding).
    nbx:      blocks per side of the bounding box.
    lut:      (num_blocks, 2) int32 device tensor under prefetch_lut,
              else None.
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
    lut: Optional[torch.Tensor]


class GridPlan:
    """Execution plan for one kernel launch over a block domain.

    Parameters
    ----------
    domain:      the block domain to enumerate.
    lowering:    "closed_form" | "prefetch_lut" | "bounding" (or the
                 alias "compact").
    batch_dims:  leading grid dimensions iterated outside the domain
                 (e.g. ``(batch * heads,)`` for attention).
    storage:     "embedded": state arrays are the dense bounding-box
                 layout.
    coarsen:     1 (superblocks are not ported yet).
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
        self.coarsen = int(coarsen)
        if self.coarsen < 1:
            raise ValueError(f"coarsen must be >= 1, got {coarsen}")
        if self.coarsen > 1:
            raise NotImplementedError(
                "superblock coarsening (coarsen > 1) is not ported yet "
                "(ROADMAP A4)")
        self.target = backend_lib.resolve(backend)
        #: the domain the grid enumerates (the coarse one, once
        #: coarsening is ported)
        self.sched_domain: BlockDomain = domain

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
        """Host-built (num_blocks, 2) i32 decode table of (bx, by), one
        row per scheduled block, memoized per (domain, storage,
        coarsen)."""
        return memo.cached("gridplan-lut", self.domain,
                           (self.storage, self.coarsen), self._lut_host)

    def _lut_host(self) -> np.ndarray:
        return np.asarray(self.sched_domain.coords_host(), np.int32)

    def lut(self, device) -> torch.Tensor:
        """The decode table as an int32 tensor on ``device``, copied
        once per device and memoized beside the host table."""
        device = torch.device(device)
        return memo.cached(
            "gridplan-lut-device", self.domain,
            (self.storage, self.coarsen, str(device)),
            lambda: torch.from_numpy(self.lut_host().copy()).to(device))

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
        tensors, ``valid`` None when every step is a member block.

        closed_form runs the digit loop on ``arange``, prefetch_lut
        reads the device table, bounding splits the row-major step id
        and tests ``domain.contains``."""
        if self.lowering == "prefetch_lut":
            rows = self.lut(device)[start:stop].to(torch.int64)
            return rows[:, 0], rows[:, 1], None
        t = torch.arange(start, stop, dtype=torch.int64, device=device)
        if self.lowering == "closed_form":
            bx, by = self.sched_domain.block_coords(t)
            return bx, by, None
        nbx, _ = self.sched_domain.bounding_box
        bx, by = t % nbx, t // nbx
        valid = None
        if not getattr(self.sched_domain, "always_member", False):
            valid = self.sched_domain.contains(bx, by)
        return bx, by, valid

    def launch_params(self, n: int, block: int, device) -> LaunchParams:
        """The CUDA kernels' launch parameters for an embedded (n, n)
        state tiled by ``block``.  Only the fractal domains have a
        device-side decode in this port."""
        dom = self.sched_domain
        if isinstance(dom, SierpinskiDomain):
            family, spec, r_cell = FAMILY_GASKET, F.SIERPINSKI, 0
        elif isinstance(dom, GeneralizedFractalDomain):
            family, spec = FAMILY_SPEC, dom.spec
            # the digit test needs n = m**r (raises like spec.is_member)
            r_cell = spec.scale_level(n) - dom.r_b
        else:
            raise NotImplementedError(
                f"no device-side decode for the {dom.name!r} domain yet "
                f"(ROADMAP A6)")
        nbx, _ = dom.bounding_box
        lut = self.lut(device) if self.lowering == "prefetch_lut" else None
        return LaunchParams(
            family=family, lowering=LOWERING_CODES[self.lowering],
            r_b=dom.r_b, k=spec.k, m=spec.m, r_cell=r_cell,
            offsets=spec.offsets,
            n=int(n), block=int(block), steps=self.steps_per_launch,
            nbx=int(nbx), lut=lut)

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
