"""The paper's block-space Sierpinski map, on ints, numpy and torch.

Notation follows Navarro, Bustos, Vega, Hitschfeld (2017),
"Block-space GPU Mapping for Embedded Sierpinski Gasket Fractals":

* the discrete gasket of scale level ``r`` lives embedded in an
  ``n x n`` grid with ``n = 2**r``, origin at the top-left, ``y``
  increasing downwards.  Membership test (paper SS III.D.3):
  ``x & (n - 1 - y) == 0``.
* the gasket packs into a 2-orthotope of ``3**ceil(r/2) x 3**floor(r/2)``
  blocks (Lemma 2) via an alternating base-3 digit unrolling: odd scale
  levels consume base-3 digits of ``w_y``, even levels of ``w_x``.
* ``lambda(w)`` (Eq. 4-10) accumulates, per scale level ``mu``, a region
  offset ``tau^mu = Delta_mu * 2**(mu-1)`` with region index
  ``beta_mu(w) in {0, 1, 2}`` (0 = top, 1 = bottom-left, 2 = bottom-right).

Everything here is plain integer index math, so the same function runs
on Python ints, numpy arrays and int64 torch tensors (on any device):
selects go through ``torch.where`` when any argument is a tensor and
through ``np.where`` otherwise.  The CUDA kernels evaluate the same
digit loops in registers (``repro_torch/csrc/sierpinski_write.cu``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .backend import default_device

HAUSDORFF = math.log2(3.0)  # H = log2(3) ~ 1.5849625 (Lemma 1)


def _where(*vals):
    """``torch.where`` when any operand is a tensor, else ``np.where``."""
    if any(isinstance(v, torch.Tensor) for v in vals):
        return torch.where
    return np.where


# ---------------------------------------------------------------------------
# Scalar / host-side helpers
# ---------------------------------------------------------------------------

def scale_level(n: int) -> int:
    """r = log2(n); n must be a power of two (paper: r = log_{1/s}(n), s=1/2)."""
    r = int(round(math.log2(n)))
    if 2 ** r != n:
        raise ValueError(f"n={n} is not a power of two")
    return r


def gasket_volume(n: int) -> int:
    """V(F_n^{3,1/2}) = 3**r = n**H   (Lemma 1)."""
    return 3 ** scale_level(n)


def orthotope_shape(r: int) -> Tuple[int, int]:
    """Packing orthotope (width_x, height_y) of the level-r gasket (Lemma 2):
    3**floor(r/2) wide and 3**ceil(r/2) tall (odd scale levels consume
    the base-3 digits of w_y)."""
    return 3 ** (r // 2), 3 ** ((r + 1) // 2)


def is_member(x, y, n: int):
    """Embedded-space membership bit test: x & (n - 1 - y) == 0.

    Apex at (0,0); left edge x == 0 always member; bottom row y == n-1 full.
    Works on python ints, numpy arrays and integer tensors alike.
    """
    return (x & (n - 1 - y)) == 0


# ---------------------------------------------------------------------------
# The paper's map, Eq. (4) - (10)
# ---------------------------------------------------------------------------

def beta_mu(wx, wy, mu: int):
    """Region index beta_mu(w) in {0,1,2} at scale level mu  (Eq. 4)."""
    sel = wx * ((mu + 1) % 2) + wy * (mu % 2)      # odd mu -> w_y, even -> w_x
    return (sel // 3 ** ((mu + 1) // 2 - 1)) % 3


def delta_mu(beta):
    """Offset weights (Delta_x, Delta_y) in {0,1}^2 for a region index (Eq. 5)."""
    dx = beta // 2
    dy = beta - dx
    return dx, dy


def lambda_map(wx, wy, r: int):
    """lambda(w): orthotope block coords -> embedded fractal block coords
    (Eq. 8-10): the sum over scale levels mu = 1..r of
    tau^mu = Delta_mu * 2**(mu-1)."""
    lx = wx * 0
    ly = wy * 0
    for mu in range(1, r + 1):
        b = beta_mu(wx, wy, mu)
        dx, dy = delta_mu(b)
        lx = lx + dx * 2 ** (mu - 1)
        ly = ly + dy * 2 ** (mu - 1)
    return lx, ly


def lambda_map_linear(i, r: int):
    """lambda over a *linear* grid index i in [0, 3**r).

    The digit stream of i in base 3 IS the sequence (beta_1, ..., beta_r)
    under the paper's alternating unrolling (i = interleave(w_y, w_x) in
    base 3), so this is the same bijection with one fewer divmod chain.
    It is the closed-form decode of the write/sum kernels.
    """
    lx = i * 0
    ly = i * 0
    for mu in range(1, r + 1):
        b = (i // 3 ** (mu - 1)) % 3
        dx, dy = delta_mu(b)
        lx = lx + dx * 2 ** (mu - 1)
        ly = ly + dy * 2 ** (mu - 1)
    return lx, ly


def lambda_inverse(x, y, r: int):
    """Inverse map: embedded fractal block coords -> orthotope coords.

    For each scale level mu the region is recovered from bit mu-1 of (x, y):
    (0,0) -> beta 0, (0,1) -> beta 1, (1,1) -> beta 2.  ((1,0) never occurs
    for members.)  The betas are then re-packed into the alternating base-3
    digits of (w_x, w_y).
    """
    wx = x * 0
    wy = y * 0
    px = x * 0 + 1  # 3**(even-digit position)
    py = y * 0 + 1
    for mu in range(1, r + 1):
        bx = (x >> (mu - 1)) & 1
        by = (y >> (mu - 1)) & 1
        b = bx + by  # (0,0)->0 (0,1)->1 (1,1)->2
        if mu % 2 == 1:
            wy = wy + b * py
            py = py * 3
        else:
            wx = wx + b * px
            px = px * 3
    return wx, wy


# ---------------------------------------------------------------------------
# Generalized F^{k,s} fractals (paper SS V, future-work question 1)
# ---------------------------------------------------------------------------

class FractalSpec:
    """A self-similar fractal built from k copies at scale s with integer
    per-copy offsets, generalizing the gasket's (k=3, s=1/2).

    offsets: tuple of (dx, dy) unit offsets in {0..m-1}^2 where m = 1/s is
    the integer subdivision factor.  Level-mu copy c sits at
    offsets[c] * m**(mu-1).
    """

    def __init__(self, name: str, k: int, m: int, offsets):
        if len(offsets) != k:
            raise ValueError("need one offset per copy")
        self.name, self.k, self.m = name, k, m
        self.offsets = tuple(tuple(o) for o in offsets)
        self._grid_cache = {}  # n -> dense membership grid (oracle)

    @property
    def hausdorff(self) -> float:
        return math.log(self.k) / math.log(self.m)

    @property
    def cache_key(self):
        """Value identity for :mod:`repro_torch.core.memo`."""
        return ("fractal-spec", self.name, self.k, self.m, self.offsets)

    def scale_level(self, n: int) -> int:
        r = int(round(math.log(n, self.m)))
        if self.m ** r != n:
            raise ValueError(f"n={n} is not a power of m={self.m}")
        return r

    def volume(self, n: int) -> int:
        return self.k ** self.scale_level(n)

    def _copy_offset(self, c):
        """(dx, dy) of copy index ``c``: a select chain over the k static
        offsets (the kernels unroll the same chain over their by-value
        offset table)."""
        where = _where(c)
        dx, dy = c * 0, c * 0
        for j, (ox, oy) in enumerate(self.offsets):
            dx = where(c == j, ox, dx)
            dy = where(c == j, oy, dy)
        return dx, dy

    def _copy_index(self, dx, dy):
        """Copy index whose offset is the digit pair (dx, dy); unmatched
        pairs (non-members) fall through to copy 0."""
        where = _where(dx, dy)
        c = dx * 0
        for j, (ox, oy) in enumerate(self.offsets):
            c = where((dx == ox) & (dy == oy), j, c)
        return c

    def lambda_map_linear(self, i, r: int):
        """Generalized digit-unrolled map: base-k digits of i choose copies."""
        lx = i * 0
        ly = i * 0
        for mu in range(1, r + 1):
            c = (i // self.k ** (mu - 1)) % self.k
            dx, dy = self._copy_offset(c)
            lx = lx + dx * self.m ** (mu - 1)
            ly = ly + dy * self.m ** (mu - 1)
        return lx, ly

    def lambda_map(self, wx, wy, r: int):
        """Generalized lambda over *orthotope* coords (w_x, w_y) ->
        embedded fractal coords: odd scale levels mu = 1, 3, ... consume
        base-k digits of w_y, even levels of w_x (the Lemma 2
        alternating unrolling)."""
        lx = wx * 0
        ly = wy * 0
        for mu in range(1, r + 1):
            if mu % 2 == 1:
                c = (wy // self.k ** ((mu - 1) // 2)) % self.k
            else:
                c = (wx // self.k ** (mu // 2 - 1)) % self.k
            dx, dy = self._copy_offset(c)
            lx = lx + dx * self.m ** (mu - 1)
            ly = ly + dy * self.m ** (mu - 1)
        return lx, ly

    def lambda_inverse(self, x, y, r: int):
        """Inverse map: embedded fractal coords -> orthotope coords.

        Per scale level mu the copy index c is recovered by matching the
        base-m digit pair of (x, y) against the copy offsets; the copy
        indices are then re-packed into the alternating base-k digits of
        (w_x, w_y).  Non-member inputs decode to *some* in-range
        orthotope coordinate (unmatched digit pairs fall through to
        copy 0).
        """
        wx = x * 0
        wy = y * 0
        px = x * 0 + 1   # k**(even-digit position)
        py = y * 0 + 1
        for mu in range(1, r + 1):
            p = self.m ** (mu - 1)
            c = self._copy_index((x // p) % self.m, (y // p) % self.m)
            if mu % 2 == 1:
                wy = wy + c * py
                py = py * self.k
            else:
                wx = wx + c * px
                px = px * self.k
        return wx, wy

    def linear_index(self, x, y, r: int):
        """Embedded fractal coords -> linear index in lambda order (the
        inverse of :meth:`lambda_map_linear`); copy indices become the
        base-k digits of i."""
        i = x * 0
        for mu in range(1, r + 1):
            p = self.m ** (mu - 1)
            c = self._copy_index((x // p) % self.m, (y // p) % self.m)
            i = i + c * self.k ** (mu - 1)
        return i

    def orthotope_shape(self, r: int) -> Tuple[int, int]:
        """Packing orthotope (width_x, height_y): k**floor(r/2) wide by
        k**ceil(r/2) tall (Lemma 2 generalized to F^{k,s})."""
        return self.k ** (r // 2), self.k ** ((r + 1) // 2)

    def is_member(self, x, y, n: int):
        """Membership test: (x, y) is in the level-r fractal iff every
        base-m digit pair of (x, y) is one of the copy offsets.  O(r * k)
        integer ops, no dense grid."""
        r = self.scale_level(n)
        ok = None
        for mu in range(r):
            p = self.m ** mu
            dx = (x // p) % self.m
            dy = (y // p) % self.m
            lvl = None
            for (ox, oy) in self.offsets:
                hit = (dx == ox) & (dy == oy)
                lvl = hit if lvl is None else (lvl | hit)
            ok = lvl if ok is None else (ok & lvl)
        if ok is None:  # r == 0: the single cell is the whole fractal
            ok = (x == 0) & (y == 0)
        return ok

    def membership_grid(self, n: int) -> np.ndarray:
        """Dense boolean n x n occupancy via recursive construction (oracle).
        Memoized per instance."""
        if n in self._grid_cache:
            return self._grid_cache[n]
        r = self.scale_level(n)
        g = np.ones((1, 1), dtype=bool)
        for mu in range(1, r + 1):
            size = self.m ** (mu - 1)
            big = np.zeros((size * self.m, size * self.m), dtype=bool)
            for (dx, dy) in self.offsets:
                big[dy * size:(dy + 1) * size, dx * size:(dx + 1) * size] |= g
            g = big
        g.setflags(write=False)
        self._grid_cache[n] = g
        return g


SIERPINSKI = FractalSpec("sierpinski-gasket", k=3, m=2,
                         offsets=((0, 0), (0, 1), (1, 1)))
# Sierpinski carpet: 8 copies at 1/3 scale (center removed), H = log3(8).
CARPET = FractalSpec("sierpinski-carpet", k=8, m=3,
                     offsets=((0, 0), (1, 0), (2, 0),
                              (0, 1), (2, 1),
                              (0, 2), (1, 2), (2, 2)))
# Vicsek cross: 5 copies at 1/3 scale, H = log3(5).
VICSEK = FractalSpec("vicsek-cross", k=5, m=3,
                     offsets=((1, 0), (0, 1), (1, 1), (2, 1), (1, 2)))

FRACTALS = {f.name: f for f in (SIERPINSKI, CARPET, VICSEK)}


def deinterleave_linear(i, k: int, r: int):
    """Linear lambda-order index -> orthotope coords (w_x, w_y).

    The base-k digit stream of i is the alternating digit unrolling of
    (w_y, w_x) (odd scale levels mu = 1, 3, ... are digits of w_y, even
    of w_x), so de-interleaving i's digits recovers the Lemma 2 packing
    coordinate without going through embedded space."""
    wx = i * 0
    wy = i * 0
    px = i * 0 + 1
    py = i * 0 + 1
    for mu in range(1, r + 1):
        d = (i // k ** (mu - 1)) % k
        if mu % 2 == 1:
            wy = wy + d * py
            py = py * k
        else:
            wx = wx + d * px
            px = px * k
    return wx, wy


def membership_grid(n: int) -> np.ndarray:
    """Dense boolean occupancy of the embedded gasket via the bit test."""
    y, x = np.mgrid[0:n, 0:n]
    return (x & (n - 1 - y)) == 0


# ---------------------------------------------------------------------------
# Device utilities: the block table and the orthotope bridges
# ---------------------------------------------------------------------------

def all_block_coords(r: int, device=None) -> torch.Tensor:
    """(3**r, 2) int32 tensor of embedded coords for every gasket block,
    enumerated in linear lambda order (the canonical compact layout
    order), on ``device`` (the card unless the caller names another)."""
    i = torch.arange(3 ** r, dtype=torch.int64,
                     device=default_device(device))
    lx, ly = lambda_map_linear(i, r)
    return torch.stack([lx, ly], dim=-1).to(torch.int32)


def _orthotope_lambda(r: int, device):
    """lambda of every orthotope cell (w_y, w_x), as int64 tensors shaped
    like the (3**ceil(r/2), 3**floor(r/2)) orthotope."""
    ox, oy = orthotope_shape(r)
    wy = torch.arange(oy, dtype=torch.int64, device=device)[:, None]
    wx = torch.arange(ox, dtype=torch.int64, device=device)[None, :]
    return lambda_map(wx.expand(oy, ox), wy.expand(oy, ox), r)


def _on_device(arr, device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``; with ``device=None`` a tensor
    stays where it is and anything else goes to the card."""
    if device is None and isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(arr, device=default_device(device))


def pack_to_orthotope(grid, r: int, device=None) -> torch.Tensor:
    """Gather an embedded n x n array into the compact (3**ceil, 3**floor)
    orthotope layout (Lemma 2): grid[y, x] -> packed[w_y, w_x].  The
    result lies on ``device``: the grid's own when it is a tensor and no
    device is named, else the card unless the caller names another."""
    grid = _on_device(grid, device)
    lx, ly = _orthotope_lambda(r, grid.device)
    return grid[ly, lx]


def unpack_from_orthotope(packed, r: int, n: int, fill=0,
                          device=None) -> torch.Tensor:
    """Scatter the compact orthotope layout back into the embedded n x n
    (trailing dims carried along); cells outside the gasket get
    ``fill``.  ``device`` as in :func:`pack_to_orthotope`."""
    packed = _on_device(packed, device)
    lx, ly = _orthotope_lambda(r, packed.device)
    out = torch.full((n, n) + tuple(packed.shape[2:]), fill,
                     dtype=packed.dtype, device=packed.device)
    out[ly, lx] = packed
    return out
