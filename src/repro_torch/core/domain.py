"""Block-space domains: compact grid enumerations of structured-sparse
block sets, generalizing the paper's lambda(w) beyond fractals.

A BlockDomain answers two questions for a kernel launch:

  * ``num_blocks`` -- how many grid steps to launch (the paper's
    parallel-space volume), and
  * ``block_coords(i)`` -- integer math mapping the linear grid index to
    the 2-D block coordinate in the *embedded* space (the paper's
    lambda), on ints, numpy arrays or int64 tensors.

The bounding-box baseline is itself a domain, so every kernel can A/B
exactly as the paper does.  ``coords_host()`` gives the same enumeration
as a host numpy array, used for (a) oracle tests and (b) the
lookup-table lowering (the paper's "shared lookup table" option).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import fractal as F


class BlockDomain:
    """Interface; block coords are (bx, by) with y the row (downwards)."""

    name: str = "abstract"
    #: True when every bounding-box block is a member (no run-time
    #: discard needed even under the "bounding" lowering).
    always_member: bool = False

    @property
    def cache_key(self):
        """Hashable identity for host-table memoization
        (:mod:`repro_torch.core.memo`), or None when the instance cannot
        guarantee one (e.g. closures over arbitrary membership
        callables)."""
        return None

    @property
    def num_blocks(self) -> int:
        raise NotImplementedError

    def block_coords(self, i):
        """Linear grid index -> (bx, by)."""
        raise NotImplementedError

    def linear_index(self, bx, by):
        """Member block coords -> linear grid index (the inverse of
        ``block_coords``).  Undefined garbage for non-member coords."""
        raise NotImplementedError

    def contains(self, bx, by):
        """Membership test in the embedded block space."""
        raise NotImplementedError

    def cell_member(self, gx, gy, n: int):
        """Cell-level membership of the embedded n x n grid; only
        meaningful for domains with intra-block structure (fractals).
        Default: every cell of a member block is live."""
        return (gx == gx)  # all true, shape-following

    def coords_host(self) -> np.ndarray:
        """(num_blocks, 2) int32 enumeration on host (oracle + the
        lookup-table lowering).  Memoized per instance."""
        cached = getattr(self, "_coords_host", None)
        if cached is None:
            i = np.arange(self.num_blocks, dtype=np.int64)
            bx, by = self.block_coords(i)
            cached = np.stack(
                [np.asarray(bx), np.asarray(by)], -1).astype(np.int32)
            cached.setflags(write=False)
            self._coords_host = cached
        return cached

    def space_efficiency(self) -> float:
        """Fraction of bounding-box blocks that are real work (Theorem 2)."""
        bb = self.bounding_box
        return self.num_blocks / float(bb[0] * bb[1])

    @property
    def bounding_box(self) -> Tuple[int, int]:
        raise NotImplementedError


class BoundingBoxDomain(BlockDomain):
    """The paper's baseline: launch every block of the n_b x n_b box and
    let the kernel discard non-members at run time."""

    name = "bounding-box"

    def __init__(self, nbx: int, nby: int, member=None):
        self.nbx, self.nby = nbx, nby
        self._member = member
        self.always_member = member is None

    @property
    def cache_key(self):
        if self._member is not None:
            return None  # membership closure: identity not capturable
        return ("bounding-box", self.nbx, self.nby)

    @property
    def num_blocks(self) -> int:
        return self.nbx * self.nby

    @property
    def bounding_box(self):
        return (self.nbx, self.nby)

    def block_coords(self, i):
        return i % self.nbx, i // self.nbx

    def linear_index(self, bx, by):
        return by * self.nbx + bx

    def contains(self, bx, by):
        if self._member is None:
            return (bx == bx)  # all true, shape-following
        return self._member(bx, by)


class SierpinskiDomain(BlockDomain):
    """The paper, faithfully: 3**r_b blocks mapped by lambda (Eq. 4-10)."""

    name = "sierpinski"

    def __init__(self, n_b: int):
        self.n_b = n_b
        self.r_b = F.scale_level(n_b)

    @property
    def cache_key(self):
        return ("sierpinski", self.n_b)

    @property
    def num_blocks(self) -> int:
        return 3 ** self.r_b

    @property
    def bounding_box(self):
        return (self.n_b, self.n_b)

    def block_coords(self, i):
        return F.lambda_map_linear(i, self.r_b)

    def linear_index(self, bx, by):
        # per scale level the base-3 digit is the bit-pair sum
        # (0,0)->0 (0,1)->1 (1,1)->2; see F.lambda_inverse
        i = bx * 0
        for mu in range(1, self.r_b + 1):
            b = ((bx >> (mu - 1)) & 1) + ((by >> (mu - 1)) & 1)
            i = i + b * 3 ** (mu - 1)
        return i

    def contains(self, bx, by):
        return F.is_member(bx, by, self.n_b)

    def cell_member(self, gx, gy, n: int):
        return F.is_member(gx, gy, n)


class GeneralizedFractalDomain(BlockDomain):
    """Paper SS V future-work question 1: any F^{k,s} digit-unrolled fractal."""

    name = "generalized-fractal"

    def __init__(self, spec: F.FractalSpec, n_b: int):
        self.spec = spec
        self.n_b = n_b
        self.r_b = spec.scale_level(n_b)
        self.name = f"fractal:{spec.name}"

    @property
    def cache_key(self):
        return ("fractal", self.spec.name, self.n_b)

    @property
    def num_blocks(self) -> int:
        return self.spec.k ** self.r_b

    @property
    def bounding_box(self):
        return (self.n_b, self.n_b)

    def block_coords(self, i):
        return self.spec.lambda_map_linear(i, self.r_b)

    def linear_index(self, bx, by):
        return self.spec.linear_index(bx, by, self.r_b)

    def contains(self, bx, by):
        # the coarse block grid is the same fractal at level r_b
        return self.spec.is_member(bx, by, self.n_b)

    def cell_member(self, gx, gy, n: int):
        return self.spec.is_member(gx, gy, n)


def _isqrt(x):
    """Integer sqrt for the triangular decode (related work [18] solves
    an order-m equation; here m=2 so it is a square root).  On host a
    float64 sqrt plus one correction round; on tensors a float32 sqrt
    plus two correction rounds, which is exact for x < 2**24 block
    grids (asserted by the domains) -- the device-side decode."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.int64)
        s = np.floor(np.sqrt(x.astype(np.float64))).astype(np.int64)
        s = np.where((s + 1) * (s + 1) <= x, s + 1, s)
        return np.where(s * s > x, s - 1, s)
    x = x.to(torch.int64)
    s = torch.floor(torch.sqrt(x.to(torch.float32))).to(torch.int64)
    for _ in range(2):
        s = torch.where((s + 1) * (s + 1) <= x, s + 1, s)
        s = torch.where(s * s > x, s - 1, s)
    return s


def _as_index(i):
    """Host ints stay ints, arrays become int64 numpy, tensors int64."""
    if isinstance(i, torch.Tensor):
        return i.to(torch.int64)
    if isinstance(i, (int, np.integer)):
        return i
    return np.asarray(i, np.int64)


class TriangularDomain(BlockDomain):
    """Causal (lower-triangular) block domain over m x m blocks: the
    2-simplex case of the authors' block-space program, and the domain of
    causal attention.  T(m) = m(m+1)/2 blocks instead of m**2."""

    name = "triangular"

    def __init__(self, m: int):
        if m * (m + 1) // 2 >= 2 ** 24:
            raise ValueError("triangular decode exact only below 2**24 blocks")
        self.m = m

    @property
    def cache_key(self):
        return ("triangular", self.m)

    @property
    def num_blocks(self) -> int:
        return self.m * (self.m + 1) // 2

    @property
    def bounding_box(self):
        return (self.m, self.m)

    def block_coords(self, i):
        # row q = floor((sqrt(8i+1)-1)/2); col k = i - q(q+1)/2  (k <= q)
        i = _as_index(i)
        q = (_isqrt(8 * i + 1) - 1) // 2
        k = i - q * (q + 1) // 2
        if isinstance(i, (int, np.integer)):
            return int(k), int(q)
        return k, q  # (bx=key block, by=query block)

    def linear_index(self, bx, by):
        return by * (by + 1) // 2 + bx

    def contains(self, bx, by):
        return bx <= by


class BandDomain(BlockDomain):
    """Sliding-window (local) attention block domain: key block kj in
    [max(0, qi + off - w + 1), qi + off] for each query block qi, with
    ``off = m_k - m_q`` (queries are the *last* m_q rows of the key
    grid -- the decode convention; off = 0 is square self-attention).

    Square blocks: T(w) + (m-w)*w vs bounding box m**2.  Rectangular
    (off > 0) requires off >= w - 1 so every row sees a full window:
    m*w blocks, and the key-block support shrinks to the *last*
    m + w - 1 key blocks -- the compact sliding-window KV cache."""

    name = "band"

    def __init__(self, m: int, w: int, m_k: int = None):
        if w < 1:
            raise ValueError(
                f"band window must be at least 1 block, got w={w}: a "
                f"0-wide band has no blocks and its decode divides by "
                f"zero")
        m_k = m if m_k is None else m_k
        if m_k < m:
            raise ValueError(f"band domain needs m_k >= m_q, got "
                             f"m_k={m_k} < m_q={m}")
        self.off = m_k - m
        if self.off == 0 and w > m:
            w = m
        if self.off and self.off < w - 1:
            raise ValueError(
                f"rectangular band needs m_k - m_q >= w - 1 (every query "
                f"row sees a full window), got off={self.off}, w={w}")
        self.m, self.w, self.m_k = m, w, m_k
        self._tw = w * (w + 1) // 2
        if self.off == 0 and m * (m + 1) // 2 >= 2 ** 24:
            raise ValueError("band decode exact only below 2**24 blocks")

    @property
    def cache_key(self):
        return ("band", self.m, self.w, self.m_k)

    @property
    def num_blocks(self) -> int:
        if self.off:
            return self.m * self.w
        return self._tw + (self.m - self.w) * self.w

    @property
    def bounding_box(self):
        return (self.m_k, self.m)

    def block_coords(self, i):
        i = _as_index(i)
        where = F._where(i)
        if self.off:
            q = i // self.w
            k = self.off + q - self.w + 1 + i % self.w
            return k, q
        tw = self._tw
        # triangular head (rows 0..w-1), then dense band rows of width w
        q_tri = (_isqrt(8 * i + 1) - 1) // 2
        k_tri = i - q_tri * (q_tri + 1) // 2
        j = i - tw
        # clamp to >= 0 so negatives in the head region stay inert
        # before the select
        jw = where(j < 0, 0, j)
        q_band = self.w + jw // self.w
        k_band = q_band - self.w + 1 + jw % self.w
        in_tri = i < tw
        q = where(in_tri, q_tri, q_band)
        k = where(in_tri, k_tri, k_band)
        return k, q

    def linear_index(self, bx, by):
        if self.off:
            return by * self.w + (bx - (self.off + by - self.w + 1))
        where = F._where(bx, by)
        return where(by < self.w, by * (by + 1) // 2 + bx,
                     self._tw + (by - self.w) * self.w
                     + (bx - (by - self.w + 1)))

    def contains(self, bx, by):
        return (bx <= by + self.off) & (bx > by + self.off - self.w)


def make_fractal_domain(fractal: str, n_b: int) -> BlockDomain:
    """Factory used by the embedded-fractal kernels (write / sum).

    fractal: "sierpinski-gasket" (the paper's gasket, O(1) bit-test
    membership) or any registered FractalSpec name ("sierpinski-carpet",
    "vicsek-cross", ... -- O(r*k) digit-test membership)."""
    if fractal in ("sierpinski", "sierpinski-gasket"):
        return SierpinskiDomain(n_b)
    if fractal not in F.FRACTALS:
        raise ValueError(
            f"unknown fractal {fractal!r}; registered: "
            f"{tuple(F.FRACTALS)}")
    return GeneralizedFractalDomain(F.FRACTALS[fractal], n_b)


def make_attention_domain(kind: str, m_q: int, m_k: int,
                          window_blocks: int = None):
    """Factory for the attention block domains.

    kind: "causal" -> TriangularDomain (requires m_q == m_k),
          "local"  -> BandDomain (``window_blocks`` is REQUIRED, >= 1),
          "full"   -> BoundingBoxDomain (bidirectional / baseline).
    """
    if kind == "causal":
        if m_q != m_k:
            raise ValueError("causal triangular domain needs square block grid")
        return TriangularDomain(m_q)
    if kind == "local":
        if window_blocks is None or window_blocks < 1:
            raise ValueError(
                f"kind='local' requires window_blocks >= 1, got "
                f"{window_blocks!r}")
        return BandDomain(m_q, window_blocks, m_k)
    if kind == "full":
        return BoundingBoxDomain(m_k, m_q)
    raise ValueError(kind)
