"""MMA lowering: the block-space map as matrix products.

The paper's lambda(w) map (and its inverse, the Squeeze-style compact
slot resolution) is a per-scale-level weighted sum over base-k digits.
Following *Accelerating Compact Fractals with Tensor Core GPUs* (arXiv
2110.12952) and *Squeeze* (arXiv 2201.00613), every such sum is a small
matrix contraction: encode the digit stream of an index as a one-hot
matrix ``O`` of shape (levels, k) and contract it with a precomputed
*digit-basis* matrix ``B`` of shape (levels, k, width).

Contract
--------
One-hot digit vectors are bf16 (0/1 are exact in any float format);
basis matrices are f32 with integer entries; every contraction returns
f32.  A dot of 0/1 values against integer weights is a sum of exact
addends, exact while every partial sum stays below 2**24 --
:data:`DIGIT_BOUND`.  The basis builders *reject* any level count whose
coordinates, volume or slot indices could reach 2**24, and within that
bound the chains equal the integer ``closed_form`` decode bit for bit.

These torch functions are the chains' plain version: the CPU tests run
them, and so do the GridPlan's host tables (``mma_table_host``) and the
kernels' plain versions.  They contract in float64, whatever the
process's TF32 settings, so an f32 matmul that a card would round to
TF32 cannot creep in; below the bound the float64 sums equal the exact
f32 ones.  On the card the same contractions run inside the write, sum
and CA kernels on the tensor cores (``csrc/mma_decode.cuh``), with each
basis split into exact bf16 pieces by :func:`exact_split` and laid out
as ``mma.sync`` B fragments by :func:`tensor_core_operand`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import fractal as F
from . import memo

#: Largest integer magnitude whose f32 sums stay exact.  Every basis
#: builder raises ``ValueError`` when a coordinate, slot, or linear
#: index could reach this bound.
DIGIT_BOUND = 1 << 24

#: The tensor-core tile of the device chains: mma.sync m16n8k16 (bf16
#: operands, f32 accumulation).  K is consumed 16 at a time; the B tile
#: has 8 columns.
MMA_K, MMA_N = 16, 8
#: bits per exact piece: bf16 holds integers exactly up to 256, so a
#: basis entry below 2**24 is carried as three 8-bit pieces
PIECE_BITS, PIECES = 8, 3
#: elements of ``decode_rows``' comparison matrix built at once
ROWS_CHUNK = 1 << 22


def ksteps(k: int) -> int:
    """k-steps of one tensor-core chain over a K of ``k`` columns (at
    least one: an empty chain contracts one zero tile)."""
    return max(1, -(-int(k) // MMA_K))


def fractal_of(domain) -> Optional[Tuple[F.FractalSpec, int]]:
    """``(spec, r_b)`` of a fractal block domain, else ``None``.

    The classic gasket domain carries no ``.spec`` attribute."""
    from .domain import GeneralizedFractalDomain, SierpinskiDomain
    if isinstance(domain, SierpinskiDomain):
        return F.SIERPINSKI, domain.r_b
    if isinstance(domain, GeneralizedFractalDomain):
        return domain.spec, domain.r_b
    return None


def _check_bound(spec: F.FractalSpec, r: int) -> None:
    if spec.k ** r >= DIGIT_BOUND or spec.m ** r >= DIGIT_BOUND:
        raise ValueError(
            f"mma digit-basis for {spec.name} at r={r}: volume k^r="
            f"{spec.k ** r} / extent m^r={spec.m ** r} reaches 2^24; "
            f"f32 accumulation would stop being exact "
            f"(DIGIT_BOUND={DIGIT_BOUND})")


def _check_rows_bound(num_blocks: int, nbx: int) -> None:
    if num_blocks >= DIGIT_BOUND or nbx >= DIGIT_BOUND:
        raise ValueError(
            f"mma row basis: {num_blocks} blocks / width {nbx} reaches "
            f"2^24; f32 accumulation would stop being exact")


def check_domain(domain) -> None:
    """Raise the chains' ``ValueError`` when ``domain`` lies beyond the
    exactness bound, without building any table (what a plan under
    ``mma`` checks before anything is launched)."""
    frac = fractal_of(domain)
    if frac is not None:
        _check_bound(*frac)
    else:
        _check_rows_bound(domain.num_blocks, domain.bounding_box[0])


# ---------------------------------------------------------------------------
# Host-built digit-basis matrices (memoized on the spec via core.memo)
# ---------------------------------------------------------------------------

def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


def coords_basis(spec: F.FractalSpec, r: int) -> np.ndarray:
    """(r, k, 2) f32 basis: digit c at level mu contributes the copy
    offset ``offsets[c] * m**(mu-1)`` to the embedded (bx, by) -- the
    weights of :meth:`FractalSpec.lambda_map_linear` as a matrix."""
    def build():
        _check_bound(spec, r)
        b = np.zeros((r, spec.k, 2), np.float32)
        for mu in range(1, r + 1):
            p = spec.m ** (mu - 1)
            for c, (ox, oy) in enumerate(spec.offsets):
                b[mu - 1, c, 0] = ox * p
                b[mu - 1, c, 1] = oy * p
        return _frozen(b)
    return memo.cached("mma-coords-basis", spec, (r,), build)


def slots_basis(spec: F.FractalSpec, r: int) -> np.ndarray:
    """(r, k, 2) f32 basis: digit c at level mu contributes to the
    orthotope (w_x, w_y) -- odd levels are base-k digits of w_y, even of
    w_x (the Lemma 2 alternating unrolling).  Contracting the digit
    one-hots of a *linear* index with this basis is
    ``deinterleave_linear``; contracting per-level *copy rows* (see
    :func:`copy_rows`) is ``lambda_inverse``."""
    def build():
        _check_bound(spec, r)
        b = np.zeros((r, spec.k, 2), np.float32)
        for mu in range(1, r + 1):
            for c in range(spec.k):
                if mu % 2 == 1:
                    b[mu - 1, c, 1] = c * spec.k ** ((mu - 1) // 2)
                else:
                    b[mu - 1, c, 0] = c * spec.k ** (mu // 2 - 1)
        return _frozen(b)
    return memo.cached("mma-slots-basis", spec, (r,), build)


def linear_basis(spec: F.FractalSpec, r: int) -> np.ndarray:
    """(r, k, 1) f32 basis: copy c at level mu contributes
    ``c * k**(mu-1)`` to the linear lambda-order index."""
    def build():
        _check_bound(spec, r)
        b = np.zeros((r, spec.k, 1), np.float32)
        for mu in range(1, r + 1):
            for c in range(spec.k):
                b[mu - 1, c, 0] = c * spec.k ** (mu - 1)
        return _frozen(b)
    return memo.cached("mma-linear-basis", spec, (r,), build)


def pair_basis(spec: F.FractalSpec) -> np.ndarray:
    """(m*m, k) f32 match matrix: base-m digit pair (dx, dy) -> one-hot
    copy row.  Pairs matching no copy offset give an all-zero row, which
    under every weighted contraction contributes nothing -- exactly the
    copy-0 fall-through of the integer ``lambda_inverse``."""
    def build():
        b = np.zeros((spec.m * spec.m, spec.k), np.float32)
        for c, (ox, oy) in enumerate(spec.offsets):
            b[oy * spec.m + ox, c] = 1.0
        return _frozen(b)
    return memo.cached("mma-pair-basis", spec, (), build)


# ---------------------------------------------------------------------------
# Chain evaluators (torch; ints, numpy arrays and int tensors)
# ---------------------------------------------------------------------------

def _as_tensor(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def _basis(b, device) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b.to(device, torch.float64)
    return torch.from_numpy(np.asarray(b, np.float64)).to(device)


def _powers(base: int, levels: int, device) -> torch.Tensor:
    return torch.tensor([base ** i for i in range(levels)],
                        dtype=torch.int64, device=device)


def digit_onehot(v, base: int, levels: int) -> torch.Tensor:
    """(..., levels, base) bf16 one-hot of the base-``base`` digits of
    an integer array (0/1 are exact in bf16)."""
    v = _as_tensor(v)
    d = torch.div(v[..., None], _powers(base, levels, v.device),
                  rounding_mode="floor") % base
    oh = d[..., None] == torch.arange(base, device=v.device)
    return oh.to(torch.bfloat16)


def _contract(onehot: torch.Tensor, basis) -> torch.Tensor:
    """Contract (..., L, B) digit one-hots with an (L, B, W) basis into
    (..., W) f32 -- one (1, L*B) x (L*B, W) product per decode, batched
    over the leading dims.  Computed in float64 (exact below the
    bound, and immune to TF32 matmul settings)."""
    b = _basis(basis, onehot.device)
    out = torch.einsum("...lb,lbw->...w", onehot.to(torch.float64), b)
    return out.to(torch.float32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def decode_linear(spec: F.FractalSpec, r: int, i):
    """lambda over a linear grid index: MMA replica of
    :meth:`FractalSpec.lambda_map_linear` -> (bx, by) i32."""
    out = _contract(digit_onehot(i, spec.k, r), coords_basis(spec, r))
    return _i32(out[..., 0]), _i32(out[..., 1])


def slots_of_linear(spec: F.FractalSpec, r: int, i, swap: bool = False):
    """Packed slot (sx, sy) of linear step i -- MMA replica of
    ``deinterleave_linear`` (the compact enumeration is lambda-linear,
    so the own slot never needs the inverse chain).  ``swap`` mirrors
    the odd-level ``SuperTiling.tile_index`` transpose."""
    out = _contract(digit_onehot(i, spec.k, r), slots_basis(spec, r))
    sx, sy = _i32(out[..., 0]), _i32(out[..., 1])
    return (sy, sx) if swap else (sx, sy)


def decode_orthotope(spec: F.FractalSpec, r: int, wx, wy):
    """lambda over orthotope coords: MMA replica of
    :meth:`FractalSpec.lambda_map`.  The per-level one-hots interleave
    digits of w_y (odd levels) and w_x (even levels) -- a static
    restack, then one contraction with the coords basis."""
    wx, wy = _as_tensor(wx), _as_tensor(wy)
    ohy = digit_onehot(wy, spec.k, (r + 1) // 2)
    ohx = digit_onehot(wx, spec.k, r // 2)
    parts = [ohy[..., (mu - 1) // 2, :] if mu % 2 == 1
             else ohx[..., mu // 2 - 1, :] for mu in range(1, r + 1)]
    if parts:
        oh = torch.stack(parts, dim=-2)
    else:
        oh = torch.zeros(wx.shape + (0, spec.k), dtype=torch.bfloat16,
                         device=wx.device)
    out = _contract(oh, coords_basis(spec, r))
    return _i32(out[..., 0]), _i32(out[..., 1])


def copy_rows(spec: F.FractalSpec, r: int, x, y) -> torch.Tensor:
    """(..., r, k) f32 per-level copy-index rows of embedded coords:
    base-m digit-pair one-hots contracted with the pair-match basis.
    Each row is one-hot (a matched pair) or all-zero (non-member level,
    the copy-0 fall-through)."""
    x, y = _as_tensor(x), _as_tensor(y)
    pows = _powers(spec.m, r, x.device)
    dx = torch.div(x[..., None], pows, rounding_mode="floor") % spec.m
    dy = torch.div(y[..., None], pows, rounding_mode="floor") % spec.m
    pr = dy * spec.m + dx
    oh = pr[..., None] == torch.arange(spec.m * spec.m, device=x.device)
    out = torch.einsum("...lp,pc->...lc", oh.to(torch.float64),
                       _basis(pair_basis(spec), x.device))
    return out.to(torch.float32)


def member_of_rows(r: int, rows: torch.Tensor) -> torch.Tensor:
    """Membership from copy rows: every level matched <=> the sum of
    the (at most r) ones equals r -- value-equal to the domain's
    digit-pair / bit membership test."""
    return rows.to(torch.float64).sum(dim=(-2, -1)) == float(r)


def inverse_slots(spec: F.FractalSpec, r: int, x, y, swap: bool = False):
    """MMA replica of :meth:`FractalSpec.lambda_inverse`: embedded
    coords -> packed orthotope slot (sx, sy).  Non-member inputs decode
    to some in-range slot (zero rows contribute nothing), exactly like
    the integer fall-through."""
    rows = copy_rows(spec, r, x, y)
    out = _contract(rows.to(torch.bfloat16), slots_basis(spec, r))
    sx, sy = _i32(out[..., 0]), _i32(out[..., 1])
    return (sy, sx) if swap else (sx, sy)


def linear_of(spec: F.FractalSpec, r: int, x, y):
    """MMA replica of :meth:`FractalSpec.linear_index`."""
    rows = copy_rows(spec, r, x, y)
    out = _contract(rows.to(torch.bfloat16), linear_basis(spec, r))
    return _i32(out[..., 0])


def neighbor_slots(spec: F.FractalSpec, r: int, domain, bx, by,
                   dx: int, dy: int, swap: bool = False):
    """MMA replica of ``CompactLayout.neighbor_slot`` /
    ``SuperTiling.neighbor_tile``: the (dx, dy) neighbour of embedded
    (bx, by), clamped into the bounding box, membership-tested via the
    copy-row sum, resolved to its packed slot, and zeroed when invalid
    -- bit-for-bit the integer table entry."""
    nbx, nby = domain.bounding_box
    x = _as_tensor(bx) + dx
    y = _as_tensor(by) + dy
    xc = torch.clamp(x, 0, nbx - 1)
    yc = torch.clamp(y, 0, nby - 1)
    rows = copy_rows(spec, r, xc, yc)
    out = _contract(rows.to(torch.bfloat16), slots_basis(spec, r))
    sx, sy = _i32(out[..., 0]), _i32(out[..., 1])
    if swap:
        sx, sy = sy, sx
    ok = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) \
        & member_of_rows(r, rows)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return torch.where(ok, sx, zero), torch.where(ok, sy, zero), ok


# ---------------------------------------------------------------------------
# Non-fractal (attention / generic) domains: row-comparison chains
# ---------------------------------------------------------------------------

def row_basis(domain):
    """Host row tables of a row-major contiguous block domain:
    ``(starts, diff, ones)`` where ``starts`` is the (R+1,) i32 first
    linear index of each block row (``starts[R] = num_blocks``),
    ``diff[rho] = min_bx[rho] - starts[rho]`` (f32), and ``ones`` is the
    (R,) f32 summing vector.  Raises ``ValueError`` when the domain's
    canonical enumeration is not row-major with ascending-contiguous
    rows (every registered attention domain is)."""
    def build():
        coords = np.asarray(domain.coords_host(), np.int64)
        nbx, nby = domain.bounding_box
        _check_rows_bound(len(coords), nbx)
        bx, by = coords[:, 0], coords[:, 1]
        if np.any(np.diff(by) < 0):
            raise ValueError(
                "mma row basis: domain enumeration is not row-major")
        starts = np.searchsorted(by, np.arange(nby + 1)).astype(np.int64)
        lo = np.zeros(nby, np.int64)
        for rho in range(nby):
            s, e = int(starts[rho]), int(starts[rho + 1])
            if e == s:
                continue
            lo[rho] = bx[s]
            if not np.array_equal(bx[s:e],
                                  np.arange(lo[rho], lo[rho] + e - s)):
                raise ValueError(
                    f"mma row basis: block row {rho} is not a "
                    f"contiguous ascending span")
        return tuple(_frozen(a) for a in (
            starts.astype(np.int32), (lo - starts[:-1]).astype(np.float32),
            np.ones(nby, np.float32)))
    return memo.cached("mma-row-basis", domain, (), build)


def decode_rows(domain, t):
    """Linear step -> (bx, by) for a row-major contiguous domain, as
    two dot products: the row index is the count of row starts at or
    below t (a comparison matrix contracted with ones, minus one), and
    the column is t plus the one-hot row's ``min_bx - start`` offset.
    Value-equal to ``domain.block_coords`` for t in [0, num_blocks).
    The (T, R) comparison matrix is built in chunks of steps."""
    starts, diff, ones = row_basis(domain)
    t = _as_tensor(t)
    flat = t.reshape(-1)
    si = torch.from_numpy(starts.astype(np.int64)).to(t.device)
    d64, o64 = _basis(diff, t.device), _basis(ones, t.device)
    per = max(1, ROWS_CHUNK // max(1, len(ones)))
    bxs, bys = [], []
    for c0 in range(0, flat.numel(), per):
        tc = flat[c0:c0 + per, None]
        ge_lo = (tc >= si[:-1]).to(torch.bfloat16)
        ge_hi = (tc >= si[1:]).to(torch.bfloat16)
        by = ge_lo.to(torch.float64) @ o64 - 1.0
        bx = tc[:, 0].to(torch.float64) \
            + (ge_lo - ge_hi).to(torch.float64) @ d64
        bxs.append(bx.to(torch.float32))
        bys.append(by.to(torch.float32))
    if not bxs:
        empty = torch.zeros(0, dtype=torch.int32, device=t.device)
        return empty.reshape(t.shape), empty.reshape(t.shape)
    return (_i32(torch.cat(bxs)).reshape(t.shape),
            _i32(torch.cat(bys)).reshape(t.shape))


def row_extents_chain(domain, device=None) -> torch.Tensor:
    """(nby, 2) i32 tensor on ``device`` of [min_bx, max_bx] per block
    row -- the flash q/k window hulls -- via membership matmuls:
    prefix/suffix member counts are the 0/1 membership matrix contracted
    with triangular ones matrices; the min (max) column is the number of
    leading (trailing) zero prefix (suffix) counts.  Empty rows give
    [0, -1], bit-identical to ``GridPlan.row_extents``."""
    nbx, nby = domain.bounding_box
    if nbx >= DIGIT_BOUND:
        raise ValueError(
            f"mma row extents: width {nbx} reaches 2^24; f32 "
            f"accumulation would stop being exact")
    device = torch.device("cpu" if device is None else device)
    x = torch.arange(nbx, device=device)[None, :].expand(nby, nbx)
    y = torch.arange(nby, device=device)[:, None].expand(nby, nbx)
    mem = torch.as_tensor(domain.contains(x, y), device=device)
    m = torch.broadcast_to(mem, (nby, nbx)).to(torch.float64)
    tri = torch.triu(torch.ones((nbx, nbx), dtype=torch.float64,
                                device=device))
    prefix = m @ tri          # (nby, nbx): members at cols <= x
    suffix = m @ tri.T        # members at cols >= x
    lead = (prefix == 0).sum(dim=1)
    trail = (suffix == 0).sum(dim=1)
    count = prefix[:, -1]
    lo = torch.where(count == 0, torch.zeros_like(lead), lead)
    hi = (nbx - 1) - trail
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Tensor-core operands of the device chains (csrc/mma_decode.cuh)
# ---------------------------------------------------------------------------

def exact_split(basis) -> np.ndarray:
    """A (K, W) integer-valued basis split into exact tensor-core
    pieces: a (K, 8) f32 array whose column ``3 * w + p`` holds piece p
    of output w, ``sign(v) * ((|v| >> 8p) & 255)``.

    The device chains need it because the tensor cores take no f32
    operands: bf16 holds integers exactly only up to 256 (TF32 up to
    2048), so a basis entry below 2**24 travels as three signed 8-bit
    pieces, each exact in bf16.  Each piece column is accumulated in
    f32 (a sum of at most K terms of magnitude <= 255, exact), and the
    kernel recombines ``p0 + 256 * p1 + 65536 * p2`` in int32.  The
    sign rides every piece, so negative entries (the ``diff`` column of
    :func:`row_basis`) recombine exactly too.  Pieces that would fall
    past column 8 must be zero (an output whose entries are below 256
    needs one piece), else this raises."""
    b = np.asarray(basis, np.float64)
    if b.ndim == 1:
        b = b[:, None]
    v = np.rint(b).astype(np.int64)
    if not np.array_equal(v, b) or np.abs(v).max(initial=0) >= DIGIT_BOUND:
        raise ValueError("exact_split: entries must be integers below 2^24")
    sign, mag = np.sign(v), np.abs(v)
    out = np.zeros((v.shape[0], MMA_N), np.float32)
    for w in range(v.shape[1]):
        for p in range(PIECES):
            piece = sign[:, w] * ((mag[:, w] >> (PIECE_BITS * p)) & 255)
            col = PIECES * w + p
            if col < MMA_N:
                out[:, col] = piece
            elif np.any(piece):
                raise ValueError(
                    f"exact_split: output {w} needs piece {p}, past the "
                    f"{MMA_N} columns of one tensor-core tile")
    return out


def recombine(pieces, width: int) -> np.ndarray:
    """Inverse of :func:`exact_split` on (..., 8) piece sums: the
    (..., width) integers ``sum_p 256**p * pieces[..., 3w + p]``."""
    pieces = np.asarray(pieces, np.int64)
    out = np.zeros(pieces.shape[:-1] + (width,), np.int64)
    for w in range(width):
        for p in range(PIECES):
            col = PIECES * w + p
            if col < MMA_N:
                out[..., w] += pieces[..., col] << (PIECE_BITS * p)
    return out


def tensor_core_operand(pieces: np.ndarray) -> np.ndarray:
    """(K, 8) exact pieces -> the ``mma.sync.m16n8k16`` B fragments of
    every k-step: an int32 array (ceil(K/16), 32, 2), K zero-padded to a
    multiple of 16.  Lane l (group g = l // 4, t = l % 4) holds
    B[2t, g], B[2t+1, g] in its first register and B[2t+8, g],
    B[2t+9, g] in its second, each a bf16 in the low then the high
    half, so a lane reads its fragment as one 8-byte load."""
    pieces = np.asarray(pieces, np.float32)
    k = pieces.shape[0]
    ks = ksteps(k)
    full = np.zeros((ks * MMA_K, MMA_N), np.float32)
    full[:k] = pieces
    bits = torch.from_numpy(full).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().astype(np.int64) & 0xFFFF
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((ks, 32, 2), np.int64)
    for s in range(ks):
        rows = s * MMA_K + 2 * t
        out[s, :, 0] = bits[rows, g] | (bits[rows + 1, g] << 16)
        out[s, :, 1] = bits[rows + 8, g] | (bits[rows + 9, g] << 16)
    return out.astype(np.uint32).view(np.int32)


def neighbor_basis(spec: F.FractalSpec, r: int) -> np.ndarray:
    """(r * m * m, 3) f32: :func:`pair_basis` folded into
    :func:`slots_basis` per level, plus a match column -- row
    ``mu * m*m + dy * m + dx`` holds the slot weights of the copy whose
    offset is (dx, dy) at level mu and a 1 (or zeros for an unmatched
    pair).  Contracting a neighbour's digit-pair one-hots with it gives
    :func:`inverse_slots` and the copy-row sum of
    :func:`member_of_rows` in one product: every product and partial
    sum stays an exact integer."""
    def build():
        sb = slots_basis(spec, r)
        pb = pair_basis(spec)
        mm = spec.m * spec.m
        out = np.zeros((r * mm, 3), np.float32)
        for mu in range(r):
            out[mu * mm:(mu + 1) * mm, :2] = pb @ sb[mu]
            out[mu * mm:(mu + 1) * mm, 2] = pb.sum(axis=1)
        return _frozen(out)
    return memo.cached("mma-neighbor-basis", spec, (r,), build)


def fractal_operands(spec: F.FractalSpec, r: int) -> Tuple[np.ndarray, ...]:
    """The device operands of a fractal domain at level r: the B
    fragments of the coords basis, the slots basis and the neighbour
    basis (each ``tensor_core_operand`` of its ``exact_split``)."""
    def build():
        k = spec.k
        return tuple(_frozen(tensor_core_operand(exact_split(b))) for b in (
            coords_basis(spec, r).reshape(r * k, 2),
            slots_basis(spec, r).reshape(r * k, 2),
            neighbor_basis(spec, r)))
    return memo.cached("mma-fractal-operands", spec, (r,), build)


def rows_operands(domain) -> Tuple[np.ndarray, np.ndarray]:
    """The device operands of a row-major domain: the int32 row starts
    padded with INT32_MAX (a padded row never compares true) to
    ``16 * ksteps + 2`` entries -- the chain reads up to
    ``starts[16 * ksteps]``, and the last entry keeps the fragments that
    follow in the operand tensor 8-byte aligned -- and the B fragments
    of the (ones, diff) basis."""
    def build():
        starts, diff, ones = row_basis(domain)
        frag = tensor_core_operand(exact_split(np.stack([ones, diff], -1)))
        padded = np.full(frag.shape[0] * MMA_K + 2, np.iinfo(np.int32).max,
                         np.int32)
        padded[:len(starts)] = starts
        return _frozen(padded), _frozen(frag)
    return memo.cached("mma-rows-operands", domain, (), build)
