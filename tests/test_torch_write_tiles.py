"""The write and sum kernels' work split, emulated on the CPU.

``csrc/sierpinski_write.cu`` runs a persistent grid: CTAs of ``WARPS``
warps take runs of consecutive grid steps by grid stride over runs, and
warp w takes steps w, w + WARPS, ... of a run.  A warp decodes its first
step of a run and walks the block coords (and a row-major domain's
packed slot) forward along the rows; a random-access decode (the LUT
row, lambda's digit loop) runs for 32 of a warp's steps at once, one a
lane; the tensor-core chains run per step, or per batch of eight.
The cells of a fine block are chunks of 16 bytes when that many cells
divide the block (else single cells), chunk j of the block (row-major)
belonging to lane j % 32; a chunk is one 128-bit access when the block,
the pitch and the state's base are 16-byte aligned, else scalar ones in
the same order.  The write stores a chunk of members as one vector,
the members of a partial chunk one by one, a chunk of non-members not at
all.  The sum adds a lane's member cells in f32 in chunk order, fine
blocks in embedded order, then combines the lanes by a fixed xor
butterfly.  Under mma a row-major domain's row chain decodes eight of a
warp's steps in one m16n8k16 tile.

This file emulates that assignment in numpy / torch on the CPU, where
no kernel runs, and holds it against ``GridPlan.step_coords`` /
``storage_index`` and the plain versions, for every registered small
and medium domain under both storages: every member cell is covered
exactly once, no pad slot and no non-member cell is touched, integer
partials are bit-equal to ``sum_partials_plain``, float partials within
``RTOL`` of each tile's sum of magnitudes, and the lane order gives the
same float partials under embedded and compact storage and under every
lowering.  The batched row chain is emulated with the fragment
arithmetic of ``tests/test_torch_mma.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import mma as TM
from repro_torch.core import plan as TP
from repro_torch.core.compact import compact_layout
from repro_torch.core.domain import (BandDomain, BoundingBoxDomain,
                                     TriangularDomain)

from test_torch_mma import _b_from_fragments, _dout, _warp_d

TW = importlib.import_module("repro_torch.kernels.sierpinski_write")

#: the kernels' constants (csrc/sierpinski_write.cu kWarps, kRunsPerCta;
#: csrc/mma_decode.cuh kRowsBatch)
WARPS, RUNS_PER_CTA, ROWS_BATCH = 8, 16, 8
#: float partials against the plain version: two f32 reductions of at
#: most a few thousand terms in different orders each err by at most
#: ~1e-6 of the tile's sum of magnitudes (chip_smoke.py NORMAL_RTOL)
RTOL = 1e-5
#: resident CTAs the emulated launches take: 1-5 make long runs (many
#: walked steps a warp), 1056 is 132 SMs x 8
CTAS = (1, 2, 5, 1056)


def all_domains():
    """Every registered small and medium domain, the rectangular band
    and the tall box."""
    out = {}
    for size in ("small", "medium"):
        for name, dom in TP.registered_domains(size).items():
            out[f"{name}-{size}"] = dom
    out["band-rect"] = BandDomain(8, 3, 20)
    out["tall-box"] = BoundingBoxDomain(3, 6)
    return out


DOMAINS = all_domains()
GENERIC = {k: d for k, d in DOMAINS.items()
           if isinstance(d, (TriangularDomain, BandDomain, BoundingBoxDomain))}


def blocks_for(dom):
    """The blocks the emulation runs a domain at: single cells (1, 2, 3,
    9), one 16-byte chunk per row (4), wide chunks of f32 and bf16 (8);
    a fractal's n = nby * block must stay a power of its m."""
    if dom in GENERIC.values():
        return (1, 3, 4, 8)
    if getattr(dom, "spec", None) is not None:
        return (1, 3, 9)
    return (1, 2, 4, 8)


# ---------------------------------------------------------------------------
# the kernel's host-side geometry (cells_of, persistent)
# ---------------------------------------------------------------------------

class Cells:
    """csrc/sierpinski_write.cu cells_of: the lane geometry of a block."""

    def __init__(self, block, elem_bytes, pitch, base=0):
        v = 16 // elem_bytes
        self.wide = block % v == 0
        self.va = v if self.wide else 1
        self.cpr = block // v if self.wide else block
        self.dr, self.dc = 32 // self.cpr, 32 % self.cpr
        self.iters = -(-block * self.cpr // 32)
        self.vec = self.wide and pitch % v == 0 and base % 16 == 0


def launch_geometry(steps, ctas, batch=1):
    """csrc/sierpinski_write.cu persistent: (grid, run); batch is
    ROWS_BATCH under the batched row chain, else 1."""
    unit = WARPS * batch
    share = ctas * unit * RUNS_PER_CTA
    run = unit * max(1, -(-steps // share))
    runs = -(-steps // run)
    return min(runs, ctas), run


def schedule(steps, ctas, batch=1):
    """for_each_step's assignment: [(cta, warp, steps of the warp in the
    run)] in launch order."""
    grid, run = launch_geometry(steps, ctas, batch)
    nruns = -(-steps // run)
    out = []
    for cta in range(grid):
        for r in range(cta, nruns, grid):
            end = min(r * run + run, steps)
            for warp in range(WARPS):
                out.append((cta, warp, range(r * run + warp, end, WARPS)))
    return out


def lane_chunks(L, block):
    """for_each_chunk: the (row, chunk) of each lane's rounds, (32, iters,
    2), -1 where the lane idles."""
    out = np.full((32, L.iters, 2), -1, np.int64)
    for lane in range(32):
        r, c = divmod(lane, L.cpr)
        for i in range(L.iters):
            if r < block:
                out[lane, i] = (r, c)
            r += L.dr
            c += L.dc
            if c >= L.cpr:
                c -= L.cpr
                r += 1
    return out


def fine_blocks(p):
    """for_each_fine: (srow, scol, ox0, oy0) of each stored fine block of
    a supertile, in embedded order."""
    if p.nfine == 1 and p.coarsen == 1:
        return [(0, 0, 0, 0)]
    s = p.coarsen
    perm = None if p.tile_perm is None else p.tile_perm.numpy()
    out = []
    for e in range(s * s if perm is not None else p.nfine):
        q, ey, ex = e, e // p.bw, e % p.bw
        if perm is not None:
            q = int(perm[2 * p.nfine + e])
            if q < 0:
                continue
            ey, ex = divmod(e, s)
        out.append(((q // p.bw) * p.block, (q % p.bw) * p.block,
                    ex * p.block, ey * p.block))
    return out


# ---------------------------------------------------------------------------
# the decode: walks along the rows (fractal_common.cuh generic_row)
# ---------------------------------------------------------------------------

def generic_row(p, q):
    """Member columns [lo, lo + len) of block row q."""
    w = p.dom_w
    if p.family == TP.FAMILY_TRIANGULAR:
        return 0, q + 1
    if p.family == TP.FAMILY_BAND:
        if p.dom_off:
            return p.dom_off + q - w + 1, w
        return (0, q + 1) if q < w else (q - w + 1, w)
    return 0, p.nbx


def walked(p):
    """Does the kernel walk this launch's decode (bounding, or a
    row-major domain under closed_form)?"""
    return p.lowering == TP.LOWERING_CODES["bounding"] or (
        p.family in TP.GENERIC_FAMILIES
        and p.lowering == TP.LOWERING_CODES["closed_form"])


def walk_warp(p, plan, ts):
    """One warp's steps of a run, decoded as the kernel does: the first
    from scratch, then walked forward by WARPS.  Returns {t: (bx, by,
    slot)} with slot the walked packed slot (row-major closed_form under
    compact storage) or None."""
    out = {}
    bounding = p.lowering == TP.LOWERING_CODES["bounding"]
    compact = p.storage == TP.STORAGE_CODES["compact"]
    for k, t in enumerate(ts):
        if bounding:
            if k == 0:
                bx, by = t % p.nbx, t // p.nbx
            else:
                bx += WARPS
                while bx >= p.nbx:
                    bx -= p.nbx
                    by += 1
            out[t] = (bx, by, None)
            continue
        if k == 0:
            bx, by = (int(v) for v in plan.sched_domain.block_coords(t))
            lo, ln = generic_row(p, by)
            sx, sy = t % p.scols, t // p.scols
        else:
            j = bx - lo + WARPS
            while j >= ln:
                j -= ln
                by += 1
                lo, ln = generic_row(p, by)
            bx = lo + j
            sx += WARPS
            while sx >= p.scols:
                sx -= p.scols
                sy += 1
        out[t] = (bx, by, (sx, sy) if compact else None)
    return out


def decode_all(plan, p, ctas):
    """Per step: (bx, by, valid, row0, col0) int64 tensors as the kernel
    decodes them under a launch of ``ctas`` resident CTAs."""
    steps = p.steps
    bx, by, valid = plan.step_coords(0, steps, "cpu")
    row, col = plan.storage_index(0, steps, "cpu")
    bx, by, row, col = (x.long().clone() for x in (bx, by, row, col))
    if walked(p):
        seen = torch.zeros(steps, dtype=torch.int64)
        for _, _, ts in schedule(steps, ctas):
            for t, (x, y, slot) in walk_warp(p, plan, ts).items():
                seen[t] += 1
                bx[t], by[t] = x, y
                if slot is not None:
                    col[t], row[t] = slot
        assert bool((seen == 1).all())
    if valid is None:
        valid = torch.ones(steps, dtype=torch.bool)
    th, tw = plan.supertile_shape((p.block, p.block))
    return bx, by, valid, row * th, col * tw


# ---------------------------------------------------------------------------
# the kernels, emulated
# ---------------------------------------------------------------------------

def emulate(plan, n, block, m, ctas=1056, base=0):
    """The write kernel's stores and the sum kernel's partials on ``m``:
    (count of stores per state cell, vector stores, scalar stores,
    partials)."""
    p = plan.launch_params(n, block, "cpu")
    L = Cells(block, m.element_size(), p.pitch, base)
    bx, by, valid, row0, col0 = decode_all(plan, p, ctas)
    ch = torch.from_numpy(lane_chunks(L, block))
    e = torch.arange(L.va)
    iy = ch[..., 0, None].expand(32, L.iters, L.va)
    ix = ch[..., 1, None] * L.va + e
    active = iy >= 0
    flat = m.reshape(-1).to(torch.float32)
    counts = torch.zeros(m.numel(), dtype=torch.int64)
    acc = torch.zeros((p.steps, 32), dtype=torch.float32)
    nvec = nscalar = 0
    x0 = (bx * p.span)[:, None, None, None]
    y0 = (by * p.span)[:, None, None, None]
    for srow, scol, ox0, oy0 in fine_blocks(p):
        gx = x0 + ox0 + ix
        gy = y0 + oy0 + iy
        member = plan.domain.cell_member(gx, gy, n) & active \
            & valid[:, None, None, None]
        off = (row0[:, None, None, None] + srow + iy) * p.pitch \
            + col0[:, None, None, None] + scol + ix
        off = torch.where(member, off, 0)
        # the write: one vector store for a chunk of members, else scalar
        # stores of the members
        whole = member.all(-1) & L.vec
        nvec += int(whole.sum())
        nscalar += int((member & ~whole[..., None]).sum())
        counts.index_add_(0, off[member], torch.ones_like(off[member]))
        # the sum: each lane in chunk order
        for i in range(L.iters):
            for k in range(L.va):
                x = flat[off[:, :, i, k]]
                acc = torch.where(member[:, :, i, k], acc + x, acc)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    assert bool((acc == acc[:, :1]).all())  # every lane holds the sum
    return counts, nvec, nscalar, torch.where(valid, acc[:, 0], 0.0)


def state_for(plan, n, block, dtype, seed, integer=True):
    shape = plan.state_shape(block)
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, shape) if integer else rng.normal(size=shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def plan_for(dom, block, lowering, storage, coarsen=1):
    n = dom.bounding_box[1] * block
    m = torch.zeros(compact_layout(dom).array_shape(block)
                    if storage == "compact"
                    else compact_layout(dom).embedded_shape(block))
    plan, n, block = TW.prepare_launch(m, block=block, grid_mode=lowering,
                                       storage=storage, n=n, domain=dom,
                                       coarsen=coarsen)
    return plan, n, block


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("block", [1, 2, 3, 4, 8, 9, 16, 27, 32, 64, 128])
def test_lane_chunks_cover_each_cell_once(elem_bytes, block):
    """Chunk j of a block (row-major) is lane j % 32's round j // 32, and
    the chunks cover every cell once."""
    L = Cells(block, elem_bytes, pitch=block)
    assert L.va == (16 // elem_bytes if block % (16 // elem_bytes) == 0
                    else 1)
    ch = lane_chunks(L, block)
    seen = np.zeros((block, block), np.int64)
    for lane in range(32):
        for i in range(L.iters):
            r, c = ch[lane, i]
            if r < 0:
                assert i * 32 + lane >= block * L.cpr
                continue
            assert r * L.cpr + c == i * 32 + lane
            seen[r, c * L.va:(c + 1) * L.va] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch", [1, ROWS_BATCH])
@pytest.mark.parametrize("ctas", [1, 2, 3, 528, 1056])
@pytest.mark.parametrize("steps", [1, 3, 7, 8, 9, 100, 4097, 33800, 123457])
def test_runs_cover_each_step_once(steps, ctas, batch):
    """Persistent CTAs over runs by grid stride: every step once, a
    warp's steps of a run ascending by WARPS, no CTA without a run, at
    most RUNS_PER_CTA runs a CTA, and under the batched row chain only a
    warp's last batch of the launch short of ROWS_BATCH steps."""
    grid, run = launch_geometry(steps, ctas, batch)
    assert run % (WARPS * batch) == 0 and 1 <= grid <= ctas
    seen = np.zeros(steps, np.int64)
    runs_of = np.zeros(grid, np.int64)
    for cta, warp, ts in schedule(steps, ctas, batch):
        assert ts.step == WARPS and (len(ts) == 0 or ts.start % WARPS == warp)
        seen[list(ts)] += 1
        runs_of[cta] += warp == 0
        if batch > 1 and len(ts) % batch:
            assert ts.stop > steps - WARPS * batch  # the launch's tail
    assert (seen == 1).all() and (runs_of >= 1).all()
    assert runs_of.max() <= RUNS_PER_CTA


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("name", list(GENERIC) + [
    "triangular-60", "band-50-7", "band-rect-30-4-40", "box-13-1"])
def test_row_walk_equals_block_coords_and_slots(name, ctas):
    """The walked coords equal block_coords (GridPlan.step_coords under
    closed_form) at every step, and the walked packed slot equals
    storage_index."""
    dom = GENERIC.get(name) or {
        "triangular-60": TriangularDomain(60), "band-50-7": BandDomain(50, 7),
        "band-rect-30-4-40": BandDomain(30, 4, 40),
        "box-13-1": BoundingBoxDomain(13, 1)}[name]
    for storage in TP.STORAGES:
        plan, n, block = plan_for(dom, 2, "closed_form", storage)
        p = plan.launch_params(n, block, "cpu")
        bx, by, _ = plan.step_coords(0, p.steps, "cpu")
        row, col = plan.storage_index(0, p.steps, "cpu")
        got = {}
        for _, _, ts in schedule(p.steps, ctas):
            got.update(walk_warp(p, plan, ts))
        assert sorted(got) == list(range(p.steps))
        for t, (x, y, slot) in got.items():
            assert (x, y) == (int(bx[t]), int(by[t]))
            if storage == "compact":
                assert slot == (int(col[t]), int(row[t]))


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("name", list(DOMAINS))
def test_bounding_walk_equals_the_box_split(name, ctas):
    dom = DOMAINS[name]
    plan, n, block = plan_for(dom, 1, "bounding", "embedded")
    p = plan.launch_params(n, block, "cpu")
    bx, by, _ = plan.step_coords(0, p.steps, "cpu")
    for _, _, ts in schedule(p.steps, ctas):
        for t, (x, y, _) in walk_warp(p, plan, ts).items():
            assert (x, y) == (int(bx[t]), int(by[t]))


def _plain_written(plan, n, block, shape, dtype):
    m = torch.full(shape, -5, dtype=dtype)
    return TW.sierpinski_write_plain(m, 3, plan, n, block) != -5


@pytest.mark.parametrize("lowering", TP.LOWERINGS)
@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("name", list(DOMAINS))
def test_emulated_kernels_match_the_plain_versions(name, storage, lowering):
    """Every member cell stored exactly once and nothing else; integer
    partials bit-equal, float partials within RTOL; per dtype (f32 and
    int32 chunks of 4 cells, bf16 of 8) and block."""
    dom = DOMAINS[name]
    for block in blocks_for(dom):
        plan, n, blk = plan_for(dom, block, lowering, storage)
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            m = state_for(plan, n, blk, dtype, seed=block)
            counts, nvec, nscalar, parts = emulate(plan, n, blk, m,
                                                   ctas=CTAS[block % 4])
            want = _plain_written(plan, n, blk, m.shape, dtype).reshape(-1)
            assert bool((counts[want] == 1).all())
            assert int(counts[~want].sum()) == 0  # no pad, no non-member
            assert nvec * Cells(blk, m.element_size(), 1).va + nscalar \
                == int(want.sum())
            if name in GENERIC:
                # a generic domain's aligned chunks are all vector stores
                assert nscalar == (0 if Cells(blk, m.element_size(),
                                              plan.state_shape(blk)[1]).vec
                                   else int(want.sum()))
            assert torch.equal(parts, TW.sum_partials_plain(m, plan, n, blk))
        x = state_for(plan, n, blk, torch.float32, seed=7, integer=False)
        parts = emulate(plan, n, blk, x)[3]
        plain = TW.sum_partials_plain(x, plan, n, blk)
        mag = TW.sum_partials_plain(x.abs(), plan, n, blk)
        assert bool(((parts - plain).abs() <= RTOL * mag).all())


#: (fractal domain, block, coarsen)
COARSE_CASES = [("sierpinski-medium", 2, 2), ("sierpinski-medium", 1, 4),
                ("carpet-medium", 1, 3), ("vicsek-medium", 1, 3),
                ("sierpinski-small", 4, 2)]


@pytest.mark.parametrize("name,block,coarsen", COARSE_CASES)
def test_float_partials_equal_across_storages_and_lowerings(name, block,
                                                            coarsen):
    """Fine blocks in embedded order, chunks in lane order: on a normal
    f32 state the emulated partials are bit-equal under embedded and
    compact storage and under closed_form, prefetch_lut and mma,
    coarsened or not, and every member cell is stored once."""
    dom = DOMAINS[name]
    lay = compact_layout(dom)
    rng = np.random.default_rng(11)
    emb = torch.from_numpy(rng.normal(
        size=lay.embedded_shape(block)).astype(np.float32))
    packed = lay.pack(emb, block)
    for s in (1, coarsen):
        got = []
        for storage, m in (("embedded", emb), ("compact", packed)):
            for lowering in ("closed_form", "prefetch_lut", "mma"):
                plan, n, blk = plan_for(dom, block, lowering, storage, s)
                counts, _, _, parts = emulate(plan, n, blk, m)
                want = _plain_written(plan, n, blk, m.shape,
                                      torch.float32).reshape(-1)
                assert bool((counts[want] == 1).all())
                assert int(counts[~want].sum()) == 0
                got.append(parts)
        assert all(torch.equal(got[0], g) for g in got[1:])


@pytest.mark.parametrize("name", ["sierpinski-medium", "triangular-medium",
                                  "band-small"])
def test_misaligned_state_takes_scalar_accesses_in_the_same_order(name):
    """A state 4 bytes past a 16-byte boundary: no vector access, the same
    cells stored, the same float partials bit for bit."""
    dom = DOMAINS[name]
    plan, n, blk = plan_for(dom, 4, "closed_form", "embedded")
    x = state_for(plan, n, blk, torch.float32, seed=2, integer=False)
    c0, v0, s0, p0 = emulate(plan, n, blk, x, base=0)
    c1, v1, s1, p1 = emulate(plan, n, blk, x, base=4)
    assert v0 > 0 and v1 == 0 and v0 * 4 + s0 == s1
    assert torch.equal(c0, c1) and torch.equal(p0, p1)


# ---------------------------------------------------------------------------
# B7c batched: one m16n8k16 chain for eight of a warp's steps
# ---------------------------------------------------------------------------

def _a_from_lanes(starts, t, stride, nlive, ks):
    """rows_chain_warp's A tile of k-step ks, assembled from what each
    lane builds: rows g and g + 8 of lane (g, tq) carry the one-hots of
    steps ja = g // 2 and ja + 4, own-row when g is odd."""
    a = np.zeros((16, 16), np.float32)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        own, ja = g & 1, g >> 1
        c = ks * 16 + 2 * tq
        for row, j in ((g, ja), (g + 8, ja + 4)):
            tj = t + j * stride
            for col in (c, c + 1, c + 8, c + 9):
                hot = j < nlive and tj >= starts[col] and (
                    not own or tj < starts[col + 1])
                a[row, col - ks * 16] = float(hot)
    return a


def _lane_registers(d):
    """The D fragment per lane: d[0..1] = (g, 2tq..2tq+1), d[2..3] =
    (g + 8, 2tq..2tq+1)."""
    regs = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        regs[lane] = (d[g, 2 * tq], d[g, 2 * tq + 1], d[g + 8, 2 * tq],
                      d[g + 8, 2 * tq + 1])
    return regs


def _dget_at(regs, row, col):
    """mma_decode.cuh dget_at: read all four registers of lane
    4 * (row % 8) + col / 2, keep register 2 * (row / 8) + col % 2."""
    src = ((row & 7) << 2) | (col >> 1)
    return regs[src, 2 * (row >= 8) + (col & 1)]


@pytest.mark.parametrize("name", list(GENERIC) + ["triangular-60"])
def test_batched_row_chain_decodes_eight_steps(name):
    """Eight steps t + j * WARPS per chain, with the tail batch of a run
    (nlive < 8) leaving its rows zero: A assembled lane by lane equals the
    intended one-hots, and lane j's recombined count and diff give
    block_coords of step j."""
    dom = GENERIC.get(name) or TriangularDomain(60)
    starts, frag = TM.rows_operands(dom)
    b = _b_from_fragments(frag)
    nb = dom.num_blocks
    for t in range(0, nb, 5):
        nlive = min(ROWS_BATCH, -(-(nb - t) // WARPS))

        def a_of(row, col, t=t, nlive=nlive):
            j, own = divmod(row, 2)
            tj = t + j * WARPS
            if j >= nlive or col + 1 >= len(starts):
                return 0
            ge = tj >= starts[col]
            return int(ge and (not own or tj < starts[col + 1]))
        d = _warp_d(a_of, frag)
        lanes = sum(_a_from_lanes(starts, t, WARPS, nlive, ks)
                    @ b[ks * 16:(ks + 1) * 16]
                    for ks in range(frag.shape[0]))
        np.testing.assert_array_equal(lanes, d)
        regs = _lane_registers(d)
        for lane in range(32):
            j = lane & 7
            count = [_dget_at(regs, 2 * j, c) for c in range(3)]
            diff = [_dget_at(regs, 2 * j + 1, c) for c in range(3, 6)]
            assert count == [d[2 * j, c] for c in range(3)]
            assert diff == [d[2 * j + 1, c] for c in range(3, 6)]
            if j >= nlive:
                assert (d[2 * j:2 * j + 2] == 0).all()
                continue
            tj = t + j * WARPS
            got = (tj + _dout(d, 2 * j + 1, 1), _dout(d, 2 * j, 0) - 1)
            assert got == tuple(int(v) for v in dom.block_coords(tj))
