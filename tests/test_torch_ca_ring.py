"""The fused CA kernel's work split (csrc/sierpinski_ca.cu) without the card.

A numpy emulation of what ``ca_fused_kernel`` does per launch, index for
index:

* persistent CTAs: CTA c of G walks steps c, c + G, ...; under bounding
  a warp tests 32 of them at a time and keeps the first member, and G is
  coprime with the box's width (``walk_ctas``);
* the ring: S slots (``num_stages``) and S + 1 entries; a prologue
  resolves steps 0 .. S - 1 and issues 0 .. S - 2, one commit group
  each; iteration i issues step i + S - 1 (S = 1: step i itself), waits
  until at most S - 2 groups are pending and computes on slot i % S.
  Copies land only when a wait retires their group.  Under mma the
  entries are S + 16 and resolved sixteen at a time (the batched
  chains): the prologue resolves 0 .. 15, iteration i resolves i + S ..
  i + S + 15 when i + S is a multiple of 16, never over a live entry;
* the gather: per working row its fine-block row, offset and supertile
  row once; per piece (4 cells at pad = -h mod 4 when the block and the
  pitch are multiples of 4, else 1 cell) its fine block, a zero-filled
  copy where that block is out of range or not a member, else its
  storage offset (compact: the supertile's origin and the static
  fine-block table); the cell mask a byte of 4 bits per 4 shared
  columns of a row;
* the trapezoid by rows in whole groups of 4 shared columns (cells past
  the region are computed and written too, never read again), each row's
  offset computed once, a lane a group, short rows packed into a warp;
  the store per fine-block row in pieces through the per-CTA fine-block
  tables.

It is held against ``GridPlan.step_coords`` / ``storage_index`` and the
plain version ``ca_launch_plain`` (bit-equal) on small registered
fractals and row-major domains, both storages, every lowering, at ring
depths 1-3.  The constants mirror the kernel: ``MAX_STAGES``, the
32-step bounding scan, the piece of 4 cells.
"""
import importlib
import math
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.core import domain as D
from repro_torch.core.compact import NEIGHBOR_OFFSETS8, compact_layout
from repro_torch.core.plan import LOWERINGS
from torch_parity import fractal_state

TC = importlib.import_module("repro_torch.kernels.sierpinski_ca")
TW = importlib.import_module("repro_torch.kernels.sierpinski_write")

SCAN = 32     # steps a warp tests at a time under bounding
BATCH = 16    # steps a batch of the mma chains resolves (kStepsBatch)
PIECE = 4     # cells of a 16-byte copy
ALPHA = 0.2


# ---------------------------------------------------------------------------
# the emulated kernel
# ---------------------------------------------------------------------------

def mod2(x):
    """csrc mod2: jnp.mod(x, 2) as x - 2 trunc(x / 2) with fmod's sign,
    then + 2 where negative (float32 throughout)."""
    x = np.asarray(x, np.float32)
    r = np.copysign(x - np.float32(2) * np.trunc(x * np.float32(0.5)), x)
    return np.where(r < 0, r + np.float32(2), r).astype(np.float32)


def geometry(p, halo, vec):
    """The kernel's tile geometry: (wid, stride, ngr, pc, pad), ngr the
    mask bytes of a row, one per 4 shared columns."""
    wid = p.span + 2 * halo
    stride = (wid + 6) // 4 * 4
    pc = PIECE if vec else 1
    pad = (PIECE - halo % PIECE) % PIECE if vec else 0
    return wid, stride, stride // 4, pc, pad


def row_split(per):
    """csrc RowSplit: lane -> (row offset, first item) for rows of
    ``per`` items; (rows a warp covers, lane map)."""
    if per >= 32 or per < 1:
        return 1, [(0, lane) for lane in range(32)]
    rows = 32 // per
    return rows, [(lane // per, lane % per) for lane in range(32)]


class Launch:
    """One emulated launch of the fused kernel over ``ctas`` persistent
    CTAs with a ring of ``stages`` slots."""

    def __init__(self, src, dst, plan, n, block, halo, steps, rule,
                 stages, ctas):
        self.src = src.numpy().reshape(-1)
        self.dst = dst.numpy().reshape(-1)  # written in place
        self.plan, self.n, self.block, self.rule = plan, n, block, rule
        self.halo, self.nsteps, self.S, self.G = halo, steps, stages, ctas
        self.p = p = plan.launch_params(n, block, "cpu")
        self.vec = block % PIECE == 0 and p.pitch % PIECE == 0
        (self.wid, self.stride, self.ngr, self.pc,
         self.pad) = geometry(p, halo, self.vec)
        self.generic = p.family >= 2
        self.compact = plan.storage == "compact"
        total = p.steps
        bx, by, valid = plan.step_coords(0, total, "cpu")
        self.bx, self.by = bx.numpy(), by.numpy()
        self.valid = (np.ones(total, bool) if valid is None
                      else valid.numpy())
        self.org = self._origins()
        self.gtab, self.ssrc, self.sdst = self._tables()
        self.events = []   # ("issue" | "compute", step, slot)
        self.zero_pieces = {}  # step -> bool (wid, npieces): zero-filled
        self.tiles_seen = {}   # step -> the landed tile it computed on
        self.masks_seen = {}

    # -- the CTA's tables and each step's nine origins ----------------------

    def _origins(self):
        """(steps, 9, 2) storage origins (row, col) in cells, slot
        (dy + 1) * 3 + dx + 1; -1 for a fractal neighbour out of range
        or not a member (never read)."""
        plan, p, total = self.plan, self.p, self.p.steps
        org = np.full((total, 9, 2), -1, np.int64)
        if not self.compact:
            return org
        th, tw = plan.supertile_shape((self.block, self.block))
        row, col = plan.storage_index(0, total, "cpu")
        org[:, 4] = np.stack([row.numpy() * th, col.numpy() * tw], 1)
        nbx, nby = plan.sched_domain.bounding_box
        for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
            row, col = plan.neighbor_index(j, 0, total, "cpu")
            o = np.stack([row.numpy() * th, col.numpy() * tw], 1)
            if not self.generic:
                x, y = self.bx + dx, self.by + dy
                inr = (x >= 0) & (y >= 0) & (x < nbx) & (y < nby)
                ok = inr & plan.sched_domain.contains(
                    torch.from_numpy(np.clip(x, 0, nbx - 1)),
                    torch.from_numpy(np.clip(y, 0, nby - 1))).numpy()
                o[~ok] = -1
            org[:, (dy + 1) * 3 + dx + 1] = o
        return org

    def _tables(self):
        """gtab[fy * s + fx]: a fine block's storage offset from its
        supertile's origin; ssrc[q] / sdst[q]: packed fine block q's tile
        and storage offsets (the store)."""
        p, b, s = self.p, self.block, self.p.coarsen
        perm = None if p.tile_perm is None else p.tile_perm.numpy()
        gtab = np.zeros(s * s, np.int64)
        for i in range(s * s):
            q = perm[2 * p.nfine + i] if perm is not None else i
            if q >= 0:
                gtab[i] = (q // p.bw) * b * p.pitch + (q % p.bw) * b
        ssrc = np.zeros(p.nfine, np.int64)
        sdst = np.zeros(p.nfine, np.int64)
        h = self.halo
        for q in range(p.nfine):
            ey, ex = ((perm[2 * q], perm[2 * q + 1]) if perm is not None
                      else (q // p.bw, q % p.bw))
            ssrc[q] = (h + ey * b) * self.stride + self.pad + h + ex * b
            sdst[q] = (q // p.bw) * b * p.pitch + (q % p.bw) * b
        return gtab, ssrc, sdst

    # -- the CTA's walk ----------------------------------------------------

    def walk(self, c):
        """The steps CTA c resolves, in order, then -1 forever."""
        total, G = self.p.steps, self.G
        batch = SCAN if self.plan.lowering == "bounding" else 1
        cursor = c
        while True:
            t = -1
            while cursor < total:
                cand = cursor + np.arange(batch) * G
                ok = cand < total
                ok[ok] = self.valid[cand[ok]]
                if ok.any():
                    t = int(cand[np.argmax(ok)])
                    cursor = t + G
                    break
                cursor += batch * G
            yield t

    # -- gather: pieces and mask bytes of one step -------------------------

    def gather(self, t):
        """The copies of step t's working tile, as (flat shared index,
        values) with zero-filled pieces, and its mask bytes."""
        p, n, b, s = self.p, self.n, self.block, self.p.coarsen
        wid, stride, pc, pad = self.wid, self.stride, self.pc, self.pad
        bx, by = int(self.bx[t]), int(self.by[t])
        gx0, gy0 = bx * p.span - self.halo, by * p.span - self.halo
        npieces = (pad + wid + pc - 1) // pc
        # per row, once
        gy = gy0 + np.arange(wid)[:, None]
        row_in = (gy >= 0) & (gy < n)
        fby = np.where(row_in, gy // b, 0)
        oy = gy - fby * b
        cby = fby // s
        fy = fby - cby * s
        rdy = cby - by
        # per piece
        gx = gx0 - pad + np.arange(npieces)[None, :] * pc
        ok = row_in & (gx >= 0) & (gx < n)
        fbx = np.where(ok, gx // b, 0)
        fbyb = np.broadcast_to(fby, ok.shape)
        ox = gx - fbx * b
        member = self.plan.domain.contains(
            torch.from_numpy(fbx), torch.from_numpy(fbyb.copy())).numpy()
        ok = ok & member
        org = self.org[t]
        if not self.compact:
            if self.generic:
                nbx, nby = self.plan.sched_domain.bounding_box
                tx, ty = np.minimum(fbx, nbx - 1), np.minimum(fby, nby - 1)
                off = (ty * b + oy) * p.pitch + tx * b + ox
            else:
                off = gy * p.pitch + gx
        else:
            if self.generic:
                slot = (fby - by + 1) * 3 + (fbx - bx + 1)
                gt = 0
            else:
                cbx = fbx // s
                slot = (rdy + 1) * 3 + (cbx - bx) + 1
                gt = self.gtab[fy * s + (fbx - cbx * s)]
            slot = np.where(ok, slot, 4)
            orow, ocol = org[slot, 0], org[slot, 1]
            assert (orow[ok] >= 0).all(), "a read piece of an invalid origin"
            off = (orow + oy) * p.pitch + ocol + gt + ox
        off = np.where(ok, off, 0)
        cells = off[..., None] + np.arange(pc)
        assert (cells[ok] < self.src.size).all()
        vals = np.where(ok[..., None], self.src[cells], np.float32(0))
        dst_idx = (np.arange(wid)[:, None, None] * stride
                   + np.arange(npieces)[None, :, None] * pc
                   + np.arange(pc))
        self.zero_pieces[t] = ~ok
        # the cell mask: a byte of 4 bits per 4 shared columns
        ngroups = (pad + wid + 3) // 4
        x = 4 * np.arange(ngroups)[None, :, None] - pad + np.arange(4)
        gxc = gx0 + x
        live = (x >= 0) & (x < wid) & row_in[..., None] & (gxc >= 0) \
            & (gxc < n)
        if not self.generic:
            gyb = np.broadcast_to(gy[..., None], live.shape)
            cm = self.plan.domain.cell_member(
                torch.from_numpy(np.clip(gxc, 0, n - 1)).expand(
                    live.shape).contiguous(),
                torch.from_numpy(np.clip(gyb, 0, n - 1).copy()), n).numpy()
            live = live & cm
        mbytes = (live.astype(np.uint8) << np.arange(4, dtype=np.uint8)).sum(
            -1).astype(np.uint8)
        return dst_idx.reshape(-1), vals.reshape(-1), mbytes

    # -- compute: the trapezoid and the store --------------------------------

    def compute(self, t, tile, buf, mbytes):
        p, b = self.p, self.block
        wid, stride, ngr, pc, pad = (self.wid, self.stride, self.ngr,
                                     self.pc, self.pad)
        cur, nxt = tile, buf
        al = np.float32(ALPHA)
        mflat = mbytes.reshape(-1)

        def bit(r, c):
            # the mask bit of shared column c (-1 and 4 ngr reach into
            # the neighbouring rows' bytes, as the kernel's loads do)
            return (mflat[r * ngr + (c >> 2)] >> (c & 3)) & 1

        for i in range(self.nsteps):
            lo, hi = i + 1, wid - i - 1
            g0, g1 = (lo + pad) >> 2, (hi - 1 + pad) >> 2
            rows, lanes = row_split(g1 - g0 + 1)
            assert all(lr < rows or lr >= rows for lr, _ in lanes)
            r = np.arange(lo, hi)[:, None]
            c = np.arange(4 * g0, 4 * g1 + 4)[None, :]  # whole groups
            ro = r * stride  # the row's offset, once per row
            idx = ro + c
            ok = bit(r, c) != 0
            pv = cur[idx]
            with np.errstate(all="ignore"):  # garbage past the region
                nsum = ((cur[idx - stride] + cur[idx + stride])
                        + cur[idx - 1]) + cur[idx + 1]
                if self.rule == "parity":
                    out = mod2(pv + nsum)
                else:
                    deg = (bit(r - 1, c) + bit(r + 1, c) + bit(r, c - 1)
                           + bit(r, c + 1)).astype(np.float32)
                    out = pv + al * (nsum - deg * pv)
            nxt[idx] = np.where(ok, out, np.float32(0))
            cur, nxt = nxt, cur
        # the store, per fine-block row in pieces
        if self.compact:
            row0, col0 = self.org[t, 4]
        else:
            row0, col0 = self.by[t] * p.span, self.bx[t] * p.span
        base = row0 * p.pitch + col0
        ppr = b // pc
        c = np.arange(p.nfine * b * ppr)
        fr = c // ppr
        q, cy, x = fr // b, fr % b, (c % ppr) * pc
        frm = self.ssrc[q] + cy * stride + x
        to = base + self.sdst[q] + cy * p.pitch + x
        for e in range(pc):
            self.dst[to + e] = cur[frm + e]

    # -- the CTA's ring ------------------------------------------------------

    def run_cta(self, c, rng):
        mma = self.plan.lowering == "mma"
        S = self.S
        E = S + (BATCH if mma else 1)
        size = self.wid * self.stride
        # shared memory starts out holding garbage
        tiles = rng.normal(size=(S + 1, size)).astype(np.float32)
        masks = rng.integers(0, 256, size=(S, self.wid, self.ngr),
                             dtype=np.uint8)
        ent = [None] * E
        walk = self.walk(c)
        pending, group = deque(), []

        def issue(t, sl):
            idx, vals, mbytes = self.gather(t)
            masks[sl, :, :mbytes.shape[1]] = mbytes  # plain stores at issue
            group.append((sl, idx, vals))
            self.events.append(("issue", t, sl))

        def commit():
            pending.append(list(group))
            group.clear()

        def wait(n_pending):
            while len(pending) > n_pending:
                for sl, idx, vals in pending.popleft():
                    tiles[sl, idx] = vals

        for k in range(BATCH if mma else S):
            ent[k % E] = next(walk)
        for k in range(S - 1):
            if ent[k] >= 0:
                issue(ent[k], k)
            commit()
        i = 0
        while True:
            t = ent[i % E]
            if S == 1:
                if t >= 0:
                    issue(t, 0)
                commit()
            wait(0 if S == 1 else S - 2)
            if t < 0:
                return
            if S > 1:
                f = ent[(i + S - 1) % E]
                if f >= 0:
                    issue(f, (i + S - 1) % S)
                commit()
            # the entries a resolve overwrites held steps that are done
            live = {(i + j) % E for j in range(S)}
            if not mma:
                assert (i + S) % E not in live
                ent[(i + S) % E] = next(walk)
            elif (i + S) % BATCH == 0:
                for j in range(BATCH):
                    assert (i + S + j) % E not in live
                    ent[(i + S + j) % E] = next(walk)
            sl = i % S
            self.events.append(("compute", t, sl))
            self.tiles_seen[t] = tiles[sl].copy()
            self.masks_seen[t] = masks[sl].copy()
            self.compute(t, tiles[sl], tiles[S], masks[sl])
            i += 1

    def run(self, seed=0):
        rng = np.random.default_rng(seed)
        for c in range(min(self.G, self.p.steps)):
            self.run_cta(c, rng)
        return torch.from_numpy(self.dst.reshape(self.plan.state_shape(
            self.block)))


# ---------------------------------------------------------------------------
# cases: (name, domain factory or fractal, n or None, block, coarsen, halo)
# ---------------------------------------------------------------------------

FRACTAL_CASES = [
    ("sierpinski-gasket", 32, 4, 1, 3),    # 16-byte pieces, pad 1
    ("sierpinski-gasket", 64, 8, 2, 5),    # coarsened, pad 3
    ("sierpinski-gasket", 32, 4, 2, 8),    # halo = span
    ("sierpinski-gasket", 16, 2, 2, 2),    # 2-cell blocks: 4-byte copies
    ("sierpinski-carpet", 27, 3, 1, 2),
    ("sierpinski-carpet", 27, 3, 3, 4),
    ("vicsek-cross", 27, 3, 3, 3),
]
DOMAIN_CASES = [
    ("triangular", lambda: D.TriangularDomain(6), 4, 2),
    ("band", lambda: D.BandDomain(6, 2), 4, 3),
    ("band-rect", lambda: D.BandDomain(4, 2, 7), 4, 1),
    ("bounding-box", lambda: D.BoundingBoxDomain(5, 3), 4, 4),
    ("triangular-b2", lambda: D.TriangularDomain(5), 2, 2),
]


def fractal_buffers(fractal, n, block, storage, rule, seed):
    x = torch.from_numpy(fractal_state(fractal, n, rule == "parity",
                                       seed=seed))
    if storage == "compact":
        lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
        x = lay.pack(x, block)
    return x.contiguous()


def domain_buffers(dom, block, storage, rule, seed):
    lay = compact_layout(dom)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = np.random.default_rng(seed)
    x = g.integers(0, 2, shape) if rule == "parity" else g.normal(size=shape)
    return torch.from_numpy(x.astype(np.float32))


def plan_for(case, storage, lowering, rule, seed=1):
    """(state, plan, n, block, halo) of a fractal or domain case."""
    if case[0] in dict((c[0], 1) for c in FRACTAL_CASES) and \
            isinstance(case[1], int):
        fractal, n, block, coarsen, halo = case
        a = fractal_buffers(fractal, n, block, storage, rule, seed)
        plan, n_, blk = TC.prepare_run(
            a, torch.zeros_like(a), block=block, grid_mode=lowering,
            fractal=fractal, storage=storage, n=n, coarsen=coarsen)
    else:
        _, make, block, halo = case
        dom = make()
        a = domain_buffers(dom, block, storage, rule, seed)
        plan, n_, blk = TC.prepare_run(a, torch.zeros_like(a), block=block,
                                       grid_mode=lowering, storage=storage,
                                       domain=dom)
    halo = TC.effective_fuse(halo, halo, blk, plan.coarsen)
    return a, plan, n_, blk, halo


ALL_CASES = FRACTAL_CASES + DOMAIN_CASES
CASE_IDS = [f"{c[0]}-{c[2] if isinstance(c[1], int) else c[2]}-"
            f"{c[3] if isinstance(c[1], int) else ''}" for c in ALL_CASES]


def run_both(case, storage, lowering, rule, stages, ctas, steps=None):
    a, plan, n, block, halo = plan_for(case, storage, lowering, rule)
    steps = halo if steps is None else steps
    stale = torch.full_like(a, 7.0)  # unvisited blocks keep these
    want = TC.ca_launch_plain(a, stale.clone(), plan, n, block, halo, steps,
                              rule, ALPHA)
    em = Launch(a, stale.clone(), plan, n, block, halo, steps, rule, stages,
                ctas)
    return em, em.run(), want


# ---------------------------------------------------------------------------
# the emulation against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ALL_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_emulated_kernel_bit_equal_to_plain(case, storage, lowering):
    # every depth, both rules, a remainder launch (steps < halo) and a
    # CTA count that leaves CTAs with unequal runs
    for stages, rule in ((1, "parity"), (2, "diffusion"), (3, "parity"),
                         (3, "diffusion")):
        em, got, want = run_both(case, storage, lowering, rule, stages, 3)
        assert torch.equal(got, want), (stages, rule)
    _, plan, *_ = plan_for(case, storage, lowering, "parity")
    if plan.steps_per_launch > 1:
        em, got, want = run_both(case, storage, lowering, "diffusion", 2, 2,
                                 steps=1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("ctas", [1, 3, 7, 64])
def test_persistent_ctas_take_every_member_step_once(lowering, ctas):
    # the CTAs' walks cover exactly the member steps of step_coords, each
    # once, CTA c its own residue class in increasing order; under
    # bounding the 32-step scan skips the others
    for case in (FRACTAL_CASES[1], DOMAIN_CASES[0]):
        a, plan, n, block, halo = plan_for(case, "compact", lowering,
                                           "parity")
        em = Launch(a, torch.zeros_like(a), plan, n, block, halo, 1,
                    "parity", 2, ctas)
        em.run()
        done = [t for kind, t, _ in em.events if kind == "compute"]
        bx, by, valid = plan.step_coords(0, plan.steps_per_launch, "cpu")
        members = np.arange(plan.steps_per_launch)
        if valid is not None:
            members = members[valid.numpy()]
        assert sorted(done) == members.tolist()
        for c in range(ctas):
            mine = [t for t in done if t % ctas == c]
            assert mine == sorted(mine)
        # the block each step computed is the plan's decode of it
        assert np.array_equal(em.bx[done], bx.numpy()[done])
        assert np.array_equal(em.by[done], by.numpy()[done])


def walk_ctas(ctas, nbx, lowering):
    """csrc walk_ctas: under bounding, one CTA fewer at a time until the
    grid stride is coprime with the box's width."""
    if lowering != "bounding":
        return ctas
    while ctas > 1 and math.gcd(ctas, nbx) != 1:
        ctas -= 1
    return ctas


def test_bounding_walk_balances_the_ctas():
    # the gasket's box columns hold 2^(r - popcount(bx)) members: a stride
    # that shares a factor with the width hands each CTA a fixed set of
    # column residues (here 32 CTAs over 64 columns: 32x apart in work), a
    # coprime one (walk_ctas: 31) spreads every CTA over all of them
    from repro_torch.core.domain import SierpinskiDomain
    dom = SierpinskiDomain(64)
    nbx, nby = dom.bounding_box
    t = torch.arange(nbx * nby)
    member = dom.contains(t % nbx, t // nbx).numpy()

    def spread(g):
        work = [int(member[c::g].sum()) for c in range(g)]
        return max(work) / max(1, min(work))

    assert spread(32) >= 32
    g = walk_ctas(32, nbx, "bounding")
    assert g == 31 and spread(g) <= 2
    assert walk_ctas(32, nbx, "closed_form") == 32


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_ring_prologue_and_slot_order(stages):
    # one CTA: the prologue issues steps 0 .. S-2 into slots 0 .. S-2;
    # step j is issued into slot j % S before it is computed there, and
    # slot j % S is issued again (step j + S) only after step j computed
    a, plan, n, block, halo = plan_for(FRACTAL_CASES[1], "compact",
                                       "closed_form", "parity")
    em = Launch(a, torch.zeros_like(a), plan, n, block, halo, halo,
                "parity", stages, 1)
    em.run()
    ev = em.events
    issues = [(t, sl) for kind, t, sl in ev if kind == "issue"]
    assert issues[:max(stages - 1, 1)] == [(j, j % stages) for j in
                                           range(max(stages - 1, 1))]
    pos = {(kind, t): k for k, (kind, t, _) in enumerate(ev)}
    total = plan.steps_per_launch
    for kind, t, sl in ev:
        assert sl == t % stages
    for t in range(total):
        assert pos[("issue", t)] < pos[("compute", t)]
        if t + stages < total:
            assert pos[("compute", t)] < pos[("issue", t + stages)]
        if stages > 1 and t + stages - 1 < total and t > 0:
            # the copies of step t + S - 1 fly while step t computes
            assert pos[("issue", t + stages - 1)] < pos[("compute", t)]


@pytest.mark.parametrize("case", ALL_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
def test_gathered_tile_zero_pieces_and_cell_mask(case, storage):
    # each step's landed tile is the plain version's masked working tile
    # (zero where the fine block is out of range or not a member: exactly
    # the zero-filled pieces), and its mask bytes hold cell_ok bit by bit
    a, plan, n, block, halo = plan_for(case, storage, "closed_form",
                                       "diffusion")
    em = Launch(a, torch.zeros_like(a), plan, n, block, halo, 1,
                "diffusion", 2, 2)
    em.run()
    wid, stride, pad, pc = em.wid, em.stride, em.pad, em.pc
    span, dev = plan.coarsen * block, "cpu"
    oy, ox = TW.supertile_offsets(plan, block, dev)
    th, tw = plan.supertile_shape((block, block))
    spans = {-1: (span - halo, 0, halo), 0: (0, halo, span),
             1: (0, span + halo, halo)}
    flat = a.reshape(-1)
    for t, tile in em.tiles_seen.items():
        P = torch.zeros((wid, wid))
        for j, (dx, dy) in [(None, (0, 0))] + list(enumerate(
                NEIGHBOR_OFFSETS8)):
            row, col = (plan.storage_index(t, t + 1, dev) if j is None
                        else plan.neighbor_index(j, t, t + 1, dev))
            tile_v = flat[TW.storage_offsets(plan, row, col, block, dev)]
            e = torch.zeros((1, span, span))
            e[:, oy, ox] = tile_v
            r_src, r_dst, nr = spans[dy]
            c_src, c_dst, nc = spans[dx]
            P[r_dst:r_dst + nr, c_dst:c_dst + nc] = \
                e[0, r_src:r_src + nr, c_src:c_src + nc]
        iy = torch.arange(wid)[:, None]
        ix = torch.arange(wid)[None, :]
        gx = int(em.bx[t]) * span - halo + ix
        gy = int(em.by[t]) * span - halo + iy
        inr = (gx >= 0) & (gx < n) & (gy >= 0) & (gy < n)
        gxc, gyc = gx.clamp(0, n - 1), gy.clamp(0, n - 1)
        block_ok = inr & plan.domain.contains(gxc // block, gyc // block)
        cell_ok = inr & plan.domain.cell_member(gxc, gyc, n) \
            if em.generic is False else inr
        want = torch.where(block_ok, P, 0).numpy()
        got = tile.reshape(wid, stride)[:, pad:pad + wid]
        assert np.array_equal(got, want), t
        # zero-filled pieces: those covering a cell that is not block_ok
        zp = em.zero_pieces[t]
        cover = np.zeros_like(zp)
        for k in range(zp.shape[1]):
            cols = [c - pad for c in range(k * pc, k * pc + pc)
                    if 0 <= c - pad < wid]
            if cols:
                cover[:, k] = ~block_ok.numpy()[:, cols].all(1)
        assert np.array_equal(zp[:, [k for k in range(zp.shape[1])
                                     if 0 <= k * pc - pad + pc - 1
                                     and k * pc - pad < wid]],
                              cover[:, [k for k in range(zp.shape[1])
                                        if 0 <= k * pc - pad + pc - 1
                                        and k * pc - pad < wid]])
        mb = em.masks_seen[t]
        bits = (mb[:, :, None] >> np.arange(4, dtype=np.uint8)) & 1
        assert np.array_equal(
            bits.reshape(wid, -1)[:, pad:pad + wid].astype(bool),
            cell_ok.numpy())


def trapezoid_assignment(wid, pad, nwarps, steps):
    """csrc compute()'s work split of trapezoid steps ``steps``: for each
    (step, row, group) the (warp, lane) that computes it.  Returns
    {step: (owner, lo, hi)}."""
    out = {}
    for i in steps:
        lo, hi = i + 1, wid - i - 1
        if lo >= hi:
            break
        g0 = (lo + pad) >> 2
        per = ((hi - 1 + pad) >> 2) - g0 + 1
        rows, lanes = row_split(per)
        step = per if per < 32 else 32
        owner = {}
        for w in range(nwarps):
            for lane, (lr, li) in enumerate(lanes):
                if lr >= rows:
                    continue
                for r in range(lo + w * rows + lr, hi, nwarps * rows):
                    for k in range(li, per, step):
                        key = (r, g0 + k)
                        assert key not in owner, key
                        owner[key] = (w, lane)
        out[i] = (owner, lo, hi)
    return out


@pytest.mark.parametrize("nwarps", [4, 8])
def test_trapezoid_groups_cover_the_region_once(nwarps):
    # every row of every step's region and every 4-column group that
    # meets it is computed by exactly one lane, short rows packed into a
    # warp (RowSplit)
    for wid in (6, 10, 34, 48, 66, 96, 130):
        steps = sorted({0, 1, 2, wid // 4, wid // 2 - 2, wid // 2 - 1})
        for pad in (0, 1, 2, 3):
            for i, (owner, lo, hi) in trapezoid_assignment(
                    wid, pad, nwarps, steps).items():
                groups = range((lo + pad) >> 2, ((hi - 1 + pad) >> 2) + 1)
                assert set(owner) == {(r, g) for r in range(lo, hi)
                                      for g in groups}


def test_gather_columns_cover_each_piece_once():
    # csrc gather(): a lane keeps its piece column for every row it
    # takes; over the CTA's warps every (row, piece) is copied once
    for nwarps in (4, 8):
        for wid in (3, 10, 34, 48, 130, 200):
            for npieces in {wid, (wid + 3 + 3) // 4}:
                rows, lanes = row_split(npieces)
                step = npieces if npieces < 32 else 32
                seen = []
                for w in range(nwarps):
                    for lr, li in lanes:
                        if lr >= rows:
                            continue
                        for k in range(li, npieces, step):
                            for iy in range(w * rows + lr, wid,
                                            nwarps * rows):
                                seen.append((iy, k))
                assert sorted(seen) == [(iy, k) for iy in range(wid)
                                        for k in range(npieces)]


def test_pad_puts_fine_blocks_on_piece_boundaries():
    # with 16-byte pieces every fine-block boundary of a working row
    # (global column a multiple of the block) lands on a shared column
    # that is a multiple of 4, for every halo depth
    for block in (4, 8, 32):
        for halo in range(1, 2 * block + 1):
            pad = (PIECE - halo % PIECE) % PIECE
            for bx in range(3):
                gx0 = bx * block - halo
                for ix in range(block + 2 * halo):
                    if (gx0 + ix) % block == 0:
                        assert (ix + pad) % PIECE == 0


def test_mod2_is_the_floor_mod_bit_for_bit():
    x = np.concatenate([
        np.arange(-12, 13, dtype=np.float32),
        np.array([-0.0, 0.0, 0.5, -0.5, 1.5, -1.5, 2.0 - 2 ** -22,
                  -(2.0 - 2 ** -22), 1e-40, -1e-40, 3e7, -3e7, 2 ** 24 + 2,
                  -(2 ** 24 + 2), 123.25, -123.25], np.float32),
        np.random.default_rng(0).normal(scale=50, size=500).astype(
            np.float32)])
    r = np.fmod(x, np.float32(2))
    want = np.where((r != 0) & (r < 0), r + np.float32(2), r).astype(
        np.float32)
    assert np.array_equal(mod2(x).view(np.int32), want.view(np.int32))
    tx = torch.from_numpy(x)
    assert torch.equal(torch.from_numpy(mod2(x)), TC._floor_mod2(tx))
