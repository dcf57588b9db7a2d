"""A torch emulation of the split-K decode kernels' order
(``csrc/decode_split.cuh``, run by ``flash_decode_kernel`` and
``paged_decode_kernel``), held against tpu-interpret ``repro`` and the
port's plain versions on the CPU, as ``test_torch_write_tiles.py``
emulates the write kernels.

The emulation follows the kernels step by step: the split rule (key
blocks [j T, j T + T - 1] of the extent, T = SPLIT_KEYS / block_k), the
warps' fixed key batches, each key row's lanes (a lane's values summed in
order, then a butterfly over the row's lanes), one online-softmax step
per batch, the key groups of a warp summed by a butterfly, the merge in
warp order and then in split order (the last CTA to arrive merges, in
split order whatever the arrival order).  Its arithmetic is f32 torch
ops, not the kernels' fma and SFU exp: the point is the order and the
partition.
Tolerances: f32 within 2e-5, bf16 within 2e-2 and ``ROW_RTOL`` (the
kernels' own, ``FA._compare``).

Constants mirror csrc/decode_split.cuh: SPLIT_KEYS (kSplitKeys), WARPS
(kWarps), MAX_GROUP (kMaxGroup) and rounds().
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import paged_flash_attention as jpaged
from repro_torch.core import paged as TP
from repro_torch.core.plan import LOWERINGS
from torch_parity import as_f32, attn_pair

FA = importlib.import_module("repro_torch.kernels.flash_attention")

SPLIT_KEYS = 256
WARPS = 8
MAX_GROUP = 8
NEG = -1e30


def split_blocks(bk):
    return 1 if bk >= SPLIT_KEYS else SPLIT_KEYS // bk


class Geometry:
    """make_args of csrc/decode_split.cuh: lanes per row, 16-byte chunks
    per lane, the head chunk, rounds per batch."""

    def __init__(self, d, elt, h, hkv):
        self.vec = 16 // elt
        chunks = -(-d // self.vec)
        self.lpk = 1
        while self.lpk < chunks and self.lpk < 32:
            self.lpk *= 2
        self.cpl = -(-chunks // self.lpk)
        self.kpw = 32 // self.lpk
        self.kg = 2 if h // hkv <= 2 else MAX_GROUP
        self.rounds = 2 if self.kg * self.cpl >= 8 else 4
        # the lane that holds value e of a row, and its place in the lane
        lanes = torch.full((self.lpk, self.cpl * self.vec), -1,
                           dtype=torch.long)
        for e in range(d):
            gc = e // self.vec
            lanes[gc % self.lpk, (gc // self.lpk) * self.vec
                  + e % self.vec] = e
        self.lanes = lanes


def splits(start, end, bk):
    """The live splits (j, first block, last block) in split order: a
    function of the extent and block_k alone."""
    if start > end:
        return []
    t = split_blocks(bk)
    return [(j, max(start, j * t), min(end, j * t + t - 1))
            for j in range(start // t, end // t + 1)]


def warp_batches(nkeys, geo):
    """The warps' batches as (WARPS, rounds, kpw) split-relative key
    indices, batch n of warp w from key (n WARPS + w) kpw rounds, round r
    and key group u at + r kpw + u; an index >= nkeys lies past the split
    (a warp whose batches ran out: the kernel skips it, and here it is an
    update that changes nothing, bit for bit)."""
    kpb = geo.kpw * geo.rounds
    grid = (torch.arange(WARPS)[:, None, None] * kpb
            + torch.arange(geo.rounds)[None, :, None] * geo.kpw
            + torch.arange(geo.kpw)[None, None, :])
    return [n * WARPS * kpb + grid for n in range(-(-nkeys // (WARPS * kpb)))]


def butterfly(x, offs):
    """A lane-axis (dim 0) xor butterfly over ``offs``, in that order;
    every lane ends with the same sum (f32 addition commutes): lane 0's."""
    idx = torch.arange(x.shape[0])
    for off in offs:
        x = x + x[idx ^ off]
    return x[0]


def lane_dot(qf, rows, geo):
    """Scores of (..., d) rows for every head: each lane sums its values
    in order, then the row's lanes combine by a butterfly over offsets
    lpk / 2 .. 1.  qf (H, d); rows (..., H, d) -> (..., H)."""
    pad = lambda x: torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], -1)  # noqa: E731
    ql, rl = pad(qf)[..., geo.lanes], pad(rows)[..., geo.lanes]
    dot = ql[..., 0] * rl[..., 0]
    for i in range(1, geo.lanes.shape[1]):
        dot = dot + ql[..., i] * rl[..., i]
    dot = dot.movedim(-1, 0)  # the lane axis first
    offs = [geo.lpk >> s for s in range(1, geo.lpk.bit_length())]
    return butterfly(dot, offs)


def merge(parts):
    """Parts (m (H,), l (H,), acc (H, d)) merged in list order: M = max m,
    c = exp(m - M), l = sum c l, acc = sum c acc."""
    mx = torch.stack([p[0] for p in parts]).amax(0)
    lt = torch.zeros_like(mx)
    at = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        c = torch.exp(m - mx)
        lt = lt + c * l
        at = at + c[:, None] * acc
    return mx, lt, at


def warp_states(qf, rows, k0, nkeys, live_key, geo, group):
    """Every warp's online state over its batches: [(m, l, acc)] in warp
    order, per q head, acc summed over the warp's key groups by the
    butterfly over lane offsets lpk .. 16 (key groups 1 .. kpw / 2)."""
    h, d = qf.shape
    m = torch.full((WARPS, 1, h), NEG)
    l = torch.zeros(WARPS, 1, h)
    acc = torch.zeros(WARPS, geo.kpw, h, d)   # per warp and key group
    sub = [1 << s for s in range(geo.kpw.bit_length() - 1)]
    for idx in warp_batches(nkeys, geo):
        kpos = k0 + idx
        live = (idx < nkeys) & live_key(kpos)             # (W, R, kpw)
        k, v = rows(torch.where(live, kpos, k0))          # (W, R, kpw, Hkv, d)
        k = torch.where(live[..., None, None], k, 0.0)
        v = torch.where(live[..., None, None], v, 0.0)
        k, v = k.repeat_interleave(group, -2), v.repeat_interleave(group, -2)
        s = torch.where(live[..., None], lane_dot(qf, k, geo), NEG)
        m_new = torch.maximum(m, s.amax((1, 2))[:, None])
        alpha = torch.exp(m - m_new)                      # (W, 1, H)
        p = torch.where(live[..., None], torch.exp(s - m_new[:, None]), 0.0)
        psum = torch.zeros(WARPS, geo.kpw, h)
        pv = torch.zeros(WARPS, geo.kpw, h, d)
        for r in range(geo.rounds):
            psum = psum + p[:, r]
            pv = pv + p[:, r][..., None] * v[:, r]
        l = alpha * l + butterfly(psum.movedim(1, 0), sub)[:, None]
        m = m_new
        acc = acc * alpha[..., None] + pv
    acc = butterfly(acc.movedim(1, 0), sub)
    return [(m[w, 0], l[w, 0], acc[w]) for w in range(WARPS)]


def emulate(qf, rows, start, end, pos, window, bk, geo, group,
            member=None, arrival=None):
    """The decode of one slot: qf (H, d) pre-scaled f32 queries; rows(kpos)
    -> (K, V) rows (..., Hkv, d) of key positions; [start, end] the
    key-block extent.  ``arrival`` orders the CTAs' arrival (the last
    merges, in split order).  Returns (out (H, d) f32, warp states per
    split)."""
    def live_key(kpos):
        ok = kpos <= pos
        if window:
            ok = ok & (kpos > pos - window)
        if member is not None:
            ok = ok & member(torch.div(kpos, bk, rounding_mode="floor"))
        return ok

    parts, states = {}, {}
    for j, tlo, thi in splits(start, end, bk):
        k0, nkeys = tlo * bk, (thi - tlo + 1) * bk
        states[j] = warp_states(qf, rows, k0, nkeys, live_key, geo, group)
        parts[j] = merge(states[j])
    if not parts:
        return torch.zeros_like(qf), states
    arrived = sorted(parts) if arrival is None else arrival(sorted(parts))
    assert sorted(arrived) == sorted(parts)
    # the last CTA to arrive merges every part, in split order
    _, lt, at = merge([parts[j] for j in sorted(parts)])
    return at / torch.where(lt == 0, 1.0, lt)[:, None], states


def contiguous_extent(sched, pos, lowering_bounds):
    start, end = (int(x) for x in lowering_bounds[0])
    end = min(end, pos // sched.block_k)
    if sched.window:
        start = max(start, max(pos - sched.window + 1, 0) // sched.block_k)
    return start, end


def paged_extent(pos, window, ps, max_pages):
    start = max(pos - window + 1, 0) // ps if window else 0
    return start, min(pos // ps, max_pages - 1)


def emulate_contiguous(q, k, v, sched, pos, arrival=None):
    """The emulated flash_decode_kernel: (B, H, 1, d) in q's dtype."""
    b, h, _, d = q.shape
    geo = Geometry(d, q.element_size(), h, sched.hkv)
    bounds = sched.row_bounds()
    member = None
    if sched.lowering == "bounding":
        member = lambda kb: sched.member(kb, torch.zeros_like(kb))  # noqa: E731
    kf, vf = k.float(), v.float()
    out = []
    for i in range(b):
        p = int(pos[i])
        start, end = contiguous_extent(sched, p, bounds)

        def rows(kpos, i=i):
            kv = (torch.div(kpos, sched.block_k, rounding_mode="floor")
                  - sched.s0).clamp(0, sched.kv_blocks - 1)
            r = kv * sched.block_k + kpos % sched.block_k
            return (kf[i][:, r].movedim(0, -2), vf[i][:, r].movedim(0, -2))
        qf = q[i, :, 0].float() * sched.scale
        out.append(emulate(qf, rows, start, end, p, sched.window,
                           sched.block_k, geo, sched.group, member,
                           arrival)[0])
    return torch.stack(out)[:, :, None].to(q.dtype)


def emulate_paged(q, pool, table, pos, sched, split_rule=None):
    """The emulated paged_decode_kernel: (B, H, 1, d) in q's dtype."""
    b, h, _, d = q.shape
    geo = Geometry(d, q.element_size(), h, sched.hkv)
    ps = sched.page_size
    pf = pool.float()
    out = []
    for i in range(b):
        p = int(pos[i])
        start, end = paged_extent(p, sched.window, ps, sched.max_pages)

        def rows(kpos, i=i):
            page = table[i][torch.div(kpos, ps, rounding_mode="floor")]
            tile = pf[page]                         # (..., 2 Hkv, ps, d)
            off = (kpos % ps)[..., None, None, None].expand(
                tile.shape[:-3] + (2 * sched.hkv, 1, d))
            r = tile.gather(-2, off)[..., 0, :]      # (..., 2 Hkv, d)
            return r[..., 0::2, :], r[..., 1::2, :]
        qf = q[i, :, 0].float() * sched.scale
        out.append(emulate(qf, rows, start, end, p, sched.window, ps, geo,
                           sched.group)[0])
    return torch.stack(out)[:, :, None].to(q.dtype)


def paged_copy(k, v, ps, width, seed):
    """k, v (B, Hkv, S, D) scattered into a shuffled pool; the table has
    ``width`` columns (the slot's pages first, the null page after)."""
    b, hkv, s, d = k.shape
    npg = s // ps
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        b * npg) + 1)
    pool = TP.init_pool(b * npg + 1, hkv, ps, d, k.dtype, "cpu")
    table = torch.zeros((b, width), dtype=torch.int32)
    for i in range(b):
        table[i, :npg] = perm[i * npg:(i + 1) * npg].to(torch.int32)
        TP.write_prefill_pages(pool, table[i, :npg], k[i], v[i])
    return pool, table


#: llama4-maverick's 40 q heads over 8 kv heads: a group of 5, which
#: fills 5 of a head chunk's kMaxGroup = 8 rows
HEADS = {"GQA": (16, 8), "MQA": (8, 1), "MHA": (4, 4), "GQA5": (40, 8)}
#: positions at tile and split edges of 64-key blocks (T = 4 blocks)
POS = [63, 256, 511, 600]
SK = 640


def _case(heads, d, dtype, seed):
    h, hkv = HEADS[heads]
    (_, tq), (_, tk), (_, tv) = (attn_pair(s, seed + i, dtype) for i, s in
                                 enumerate([(4, h, 1, d), (4, hkv, SK, d),
                                            (4, hkv, SK, d)]))
    return tq, tk, tv


# ---------------------------------------------------------------------------
# the split rule and the partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bk", [16, 64, 128, 256, 1024])
@pytest.mark.parametrize("window", [0, 300])
def test_split_rule_partitions_the_extent_alike_paged_and_contiguous(bk,
                                                                     window):
    t = split_blocks(bk)
    assert t == max(1, SPLIT_KEYS // bk)
    for pos in [0, bk - 1, bk, 255, 256, 257, 1023, 4095]:
        m_k = 4096 // bk
        sched = FA.flash_schedule((1, 2, 1, 64), (1, 2, 4096, 64),
                                  kind="full", window=window, block_q=1,
                                  block_k=bk, has_pos=True)
        start, end = contiguous_extent(sched, pos, sched.row_bounds())
        got = splits(start, end, bk)
        # contiguous blocks, in split order, each inside one span of T
        blocks = [kb for _, lo, hi in got for kb in range(lo, hi + 1)]
        assert blocks == list(range(start, end + 1))
        assert all(lo // t == j == hi // t for j, lo, hi in got)
        # the paged front end at page_size == block_k: the same partition
        # whatever the table's width
        for width in (m_k, m_k + 1, 3 * m_k):
            assert splits(*paged_extent(pos, window, bk, width), bk) == got


def test_empty_extent_writes_zeros():
    geo = Geometry(64, 4, 2, 2)
    qf = torch.randn(2, 64)
    out, states = emulate(qf, None, 0, -1, -1, 0, 64, geo, 1)
    assert not states and torch.equal(out, torch.zeros(2, 64))


# ---------------------------------------------------------------------------
# against tpu-interpret repro and the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [h for h in HEADS if h != "GQA5"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_jax_and_plain(heads, d, window, dtype):
    _check_emulation(heads, d, window, dtype)


@pytest.mark.parametrize("dtype,window", [("bfloat16", 0),
                                          ("float32", 300)])
def test_emulation_matches_jax_and_plain_at_group_5(dtype, window):
    # llama4-maverick's decode: 40 q heads over 8 kv heads at D 128, each
    # CTA's chunk of kMaxGroup = 8 rows holding 5 live ones (each case
    # takes ~8 s: the dtype and the window alternate)
    _check_emulation("GQA5", 128, window, dtype)


def _check_emulation(heads, d, window, dtype):
    tq, tk, tv = _case(heads, d, dtype, seed=d + window)
    pos = torch.tensor(POS, dtype=torch.int32)
    # a lowering enters only through the extent (and bounding's skip):
    # the four give every row the same extent, and the emulation under
    # closed_form and bounding (its skip test) is bit-equal
    scheds = {gm: FA.flash_schedule(tq.shape, tk.shape, kind="full",
                                    window=window, block_q=1, block_k=64,
                                    grid_mode=gm, has_pos=True)
              for gm in LOWERINGS}
    extents = {gm: [contiguous_extent(sc, p, sc.row_bounds()) for p in POS]
               for gm, sc in scheds.items()}
    assert all(e == extents["closed_form"] for e in extents.values())
    assert all(FA.flash_route(sc, tq.dtype) == "decode"
               for sc in scheds.values())
    outs = [emulate_contiguous(tq, tk, tv, scheds[gm], pos)
            for gm in ("closed_form", "bounding")]
    assert torch.equal(outs[1], outs[0])
    FA._compare(outs[0], FA.flash_attention_plain(
        tq, tk, tv, scheds["closed_form"], pos), "emulated vs plain")
    # compact KV (kind full: support from block 0) is the same launch
    comp = FA.flash_schedule(tq.shape, tk.shape, kind="full", window=window,
                             block_q=1, block_k=64, storage="compact",
                             kv_seq_len=SK, has_pos=True)
    assert comp.s0 == 0
    assert torch.equal(emulate_contiguous(tq, tk, tv, comp, pos), outs[0])
    jq, jk, jv = (jnp.asarray(as_f32(t), jnp.float32 if dtype == "float32"
                              else jnp.bfloat16) for t in (tq, tk, tv))
    want = jops.flash_attention(jq, jk, jv, kind="full", window=window,
                                block_q=1, block_k=64,
                                seq_pos=jnp.asarray(POS, jnp.int32))
    FA._compare(outs[0], torch.tensor(as_f32(want)).to(tq.dtype),
                "emulated vs repro")
    # paged: the pool at page_size == block_k, a table wider than needed
    pool, table = paged_copy(tk, tv, 64, SK // 64 + 3, seed=d)
    psched = FA.paged_schedule(tq.shape, pool.shape, table.shape,
                               window=window)
    paged = emulate_paged(tq, pool, table, pos, psched)
    assert torch.equal(paged, outs[0])
    FA._compare(paged, FA.paged_attention_plain(tq, pool, table, pos, psched),
                "emulated paged vs plain")
    jwant = jpaged(jnp.asarray(as_f32(tq), jq.dtype),
                   jnp.asarray(as_f32(pool), jq.dtype), jnp.asarray(table),
                   jnp.asarray(POS, jnp.int32), window=window)
    FA._compare(paged, torch.tensor(as_f32(jwant)).to(tq.dtype),
                "emulated paged vs repro")


@pytest.mark.parametrize("ps,d", [(16, 64), (128, 256)])
def test_paged_bit_equal_to_contiguous_whatever_the_table_width(ps, d):
    tq, tk, tv = _case("GQA", d, "bfloat16", seed=ps)
    pos = torch.tensor([0, ps - 1, 300, SK - 1], dtype=torch.int32)
    sched = FA.flash_schedule(tq.shape, tk.shape, kind="full", window=300,
                              block_q=1, block_k=ps, has_pos=True)
    want = emulate_contiguous(tq, tk, tv, sched, pos)
    for width in (SK // ps, SK // ps + 1, 2 * SK // ps):
        pool, table = paged_copy(tk, tv, ps, width, seed=width)
        psched = FA.paged_schedule(tq.shape, pool.shape, table.shape,
                                   window=300)
        assert torch.equal(emulate_paged(tq, pool, table, pos, psched), want)


def test_merge_order_does_not_follow_the_arrival_order():
    # the last CTA to arrive merges; the result is the split-order merge
    # whichever CTA that is
    tq, tk, tv = _case("GQA", 128, "float32", seed=5)
    pos = torch.tensor(POS, dtype=torch.int32)
    sched = FA.flash_schedule(tq.shape, tk.shape, kind="full", block_q=1,
                              block_k=64, has_pos=True)
    want = emulate_contiguous(tq, tk, tv, sched, pos)
    for arrival in (lambda js: js[::-1],
                    lambda js: js[1:] + js[:1],
                    lambda js: sorted(js, key=lambda j: (j * 7) % 5)):
        assert torch.equal(
            emulate_contiguous(tq, tk, tv, sched, pos, arrival), want)


def test_a_warp_with_no_live_key_merges_to_nothing():
    # pos 20 in 64-key blocks: one split of 64 keys, of which 21 are live;
    # f32 d 64 takes 8 keys a warp batch, so warps 3-7 see no live key
    # (and with window 8, live keys 13-20, warp 0 holds only masked keys)
    tq, tk, tv = _case("MHA", 64, "float32", seed=9)
    h, d = tq.shape[1], tq.shape[3]
    geo = Geometry(d, 4, h, h)
    qf = tq[0, :, 0] * (1 / math.sqrt(d))

    def rows(kpos):
        return tk[0][:, kpos].movedim(0, -2), tv[0][:, kpos].movedim(0, -2)

    for window, dead in ((0, range(3, WARPS)), (8, (0, 3, 4, 5, 6, 7))):
        out, states = emulate(qf, rows, 0, 0, 20, window, 64, geo, 1)
        (state,) = states.values()
        for w in dead:
            m, l, acc = state[w]
            assert bool((m == NEG).all()) and not l.any() and not acc.any()
        # merging the dead warps changes nothing, bit for bit
        live = [s for w, s in enumerate(state) if w not in dead]
        mx, lt, at = merge(live)
        assert torch.equal(out, at / lt[:, None])
        assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_flash_route_sends_decode_to_the_split_kernel():
    for dtype in (torch.float32, torch.bfloat16):
        for h, hkv in HEADS.values():
            for d in (40, 64, 256):
                sched = FA.flash_schedule((2, h, 1, d), (2, hkv, 256, d),
                                          kind="full", window=100,
                                          block_q=1, block_k=64,
                                          has_pos=True)
                assert FA.flash_route(sched, dtype) == "decode"
    # block_q = 1 without seq_pos is not decode: the 3xTF32 tile path,
    # its query block padded to 16 rows
    sched = FA.flash_schedule((2, 4, 1, 64), (2, 4, 256, 64), kind="full",
                              block_q=1, block_k=64)
    assert FA.flash_route(sched, torch.float32) == "tc_f32"
    assert FA.ROUTE_KERNELS["decode"] == "flash_attention_decode"
    assert FA.KERNELS["flash_attention_decode"] is FA.decode_cuda
    assert FA.DECODE_SPLIT_KEYS == SPLIT_KEYS


def test_cpu_decode_runs_the_plain_version_and_launches_nothing():
    tq, tk, tv = _case("GQA", 64, "float32", seed=11)
    FA.reset_launch_counts()
    got = FA.flash_attention(tq, tk, tv, kind="full", block_q=1, block_k=64,
                             seq_pos=torch.tensor(POS))
    sched = FA.flash_schedule(tq.shape, tk.shape, kind="full", block_q=1,
                              block_k=64, has_pos=True)
    pos = torch.tensor(POS, dtype=torch.int32)
    assert torch.equal(got, FA.flash_attention_plain(tq, tk, tv, sched, pos))
    assert FA.launch_counts() == {name: 0 for name in FA.KERNELS}
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.decode_cuda(tq, tk, tv, sched, pos)
