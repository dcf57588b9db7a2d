"""The f32 tensor-core flash kernel (csrc/flash_attention.cu
flash_fwd_tf32_kernel, 3xTF32) without the card:

(a) a numpy emulation of its m16n8k8 tf32 fragment maps -- ldmatrix on
    16-byte rows of f32 for Q's A and K's B fragments, V's B fragment by
    32-bit loads at the permuted rows 2t and 2t + 1, and the key
    permutation that feeds P's A fragment from the score fragments --
    over one warp's 16 query rows and a few 64-key sub-tiles, equal to
    dense float64 products of the same tf32 operands; V read at the
    unpermuted rows gives another product.  Past d = 128 a pair of warps
    shares the 16 rows in 32-key sub-tiles: each multiplies its half of
    the head dim, the halves are added dims 0-127 first, and each warp
    keeps the outputs of its own half;
(b) ``tf32x3_numerics``, an emulation of the kernel's arithmetic (Q
    scaled in f32, every operand split into tf32 hi = rna(x) and
    lo = rna(x - hi), products summing lo·hi + hi·lo + hi·hi, the online
    softmax per 64-key sub-tile -- 32-key sub-tiles and the scores as two
    f32 halves added past d = 128 -- p split the same way) within the f32
    kernel tolerance 2e-5 of tpu-interpret ``repro.kernels.ops.
    flash_attention`` and of the port's plain version, the lowerings
    bit-equal to each other, compact KV bit-equal to embedded;
(c) a planted fault, the lo terms dropped (1xTF32), fails that check;
(d) ``flash_route``: which calls take the f32 tensor-core kernel.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.compact import pack_kv
from repro_torch.core.plan import LOWERINGS
from torch_parity import as_f32, qkv_pair

FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: the kernel's geometry (csrc/flash_attention.cu): 16 rows per warp,
#: 64-key sub-tiles, shared rows padded by 4 f32; past d = 128 a pair of
#: warps each owns HALF of the head dim, in 32-key sub-tiles
ROWS, SUB, PAD = 16, 64, 4
HALF, SUB_WIDE = 128, 32


def sub_keys(d):
    """Keys per sub-tile at head dim d (csrc tf32_sub)."""
    return SUB if d <= HALF else SUB_WIDE
TOL = FA.TOLERANCE[torch.float32]


# ---------------------------------------------------------------------------
# (a) fragment maps
# ---------------------------------------------------------------------------

def _tf32(x):
    """float32 values rounded to tf32 as cvt.rna.tf32.f32 does: to nearest
    on the 13 dropped mantissa bits, ties away from zero, on the bit
    pattern (bits + 0x1000) & ~0x1fff (numpy or torch) -- the kernel's
    own rounding (csrc/mma_sync.cuh round_tf32)."""
    if isinstance(x, torch.Tensor):
        b = x.to(torch.float32).view(torch.int32)
        return ((b + 0x1000) & ~0x1fff).view(torch.float32)
    b = np.asarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1fff).view(np.float32)


def _ldmatrix32(smem, addr):
    """ldmatrix.x4 over a 2-D f32 shared array: each 8 x 8 b16 matrix is 8
    rows of 4 f32, lane 8i + r gives the (row, col) of row r of matrix i,
    and register i of lane (g, t) receives word t of row g: (32, 4)."""
    out = np.zeros((32, 4))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            row, col = addr(8 * i + g)
            out[lane, i] = smem[row, col + t]
    return out


def _mma_k8(d, a, b0, b1):
    """d (32, 4) += A (16 x 8) B (8 x 8) from m16n8k8 tf32 lane fragments:
    a (32, 4), b0 / b1 (32,), accumulated in float64."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t] = a[lane, 0], a[lane, 1]
        A[g, t + 4], A[g + 8, t + 4] = a[lane, 2], a[lane, 3]
        B[t, g], B[t + 4, g] = b0[lane], b1[lane]
    D = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        d[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                    D[g + 8, 2 * t + 1]]


def _dense(frags):
    """The (16, 8 n) tile held by C fragments frags (n, 32, 4)."""
    out = np.zeros((16, 8 * len(frags)))
    for nt, d in enumerate(frags):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            out[g, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = d[lane, :2]
            out[g + 8, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = d[lane, 2:]
    return out


def _lane_offsets(lane):
    """The kernel's ldmatrix row/col offsets of one lane (f32 columns):
    (a_row, a_col), (k_row, k_col)."""
    lrow, mi = lane & 7, lane >> 3
    return (((mi & 1) * 8 + lrow, (mi >> 1) * 4),
            ((mi >> 1) * 8 + lrow, (mi & 1) * 4))


def _fragment_products(q, kk, vv, permuted=True):
    """S = Q K^T and O = tf32(S) V through the kernel's fragment maps, per
    sub-tile: one warp owning every dim up to d = 128; past it a pair of
    warps, each multiplying its half of the head dim (``dof`` = 0 or 128)
    with the halves added dims 0-127 first, each keeping the outputs of
    its half.  ``permuted=False`` reads V at rows t and t + 4 (a map
    without the key permutation).  Returns (S, O) dense."""
    d, nkeys = q.shape[1], kk.shape[0]
    sub = sub_keys(d)
    halves = [(0, d)] if d <= HALF else [(0, HALF), (HALF, d)]
    stride = d + PAD
    sq = np.zeros((ROWS, stride))
    sq[:, :d] = q
    o = np.zeros((d // 8, 32, 4))
    s_all = []
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for c in range(0, nkeys, sub):
        n = min(sub, nkeys - c)
        sk, sv = np.zeros((sub, stride)), np.zeros((sub, stride))
        sk[:n, :d], sv[:n, :d] = kk[c:c + n], vv[c:c + n]
        parts = []
        for dof, dend in halves:  # each warp of the pair, its dims
            s = np.zeros((sub // 8, 32, 4))
            for ks in range((dend - dof) // 8):
                col = dof + ks * 8
                a = _ldmatrix32(sq, lambda ln: (
                    _lane_offsets(ln)[0][0], col + _lane_offsets(ln)[0][1]))
                for np_ in range(n // 16):
                    bb = _ldmatrix32(sk, lambda ln: (
                        np_ * 16 + _lane_offsets(ln)[1][0],
                        col + _lane_offsets(ln)[1][1]))
                    _mma_k8(s[2 * np_], a, bb[:, 0], bb[:, 1])
                    _mma_k8(s[2 * np_ + 1], a, bb[:, 2], bb[:, 3])
            parts.append(s[:n // 8])
        s = parts[0] if len(parts) == 1 else parts[0] + parts[1]
        s_all.append(_dense(s))
        for kk_ in range(n // 8):
            # P's A fragment from the score fragment: d[0], d[2], d[1], d[3]
            pa = _tf32(np.stack([s[kk_][:, 0], s[kk_][:, 2], s[kk_][:, 1],
                                 s[kk_][:, 3]], 1))
            r0, r1 = (2 * t, 2 * t + 1) if permuted else (t, t + 4)
            for dof, dend in halves:  # each warp its own output dims
                for ot in range((dend - dof) // 8):
                    col = dof + ot * 8
                    _mma_k8(o[col // 8], pa, sv[kk_ * 8 + r0, col + g],
                            sv[kk_ * 8 + r1, col + g])
    return np.concatenate(s_all, 1), _dense(o)


@pytest.mark.parametrize("d,nkeys", [(64, 64), (64, 128), (64, 192),
                                     (128, 64), (128, 128), (128, 192),
                                     (256, 32), (256, 96), (200, 64)])
def test_fragment_maps_give_the_dense_products(d, nkeys):
    rng = np.random.default_rng(d + nkeys)
    q, kk, vv = (_tf32(rng.normal(size=shape)).astype(np.float64)
                 for shape in ((ROWS, d), (nkeys, d), (nkeys, d)))
    s, o = _fragment_products(q, kk, vv)
    s_dense = q @ kk.T
    np.testing.assert_allclose(s, s_dense, rtol=0, atol=1e-9)
    o_dense = _tf32(s_dense).astype(np.float64) @ vv
    np.testing.assert_allclose(o, o_dense, rtol=0, atol=1e-9)
    if nkeys == sub_keys(d):
        # the same loads without the key permutation pair P's columns
        # with the wrong rows of V
        _, wrong = _fragment_products(q, kk, vv, permuted=False)
        assert np.abs(wrong - o_dense).max() > 1.0


def test_tf32_rounding_is_rna_on_the_bit_pattern():
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: away from zero; the
    # split hi + lo keeps 22 bits of a random f32 value
    x = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0],
                 np.float32)
    np.testing.assert_array_equal(
        _tf32(x), [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0])
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(
        np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert torch.equal(_tf32(hi), hi)
    rel = ((hi.double() + lo.double() - r.double()).abs()
           / r.double().abs()).max()
    assert rel <= 2.0 ** -21


# ---------------------------------------------------------------------------
# (b) the kernel's numerics
# ---------------------------------------------------------------------------

def _mm3(eq, a, b, terms=3):
    """einsum ``eq`` of f32 a and b as 3xTF32 products (terms=3: lo·hi +
    hi·lo + hi·hi, exact in float64, then rounded to f32) or, with
    terms=1, hi·hi alone (1xTF32)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah.double(), bh.double())
    if terms == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = (torch.einsum(eq, al.double(), bh.double())
               + torch.einsum(eq, ah.double(), bl.double()) + out)
    return out.float()


def tf32x3_numerics(q, k, v, sched, pos=None, terms=3):
    """What flash_fwd_tf32_kernel computes, as tensor math on f32 q, k, v:
    every query-block row walks its key blocks in order, each in 64-key
    sub-tiles (32-key past d = 128); s = (q * scale) k^T in 3xTF32 --
    past d = 128 as two f32 halves over dims 0-127 and 128-d, added in
    that order -- masked with -1e30; the online softmax updates per
    sub-tile; O += p v in 3xTF32, l sums the f32 p; out = acc / l
    (l == 0 -> 1).  ``terms=1`` drops the lo terms (a planted fault)."""
    b, h, sq, d = q.shape
    hkv, g, bq, bk = sched.hkv, sched.group, sched.block_q, sched.block_k
    qf = (q.float() * sched.scale).reshape(b, hkv, g, sched.m_q, bq, d)
    kf = k.float().reshape(b, hkv, sched.kv_blocks, bk, d)
    vf = v.float().reshape(b, hkv, sched.kv_blocks, bk, d)
    bounds = torch.from_numpy(sched.row_bounds()).long()
    start = bounds[:, 0].expand(b, sched.m_q)
    end = bounds[:, 1].expand(b, sched.m_q)
    start, end, nsteps = FA._extents(start, end, pos, sched.kind,
                                     sched.window, bk)
    bidx = torch.arange(b)[:, None]
    qb = torch.arange(sched.m_q)[None, :]
    qpos = (sched.off + torch.arange(sched.m_q)[:, None] * bq
            + torch.arange(bq)[None, :])[None, None, None, :, :, None]
    acc = qf.new_zeros(qf.shape)
    m = qf.new_full(qf.shape[:-1] + (1,), FA.NEG_INF)
    l = qf.new_zeros(qf.shape[:-1] + (1,))
    for j in range(nsteps):
        kb = start + j
        live = kb <= end
        if sched.lowering == "bounding":
            live = live & torch.as_tensor(sched.member(kb, qb))
        kv = (kb - sched.s0).clamp(0, sched.kv_blocks - 1)
        kt = kf[bidx, :, kv].permute(0, 2, 1, 3, 4)
        vt = vf[bidx, :, kv].permute(0, 2, 1, 3, 4)
        upd = live[:, None, None, :, None, None]
        sub = sub_keys(d)
        for c in range(0, bk, sub):
            ks, vs = kt[..., c:c + sub, :], vt[..., c:c + sub, :]
            if d <= HALF:
                s = _mm3("bhgrqd,bhrkd->bhgrqk", qf, ks, terms)
            else:  # the pair's halves, dims 0-127 first
                s = (_mm3("bhgrqd,bhrkd->bhgrqk", qf[..., :HALF],
                          ks[..., :HALF], terms)
                     + _mm3("bhgrqd,bhrkd->bhgrqk", qf[..., HALF:],
                            ks[..., HALF:], terms))
            kpos = (kb[:, :, None] * bk + c + torch.arange(ks.shape[-2]))[
                :, None, None, :, None, :]
            mask = torch.ones_like(s, dtype=torch.bool)
            if sched.kind != "full":
                mask = kpos <= qpos
                if sched.kind == "local":
                    mask = mask & (kpos > qpos - sched.window)
            if pos is not None:
                pp = pos.long()[:, None, None, None, None, None]
                pm = kpos <= pp
                if sched.kind == "full" and sched.window:
                    pm = pm & (kpos > pp - sched.window)
                mask = mask & pm
            s = torch.where(mask, s, FA.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            pv = _mm3("bhgrqk,bhrkd->bhgrqd", p, vs, terms)
            acc = torch.where(upd, acc * alpha + pv, acc)
            l = torch.where(upd, alpha * l + p.sum(-1, keepdim=True), l)
            m = torch.where(upd, m_new, m)
    l = torch.where(l == 0, 1.0, l)
    return (acc / l).reshape(b, h, sq, d)


def _close(got, want):
    g, w = as_f32(got), as_f32(want)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    return float(np.abs(g - w).max())


HEADS = {"MHA": (2, 2), "GQA": (4, 2), "MQA": (4, 1)}


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_tf32x3_numerics_match_jax_and_plain(kind, heads, d, block):
    h, hkv = HEADS[heads]
    s = 4 * block if kind == "local" else 2 * block
    window = 2 * block if kind == "local" else 0
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, h, hkv, s, s, d,
                                          seed=3 * d + block)
    kw = dict(kind=kind, window=window, block_q=block, block_k=block)
    want = jops.flash_attention(jq, jk, jv, grid_mode="closed_form", **kw)
    # the plain version's lowerings are bit-equal (test_torch_flash.py)
    plain = FA.flash_attention_plain(tq, tk, tv, FA.flash_schedule(
        tq.shape, tk.shape, **kw))
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(tq.shape, tk.shape, grid_mode=gm, **kw)
        assert FA.flash_route(sched, tq.dtype) == "tc_f32"
        outs.append(tf32x3_numerics(tq, tk, tv, sched))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    _close(outs[0], want)
    _close(outs[0], plain)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_tf32x3_numerics_compact_kv_and_seq_pos(grid_mode):
    from repro.core.compact import pack_kv as j_pack_kv
    from repro.core.domain import make_attention_domain as j_dom
    # rectangular local, block_q 64: the first visited tile of the first
    # rows is wholly masked; compact K/V hold the band's support
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 4, 2, 128, 512, 64, seed=21)
    kw = dict(kind="local", window=128, block_q=64, block_k=64)
    emb = FA.flash_schedule(tq.shape, tk.shape, grid_mode=grid_mode, **kw)
    tkc = pack_kv(tk, emb.domain, 64).contiguous()
    tvc = pack_kv(tv, emb.domain, 64).contiguous()
    comp = FA.flash_schedule(tq.shape, tkc.shape, grid_mode=grid_mode,
                             storage="compact", kv_seq_len=512, **kw)
    assert FA.flash_route(comp, tq.dtype) == "tc_f32"
    got = tf32x3_numerics(tq, tkc, tvc, comp)
    assert torch.equal(got, tf32x3_numerics(tq, tk, tv, emb))
    jd = j_dom("local", 2, 8, 3)
    want = jops.flash_attention(jq, j_pack_kv(jk, jd, 64),
                                j_pack_kv(jv, jd, 64), storage="compact",
                                kv_seq_len=512, grid_mode=grid_mode, **kw)
    _close(got, want)
    _close(got, FA.flash_attention_plain(tq, tkc, tvc, comp))
    # seq_pos at block_q 64: per-row positions, full and full + window
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(3, 4, 2, 64, 256, 64, seed=22)
    for pos, window in ((200, 0), ([37, 255, 128], 0), ([37, 255, 128], 80)):
        kw = dict(kind="full", window=window, block_q=64, block_k=64,
                  grid_mode=grid_mode)
        sched = FA.flash_schedule(tq.shape, tk.shape, has_pos=True, **kw)
        assert FA.flash_route(sched, tq.dtype) == "tc_f32"
        pv = FA.seq_pos_vector(pos, 3, "cpu")
        got = tf32x3_numerics(tq, tk, tv, sched, pv)
        _close(got, jops.flash_attention(jq, jk, jv, seq_pos=jnp.asarray(pos),
                                         **kw))
        _close(got, FA.flash_attention_plain(tq, tk, tv, sched, pv))


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_tf32x3_numerics_past_d128_match_jax_and_plain(kind, d):
    # the pair layout (d 256, and d 200 below its instantiation): 32-key
    # sub-tiles, the two halves' scores added in one order; the
    # lowerings bit-equal to each other
    block = 64
    s = 4 * block if kind == "local" else 2 * block
    window = 2 * block if kind == "local" else 0
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 4, 2, s, s, d, seed=d + 7)
    kw = dict(kind=kind, window=window, block_q=block, block_k=block)
    want = jops.flash_attention(jq, jk, jv, grid_mode="closed_form", **kw)
    plain = FA.flash_attention_plain(tq, tk, tv, FA.flash_schedule(
        tq.shape, tk.shape, **kw))
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(tq.shape, tk.shape, grid_mode=gm, **kw)
        assert FA.flash_route(sched, tq.dtype) == "tc_f32"
        outs.append(tf32x3_numerics(tq, tk, tv, sched))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    _close(outs[0], want)
    _close(outs[0], plain)


# ---------------------------------------------------------------------------
# (c) a planted fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128, 256])
def test_dropping_the_lo_terms_fails_the_f32_tolerance(d):
    # 1xTF32 (hi x hi alone) keeps ~11 bits of each product: its outputs
    # leave rtol = atol = 2e-5 of the plain version, where 3xTF32 stays
    _, (q, k, v) = qkv_pair(1, 2, 2, 512, 512, d, seed=31)
    sched = FA.flash_schedule(q.shape, k.shape, kind="causal")
    plain = FA.flash_attention_plain(q, k, v, sched)
    assert FA._compare(tf32x3_numerics(q, k, v, sched), plain,
                       "3xTF32") <= TOL
    fault = tf32x3_numerics(q, k, v, sched, terms=1)
    with pytest.raises(AssertionError, match="kernel != plain"):
        FA._compare(fault, plain, "1xTF32")


# ---------------------------------------------------------------------------
# (d) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw,route", [
    ((1, 2, 256, 64), dict(), "tc_f32"),
    ((1, 2, 256, 128), dict(block_q=64, block_k=64), "tc_f32"),
    ((1, 2, 256, 40), dict(), "tc_f32"),                       # d % 8
    ((1, 2, 256, 8), dict(block_q=16, block_k=16), "tc_f32"),
    ((1, 2, 1024, 64), dict(block_q=256, block_k=256), "tc_f32"),
    ((1, 2, 96, 48), dict(kind="full", block_q=48, block_k=48), "tc_f32"),
    ((1, 2, 256, 256), dict(block_q=64, block_k=64), "tc_f32"),
    ((1, 2, 256, 136), dict(), "tc_f32"),                      # d > 128
    ((1, 2, 256, 264), dict(), "cuda_core"),                   # d > 256
    ((1, 2, 256, 36), dict(), "tc_f32"),                       # d % 8 = 4
    ((1, 2, 96, 64), dict(kind="full", block_q=24, block_k=24), "tc_f32"),
    ((1, 2, 64, 64), dict(kind="full", block_q=8, block_k=8), "tc_f32"),
    ((1, 2, 256, 38), dict(), "tc_f32"),                       # d % 4
    ((1, 2, 256, 37), dict(), "tc_f32"),                       # odd d
    ((1, 2, 256, 62), dict(), "tc_f32"),                       # 8-byte
    ((1, 2, 96, 255), dict(kind="full", block_q=24, block_k=24), "tc_f32"),
])
def test_flash_route_sends_f32_prefill_to_the_tf32_kernel(shape, kw, route):
    # the route follows shape and dtype alone: a misaligned view keeps it
    # (flash_cuda copies it to an aligned buffer first)
    sched = FA.flash_schedule(shape, shape, **kw)
    assert FA.flash_route(sched, torch.float32) == route


def test_f32_decode_and_misaligned_views_stay_on_the_cuda_cores():
    # decode takes the split-K decode kernel on the CUDA cores; a
    # misaligned f32 view is detected (flash_cuda then copies it to an
    # aligned buffer for the 3xTF32 kernel)
    sched = FA.flash_schedule((4, 16, 1, 64), (4, 8, 1664, 64), kind="full",
                              block_q=1, block_k=128, has_pos=True)
    assert FA.flash_route(sched, torch.float32) == "decode"
    shape = (1, 2, 256, 64)
    base = torch.zeros(1 + 2 * 256 * 64, dtype=torch.float32)
    assert not FA._aligned(base[1:].view(shape))
    assert FA.flash_route(FA.flash_schedule(shape, shape),
                          torch.float32) == "tc_f32"
    assert FA.ROUTE_KERNELS["tc_f32"] == "flash_attention_tc_f32"
    assert FA.KERNELS["flash_attention_tc_f32"] is FA.flash_tc_f32_cuda


def test_cpu_f32_tensors_run_the_plain_version_and_launch_nothing():
    FA.reset_launch_counts()
    _, (tq, tk, tv) = qkv_pair(1, 2, 2, 128, 128, 64, seed=41)
    out = FA.flash_attention(tq, tk, tv, block_q=64, block_k=64)
    sched = FA.flash_schedule(tq.shape, tk.shape, block_q=64, block_k=64)
    assert FA.flash_route(sched, tq.dtype) == "tc_f32"
    assert torch.equal(out, FA.flash_attention_plain(tq, tk, tv, sched))
    assert FA.launch_counts() == {name: 0 for name in FA.KERNELS}
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_tc_f32_cuda(tq, tk, tv, sched)
