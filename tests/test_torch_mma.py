"""The port's mma lowering (:mod:`repro_torch.core.mma`) against the JAX
package's (:mod:`repro.core.mma`): every basis builder and chain on the
same inputs, the exactness properties up to the 2^24 bound
(tests/test_mma.py's), the bound itself, the exact tensor-core split of
the bases, an emulation of the device chains' fragment arithmetic, and
``GridPlan(..., "mma").mma_table_host()`` against the JAX package's and
against ``lut_host()``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractal as JF
from repro.core import mma as JM
from repro.core import plan as JP
from repro_torch.core import fractal as TF
from repro_torch.core import mma as TM
from repro_torch.core import plan as TP

from hypothesis_compat import given, settings, st

SPECS = {name: (JF.FRACTALS[name], TF.FRACTALS[name])
         for name in ("sierpinski-gasket", "sierpinski-carpet",
                      "vicsek-cross")}
NAMES = tuple(SPECS)
#: deepest level per spec whose volume k^r and extent m^r both stay
#: under DIGIT_BOUND (tests/test_mma.py's MAX_R)
MAX_R = {name: max(r for r in range(1, 40)
                   if s.k ** r < TM.DIGIT_BOUND and s.m ** r < TM.DIGIT_BOUND)
         for name, (_, s) in SPECS.items()}


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# basis builders and chains against the JAX package, on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("r", [1, 3, 6])
def test_bases_equal_the_jax_package(name, r):
    js, ts = SPECS[name]
    for fn in ("coords_basis", "slots_basis", "linear_basis"):
        np.testing.assert_array_equal(getattr(TM, fn)(ts, r),
                                      getattr(JM, fn)(js, r))
    np.testing.assert_array_equal(TM.pair_basis(ts), JM.pair_basis(js))


@pytest.mark.parametrize("name", NAMES)
def test_chains_equal_the_jax_package(name):
    js, ts = SPECS[name]
    r = min(MAX_R[name], 5)
    rng = np.random.default_rng(3)
    i = rng.integers(0, ts.k ** r, 300)
    oh = TM.digit_onehot(torch.from_numpy(i), ts.k, r)
    assert oh.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        oh.float().numpy(),
        np.asarray(JM.digit_onehot(jnp.asarray(i, jnp.int32), js.k, r),
                   np.float32))
    out = TM._contract(oh, TM.coords_basis(ts, r))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(JM._contract(
        JM.digit_onehot(jnp.asarray(i, jnp.int32), js.k, r),
        JM.coords_basis(js, r))))
    ti, ji = torch.from_numpy(i), jnp.asarray(i, jnp.int32)
    for fn, args in (("decode_linear", ()), ("slots_of_linear", ())):
        for got, want in zip(getattr(TM, fn)(ts, r, ti, *args),
                             getattr(JM, fn)(js, r, ji, *args)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(TM.slots_of_linear(ts, r, ti, swap=True),
                         JM.slots_of_linear(js, r, ji, swap=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wx, wy = TF.deinterleave_linear(i, ts.k, r)
    for got, want in zip(TM.decode_orthotope(ts, r, wx, wy),
                         JM.decode_orthotope(js, r, jnp.asarray(wx),
                                             jnp.asarray(wy))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # embedded coords: members and arbitrary (non-member) points
    n = ts.m ** r
    x = np.concatenate([np_of(ts.lambda_map_linear(i, r)[0]),
                        rng.integers(0, n, 200)])
    y = np.concatenate([np_of(ts.lambda_map_linear(i, r)[1]),
                        rng.integers(0, n, 200)])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32)
    rows = TM.copy_rows(ts, r, tx, ty)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(JM.copy_rows(js, r, jx, jy)))
    np.testing.assert_array_equal(
        TM.member_of_rows(r, rows).numpy(),
        np.asarray(JM.member_of_rows(r, JM.copy_rows(js, r, jx, jy))))
    for swap in (False, True):
        for got, want in zip(TM.inverse_slots(ts, r, tx, ty, swap=swap),
                             JM.inverse_slots(js, r, jx, jy, swap=swap)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TM.linear_of(ts, r, tx, ty).numpy(),
                                  np.asarray(JM.linear_of(js, r, jx, jy)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dx,dy", [(0, -1), (1, 0), (-1, 1), (1, 1)])
def test_neighbor_slots_equal_the_jax_package(name, dx, dy):
    from repro.core.domain import make_fractal_domain as jdom
    from repro_torch.core.domain import make_fractal_domain as tdom
    js, ts = SPECS[name]
    r = 3
    n_b = ts.m ** r
    i = np.arange(ts.k ** r)
    bx, by = (np_of(a) for a in ts.lambda_map_linear(i, r))
    for swap in (False, True):
        got = TM.neighbor_slots(ts, r, tdom(name, n_b), torch.from_numpy(bx),
                                torch.from_numpy(by), dx, dy, swap=swap)
        want = JM.neighbor_slots(js, r, jdom(name, n_b),
                                 jnp.asarray(bx, jnp.int32),
                                 jnp.asarray(by, jnp.int32), dx, dy,
                                 swap=swap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


ROW_DOMAINS = ["triangular", "band", "bounding-box"]


@pytest.mark.parametrize("size", ["small", "medium"])
@pytest.mark.parametrize("name", ROW_DOMAINS)
def test_row_chains_equal_the_jax_package(name, size):
    jd = JP.registered_domains(size)[name]
    td = TP.registered_domains(size)[name]
    for got, want in zip(TM.row_basis(td), JM.row_basis(jd)):
        np.testing.assert_array_equal(got, want)
    t = np.arange(td.num_blocks)
    for got, want in zip(TM.decode_rows(td, torch.from_numpy(t)),
                         JM.decode_rows(jd, jnp.asarray(t, jnp.int32))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ext = TM.row_extents_chain(td)
    assert ext.dtype == torch.int32
    np.testing.assert_array_equal(ext.numpy(),
                                  np.asarray(JM.row_extents_chain(jd)))
    np.testing.assert_array_equal(
        ext.numpy(), TP.GridPlan(td, backend="cpu").row_extents())


def test_decode_rows_chunks_over_steps(monkeypatch):
    """The (T, R) comparison matrix is built in chunks of steps; the
    result does not depend on the chunk."""
    from repro_torch.core.domain import TriangularDomain
    d = TriangularDomain(40)
    t = torch.arange(d.num_blocks)
    whole = TM.decode_rows(d, t)
    monkeypatch.setattr(TM, "ROWS_CHUNK", 7 * 40)
    for a, b in zip(whole, TM.decode_rows(d, t)):
        assert torch.equal(a, b)
    bx, by = d.block_coords(t)
    assert torch.equal(whole[0].long(), bx) and torch.equal(whole[1].long(),
                                                            by)


def test_chains_ignore_tf32_settings():
    """The plain chains contract in float64: enabling TF32 for f32
    matmuls (what a card may do) cannot change them."""
    spec = TF.SIERPINSKI
    r = MAX_R["sierpinski-gasket"]
    i = torch.arange(3 ** r - 4096, 3 ** r)
    before = TM.decode_linear(spec, r, i)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        after = TM.decode_linear(spec, r, i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    for a, b in zip(before, after):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# exactness up to the bound (tests/test_mma.py:30, :47, :61, :73)
# ---------------------------------------------------------------------------

@given(st.integers(0, 2), st.data())
@settings(max_examples=60, deadline=None)
def test_property_decode_exact_up_to_bound(which, data):
    spec = SPECS[NAMES[which]][1]
    r = data.draw(st.integers(1, MAX_R[spec.name]))
    i = data.draw(st.integers(max(0, spec.k ** r - 64), spec.k ** r - 1))
    bx, by = TM.decode_linear(spec, r, torch.tensor(i))
    ex, ey = spec.lambda_map_linear(int(i), r)
    assert (int(bx), int(by)) == (int(ex), int(ey))
    sx, sy = TM.slots_of_linear(spec, r, torch.tensor(i))
    wx, wy = TF.deinterleave_linear(int(i), spec.k, r)
    assert (int(sx), int(sy)) == (int(wx), int(wy))


@given(st.integers(0, 2), st.data())
@settings(max_examples=60, deadline=None)
def test_property_inverse_and_linear_exact(which, data):
    spec = SPECS[NAMES[which]][1]
    r = data.draw(st.integers(1, min(MAX_R[spec.name], 12)))
    i = data.draw(st.integers(0, spec.k ** r - 1))
    x, y = spec.lambda_map_linear(int(i), r)
    li = TM.linear_of(spec, r, torch.tensor(int(x)), torch.tensor(int(y)))
    assert int(li) == int(i)
    sx, sy = TM.inverse_slots(spec, r, torch.tensor(int(x)),
                              torch.tensor(int(y)))
    ex, ey = spec.lambda_inverse(int(x), int(y), r)
    assert (int(sx), int(sy)) == (int(ex), int(ey))


@pytest.mark.parametrize("name", NAMES)
def test_decode_exact_at_bound_edge_batch(name):
    """The last 4k indices at the deepest in-bound level: the largest
    magnitudes the chains ever accumulate."""
    spec = SPECS[name][1]
    r = MAX_R[name]
    k_r = spec.k ** r
    i = np.arange(max(0, k_r - 4096), k_r, dtype=np.int64)
    bx, by = TM.decode_linear(spec, r, torch.from_numpy(i))
    ex, ey = spec.lambda_map_linear(i, r)
    np.testing.assert_array_equal(bx.numpy(), ex)
    np.testing.assert_array_equal(by.numpy(), ey)
    sx, sy = TM.slots_of_linear(spec, r, torch.from_numpy(i))
    wx, wy = TF.deinterleave_linear(i, spec.k, r)
    np.testing.assert_array_equal(sx.numpy(), wx)
    np.testing.assert_array_equal(sy.numpy(), wy)


def test_bound_is_asserted():
    for name, (_, spec) in SPECS.items():
        with pytest.raises(ValueError, match="2\\^24"):
            TM.coords_basis(spec, MAX_R[name] + 1)
    with pytest.raises(ValueError, match="2\\^24"):
        TM.decode_linear(TF.SIERPINSKI, MAX_R["sierpinski-gasket"] + 1,
                         torch.tensor(0))
    # the same message as the JAX package's
    with pytest.raises(ValueError) as terr:
        TM.slots_basis(TF.CARPET, MAX_R["sierpinski-carpet"] + 1)
    with pytest.raises(ValueError) as jerr:
        JM.slots_basis(JF.CARPET, MAX_R["sierpinski-carpet"] + 1)
    assert str(terr.value) == str(jerr.value)
    # a plan under mma refuses beyond the bound before any table or launch
    from repro_torch.core.domain import SierpinskiDomain
    with pytest.raises(ValueError, match="2\\^24"):
        TP.GridPlan(SierpinskiDomain(1 << 16), "mma", backend="cpu")
    TP.GridPlan(SierpinskiDomain(1 << 15), "mma", backend="cpu")


# ---------------------------------------------------------------------------
# the tensor-core operands: exact split and fragment layout
# ---------------------------------------------------------------------------

def _bases(name, r):
    spec = SPECS[name][1]
    return [TM.coords_basis(spec, r).reshape(-1, 2),
            TM.slots_basis(spec, r).reshape(-1, 2),
            TM.neighbor_basis(spec, r)]


@pytest.mark.parametrize("name", NAMES)
def test_exact_split_recombines_to_the_basis(name):
    r = MAX_R[name]
    for basis in _bases(name, r):
        pieces = TM.exact_split(basis)
        assert pieces.shape == (basis.shape[0], 8)
        assert np.abs(pieces).max() <= 255
        # every piece is exact in bf16
        as_bf16 = torch.from_numpy(pieces).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(as_bf16, pieces)
        np.testing.assert_array_equal(
            TM.recombine(pieces, basis.shape[1]).astype(np.float32), basis)


def test_exact_split_carries_the_sign():
    from repro_torch.core.domain import TriangularDomain
    starts, diff, ones = TM.row_basis(TriangularDomain(2047))
    assert diff.min() < -(1 << 20)  # large negative entries
    basis = np.stack([ones, diff], -1)
    pieces = TM.exact_split(basis)
    np.testing.assert_array_equal(TM.recombine(pieces, 2), basis)
    with pytest.raises(ValueError, match="2\\^24"):
        TM.exact_split(np.array([[float(1 << 24)]]))
    with pytest.raises(ValueError, match="piece"):
        TM.exact_split(np.full((1, 3), 70000.0))


def _b_from_fragments(frag):
    """The (16 * ksteps, 8) bf16 B matrix a warp sees, read back from the
    per-lane fragments exactly as the mma.sync B layout assigns them."""
    ks = frag.shape[0]
    bits = frag.view(np.uint32).astype(np.int64)
    out = np.zeros((ks * 16, 8), np.int64)
    for s in range(ks):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            r0, r1 = bits[s, lane]
            out[s * 16 + 2 * t, g] = r0 & 0xFFFF
            out[s * 16 + 2 * t + 1, g] = r0 >> 16
            out[s * 16 + 2 * t + 8, g] = r1 & 0xFFFF
            out[s * 16 + 2 * t + 9, g] = r1 >> 16
    return torch.from_numpy(out.astype(np.int16)).view(torch.bfloat16) \
        .float().numpy()


def _warp_d(a_of, frag):
    """Emulate the device chain: D (16 x 8, f32) = sum over k-steps of
    A(16 x 16) . B(16 x 8), A from ``a_of(row, col)`` (0/1)."""
    b = _b_from_fragments(frag)
    cols = np.arange(b.shape[0])
    a = np.array([[float(a_of(row, c)) for c in cols] for row in range(16)],
                 np.float32)
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _dout(d, row, w):
    return int(d[row, 3 * w]) + 256 * int(d[row, 3 * w + 1]) \
        + 65536 * int(d[row, 3 * w + 2])


@pytest.mark.parametrize("name", NAMES)
def test_device_chain_emulation_matches_the_closed_forms(name):
    """The fragment arithmetic of csrc/mma_decode.cuh, emulated: the
    digit chains (B7a) give lambda and the own slot, the neighbour chain
    (B7b) the neighbour slots and the matched-level count."""
    from repro_torch.core.compact import NEIGHBOR_OFFSETS8, compact_layout
    from repro_torch.core.domain import make_fractal_domain
    spec = SPECS[name][1]
    r = 3
    cfrag, sfrag, nfrag = TM.fractal_operands(spec, r)
    assert cfrag.shape == (TM.ksteps(r * spec.k), 32, 2)
    assert nfrag.shape == (TM.ksteps(r * spec.m ** 2), 32, 2)
    dom = make_fractal_domain(name, spec.m ** r)
    lay = compact_layout(dom)
    rng = np.random.default_rng(5)
    for t in rng.integers(0, spec.k ** r, 6).tolist():
        def digit(row, col):
            if row != 0 or col >= r * spec.k:
                return 0
            mu, c = divmod(col, spec.k)
            return int((t // spec.k ** mu) % spec.k == c)
        dc, ds = _warp_d(digit, cfrag), _warp_d(digit, sfrag)
        bx, by = spec.lambda_map_linear(t, r)
        assert (_dout(dc, 0, 0), _dout(dc, 0, 1)) == (bx, by)
        assert (_dout(ds, 0, 0), _dout(ds, 0, 1)) == \
            tuple(TF.deinterleave_linear(t, spec.k, r))

        def pair(row, col):
            if row >= 8 or col >= r * spec.m ** 2:
                return 0
            dx, dy = NEIGHBOR_OFFSETS8[row]
            x = min(max(bx + dx, 0), spec.m ** r - 1)
            y = min(max(by + dy, 0), spec.m ** r - 1)
            mu, pr = divmod(col, spec.m ** 2)
            p = spec.m ** mu
            return int(((y // p) % spec.m) * spec.m + (x // p) % spec.m == pr)
        dn = _warp_d(pair, nfrag)
        for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
            sx, sy, ok = lay.neighbor_slot(bx, by, dx, dy)
            x, y = bx + dx, by + dy
            inb = 0 <= x < spec.m ** r and 0 <= y < spec.m ** r
            got_ok = inb and int(dn[j, 6]) == r
            assert got_ok == bool(ok)
            if ok:
                assert (_dout(dn, j, 0), _dout(dn, j, 1)) == (sx, sy)


# ---------------------------------------------------------------------------
# the CA's batched chains (csrc/mma_decode.cuh fractal_chain_batch and
# fractal_nbrs_pair): digits found once by the lane of their position,
# by multiply-high (no division), sixteen steps a B7a pass, two steps a
# B7b pass
# ---------------------------------------------------------------------------

STEPS_BATCH = 16  # kStepsBatch: B7a's A rows, one a step


def _div_magic(b):
    """div_magic: ceil(2^32 / b)."""
    return 0xFFFFFFFF // b + 1


def _pow_magic(b, mu):
    """pow_magic: ceil(2^64 / b^mu), the power capped once past 2^24; 0
    at mu = 0."""
    pw = 1
    for _ in range(mu):
        if pw >= 1 << 24:
            break
        pw *= b
    return 0 if mu == 0 else ((1 << 64) - 1) // pw + 1


def _lane_digit(v, pmagic, b, bmagic):
    """lane_digit: digit mu of v in base b from two multiply-highs."""
    q = (v * pmagic) >> 64 if pmagic else v
    return q - ((q * bmagic) >> 32) * b


def _a_rows(mk, hot):
    """The 16 x 16 mk A of a batched chain: lane (g, tq) sets columns
    c, c + 1, c + 8, c + 9 (c = 16 ks + 2 tq) of rows g and g + 8 (A
    registers 0-3), ``hot(lane, col)`` -> (row g's bit, row g + 8's)."""
    a = np.zeros((16, 16 * mk))
    for ks in range(mk):
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            for e in range(4):
                col = ks * 16 + 2 * tq + (e & 1) + (e >> 1) * 8
                a[g, col], a[g + 8, col] = hot(lane, col)
    return a


def _chain_batch(spec, r, frag, t0, stride, nlive):
    """fractal_chain_batch: D (16 x 8) of the steps t0 + j stride, j <
    nlive (rows past nlive decode t0).  Lane mu holds digit mu of every
    step, steps 0-7 in lo's nibbles and 8-15 in hi's; a lane building
    column mu * k + c reads lane mu's words (one shuffle each)."""
    k = spec.k
    kmag, ncols = _div_magic(k), r * k
    ts = [t0 + j * stride if j < nlive else t0 for j in range(STEPS_BATCH)]
    lo, hi = [0] * 32, [0] * 32
    for lane in range(32):
        pm = _pow_magic(k, lane)
        for j, t in enumerate(ts):
            dg = _lane_digit(t, pm, k, kmag)
            assert 0 <= dg < 16
            if j < 8:
                lo[lane] |= dg << (4 * j)
            else:
                hi[lane] |= dg << (4 * (j - 8))

    def hot(lane, col):
        g = lane >> 2
        mu = (col * kmag) >> 32
        cd = col - mu * k
        live = col < ncols
        return (live and (lo[mu & 31] >> (4 * g) & 15) == cd,
                live and (hi[mu & 31] >> (4 * g) & 15) == cd)
    b = _b_from_fragments(frag)
    return (_a_rows(frag.shape[0], hot) @ b.astype(np.float64)).astype(
        np.float32)


def _nbrs_pair(spec, r, nfrag, nb, blocks, swap):
    """fractal_nbrs_pair: the 8 neighbours of blocks[0] (A rows 0-7) and
    blocks[1] (rows 8-15).  Lane mu holds the base-m digits mu of a
    block's clamped columns bx - 1 .. bx + 1 (3 bits each) and rows
    by - 1 .. by + 1 (bits 9 on).  Returns per block and neighbour
    (sx, sy, ok)."""
    m = spec.m
    mm, top = m * m, nb - 1
    mmag, mmmag, ncols = _div_magic(m), _div_magic(mm), r * m * m

    def word(lane, bx, by):
        pm, w = _pow_magic(m, lane), 0
        for i in range(3):
            xc = min(max(bx + i - 1, 0), top)
            yc = min(max(by + i - 1, 0), top)
            w |= _lane_digit(xc, pm, m, mmag) << (3 * i)
            w |= _lane_digit(yc, pm, m, mmag) << (9 + 3 * i)
        return w
    words = [[word(lane, *blk) for lane in range(32)] for blk in blocks]

    def hot(lane, col):
        g = lane >> 2
        ndx, ndy = NBR8[g]
        sxs, sys = 3 * (ndx + 1), 9 + 3 * (ndy + 1)
        mu = (col * mmmag) >> 32
        pr = col - mu * mm
        dy = (pr * mmag) >> 32
        dx = pr - dy * m
        live = col < ncols
        return tuple(live and (w[mu & 31] >> sxs & 7) == dx
                     and (w[mu & 31] >> sys & 7) == dy for w in words)
    b = _b_from_fragments(nfrag)
    d = (_a_rows(nfrag.shape[0], hot) @ b.astype(np.float64)).astype(
        np.float32)
    out = []
    for half, (bx, by) in enumerate(blocks):
        for g, (ndx, ndy) in enumerate(NBR8):
            row = 8 * half + g
            wx, wy = _dout(d, row, 0), _dout(d, row, 1)
            x, y = bx + ndx, by + ndy
            ok = 0 <= x <= top and 0 <= y <= top and int(d[row, 6]) == r
            out.append(((wy, wx) if swap else (wx, wy)) + (ok,))
    return out


#: kNbrDx / kNbrDy of csrc/fractal_common.cuh: neighbour j's offsets
NBR8 = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, -1), (-1, 1),
        (1, 1))


def _batched_decode(spec, r, ts_batches, swap):
    """Run the batched chains over batches of (t0, stride, nlive): per
    live step (bx, by, sx, sy) and its 8 neighbours' (sx, sy, ok), the
    pairs of B7b taking steps 2 pr and 2 pr + 1 as the CA does."""
    cfrag, sfrag, nfrag = TM.fractal_operands(spec, r)
    nb = spec.m ** r
    got = {}
    for t0, stride, nlive in ts_batches:
        dc = _chain_batch(spec, r, cfrag, t0, stride, nlive)
        ds = _chain_batch(spec, r, sfrag, t0, stride, nlive)
        blocks = []
        for j in range(nlive):
            wx, wy = _dout(ds, j, 0), _dout(ds, j, 1)
            blocks.append((_dout(dc, j, 0), _dout(dc, j, 1)) +
                          ((wy, wx) if swap else (wx, wy)))
        for pr in range(0, nlive, 2):
            pair = [blocks[pr][:2], blocks[min(pr + 1, nlive - 1)][:2]]
            nbrs = _nbrs_pair(spec, r, nfrag, nb, pair, swap)
            for half in range(2):
                j = pr + half
                if j < nlive:
                    got[t0 + j * stride] = (blocks[j],
                                            nbrs[8 * half:8 * half + 8])
    return got


def _jax_decode(js, name, r, ts, swap):
    """The same from the JAX package's chains: decode_linear,
    slots_of_linear and neighbor_slots."""
    from repro.core.domain import make_fractal_domain as jdom
    t = jnp.asarray(np.asarray(ts), jnp.int32)
    bx, by = (np.asarray(a) for a in JM.decode_linear(js, r, t))
    sx, sy = (np.asarray(a) for a in JM.slots_of_linear(js, r, t, swap))
    dom = jdom(name, js.m ** r)
    nbrs = [[np.asarray(a) for a in JM.neighbor_slots(
        js, r, dom, jnp.asarray(bx), jnp.asarray(by), dx, dy, swap=swap)]
        for dx, dy in NBR8]
    return {int(t_): ((int(bx[i]), int(by[i]), int(sx[i]), int(sy[i])),
                      [(int(n[0][i]), int(n[1][i]), bool(n[2][i]))
                       for n in nbrs])
            for i, t_ in enumerate(ts)}


def _same_decode(got, want):
    assert got.keys() == want.keys()
    for t, (blk, nbrs) in want.items():
        assert got[t][0] == blk, t
        for (gx, gy, gok), (wx, wy, wok) in zip(got[t][1], nbrs):
            assert gok == wok, t
            if wok:  # an invalid neighbour's slot is never read
                assert (gx, gy) == (wx, wy), t


@pytest.mark.parametrize("base", range(2, 17))
def test_lane_digits_need_no_division(base):
    """digit mu of v < 2^24 from pow_magic / div_magic equals v //
    base^mu % base at every lane, at the edges and at random values; the
    column split col // k by div_magic too."""
    rng = np.random.default_rng(base)
    vs = [0, 1, base - 1, base, (1 << 24) - 1] + \
        rng.integers(0, 1 << 24, 120).tolist()
    bmag = _div_magic(base)
    for mu in range(32):
        pm = _pow_magic(base, mu)
        for v in vs:
            assert _lane_digit(v, pm, base, bmag) == v // base ** mu % base
    for col in range(512):
        assert (col * bmag) >> 32 == col // base
    if base <= 8:  # the digit-pair column split by m^2
        mag2 = _div_magic(base * base)
        assert all((c * mag2) >> 32 == c // (base * base)
                   for c in range(2048))


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_batched_chain_emulation_matches_the_jax_chains(name, swap):
    """Every step of a small plan, walked as the CA's persistent CTAs
    batch it (CTA c of G: steps c + j G, sixteen a B7a pass, B7b two
    steps a pass), decodes to the JAX package's decode_linear /
    slots_of_linear / neighbor_slots."""
    js, ts = SPECS[name]
    r = 3
    steps = ts.k ** r
    for ctas in (1, 5):
        batches = []
        for c in range(ctas):
            own = len(range(c, steps, ctas))
            for k0 in range(0, own, STEPS_BATCH):
                batches.append((c + k0 * ctas, ctas,
                                min(STEPS_BATCH, own - k0)))
        got = _batched_decode(ts, r, batches, swap)
        _same_decode(got, _jax_decode(js, name, r, range(steps), swap))


@pytest.mark.parametrize("name", NAMES)
def test_batched_chain_emulation_exact_at_the_bound_edge(name):
    """The last 48 steps at the deepest in-bound level (the largest
    digits and coordinates the chains see), and a short last batch."""
    js, ts = SPECS[name]
    r = MAX_R[name]
    steps = ts.k ** r
    batches = [(steps - 45, 1, 16), (steps - 29, 1, 16), (steps - 13, 2, 7)]
    got = _batched_decode(ts, r, batches, swap=r % 2 == 1)
    want = _jax_decode(js, name, r, sorted(got), swap=r % 2 == 1)
    _same_decode(got, want)
    assert max(got) == steps - 1


@pytest.mark.parametrize("name", ROW_DOMAINS)
def test_device_row_chain_emulation_matches_the_closed_forms(name):
    """The row chain (B7c) of csrc/mma_decode.cuh, emulated, over the
    padded starts and the (ones, diff) fragments."""
    td = TP.registered_domains("medium")[name]
    starts, frag = TM.rows_operands(td)
    assert len(starts) == frag.shape[0] * 16 + 2
    for t in range(td.num_blocks):
        def a_of(row, col):
            ge = t >= starts[col]
            return int(ge) if row == 0 else \
                int(row == 1 and ge and t < starts[col + 1])
        d = _warp_d(a_of, frag)
        assert (t + _dout(d, 1, 1), _dout(d, 0, 0) - 1) == \
            tuple(int(v) for v in td.block_coords(t))


def test_operand_tensor_layout():
    """GridPlan.mma_operand_tensor: the fractal fragments one after the
    other, or the padded starts, one spare entry, then the fragments
    (8-byte aligned); and LaunchParams' k-step counts match them."""
    from repro_torch.core.domain import (SierpinskiDomain,
                                         TriangularDomain)
    d = SierpinskiDomain(64)
    plan = TP.GridPlan(d, "mma", storage="compact", backend="cpu")
    ops = plan.mma_operand_tensor("cpu")
    p = plan.launch_params(256, 4, "cpu")
    assert ops.dtype == torch.int32 and p.mma_ops is ops
    assert ops.numel() == (2 * p.mk + p.mk2) * 64
    c, s, nb = TM.fractal_operands(TF.SIERPINSKI, 6)
    np.testing.assert_array_equal(ops.numpy(), np.concatenate(
        [c.ravel(), s.ravel(), nb.ravel()]))
    tri = TP.GridPlan(TriangularDomain(40), "mma", backend="cpu")
    p = tri.launch_params(160, 4, "cpu")
    assert p.mk == TM.ksteps(40) and p.mma_ops.numel() == \
        p.mk * 16 + 2 + p.mk * 64
    assert (p.mk * 16 + 2) % 2 == 0
    assert TP.GridPlan(d, "closed_form", backend="cpu").launch_params(
        64, 1, "cpu").mma_ops is None


# ---------------------------------------------------------------------------
# GridPlan's mma table against the JAX package's and against lut_host
# ---------------------------------------------------------------------------

def _plan_cases():
    out = []
    for size in ("small", "medium"):
        for name, dom in TP.registered_domains(size).items():
            spec = TM.fractal_of(dom)
            for storage in TP.STORAGES:
                for coarsen in (1, 2, 3):
                    if coarsen > 1 and (spec is None or spec[0].m != coarsen
                                        or dom.r_b < 1):
                        continue
                    out.append((size, name, storage, coarsen))
    return out


@pytest.mark.parametrize("size,name,storage,coarsen", _plan_cases())
def test_mma_table_equals_jax_and_lut(size, name, storage, coarsen):
    tp = TP.GridPlan(TP.registered_domains(size)[name], "mma",
                     storage=storage, coarsen=coarsen, backend="cpu")
    jp = JP.GridPlan(JP.registered_domains(size)[name], "mma",
                     storage=storage, coarsen=coarsen,
                     backend="tpu-interpret")
    table = tp.mma_table_host()
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, jp.mma_table_host())
    np.testing.assert_array_equal(table, tp.lut_host())
    assert torch.equal(tp.mma_table("cpu"), torch.from_numpy(table.copy()))
