"""The port's fractal maps and block domains against the JAX package.

Every table is compared exactly: the same integer inputs (numpy, from a
fixed seed) go through ``repro`` and ``repro_torch``, the port once with
numpy and once with int64 tensors.
"""
import numpy as np
import pytest
import torch

from repro.core import domain as JD
from repro.core import fractal as JF
from repro.core import plan as JP
from repro_torch.core import domain as TD
from repro_torch.core import fractal as TF
from repro_torch.core import plan as TP

RNG = np.random.default_rng(0)
SIZES = ("small", "medium")


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _both(fn, *args):
    """fn on numpy args and on the same args as int64 tensors."""
    host = fn(*args)
    dev = fn(*(torch.from_numpy(np.asarray(a, np.int64))
               if isinstance(a, np.ndarray) else a for a in args))
    return host, dev


def _domain_pairs(size):
    ref = JP.registered_domains(size)
    port = TP.registered_domains(size)
    assert list(ref) == list(port)
    return [(name, ref[name], port[name]) for name in ref]


@pytest.mark.parametrize("size", SIZES)
def test_domain_tables_match(size):
    for name, jd, td in _domain_pairs(size):
        assert td.num_blocks == jd.num_blocks, name
        assert td.bounding_box == jd.bounding_box, name
        assert td.cache_key == jd.cache_key, name
        coords = jd.coords_host()
        _eq(td.coords_host(), coords)
        i = np.arange(jd.num_blocks, dtype=np.int64)
        for got in _both(td.block_coords, i):
            _eq(got[0], coords[:, 0])
            _eq(got[1], coords[:, 1])
        bx = coords[:, 0].astype(np.int64)
        by = coords[:, 1].astype(np.int64)
        for got in _both(td.linear_index, bx, by):
            _eq(got, jd.linear_index(bx, by))
        nbx, nby = jd.bounding_box
        gy, gx = np.mgrid[0:nby, 0:nbx].astype(np.int64)
        want = np.broadcast_to(np.asarray(jd.contains(gx, gy)), gx.shape)
        for got in _both(td.contains, gx, gy):
            _eq(np.broadcast_to(_np(got), gx.shape), want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("block", [1, 3, 4])
def test_cell_member_matches(size, block):
    for name, jd, td in _domain_pairs(size):
        nbx, nby = jd.bounding_box
        n = nby * block
        gy, gx = np.mgrid[0:nby * block, 0:nbx * block].astype(np.int64)
        try:
            want = np.asarray(jd.cell_member(gx, gy, n))
        except ValueError:  # a FractalSpec needs n = m**r
            with pytest.raises(ValueError):
                td.cell_member(gx, gy, n)
            continue
        for got in _both(lambda x, y: td.cell_member(x, y, n), gx, gy):
            _eq(got, want)


@pytest.mark.parametrize("r", range(0, 11))
def test_gasket_lambda_tables_full(r):
    i = np.arange(3 ** r, dtype=np.int64)
    lx, ly = JF.lambda_map_linear(i, r)
    for got in _both(lambda t: TF.lambda_map_linear(t, r), i):
        _eq(got[0], lx)
        _eq(got[1], ly)
    # orthotope form and both inverses
    ox, oy = JF.orthotope_shape(r)
    assert TF.orthotope_shape(r) == (ox, oy)
    wy, wx = np.mgrid[0:oy, 0:ox].astype(np.int64)
    want = JF.lambda_map(wx, wy, r)
    for got in _both(lambda a, b: TF.lambda_map(a, b, r), wx, wy):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    lx, ly = np.asarray(lx), np.asarray(ly)
    want = JF.lambda_inverse(lx, ly, r)
    for got in _both(lambda a, b: TF.lambda_inverse(a, b, r), lx, ly):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    for got in _both(lambda t: TF.deinterleave_linear(t, 3, r), i):
        _eq(got[0], JF.deinterleave_linear(i, 3, r)[0])
        _eq(got[1], JF.deinterleave_linear(i, 3, r)[1])
    n = 2 ** r
    _eq(TF.membership_grid(n), JF.membership_grid(n))
    assert TF.gasket_volume(n) == JF.gasket_volume(n) == 3 ** r


@pytest.mark.parametrize("r", range(1, 6))
def test_orthotope_helpers_match_exactly(r):
    # A16: repro.core's block table and orthotope bridges, exact as index
    # tables are; the helpers default to the card, so the CPU is named
    import jax.numpy as jnp
    n = 2 ** r
    got = TF.all_block_coords(r, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    _eq(got, JF.all_block_coords(r))
    g = RNG.normal(size=(n, n, 3)).astype(np.float32)
    want = np.asarray(JF.pack_to_orthotope(jnp.asarray(g), r))
    packed = TF.pack_to_orthotope(torch.from_numpy(g), r)
    assert packed.dtype == torch.float32
    _eq(packed, want)
    _eq(TF.pack_to_orthotope(g, r, device="cpu"), want)
    for fill in (0, -1.5):
        _eq(TF.unpack_from_orthotope(packed, r, n, fill=fill),
            JF.unpack_from_orthotope(jnp.asarray(want), r, n, fill=fill))
    ints = np.arange(n * n, dtype=np.int32).reshape(n, n)
    _eq(TF.unpack_from_orthotope(TF.pack_to_orthotope(ints, r,
                                                      device="cpu"),
                                 r, n, fill=-1),
        JF.unpack_from_orthotope(JF.pack_to_orthotope(jnp.asarray(ints), r),
                                 r, n, fill=-1))


def test_gasket_lambda_spot_checks_r16():
    r = 16
    i = RNG.integers(0, 3 ** r, size=4096).astype(np.int64)
    i[:2] = (0, 3 ** r - 1)
    lx, ly = JF.lambda_map_linear(i, r)
    for got in _both(lambda t: TF.lambda_map_linear(t, r), i):
        _eq(got[0], lx)
        _eq(got[1], ly)
    lx, ly = np.asarray(lx), np.asarray(ly)
    for got in _both(lambda a, b: TF.lambda_inverse(a, b, r), lx, ly):
        _eq(got[0], JF.lambda_inverse(lx, ly, r)[0])
        _eq(got[1], JF.lambda_inverse(lx, ly, r)[1])
    n = 2 ** r
    x = RNG.integers(0, n, size=4096).astype(np.int64)
    y = RNG.integers(0, n, size=4096).astype(np.int64)
    for got in _both(lambda a, b: TF.is_member(a, b, n), x, y):
        _eq(got, JF.is_member(x, y, n))
    d = TD.SierpinskiDomain(n)
    for got in _both(d.linear_index, lx, ly):
        _eq(got, i)


def test_python_int_inputs_match():
    for r, t in [(5, 100), (16, 3 ** 16 - 1)]:
        assert tuple(map(int, TF.lambda_map_linear(t, r))) == \
            tuple(map(int, JF.lambda_map_linear(t, r)))
    for spec in ("sierpinski-carpet", "vicsek-cross"):
        js, ts = JF.FRACTALS[spec], TF.FRACTALS[spec]
        assert tuple(map(int, ts.lambda_map_linear(37, 3))) == \
            tuple(map(int, js.lambda_map_linear(37, 3)))
        assert int(ts.linear_index(4, 7, 3)) == int(js.linear_index(4, 7, 3))
        assert bool(ts.is_member(4, 7, 27)) == bool(js.is_member(4, 7, 27))
    assert TD.TriangularDomain(9).block_coords(30) == \
        JD.TriangularDomain(9).block_coords(30)


@pytest.mark.parametrize("name", ["sierpinski-carpet", "vicsek-cross",
                                  "sierpinski-gasket"])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_spec_tables_match(name, r):
    js, ts = JF.FRACTALS[name], TF.FRACTALS[name]
    assert (ts.k, ts.m, ts.offsets) == (js.k, js.m, js.offsets)
    assert ts.cache_key == js.cache_key
    assert ts.hausdorff == js.hausdorff
    n = ts.m ** r
    assert ts.volume(n) == js.volume(n)
    assert ts.orthotope_shape(r) == js.orthotope_shape(r)
    i = np.arange(ts.k ** r, dtype=np.int64)
    lx, ly = js.lambda_map_linear(i, r)
    for got in _both(lambda t: ts.lambda_map_linear(t, r), i):
        _eq(got[0], lx)
        _eq(got[1], ly)
    ox, oy = js.orthotope_shape(r)
    wy, wx = np.mgrid[0:oy, 0:ox].astype(np.int64)
    want = js.lambda_map(wx, wy, r)
    for got in _both(lambda a, b: ts.lambda_map(a, b, r), wx, wy):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    gy, gx = np.mgrid[0:n, 0:n].astype(np.int64)
    for fn in ("lambda_inverse",):
        want = getattr(js, fn)(gx, gy, r)
        for got in _both(lambda a, b: getattr(ts, fn)(a, b, r), gx, gy):
            _eq(got[0], want[0])
            _eq(got[1], want[1])
    for got in _both(lambda a, b: ts.linear_index(a, b, r), gx, gy):
        _eq(got, js.linear_index(gx, gy, r))
    for got in _both(lambda a, b: ts.is_member(a, b, n), gx, gy):
        _eq(got, js.is_member(gx, gy, n))
    _eq(ts.membership_grid(n), js.membership_grid(n))


def test_triangular_decode_matches_near_limit():
    # the integer-sqrt decode with its correction steps, up to the
    # 2**24-block bound the domain asserts
    m = 5791
    jd, td = JD.TriangularDomain(m), TD.TriangularDomain(m)
    i = RNG.integers(0, jd.num_blocks, size=20000).astype(np.int64)
    i[:2] = (0, jd.num_blocks - 1)
    want = jd.block_coords(i)
    for got in _both(td.block_coords, i):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    # perfect squares and their neighbours are where a float sqrt slips
    q = np.arange(1, m, dtype=np.int64)
    edge = np.concatenate([q * (q + 1) // 2 - 1, q * (q + 1) // 2])
    for got in _both(td.block_coords, edge):
        _eq(got[0], jd.block_coords(edge)[0])
        _eq(got[1], jd.block_coords(edge)[1])
    with pytest.raises(ValueError):
        TD.TriangularDomain(5793)


@pytest.mark.parametrize("m,w,mk", [(8, 3, None), (24, 5, None),
                                    (6, 3, 10), (5, 9, None)])
def test_band_decode_matches(m, w, mk):
    jd, td = JD.BandDomain(m, w, mk), TD.BandDomain(m, w, mk)
    assert td.num_blocks == jd.num_blocks
    i = np.arange(jd.num_blocks, dtype=np.int64)
    for got in _both(td.block_coords, i):
        _eq(got[0], jd.block_coords(i)[0])
        _eq(got[1], jd.block_coords(i)[1])


def test_domain_factories_and_errors():
    for kind, mq, mk, w in [("causal", 4, 4, None), ("local", 6, 6, 2),
                            ("full", 3, 5, None), ("local", 4, 8, 3)]:
        jd = JD.make_attention_domain(kind, mq, mk, w)
        td = TD.make_attention_domain(kind, mq, mk, w)
        assert type(td).__name__ == type(jd).__name__
        _eq(td.coords_host(), jd.coords_host())
    for args in [("causal", 4, 5, None), ("local", 4, 4, None),
                 ("local", 4, 4, 0), ("bogus", 4, 4, None),
                 ("local", 6, 4, 2), ("local", 4, 5, 3)]:
        with pytest.raises(ValueError):
            JD.make_attention_domain(*args)
        with pytest.raises(ValueError):
            TD.make_attention_domain(*args)
    for fractal, n_b in [("sierpinski", 8), ("sierpinski-gasket", 16),
                         ("sierpinski-carpet", 27), ("vicsek-cross", 9)]:
        jd = JD.make_fractal_domain(fractal, n_b)
        td = TD.make_fractal_domain(fractal, n_b)
        assert td.name == jd.name and td.num_blocks == jd.num_blocks
        assert td.space_efficiency() == jd.space_efficiency()
    for fractal, n_b in [("koch", 8), ("sierpinski-gasket", 12),
                         ("sierpinski-carpet", 8)]:
        with pytest.raises(ValueError):
            JD.make_fractal_domain(fractal, n_b)
        with pytest.raises(ValueError):
            TD.make_fractal_domain(fractal, n_b)
    with pytest.raises(ValueError):
        TF.scale_level(12)


def test_bounding_box_member_closure_is_uncacheable():
    td = TD.BoundingBoxDomain(4, 4, member=lambda x, y: x <= y)
    assert td.cache_key is None and not td.always_member
    gy, gx = np.mgrid[0:4, 0:4]
    _eq(td.contains(torch.from_numpy(gx), torch.from_numpy(gy)), gx <= gy)
