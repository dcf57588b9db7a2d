"""The port's compact orthotope storage against the JAX package.

Slot tables, 8-neighbour slot tables, supertile geometry, cell-level
neighbour tables and the 28-column compact LUT must be exactly equal to
``repro.core.compact`` / ``repro.core.plan``'s for every registered
domain; ``pack``/``unpack`` must be bit-equal for f32, bf16 and int32
and round-trip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as JC
from repro.core import plan as JP
from repro.core.domain import make_fractal_domain as j_fractal_domain
from repro_torch.core import compact as TC
from repro_torch.core import plan as TP
from repro_torch.core.domain import make_fractal_domain as t_fractal_domain
from torch_parity import DTYPES, as_f32

SIZES = ("small", "medium")
#: subdivision factor of each registered fractal domain
_M = {"sierpinski": 2, "carpet": 3, "vicsek": 3}


def _pairs(size):
    ref, port = JP.registered_domains(size), TP.registered_domains(size)
    return [(name, ref[name], port[name]) for name in ref]


def _coarsenings(name, domain):
    """1 and every valid coarsening of a registered domain."""
    out = [1]
    m = _M.get(name)
    if m is not None:
        s = m
        while s <= m ** domain.r_b:
            out.append(s)
            s *= m
    return out


@pytest.mark.parametrize("size", SIZES)
def test_neighbor_offsets_match(size):
    assert TC.NEIGHBOR_OFFSETS == JC.NEIGHBOR_OFFSETS
    assert TC.NEIGHBOR_OFFSETS8 == JC.NEIGHBOR_OFFSETS8
    for name, jd, td in _pairs(size):
        assert TP.GridPlan(td, backend="cpu").layout.grid_shape == \
            JP.GridPlan(jd, backend="tpu-interpret").layout.grid_shape, name


@pytest.mark.parametrize("size", SIZES)
def test_slot_tables_match(size):
    for name, jd, td in _pairs(size):
        jl, tl = JC.CompactLayout(jd), TC.CompactLayout(td)
        assert tl.grid_shape == jl.grid_shape, name
        assert tl.num_slots == jl.num_slots, name
        for block in (1, 3, 4):
            assert tl.array_shape(block) == jl.array_shape(block)
            assert tl.embedded_shape(block) == jl.embedded_shape(block)
            assert tl.num_cells(block) == jl.num_cells(block)
            assert tl.embedded_cells(block) == jl.embedded_cells(block)
        np.testing.assert_array_equal(tl.slots_host(), jl.slots_host())
        np.testing.assert_array_equal(tl.neighbor_slots_host(),
                                      jl.neighbor_slots_host())
        assert tl.neighbor_slots_host().dtype == np.int32


@pytest.mark.parametrize("size", SIZES)
def test_slot_addressing_on_tensors_matches_host(size):
    """``slot``/``neighbor_slot`` on int64 tensors (the plain versions'
    path) equal the host tables, including the non-member fall-through."""
    for name, jd, td in _pairs(size):
        tl, jl = TC.CompactLayout(td), JC.CompactLayout(jd)
        nbx, nby = td.bounding_box
        gy, gx = np.mgrid[0:nby, 0:nbx]
        sx, sy = tl.slot(torch.from_numpy(gx.ravel()),
                         torch.from_numpy(gy.ravel()))
        jx, jy = jl.slot(gx.ravel(), gy.ravel())
        np.testing.assert_array_equal(sx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(sy.numpy(), np.asarray(jy))
        c = torch.from_numpy(td.coords_host().astype(np.int64))
        for j, (dx, dy) in enumerate(TC.NEIGHBOR_OFFSETS8):
            nx, ny, ok = tl.neighbor_slot(c[:, 0], c[:, 1], dx, dy)
            want = jl.neighbor_slots_host()[:, j]
            np.testing.assert_array_equal(
                np.stack([nx.numpy(), ny.numpy(), ok.numpy()], -1), want)


_TILINGS = [("sierpinski-gasket", 16, 2), ("sierpinski-gasket", 16, 4),
            ("sierpinski-gasket", 32, 2), ("sierpinski-gasket", 32, 4),
            ("sierpinski-gasket", 32, 8), ("sierpinski-carpet", 27, 3),
            ("sierpinski-carpet", 27, 9), ("vicsek-cross", 27, 3),
            ("vicsek-cross", 81, 3)]


@pytest.mark.parametrize("fractal,n_b,s", _TILINGS)
def test_supertiling_tables_match(fractal, n_b, s):
    jt = JC.SuperTiling(j_fractal_domain(fractal, n_b), s)
    tt = TC.SuperTiling(t_fractal_domain(fractal, n_b), s)
    assert (tt.s, tt.j, tt.sub_shape) == (jt.s, jt.j, jt.sub_shape)
    assert tt.members_per_tile == jt.members_per_tile
    assert tt.coarse.cache_key == jt.coarse.cache_key
    assert tt.tile_map() == jt.tile_map()
    np.testing.assert_array_equal(tt.tiles_host(), jt.tiles_host())
    np.testing.assert_array_equal(tt.neighbor_tiles_host(),
                                  jt.neighbor_tiles_host())
    # the transpose of odd j, on tensors
    c = torch.from_numpy(tt.coarse.coords_host().astype(np.int64))
    tx, ty = tt.tile_index(c[:, 0], c[:, 1])
    np.testing.assert_array_equal(np.stack([tx.numpy(), ty.numpy()], -1),
                                  jt.tiles_host())


def test_supertiling_validation_matches():
    for args in ((t_fractal_domain("sierpinski-gasket", 8), 3),
                 (t_fractal_domain("sierpinski-gasket", 8), 16),
                 (t_fractal_domain("sierpinski-carpet", 9), 2),
                 (TP.registered_domains()["triangular"], 2)):
        with pytest.raises(ValueError):
            TC.SuperTiling(*args)


@pytest.mark.parametrize("r", range(0, 9))
def test_cell_neighbor_tables_match_gasket(r):
    want = JC.cell_neighbor_tables(r)
    got = TC.cell_neighbor_tables(r)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the on-device build (here: the CPU) gives the same table
    np.testing.assert_array_equal(
        TC.cell_neighbor_tables(r, device="cpu").numpy(), want)


@pytest.mark.parametrize("fractal,r", [("sierpinski-carpet", 3),
                                       ("sierpinski-carpet", 4),
                                       ("vicsek-cross", 4),
                                       ("vicsek-cross", 5)])
def test_cell_neighbor_tables_match_spec(fractal, r):
    from repro.core import fractal as JF
    from repro_torch.core import fractal as TF
    want = JC.cell_neighbor_tables(r, JF.FRACTALS[fractal])
    np.testing.assert_array_equal(
        TC.cell_neighbor_tables(r, TF.FRACTALS[fractal]), want)
    np.testing.assert_array_equal(
        TC.cell_neighbor_tables(r, TF.FRACTALS[fractal], "cpu").numpy(),
        want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("lowering", TP.LOWERINGS)
def test_compact_lut_matches(size, lowering):
    """The 28-column compact LUT, for every registered domain and each
    coarsening it allows."""
    for name, jd, td in _pairs(size):
        for s in _coarsenings(name, td):
            jp = JP.GridPlan(jd, lowering, storage="compact", coarsen=s,
                             backend="tpu-interpret")
            tp = TP.GridPlan(td, lowering, storage="compact", coarsen=s,
                             backend="cpu")
            got = tp.lut_host()
            assert got.dtype == np.int32 and got.shape[1] == 28, name
            np.testing.assert_array_equal(got, jp.lut_host())
            assert tp.grid == jp.grid and tp.steps_per_launch == \
                jp.steps_per_launch, (name, s)
            assert tp.supertile_shape((4, 4)) == jp.supertile_shape((4, 4))
            assert tp.tile_map() == jp.tile_map()
            for a, b in zip(tp.cell_offset_grids(3), jp.cell_offset_grids(3)):
                np.testing.assert_array_equal(a, b)


def _ref_grid_ids(jp, steps):
    t = np.arange(steps)
    if jp.lowering == "bounding":
        nbx = jp.grid[-1]
        return (t // nbx, t % nbx)
    return (t,)


@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("lowering", TP.LOWERINGS)
def test_storage_and_neighbor_index_match(storage, lowering):
    """storage_index / neighbor_index as tensor index math over a range
    of steps equal the reference's per-step index maps."""
    for name, jd, td in _pairs("small")[:3]:
        for s in _coarsenings(name, td):
            jp = JP.GridPlan(jd, lowering, storage=storage, coarsen=s,
                             backend="tpu-interpret")
            tp = TP.GridPlan(td, lowering, storage=storage, coarsen=s,
                             backend="cpu")
            steps = tp.steps_per_launch
            ids = _ref_grid_ids(jp, steps)
            refs = (jp.lut_host(),)
            got = tp.storage_index(0, steps, "cpu")
            want = jp.storage_index(ids, refs)
            if lowering == "bounding":  # only member steps are addressed
                valid = np.asarray(jp.sched_domain.contains(ids[1], ids[0]))
            else:
                valid = np.ones(steps, bool)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy()[valid],
                                              np.asarray(w)[valid])
            for j in range(8):
                got = tp.neighbor_index(j, 0, steps, "cpu")
                want = jp.neighbor_index(j, ids, refs)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.numpy()[valid],
                                                  np.asarray(w)[valid])


def test_launch_params_under_compact_coarsening():
    dom = t_fractal_domain("sierpinski-gasket", 16)
    for s, swap in ((1, 0), (2, 1), (4, 0)):
        plan = TP.GridPlan(dom, "prefetch_lut", storage="compact",
                           coarsen=s, backend="cpu")
        p = plan.launch_params(128, 8, "cpu")
        lay = plan.layout
        assert (p.rows, p.pitch) == lay.array_shape(8)
        assert (p.th, p.tw) == plan.supertile_shape((8, 8))
        assert p.storage == TP.STORAGE_CODES["compact"]
        assert (p.coarsen, p.swap, p.r_b, p.r_fine) == \
            (s, swap, 4 - (s.bit_length() - 1), 4)
        assert p.lut.shape == (plan.steps_per_launch, 28)
        assert p.nfine == 3 ** (s.bit_length() - 1)
        if s == 1:
            assert p.tile_perm is None
            continue
        perm = p.tile_perm.numpy()
        fwd, inv = perm[:2 * p.nfine].reshape(-1, 2), perm[2 * p.nfine:]
        for (py, px), (ey, ex) in plan.tile_map():
            q = py * p.bw + px
            assert tuple(fwd[q]) == (ey, ex)
            assert inv[ey * s + ex] == q
        assert (inv >= 0).sum() == p.nfine
    emb = TP.GridPlan(dom, "closed_form", coarsen=4, backend="cpu")
    p = emb.launch_params(128, 8, "cpu")
    assert (p.rows, p.pitch, p.th, p.tw, p.bw, p.nfine) == \
        (128, 128, 32, 32, 4, 16)
    assert p.tile_perm is None and p.lut is None


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", SIZES)
def test_pack_unpack_bit_equal(dtype, size):
    jdt, tdt = DTYPES[dtype]
    for name, jd, td in _pairs(size):
        block = 3 if name in ("carpet", "vicsek") else 4
        jl, tl = JC.CompactLayout(jd), TC.CompactLayout(td)
        rows, cols = jl.embedded_shape(block)
        x = np.random.default_rng(rows + cols).normal(size=(rows, cols))
        t = torch.from_numpy(x.astype(np.float32)).to(tdt)
        j = jnp.asarray(as_f32(t), jdt)
        tp, jpk = tl.pack(t, block), jl.pack(j, block)
        assert tp.dtype == tdt and tuple(tp.shape) == jl.array_shape(block)
        np.testing.assert_array_equal(as_f32(tp), as_f32(jpk))
        tu = tl.unpack(tp, block)
        np.testing.assert_array_equal(as_f32(tu), as_f32(jl.unpack(jpk, block)))
        # round trip: members come back, everything else is the fill
        member = np.zeros((rows // block, cols // block), bool)
        c = td.coords_host()
        member[c[:, 1], c[:, 0]] = True
        cells = np.kron(member, np.ones((block, block), bool))
        np.testing.assert_array_equal(as_f32(tu)[cells], as_f32(t)[cells])
        assert (as_f32(tu)[~cells] == 0).all()
        assert torch.equal(tl.pack(tu, block), tp)
        np.testing.assert_array_equal(
            as_f32(tl.unpack(tp, block, fill=-1))[~cells], -1)


def test_pack_rejects_wrong_shapes():
    tl = TC.CompactLayout(t_fractal_domain("sierpinski-gasket", 8))
    with pytest.raises(ValueError, match="does not match"):
        tl.pack(torch.zeros(30, 32), 4)
    with pytest.raises(ValueError, match="does not match"):
        tl.unpack(torch.zeros(32, 32), 4)


def test_memoized_constructors():
    dom = t_fractal_domain("sierpinski-gasket", 16)
    assert TC.compact_layout(dom) is TC.compact_layout(
        t_fractal_domain("sierpinski-gasket", 16))
    assert TC.super_tiling(dom, 2) is TC.super_tiling(dom, 2)
    assert TC.super_tiling(dom, 2) is not TC.super_tiling(dom, 4)
