"""The port's GridPlan, target descriptor and memo against the JAX package.

Plan tables (decode LUT, grid, step order, row extents) must be equal
to ``repro.core.plan.GridPlan``'s for every registered domain under the
three ported lowerings.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import plan as JP
from repro_torch.core import backend as TB
from repro_torch.core import domain as TD
from repro_torch.core import memo as TM
from repro_torch.core import plan as TP

SIZES = ("small", "medium")


def _pairs(size):
    ref, port = JP.registered_domains(size), TP.registered_domains(size)
    return [(name, ref[name], port[name]) for name in ref]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("lowering", TP.LOWERINGS)
@pytest.mark.parametrize("batch_dims", [(), (3,)])
def test_plan_tables_match(size, lowering, batch_dims):
    for name, jd, td in _pairs(size):
        jp = JP.GridPlan(jd, lowering, batch_dims=batch_dims,
                         backend="tpu-interpret")
        tp = TP.GridPlan(td, lowering, batch_dims=batch_dims, backend="cpu")
        assert tp.grid == jp.grid, name
        assert tp.num_steps == jp.num_steps, name
        assert tp.domain_dims == jp.domain_dims, name
        assert tp.steps_per_launch == jp.steps_per_launch, name
        np.testing.assert_array_equal(tp.lut_host(), jp.lut_host())
        assert tp.lut_host().dtype == np.int32
        np.testing.assert_array_equal(tp.row_extents(), jp.row_extents())
        dom_grid = jp.grid[len(batch_dims):]
        batch = tuple(d - 1 for d in batch_dims)
        for ids in itertools.product(*(range(d) for d in dom_grid)):
            gids = batch + ids
            lin = tp.linear_step(gids)
            assert lin == jp.linear_step(gids), (name, gids)
            assert tp.grid_ids_at(lin, batch) == jp.grid_ids_at(lin, batch)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("lowering", TP.LOWERINGS)
def test_step_coords_follow_the_lowering(size, lowering):
    """The plain versions' decode of every step equals the reference's
    scheduled coords: lambda order, or row-major bounding box with the
    contains() discard."""
    for name, jd, td in _pairs(size):
        tp = TP.GridPlan(td, lowering, backend="cpu")
        steps = tp.steps_per_launch
        bx, by, valid = tp.step_coords(0, steps, "cpu")
        if lowering == "bounding":
            nbx, nby = jd.bounding_box
            gy, gx = np.mgrid[0:nby, 0:nbx]
            np.testing.assert_array_equal(bx.numpy(), gx.ravel())
            np.testing.assert_array_equal(by.numpy(), gy.ravel())
            want = np.broadcast_to(jd.contains(gx, gy), gx.shape).ravel()
            got = (np.ones(steps, bool) if valid is None
                   else valid.numpy())
            np.testing.assert_array_equal(got, want)
        else:
            assert valid is None
            coords = jd.coords_host()
            np.testing.assert_array_equal(bx.numpy(), coords[:, 0])
            np.testing.assert_array_equal(by.numpy(), coords[:, 1])
        # a chunk decodes like the same rows of the whole
        mid = steps // 2
        cb = tp.step_coords(mid, steps, "cpu")
        np.testing.assert_array_equal(cb[0].numpy(), bx[mid:].numpy())
        np.testing.assert_array_equal(cb[1].numpy(), by[mid:].numpy())


def test_launch_params():
    dom = TD.SierpinskiDomain(16)
    for lowering in TP.LOWERINGS:
        p = TP.GridPlan(dom, lowering, backend="cpu").launch_params(
            128, 8, "cpu")
        assert (p.family, p.r_b, p.k, p.m, p.r_cell) == \
            (TP.FAMILY_GASKET, 4, 3, 2, 0)
        assert (p.n, p.block, p.nbx) == (128, 8, 16)
        assert p.lowering == TP.LOWERING_CODES[lowering]
        assert p.steps == (256 if lowering == "bounding" else 81)
        if lowering == "prefetch_lut":
            assert p.lut.dtype == torch.int32 and p.lut.shape == (81, 2)
            np.testing.assert_array_equal(p.lut.numpy(), dom.coords_host())
        else:
            assert p.lut is None
    carpet = TD.make_fractal_domain("sierpinski-carpet", 9)
    p = TP.GridPlan(carpet, "closed_form", backend="cpu").launch_params(
        81, 9, "cpu")
    assert (p.family, p.r_b, p.k, p.m, p.r_cell) == (TP.FAMILY_SPEC, 2, 8, 3, 2)
    assert p.offsets == carpet.spec.offsets
    with pytest.raises(ValueError, match="power of m"):
        TP.GridPlan(carpet, backend="cpu").launch_params(90, 10, "cpu")
    # the row-major domains have a device-side decode of their own
    for dom, fam in ((TD.TriangularDomain(4), TP.FAMILY_TRIANGULAR),
                     (TD.BandDomain(8, 3), TP.FAMILY_BAND),
                     (TD.BoundingBoxDomain(3, 3), TP.FAMILY_BOX)):
        p = TP.GridPlan(dom, backend="cpu").launch_params(32, 8, "cpu")
        assert p.family == fam and p.nblocks == dom.num_blocks
        assert (p.nbx, p.nby) == dom.bounding_box
    with pytest.raises(ValueError, match="membership callable"):
        TP.GridPlan(TD.BoundingBoxDomain(3, 3, member=lambda x, y: x <= y),
                    backend="cpu").launch_params(24, 8, "cpu")


@pytest.mark.parametrize("kw,exc,match", [
    # the gasket at n_b = 2^16 has 3^16 >= 2^24 blocks: the mma chains
    # would stop being exact, and the plan refuses before any launch
    (dict(lowering="mma", n_b=1 << 16), ValueError, "2\\^24"),
    # "auto" is resolved at the entry points, never by a plan: the
    # reference's ValueError
    (dict(lowering="auto"), ValueError, "unknown lowering 'auto'"),
    (dict(lowering="mma", storage="compact", n_b=1 << 16), ValueError,
     "2\\^24"),
    (dict(lowering="auto", coarsen=2), ValueError,
     "unknown lowering 'auto'"),
])
def test_unported_options_name_their_roadmap_item(kw, exc, match):
    n_b = kw.pop("n_b", 8)
    with pytest.raises(exc, match=match):
        TP.GridPlan(TD.SierpinskiDomain(n_b), backend="cpu", **kw)


@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("coarsen", [1, 2, 4])
def test_compact_and_coarsened_plans_match(storage, coarsen):
    """Compact storage and coarsening build like the reference: the grid
    enumerates the coarse domain, the LUT has one row per superblock."""
    jd, td = JP.registered_domains()["sierpinski"], TP.registered_domains()[
        "sierpinski"]
    for lowering in TP.LOWERINGS:
        jp = JP.GridPlan(jd, lowering, storage=storage, coarsen=coarsen,
                         backend="tpu-interpret")
        tp = TP.GridPlan(td, lowering, storage=storage, coarsen=coarsen,
                         backend="cpu")
        assert tp.grid == jp.grid and tp.storage == jp.storage
        assert tp.sched_domain.cache_key == jp.sched_domain.cache_key
        np.testing.assert_array_equal(tp.lut_host(), jp.lut_host())
        assert tp.layout.grid_shape == jp.layout.grid_shape


def test_lowering_and_storage_validation():
    assert TP.normalize_lowering("compact") == "closed_form"
    for name in TP.LOWERINGS:
        assert TP.normalize_lowering(name) == JP.normalize_lowering(name)
    with pytest.raises(ValueError):
        TP.normalize_lowering("bogus")
    with pytest.raises(ValueError):
        TP.normalize_storage("bogus")
    with pytest.raises(ValueError):
        TP.GridPlan(TD.SierpinskiDomain(8), coarsen=0, backend="cpu")
    assert TP.STORAGES == JP.STORAGES
    # tests/test_sched.py's coarsen validation
    with pytest.raises(ValueError):  # not a fractal domain
        TP.GridPlan(TD.TriangularDomain(6), coarsen=2, backend="cpu")
    with pytest.raises(ValueError):  # not a power of m=2
        TP.GridPlan(TD.SierpinskiDomain(8), coarsen=3, backend="cpu")
    with pytest.raises(ValueError):  # coarser than the whole grid
        TP.GridPlan(TD.SierpinskiDomain(8), coarsen=16, backend="cpu")
    assert TP.GridPlan(TD.TriangularDomain(6), coarsen=1,
                       backend="cpu").coarsen == 1


def test_backend_resolve_follows_the_device():
    assert TB.resolve(torch.zeros(1)) is TB.CPU
    assert TB.resolve("cpu") is TB.CPU
    assert TB.resolve(None) is TB.CUDA
    assert TB.resolve("cuda:1") is TB.CUDA
    assert TB.resolve(torch.device("cuda", 0)) is TB.CUDA
    assert TB.resolve(TB.CPU) is TB.CPU
    assert TB.CUDA.arch == "sm_90a" and TB.CUDA.kernels
    assert not TB.CPU.kernels
    with pytest.raises(ValueError, match="meta"):
        TB.resolve(torch.empty(1, device="meta"))
    assert TB.default_device("cpu") == torch.device("cpu")
    plan = TP.GridPlan(TD.SierpinskiDomain(8), backend=torch.zeros(1))
    assert plan.target is TB.CPU


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert TB.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.default_device()


def test_memo_caches_lut_per_domain_identity():
    TM.clear()
    a = TP.GridPlan(TD.SierpinskiDomain(16), "prefetch_lut", backend="cpu")
    b = TP.GridPlan(TD.SierpinskiDomain(16), "prefetch_lut", backend="cpu")
    assert a.lut_host() is b.lut_host()
    assert a.lut("cpu") is b.lut("cpu")
    assert TM.STATS["hits"] >= 2
    uncached = TD.BoundingBoxDomain(3, 3, member=lambda x, y: x <= y)
    assert TM.domain_key(uncached) is None
    p = TP.GridPlan(uncached, "prefetch_lut", backend="cpu")
    misses = TM.STATS["misses"]
    p.lut_host()
    p.lut_host()
    assert TM.STATS["misses"] == misses + 2  # every lookup rebuilds
    assert TM.size() >= 2
    TM.clear()
    assert TM.size() == 0 and TM.STATS == {"hits": 0, "misses": 0}
