"""The port's ShardedPlan / HaloPlan host geometry against the JAX
package's, and the per-rank index functions the plain versions run.

``repro.core.shard.ShardedPlan`` reads only ``mesh.shape[axis]`` when it
is built, so both packages' plans are built in-process from one
stand-in object (no forced JAX devices, no process group).  Every host
table must be exactly equal: the shard table, the LUT chunks, the
sharded mma table, the ghost rows and ghost map, the exchange rounds,
the interior/boundary steps, ``bytes_exchanged``, ``zigzag_row_order``
and the local shapes.  The per-rank decode (closed_form, mma and the
bounding grid) must enumerate each rank's blocks in the order of the
JAX package's LUT chunk, and the storage / neighbour indices must be
the ones that chunk and the ghost map give.
"""
import types

import numpy as np
import pytest
import torch

from repro.core import fractal as JF
from repro.core import shard as JS
from repro.core.domain import (BandDomain as JBand,
                               GeneralizedFractalDomain as JGen,
                               SierpinskiDomain as JGasket,
                               TriangularDomain as JTri)
from repro_torch.core import fractal as TF
from repro_torch.core import shard as TS
from repro_torch.core.domain import (BandDomain as TBand,
                                     GeneralizedFractalDomain as TGen,
                                     SierpinskiDomain as TGasket,
                                     TriangularDomain as TTri)
import torch_parity  # noqa: F401  (one torch thread per worker)

#: (name, reference domain, port domain, coarsenings)
DOMAINS = [
    ("gasket4", lambda: JGasket(4), lambda: TGasket(4), (1, 2)),
    ("gasket8", lambda: JGasket(8), lambda: TGasket(8), (1, 2, 4)),
    ("gasket16", lambda: JGasket(16), lambda: TGasket(16), (1, 4)),
    ("carpet9", lambda: JGen(JF.CARPET, 9), lambda: TGen(TF.CARPET, 9),
     (1, 3)),
    ("vicsek9", lambda: JGen(JF.VICSEK, 9), lambda: TGen(TF.VICSEK, 9),
     (1,)),
    ("triangle8", lambda: JTri(8), lambda: TTri(8), (1,)),
    ("band8x3", lambda: JBand(8, 3), lambda: TBand(8, 3), (1,)),
]
SHARDS = (1, 2, 3, 4)
LOWERINGS = ("closed_form", "prefetch_lut", "bounding", "mma")


def fake_mesh(D):
    return types.SimpleNamespace(shape={"data": D})


def plans(name, storage, coarsen, D, lowering="closed_form", halo=False,
          partition=None, batch_dims=()):
    _, jd, td, _ = next(d for d in DOMAINS if d[0] == name)
    kw = dict(storage=storage, coarsen=coarsen, mesh=fake_mesh(D),
              axis="data", halo=halo, partition=partition,
              batch_dims=batch_dims)
    return (JS.ShardedPlan(jd(), lowering, backend="tpu-interpret", **kw),
            TS.ShardedPlan(td(), lowering, backend="cpu", **kw))


def cases(storages=("embedded", "compact")):
    out = []
    for name, _, _, coarsenings in DOMAINS:
        for storage in storages:
            for s in coarsenings:
                if storage == "embedded" and s > 1 and name == "gasket16":
                    continue
                for D in SHARDS:
                    out.append((name, storage, s, D))
    return out


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


@pytest.mark.parametrize("name,storage,coarsen,D", cases())
def test_shard_tables_and_chunks_equal(name, storage, coarsen, D):
    """The shard table, LUT chunks and local shapes equal the JAX
    package's; the sharded mma table equals its LUT chunks (the mma
    chains are value-equal to the LUT, tests/test_torch_mma.py), and on
    the gasket at n_b 8 its own sharded mma table too (each JAX mma
    table costs a trace)."""
    for lowering in ("prefetch_lut", "mma"):
        jp, tp = plans(name, storage, coarsen, D, "prefetch_lut",
                       halo=storage == "compact")
        if lowering == "mma":
            _, tp = plans(name, storage, coarsen, D, "mma",
                          halo=storage == "compact")
        what = (name, storage, coarsen, D, lowering)
        assert tp.partition == jp.partition, what
        assert tp.steps_per_shard == jp.steps_per_shard, what
        _eq(tp._lo, jp._lo, what)
        _eq(tp._count, jp._count, what)
        _eq(tp.shard_table_host(), jp.shard_table_host(), what)
        if lowering == "prefetch_lut":
            _eq(tp.lut_sharded_host(), jp.lut_sharded_host(), what)
        else:
            _eq(tp.mma_table_sharded_host(), jp.lut_sharded_host(), what)
            if name == "gasket8" and D in (1, 3):
                jm, _ = plans(name, storage, coarsen, D, "mma",
                              halo=storage == "compact")
                _eq(tp.mma_table_sharded_host(),
                    jm.mma_table_sharded_host(), what)
        for block in (2, 4):
            assert tp.local_storage_shape(block) == \
                jp.local_storage_shape(block), what
            if storage == "compact":
                assert tp.global_padded_rows(block) == \
                    jp.global_padded_rows(block), what
        if storage == "compact":
            assert (tp.rpd, tp.ncols, tp.nrows, tp.nrows_pad) == \
                (jp.rpd, jp.ncols, jp.nrows, jp.nrows_pad), what
        assert sum(int(c) for c in tp._count) == \
            tp.sched_domain.num_blocks, what


@pytest.mark.parametrize("name,coarsen,D", [
    (c[0], c[2], c[3]) for c in cases(("compact",))])
def test_halo_plan_equal(name, coarsen, D):
    jp, tp = plans(name, "compact", coarsen, D, halo=True)
    jh, th = jp.halo, tp.halo
    what = (name, coarsen, D)
    assert th.ghost_rows == jh.ghost_rows, what
    assert th.row_class == jh.row_class, what
    assert th.col_span == jh.col_span, what
    assert th.int_steps == jh.int_steps, what
    assert th.bnd_steps == jh.bnd_steps, what
    assert th.h_max == jh.h_max, what
    _eq(th.ghost_map, jh.ghost_map, what)
    assert len(th.rounds) == len(jh.rounds), what
    for rt, rj in zip(th.rounds, jh.rounds):
        assert rt[:2] == rj[:2] and rt[6] == rj[6], what
        for a, b in zip(rt[2:6], rj[2:6]):
            _eq(a, b, what)
    for a, b in zip(th.send_recv_host(), jh.send_recv_host()):
        for x, y in zip(a, b):
            _eq(x, y, what)
    for block in (2, 4):
        for h in (None, 1, 2):
            assert th.bytes_exchanged(tp, block, h) == \
                jh.bytes_exchanged(jp, block, h), (what, block, h)
    assert tp.phase_widths() == jp.phase_widths(), what
    pt, pj = tp.phase_tables_host(), jp.phase_tables_host()
    assert (pt is None) == (pj is None), what
    if pt is not None:
        for a, b in zip(pt, pj):
            _eq(a, b, what)


def _chunk(plan, table, rank):
    per = plan.steps_per_shard
    return table[rank * per:rank * per + int(plan._count[rank])]


@pytest.mark.parametrize("name,storage,coarsen,D", cases())
def test_rank_decode_follows_the_reference_chunks(name, storage, coarsen,
                                                  D):
    """Each rank's closed_form / mma / prefetch_lut step coords are the
    rows of the JAX package's LUT chunk; its bounding grid's owned
    members are the same set; storage and neighbour indices are the
    chunk's slots through the ghost map."""
    jp, _ = plans(name, storage, coarsen, D, "prefetch_lut",
                  halo=storage == "compact")
    ref = jp.lut_sharded_host()
    tbl = jp.shard_table_host()
    seen = []
    for lowering in LOWERINGS:
        _, tp = plans(name, storage, coarsen, D, lowering,
                      halo=storage == "compact")
        for rank in range(D):
            view = tp.for_rank(rank)
            want = _chunk(jp, ref, rank)
            steps = view.steps_per_launch
            bx, by, valid = view.step_coords(0, steps, "cpu")
            what = (name, storage, coarsen, D, lowering, rank)
            if lowering == "bounding":
                got = {(int(x), int(y)) for x, y, v in
                       zip(bx, by, valid) if v}
                assert got == {(int(x), int(y)) for x, y in want[:, :2]}, \
                    what
                continue
            assert valid is None and steps == len(want), what
            _eq(torch.stack([bx, by], -1).numpy(), want[:, :2], what)
            if lowering == "closed_form":
                seen += [(int(x), int(y)) for x, y in want[:, :2]]
            if storage != "compact":
                continue
            row, col = view.storage_index(0, steps, "cpu")
            ncols = tp.ncols
            t = np.arange(steps)
            _eq(row.numpy(), t // ncols, what)
            _eq(col.numpy(), t % ncols, what)
            _eq(col.numpy(), want[:, 2], what)
            _eq(row.numpy() + rank * tp.rpd, want[:, 3], what)
            gmap = tbl[rank, JS.SHARD_GMAP:]
            for j in range(8):
                nrow, ncol = view.neighbor_index(j, 0, steps, "cpu")
                ok = want[:, 4 + 3 * j + 2] == 1
                _eq(ncol.numpy()[ok], want[ok, 4 + 3 * j], (what, j))
                _eq(nrow.numpy()[ok],
                    gmap[np.clip(want[ok, 4 + 3 * j + 1], 0,
                                 tp.nrows_pad - 1)], (what, j))
    # the ranks' closed_form steps cover the domain once
    assert sorted(seen) == sorted(
        (int(x), int(y)) for x, y in jp.sched_domain.coords_host())


@pytest.mark.parametrize("D", (1, 2, 3, 4))
def test_zigzag_and_rows_geometry_equal(D):
    from repro.core.domain import make_attention_domain as jattn
    from repro_torch.core.domain import make_attention_domain as tattn
    m = 8 * D
    _eq(TS.zigzag_row_order(m, D), JS.zigzag_row_order(m, D), D)
    for kind, wb in (("causal", 0), ("local", 3), ("full", 0)):
        for partition in ("rows", "zigzag"):
            if partition == "zigzag" and kind != "causal":
                continue
            jp = JS.ShardedPlan(jattn(kind, m, m, wb), "prefetch_lut",
                                batch_dims=(2,), backend="tpu-interpret",
                                mesh=fake_mesh(D), axis="data",
                                partition=partition)
            tp = TS.ShardedPlan(tattn(kind, m, m, wb), "prefetch_lut",
                                batch_dims=(2,), backend="cpu",
                                mesh=fake_mesh(D), axis="data",
                                partition=partition)
            what = (D, kind, partition)
            _eq(tp.shard_table_host(), jp.shard_table_host(), what)
            _eq(tp.lut_sharded_host(), jp.lut_sharded_host(), what)
            assert tp.rbd == jp.rbd and tp.grid == jp.grid, what
            for rank in range(D):
                view = tp.for_rank(rank)
                want = _chunk(jp, jp.lut_sharded_host(), rank)
                bx, by, _ = view.step_coords(0, len(want), "cpu")
                _eq(torch.stack([bx, by], -1).numpy(), want, what)
                # the local band coords of the rank's blocks
                lx, ly = view._place_coords(bx, by)
                assert int(ly.min()) >= 0 and int(ly.max()) < tp.rbd, what
                if partition == "zigzag":
                    back = view._zz_global_row(ly, rank)
                    _eq(back.numpy(), by.numpy(), what)


@pytest.mark.parametrize("lowering", ("closed_form", "prefetch_lut", "mma"))
def test_device_tables_equal(lowering):
    """device_tables: the shard table and the per-device decode table of
    the table-backed lowerings, as the JAX package's sharded kernels take them
    (its mma table only on TPU structures: the port's kernels run the
    chains, and its plan keeps the table for the tests)."""
    assert (TS.SHARD_LO, TS.SHARD_COUNT, TS.SHARD_ROWLO, TS.SHARD_DEV,
            TS.SHARD_GMAP) == (JS.SHARD_LO, JS.SHARD_COUNT, JS.SHARD_ROWLO,
                               JS.SHARD_DEV, JS.SHARD_GMAP)
    assert TS.PARTITIONS == JS.PARTITIONS
    jp, tp = plans("gasket8", "compact", 1, 3, lowering, halo=True)
    jtbl, jluts = JS.device_tables(jp)
    ttbl, tluts = TS.device_tables(tp)
    _eq(ttbl.numpy(), np.asarray(jtbl), lowering)
    assert len(tluts) == len(jluts) == (lowering != "closed_form")
    for t, j in zip(tluts, jluts):
        _eq(t.numpy(), np.asarray(j), lowering)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_rank_launch_params(lowering):
    """A rank-bound plan's kernel parameters: its local array's shape
    (the extended array under a halo plan, the slab without one), its own
    steps, its LUT chunk, and the SHARD_PARAMS of its slab."""
    from repro_torch.core.plan import STORAGE_CODES
    for halo in (True, False):
        _, tp = plans("gasket8", "compact", 1, 3, lowering, halo=halo)
        for rank in range(3):
            view = tp.for_rank(rank)
            p = view.launch_params(64, 8, "cpu")
            shape = view.extended_shape(8) if halo \
                else view.local_storage_shape(8)
            assert (p.rows, p.pitch) == shape and p.storage == \
                STORAGE_CODES["compact"]
            assert p.steps == (64 if lowering == "bounding"
                               else int(tp._count[rank]))
            assert (p.lut is not None) == (lowering == "prefetch_lut")
            if p.lut is not None:
                _eq(p.lut.numpy()[:int(tp._count[rank])],
                    _chunk(tp, tp.lut_sharded_host(), rank), rank)
            arr, gmap, phase = view.shard_params("cpu")
            got = dict(zip(TS.SHARD_PARAMS, list(arr)))
            assert got["lo"] == rank * tp.rpd * tp.ncols and \
                got["count"] == int(tp._count[rank]) and phase is None
            _eq(gmap.numpy(), tp.halo.ghost_map[rank], rank)


def test_rank_that_owns_nothing():
    # n 32, block 8: a 3 x 3 orthotope; at D 4 the last rank owns no row
    _, tp = plans("gasket4", "compact", 1, 4, halo=True)
    view = tp.for_rank(3)
    assert int(tp._count[3]) == 0 and view.steps_per_launch == 0
    arr, gmap, phase = view.shard_params("cpu")
    assert arr[TS.SHARD_PARAMS.index("count")] == 0 and phase is None
    assert tuple(gmap.shape) == (tp.nrows_pad,)
    m = torch.arange(3 * 8 * 3 * 8, dtype=torch.float32).reshape(24, 24)
    assert tuple(view.slab(m, 8).shape) == (8, 24)
    assert float(view.slab(m, 8).abs().sum()) == 0.0  # all padding
    _eq(tp.pad_rows(m, 8).shape, (32, 24), "pad")


def test_sharded_plan_validation():
    """The reference's own refusals (tests/test_shard.py:348), raised by
    the port's plan with the same messages."""
    mesh = fake_mesh(2)
    dom = TGasket(4)
    with pytest.raises(ValueError, match="partition"):
        TS.ShardedPlan(dom, mesh=mesh, axis="data", partition="bogus")
    with pytest.raises(ValueError, match="storage-rows"):
        TS.ShardedPlan(dom, mesh=mesh, axis="data",
                       partition="storage-rows")
    with pytest.raises(ValueError, match="packed rows"):
        TS.ShardedPlan(dom, storage="compact", mesh=mesh, axis="data",
                       partition="linear")
    with pytest.raises(ValueError, match="row-major"):
        TS.ShardedPlan(dom, mesh=mesh, axis="data", partition="rows")
    TS.ShardedPlan(TTri(8), mesh=mesh, axis="data", partition="rows")
    with pytest.raises(ValueError, match="divisible by 2"):
        TS.ShardedPlan(TTri(6), mesh=mesh, axis="data", partition="zigzag")
    with pytest.raises(ValueError, match="needs a plan bound to a rank"):
        TS.ShardedPlan(dom, mesh=mesh, axis="data").step_coords(0, 1, "cpu")
    plan = TS.ShardedPlan(dom, storage="compact", mesh=mesh, axis="data",
                          halo=True)
    with pytest.raises(ValueError, match="bounding"):
        TS.ShardedPlan(dom, "bounding", storage="compact", mesh=mesh,
                       axis="data", halo=True).phase_view("interior")
    with pytest.raises(ValueError, match="unknown phase"):
        plan.phase_view("middle")


@pytest.mark.parametrize("partition,storage,D", [
    (None, "compact", 3), (None, "embedded", 4), ("rows", "embedded", 2),
    ("zigzag", "embedded", 2)])
def test_shard_count_in_place_of_a_mesh(partition, storage, D):
    """``num_shards=D`` builds the plan a mesh of D ranks builds (the
    host geometry without a process group), and a plan takes one of the
    two, not both or neither."""
    dom = TTri(8) if partition else TGasket(4)
    kw = dict(storage=storage, partition=partition, backend="cpu",
              halo=storage == "compact")
    by_mesh = TS.ShardedPlan(dom, mesh=fake_mesh(D), axis="data", **kw)
    by_count = TS.ShardedPlan(dom, num_shards=D, **kw)
    assert by_count.num_shards == by_mesh.num_shards == D
    assert by_count.partition == by_mesh.partition
    _eq(by_count._count, by_mesh._count, "counts")
    _eq(by_count.shard_table_host(), by_mesh.shard_table_host(), "table")
    if partition == "rows":
        _eq(by_count._row_lo, by_mesh._row_lo, "row_lo")
    with pytest.raises(ValueError, match="not both or neither"):
        TS.ShardedPlan(dom, **kw)
    with pytest.raises(ValueError, match="not both or neither"):
        TS.ShardedPlan(dom, mesh=fake_mesh(D), num_shards=D, **kw)
