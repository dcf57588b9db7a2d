"""The port's static plan verifier against the JAX package's.

* clean matrix: on every plan of the reference's full ``matrix_plans()``
  the port's ``verify_plan(plan, kernel).to_json()`` equals the
  reference's, apart from ``plan["backend"]`` (one reference run per
  module);
* mutation: each seeded fault of ``tests/test_analysis.py`` -- a LUT row,
  a neighbour slot, a shifted or colliding storage index, a dropped or
  duplicated step, in-place aliasing on the stencil, the ghost map, the
  mma basis, the flash hull -- is flagged by the same check names in both
  packages.  The port's table faults are put into the table the launch
  reads (``launch_params`` / ``shard_params`` on the CPU, the memoized
  tensors), never into a host re-derivation;
* the port's own table checks: the supertile permutation and the mma
  chains' tensor-core operands a launch reads.
"""
import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from repro.analysis import verifier as JV
from repro.analysis.verify import matrix_plans as j_matrix_plans
from repro.core.domain import SierpinskiDomain as JSierpinski
from repro.core.domain import TriangularDomain as JTriangular
from repro.core.plan import GridPlan as JPlan
from repro.core.shard import SHARD_GMAP as J_SHARD_GMAP
from repro.core.shard import ShardedPlan as JSharded
from repro_torch.analysis import verifier as TV
from repro_torch.analysis.verify import matrix_plans as t_matrix_plans
from repro_torch.core import memo
from repro_torch.core.domain import SierpinskiDomain, TriangularDomain
from repro_torch.core.plan import _LUT_NBR, GridPlan
from repro_torch.core.shard import ShardedPlan

DOM = SierpinskiDomain(8)          # 27 member blocks: fast to enumerate
N = DOM.num_blocks
LABELS = [label for label, _, _ in t_matrix_plans(smoke=False)]


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Mutations edit memoized tables in place: every test starts and
    ends with a clean memo."""
    memo.clear()
    yield
    memo.clear()


@pytest.fixture(scope="module")
def reference_matrix():
    return {label: JV.verify_plan(plan, kernel=kernel).to_json()
            for label, plan, kernel in j_matrix_plans(smoke=False)}


@pytest.fixture(scope="module")
def port_matrix():
    return {label: TV.verify_plan(plan, kernel=kernel).to_json()
            for label, plan, kernel in t_matrix_plans(smoke=False)}


def test_matrix_labels_are_the_references():
    assert LABELS == [label for label, _, _ in j_matrix_plans(smoke=False)]


@pytest.mark.parametrize("label", LABELS)
def test_matrix_report_equals_the_references(label, reference_matrix,
                                             port_matrix):
    want, got = dict(reference_matrix[label]), dict(port_matrix[label])
    want["plan"], got["plan"] = dict(want["plan"]), dict(got["plan"])
    want["plan"].pop("backend")
    assert got["plan"].pop("backend") == "cpu"
    assert got == want
    assert got["ok"], got["findings"]


def test_report_json_roundtrip():
    report = TV.verify_plan(GridPlan(DOM, "prefetch_lut", backend="cpu"),
                            kernel="write")
    blob = json.loads(json.dumps(report.to_json()))
    assert blob["ok"] and blob["findings"] == []
    assert set(blob["checks"]) == {"coverage", "race", "table", "bounds",
                                   "alias", "hull"}


# ---------------------------------------------------------------------------
# mutations: the same check names as the reference
# ---------------------------------------------------------------------------

def _checks(verify, plan, kernel="write"):
    return {f.check for f in verify(plan, kernel=kernel).findings}


def _same(jplan, tplan, kernel="write"):
    want = _checks(JV.verify_plan, jplan, kernel)
    got = _checks(TV.verify_plan, tplan, kernel)
    assert want, "the reference flags nothing"
    assert got == want
    return got


def _plans(lowering="prefetch_lut", storage="embedded", **kw):
    return (JPlan(JSierpinski(8), lowering, storage=storage, **kw),
            GridPlan(SierpinskiDomain(8), lowering, storage=storage,
                     backend="cpu"))


def _launch_lut(tplan):
    """The LUT a CPU launch of ``tplan`` reads (memoized: edits stick)."""
    return tplan.launch_params(24, 3, "cpu").lut


def test_verify_or_raise_is_value_error():
    _, tplan = _plans()
    _launch_lut(tplan)[0, 0] += 1
    with pytest.raises(TV.PlanVerificationError) as ei:
        TV.verify_or_raise(tplan, kernel="write")
    assert isinstance(ei.value, ValueError)
    assert "table" in str(ei.value)


@pytest.mark.parametrize("row", [0, 1, N // 2, N - 2, N - 1])
def test_corrupt_lut_row_flagged(row):
    jplan, tplan = _plans()
    lut = np.array(jplan.lut_host())
    lut[row, 0] ^= 1
    jplan.lut_host = lambda: lut
    _launch_lut(tplan)[row, 0] ^= 1
    assert "table" in _same(jplan, tplan)


@pytest.mark.parametrize("row,offset", [(0, 0), (N - 1, 7), (5, 3),
                                        (13, 1), (20, 6)])
def test_corrupt_neighbor_slot_flagged(row, offset):
    jplan, tplan = _plans("prefetch_lut", "compact")
    base = _LUT_NBR + 3 * offset
    jl = np.array(jplan.lut_host())
    tl = _launch_lut(tplan)
    for lut in (jl, tl):
        if lut[row, base + 2] == 1:
            lut[row, base] = (lut[row, base] + 1) % \
                tplan.layout.grid_shape[0]
        else:
            lut[row, base + 2] = 1
    jplan.lut_host = lambda: jl
    assert "table" in _same(jplan, tplan, kernel="ca")


def test_shifted_storage_index_flagged_as_bounds():
    jplan, tplan = _plans("closed_form", "compact")
    jorig, torig = jplan.storage_index, tplan.storage_index
    jplan.storage_index = lambda ids, refs=(): (jorig(ids, refs)[0] + 100,
                                                jorig(ids, refs)[1])

    def shifted(start, stop, device):
        r, c = torig(start, stop, device)
        return r + 100, c
    tplan.storage_index = shifted
    assert "bounds" in _same(jplan, tplan)


def test_colliding_storage_index_flagged_as_race():
    jplan, tplan = _plans("closed_form", "compact")
    jorig, torig = jplan.storage_index, tplan.storage_index

    def jcollapsed(ids, refs=()):
        r, c = jorig(ids, refs)
        return np.zeros_like(np.asarray(r)), np.zeros_like(np.asarray(c))

    def tcollapsed(start, stop, device):
        r, c = torig(start, stop, device)
        return torch.zeros_like(r), torch.zeros_like(c)
    jplan.storage_index, tplan.storage_index = jcollapsed, tcollapsed
    assert "race" in _same(jplan, tplan)


def test_dropped_step_flagged_as_coverage():
    jplan, tplan = _plans("closed_form", "embedded")
    jorig, torig = jplan._step_valid, tplan.step_coords

    def jdrop(ids, bx, by, refs=()):
        v = jorig(ids, bx, by, refs)
        v = np.ones(np.asarray(ids[-1]).shape, bool) if v is None \
            else np.array(np.broadcast_to(np.asarray(v),
                                          np.asarray(ids[-1]).shape))
        v.ravel()[np.nonzero(v.ravel())[0][0]] = False
        return v

    def tdrop(start, stop, device):
        bx, by, v = torig(start, stop, device)
        v = torch.ones_like(bx, dtype=torch.bool) if v is None else v.clone()
        v[torch.nonzero(v)[0, 0]] = False
        return bx, by, v
    jplan._step_valid, tplan.step_coords = jdrop, tdrop
    _same(jplan, tplan)
    assert any(f.check == "coverage" and "never covered" in f.detail
               for f in TV.verify_plan(tplan, kernel="write").findings)


def test_duplicated_decode_flagged_as_coverage():
    jplan, tplan = _plans("closed_form", "embedded")
    jorig, torig = jplan._decode, tplan.step_coords

    def jduped(ids, refs=()):
        batch, bx, by = jorig(ids, refs)
        bx = np.array(np.broadcast_to(np.asarray(bx),
                                      np.asarray(ids[-1]).shape))
        by = np.array(np.broadcast_to(np.asarray(by),
                                      np.asarray(ids[-1]).shape))
        bx.ravel()[1] = bx.ravel()[0]
        by.ravel()[1] = by.ravel()[0]
        return batch, bx, by

    def tduped(start, stop, device):
        bx, by, v = torig(start, stop, device)
        bx, by = bx.clone(), by.clone()
        bx[1], by[1] = bx[0], by[0]
        return bx, by, v
    jplan._decode, tplan.step_coords = jduped, tduped
    assert "coverage" in _same(jplan, tplan)


def test_inplace_alias_on_stencil_flagged():
    model = {"race": True, "neighbors": True, "storage": True,
             "alias_reads": ("center+neighbors",)}
    JV.ACCESS_MODELS["_test_inplace_stencil"] = dict(model)
    TV.ACCESS_MODELS["_test_inplace_stencil"] = dict(model)
    try:
        jplan, tplan = _plans("closed_form", "compact")
        assert "alias" in _same(jplan, tplan, "_test_inplace_stencil")
        assert _checks(TV.verify_plan, tplan, "ca") == set()
    finally:
        del JV.ACCESS_MODELS["_test_inplace_stencil"]
        del TV.ACCESS_MODELS["_test_inplace_stencil"]


def _sharded(d, halo=True, lowering="closed_form"):
    return (JSharded(JSierpinski(8), lowering, storage="compact",
                     mesh=JV.HostMesh(d), axis="data",
                     partition="storage-rows", halo=halo),
            ShardedPlan(SierpinskiDomain(8), lowering, storage="compact",
                        backend="cpu", mesh=TV.HostMesh(d), axis="data",
                        partition="storage-rows", halo=halo))


def _launch_gmap(tplan, rank):
    """The ghost map rank ``rank``'s CPU launch reads (memoized)."""
    return tplan.for_rank(rank).shard_params("cpu")[1]


def test_corrupt_ghost_map_flagged():
    jplan, tplan = _sharded(2)
    tbl = np.array(jplan.shard_table_host())
    gmap = tbl[0, J_SHARD_GMAP:]
    ghost = np.nonzero(gmap >= jplan.rpd)[0]
    gmap[ghost[0]] = 0
    jplan.shard_table_host = lambda: tbl
    _launch_gmap(tplan, 0)[ghost[0]] = 0
    assert "table" in _same(jplan, tplan)


@pytest.mark.parametrize("d,seed", [(1, 0), (2, 5), (2, 12), (3, 7),
                                    (3, 1000), (3, 29)])
def test_corrupt_ghost_map_flagged_any(d, seed):
    jplan, tplan = _sharded(d)
    tbl = np.array(jplan.shard_table_host())
    dev = seed % d
    gmap = tbl[dev, J_SHARD_GMAP:]
    i = seed % len(gmap)
    gmap[i] = gmap[i] + 1
    jplan.shard_table_host = lambda: tbl
    tg = _launch_gmap(tplan, dev)
    tg[i] = tg[i] + 1
    assert "table" in _same(jplan, tplan)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("halo", [True, False])
def test_sharded_plans_clean_and_phase_views_checked(d, halo):
    _, tplan = _sharded(d, halo)
    report = TV.verify_plan(tplan, kernel="ca")
    assert report.ok, [str(f) for f in report.findings]


def test_corrupt_phase_list_flagged():
    _, tplan = _sharded(2)
    view = tplan.phase_view("boundary").for_rank(0)
    ph = view.shard_params("cpu")[2]
    ph[0] = ph[-1]                    # one boundary step twice
    assert "coverage" in _checks(TV.verify_plan, tplan, "ca")


def test_corrupt_mma_basis_flagged(monkeypatch):
    """A mis-weighted digit of the coords basis reaches the chains'
    table and the tensor-core operands alike: both are flagged."""
    from repro.core import memo as jmemo
    from repro.core import mma as jmma
    from repro_torch.core import mma as tmma

    def corrupt(orig):
        def corrupted(spec, r):
            b = np.array(orig(spec, r))
            b[0, 1, 0] += 1.0
            return b
        return corrupted
    jmemo.clear()
    monkeypatch.setattr(jmma, "coords_basis", corrupt(jmma.coords_basis))
    monkeypatch.setattr(tmma, "coords_basis", corrupt(tmma.coords_basis))
    try:
        jplan = JPlan(JSierpinski(8), "mma", backend="tpu-interpret")
        tplan = GridPlan(SierpinskiDomain(8), "mma", backend="cpu")
        assert "table" in _same(jplan, tplan)
        details = [f.detail for f in
                   TV.verify_plan(tplan, kernel="write").findings]
        assert any(d.startswith("mma operand decode") for d in details)
    finally:
        jmemo.clear()


@pytest.mark.parametrize("domain,storage", [("sierpinski", "embedded"),
                                            ("sierpinski", "compact"),
                                            ("triangular", "embedded")])
def test_corrupt_mma_operands_flagged(domain, storage):
    """One weight of the operands a launch reads set to 2 (a bf16 of the
    first B fragment) is found by decoding them as the tensor cores do;
    the host chains stay clean."""
    from repro_torch.core import mma as tmma
    dom = SierpinskiDomain(8) if domain == "sierpinski" \
        else TriangularDomain(6)
    plan = GridPlan(dom, "mma", storage=storage, backend="cpu")
    assert TV.verify_plan(plan, kernel="ca").ok
    ops = plan.launch_params(dom.bounding_box[0], 1, "cpu").mma_ops
    # a row-major domain's fragment follows its padded row starts
    i = 0 if domain == "sierpinski" else len(ops) - 64 * tmma.ksteps(6)
    ops[i] = (int(ops[i]) & ~0xFFFF) | 0x4000      # bf16 2.0
    found = TV.verify_plan(plan, kernel="ca").findings
    assert {f.check for f in found} == {"table"}
    assert any(f.detail.startswith("mma operand decode") for f in found)
    assert not any(f.detail.startswith("LUT") for f in found)


def test_corrupt_tile_perm_flagged():
    plan = GridPlan(SierpinskiDomain(8), "closed_form", storage="compact",
                    coarsen=2, backend="cpu")
    assert TV.verify_plan(plan, kernel="ca").ok
    perm = plan.launch_params(24, 3, "cpu").tile_perm
    nfine = (len(perm) - 4) // 2
    a, b = perm[2 * nfine], perm[2 * nfine + 1]
    perm[2 * nfine], perm[2 * nfine + 1] = b, a
    assert _checks(TV.verify_plan, plan, "ca") == {"table"}


def test_corrupt_flash_hull_flagged():
    jplan = JPlan(JTriangular(8), "prefetch_lut")
    tplan = GridPlan(TriangularDomain(8), "prefetch_lut", backend="cpu")
    for plan in (jplan, tplan):
        ext = np.array(plan.row_extents())
        ext[0, 1] += 1
        plan.row_extents = lambda ext=ext: ext
    assert "hull" in _same(jplan, tplan, kernel="flash")


def test_launch_row_extents_checked():
    plan = GridPlan(TriangularDomain(8), "prefetch_lut", backend="cpu")
    ext = torch.from_numpy(np.array(plan.row_extents()))
    assert TV.verify_plan(plan, kernel="flash", row_extents=ext).ok
    ext[3, 1] -= 1
    found = TV.verify_plan(plan, kernel="flash", row_extents=ext).findings
    assert [f.check for f in found] == ["hull"]
    assert "launch row_extents" in found[0].detail


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("lowering", ["closed_form", "prefetch_lut",
                                      "bounding", "mma"])
def test_zigzag_flash_plans_verify(D, lowering):
    """The port re-derives the snake's partition: every zigzag plan of a
    causal flash call verifies.  The reference re-derives it as
    "linear" and flags the lo column of every zigzag plan (ROADMAP C7)."""
    from repro.core.domain import make_attention_domain as jmake
    from repro_torch.core.domain import make_attention_domain as tmake
    tplan = ShardedPlan(tmake("causal", 12, 12, 0), lowering,
                        batch_dims=(2,), backend="cpu", num_shards=D,
                        partition="zigzag")
    assert TV.verify_plan(tplan, kernel="flash").ok
    jplan = JSharded(jmake("causal", 12, 12, 0), "prefetch_lut",
                     batch_dims=(2,), mesh=JV.HostMesh(D), axis="data",
                     partition="zigzag")
    found = JV.verify_plan(jplan, kernel="flash").findings
    assert [f.check for f in found] == ["table"]
    assert "lo column" in found[0].detail
