"""The port's access sanitizer and its CLI.

* the plain versions' trace rows are clean for write, sum and CA under
  every lowering x storage on ``SierpinskiDomain(8)``, block 3 (the
  reference's ``run_sanitizer_smoke`` shape), and a traced output is the
  untraced one;
* for every live step their stored and loaded tiles are the reference's
  static ``storage_tiles`` / ``neighbor_tiles`` (the reference's own
  dynamic sanitizer cannot be entered on this jax: ROADMAP C1);
* seeded faults are flagged: a LUT row the launch reads, a step skipped
  and a step visited twice (rows edited by hand);
* ``AccessTrace`` restores the chaos hook on exit;
* the CLI: ``--matrix --smoke --device cpu --out`` reports the reference
  ``--matrix --smoke --no-sanitize`` report's static labels, counts and
  ``ok``.
"""
import importlib
import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from repro.analysis import verifier as JV
from repro.core.domain import SierpinskiDomain as JSierpinski
from repro.core.plan import GridPlan as JPlan
from repro_torch.analysis import AccessTrace, verify_launches
from repro_torch.analysis import verify as TCLI
from repro_torch.core import memo
from repro_torch.core.compact import NEIGHBOR_OFFSETS8, compact_layout
from repro_torch.core.domain import SierpinskiDomain
from repro_torch.core.plan import LOWERINGS, GridPlan
from repro_torch.kernels import _cuda

TCA = importlib.import_module("repro_torch.kernels.sierpinski_ca")
TWM = importlib.import_module("repro_torch.kernels.sierpinski_write")

BLOCK = 3
KERNELS = ("write", "sum", "ca")
C = {name: i for i, name in enumerate(_cuda.TRACE_COLUMNS)}


@pytest.fixture(autouse=True)
def _fresh_tables():
    memo.clear()
    yield
    memo.clear()


def _state(storage, seed=3):
    """A {0, 1} state zero outside the gasket (packed under compact)."""
    dom = SierpinskiDomain(8)
    lay = compact_layout(dom)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 2, (24, 24)).astype(np.float32))
    gy, gx = torch.meshgrid(torch.arange(24), torch.arange(24),
                            indexing="ij")
    x = torch.where(dom.cell_member(gx, gy, 24), x, 0)
    return (lay.pack(x, BLOCK) if storage == "compact" else x), dom


def _run(kernel, storage, lowering, **extra):
    m, dom = _state(storage)
    kw = dict(block=BLOCK, grid_mode=lowering, storage=storage, domain=dom,
              num_stages=1, **extra)
    if kernel == "write":
        return TWM.sierpinski_write, (m, 2.0), kw
    if kernel == "sum":
        return TWM.sierpinski_sum, (m,), kw
    return TCA.ca_run, (m, torch.zeros_like(m), 2), dict(kw, fuse=1,
                                                         donate=False)


@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_traces_are_clean(kernel, lowering, storage):
    fn, args, kw = _run(kernel, storage, lowering)
    out, findings = verify_launches(fn, *args, kernel=kernel, **kw)
    assert findings == []
    assert torch.equal(out, fn(*args, **kw))     # the trace changes nothing


def _plans(lowering, storage):
    return (JPlan(JSierpinski(8), lowering, storage=storage),
            GridPlan(SierpinskiDomain(8), lowering, storage=storage,
                     backend="cpu"))


@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_traced_tiles_are_the_reference_static_sets(lowering, storage):
    jplan, tplan = _plans(lowering, storage)
    refs = JV.host_prefetch_refs(jplan)
    ids, jbx, jby, jlive = JV.decode_steps(jplan, refs)
    jr, jc = JV.storage_tiles(jplan, refs, ids)
    m, dom = _state(storage)
    rows = {}
    for kernel in KERNELS:
        fn, args, kw = _run(kernel, storage, lowering)
        with AccessTrace() as tr:
            fn(*args, **kw)
        assert tr.crosscheck() == []
        rows[kernel] = tr.launches[0].trace.numpy().reshape(len(jlive), -1)
    live = jlive.reshape(-1)
    for kernel, at in (("write", C["store_row"]), ("ca", C["store_row"]),
                       ("sum", _cuda.TRACE_LOADS + 8)):
        r = rows[kernel]
        assert np.array_equal(r[:, C["live"]], live)
        assert np.array_equal(r[live, at], jr.reshape(-1)[live])
        assert np.array_equal(r[live, at + 1], jc.reshape(-1)[live])
        assert np.array_equal(r[live, C["bx"]], jbx.reshape(-1)[live])
    nbx, nby = SierpinskiDomain(8).bounding_box
    for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
        nr, nc = JV.neighbor_tiles(jplan, refs, ids, j)
        x, y = jbx.reshape(-1) + dx, jby.reshape(-1) + dy
        valid = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) & np.asarray(
            SierpinskiDomain(8).contains(np.clip(x, 0, nbx - 1),
                                         np.clip(y, 0, nby - 1)), bool)
        o = _cuda.TRACE_LOADS + 2 * ((dy + 1) * 3 + dx + 1)
        got = rows["ca"][live]
        sel = valid[live]
        assert np.array_equal(got[sel, o], nr.reshape(-1)[live][sel])
        assert np.array_equal(got[sel, o + 1], nc.reshape(-1)[live][sel])
        assert (got[~sel, o] == -1).all() and (got[~sel, o + 1] == -1).all()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
def test_corrupt_lut_row_flagged(kernel, storage):
    fn, args, kw = _run(kernel, storage, "prefetch_lut")
    plan = GridPlan(SierpinskiDomain(8), "prefetch_lut", storage=storage,
                    backend="cpu")
    plan.launch_params(24, BLOCK, "cpu").lut[5, 0] ^= 1
    _, findings = verify_launches(fn, *args, kernel=kernel, strict=False,
                                  **kw)
    assert findings and all(f.check == "sanitizer" for f in findings)
    assert any("step 5 decoded block" in f.detail for f in findings)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("fault,visits", [("skipped", 0), ("twice", 2)])
def test_edited_visits_flagged(kernel, fault, visits):
    fn, args, kw = _run(kernel, "compact", "closed_form")
    with AccessTrace() as tr:
        fn(*args, **kw)
    assert tr.crosscheck() == []
    tr.launches[0].trace[7, C["visits"]] = visits
    found = tr.crosscheck()
    assert any(f"step 7 visited {visits} times" in f.detail for f in found)


def test_edited_store_and_slot_flagged():
    fn, args, kw = _run("write", "embedded", "closed_form")
    with AccessTrace() as tr:
        fn(*args, **kw)
    tr.launches[0].trace[4, C["store_row"]] = 40
    assert any("out of bounds" in f.detail for f in tr.crosscheck())
    fn, args, kw = _run("sum", "embedded", "closed_form")
    with AccessTrace() as tr:
        fn(*args, **kw)
    tr.launches[0].trace[4, C["slot"]] = 9
    assert any("partial slot 9" in f.detail for f in tr.crosscheck())


@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("fault", ["swapped", "skipped", "extra"])
def test_edited_ca_slot_flagged(storage, fault):
    """The CA's loads are held slot by slot: a stencil that gathers its W
    neighbour into E's slot (both tiles in the step's read set), skips a
    member neighbour, or reads where the static decode has no member is
    flagged."""
    fn, args, kw = _run("ca", storage, "closed_form")
    with AccessTrace() as tr:
        fn(*args, **kw)
    assert tr.crosscheck() == []
    rows = tr.launches[0].trace
    w, e = (_cuda.TRACE_LOADS + 2 * o for o in (3, 5))
    both = (rows[:, w] != -1) & (rows[:, e] != -1) & \
        ((rows[:, w] != rows[:, e]) | (rows[:, w + 1] != rows[:, e + 1]))
    step = int(torch.nonzero(both)[0])
    if fault == "swapped":
        rows[step, e:e + 2] = rows[step, w:w + 2].clone()
        want = f"step {step} loaded tile"
    elif fault == "skipped":
        rows[step, e:e + 2] = -1
        want = f"step {step} skipped origin slot 5"
    else:
        step = int(torch.nonzero((rows[:, C["visits"]] == 1)
                                 & (rows[:, w] == -1))[0])
        rows[step, w:w + 2] = rows[step, C["store_row"]:C["store_row"] + 2]
        want = f"step {step} loaded origin slot 3"
    assert any(want in f.detail for f in tr.crosscheck())


def test_strict_raises_plan_verification_error():
    from repro_torch.analysis import PlanVerificationError
    fn, args, kw = _run("write", "embedded", "prefetch_lut")
    GridPlan(SierpinskiDomain(8), "prefetch_lut",
             backend="cpu").launch_params(24, BLOCK, "cpu").lut[0, 1] ^= 1
    with pytest.raises(PlanVerificationError, match="access sanitizer"):
        verify_launches(fn, *args, **kw)


def test_access_trace_restores_the_chaos_hook():
    from repro_torch.runtime.chaos import ChaosInjector, FaultPlan
    with ChaosInjector(FaultPlan(0)) as inj:
        hook = _cuda.LAUNCH_HOOK
        assert hook == inj.around_launch
        with AccessTrace() as tr:
            assert _cuda.LAUNCH_HOOK is tr
            fn, args, kw = _run("write", "embedded", "closed_form")
            fn(*args, **kw)
        assert _cuda.LAUNCH_HOOK == hook
    assert _cuda.LAUNCH_HOOK is None
    assert len(tr.launches) == 1


def test_sharded_launches_are_observed_not_traced():
    from repro_torch.core.shard import ShardedPlan
    from repro_torch.analysis.verifier import HostMesh
    m, dom = _state("compact")
    plan = ShardedPlan(dom, "closed_form", storage="compact", backend="cpu",
                       mesh=HostMesh(2), partition="storage-rows")
    view = plan.for_rank(1).bind_block(BLOCK)
    with AccessTrace() as tr:
        TWM.write_rank(view.slab(m, BLOCK).clone(), 1.0, view, 24, BLOCK)
    assert len(tr.launches) == 1 and tr.launches[0].trace is None
    assert tr.crosscheck() == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_matrix_smoke_matches_the_reference(tmp_path, capsys):
    from repro.analysis import verify as JCLI
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    assert JCLI.main(["--matrix", "--smoke", "--no-sanitize", "--quiet",
                      "--out", str(jout)]) == 0
    assert TCLI.main(["--matrix", "--smoke", "--device", "cpu", "--quiet",
                      "--out", str(tout)]) == 0
    want, got = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert [s["label"] for s in got["static"]] == \
        [s["label"] for s in want["static"]]
    assert got["num_static"] == want["num_static"]
    assert got["ok"] == want["ok"] is True
    assert got["num_findings"] == want["num_findings"] == 0
    assert got["num_sanitized"] == 2 * 2 * len(KERNELS)
    assert all(s["ok"] for s in got["sanitizer"])
    assert "findings" in capsys.readouterr().out


def test_cli_device_cuda_fails_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["--matrix", "--smoke", "--quiet"])
