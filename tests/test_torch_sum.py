"""The port's fractal sum against the JAX package, on the CPU.

The plain versions add each step's tile sum in grid-step order, the
order of the JAX package's sequential grid.  Sums of integer-valued
states are exact in every tile, so they must be bit-equal; normal
states agree to ``rtol=1e-6``, because the order inside a tile differs
(the order between tiles is the same).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from torch_parity import COMPACT_CASES, CASES, TW, as_f32, make_pair, pack_pair


@pytest.mark.parametrize("fractal,n,block", CASES[:6])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "normal"])
def test_sum_matches_reference(fractal, n, block, grid_mode, integer):
    jm, tm = make_pair(n, "float32", seed=7 * n + block, integer=integer)
    got = TO.sierpinski_sum(tm, block=block, grid_mode=grid_mode,
                            fractal=fractal)
    want = JO.sierpinski_sum(jm, block=block, grid_mode=grid_mode,
                             fractal=fractal, backend="tpu-interpret")
    assert got.dtype == torch.float32 and got.ndim == 0
    if integer:
        assert float(got) == float(want)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
def test_sum_other_dtypes_bit_equal(dtype, grid_mode):
    jm, tm = make_pair(16, dtype, seed=11, integer=True)
    got = TO.sierpinski_sum(tm, block=4, grid_mode=grid_mode)
    want = JO.sierpinski_sum(jm, block=4, grid_mode=grid_mode,
                             backend="tpu-interpret")
    assert float(got) == float(want)


@pytest.mark.parametrize("block", [1, 16, 256])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_sum_matches_ref_oracle_n256(block, grid_mode, dtype):
    jm, tm = make_pair(256, dtype, seed=block, integer=True)
    got = TO.sierpinski_sum(tm, block=block, grid_mode=grid_mode)
    want = JR.sierpinski_sum_ref(jm)
    assert float(got) == float(want) == float(TR.sierpinski_sum_ref(tm))


def test_normal_sum_ref_oracle_n256():
    jm, tm = make_pair(256, "float32", seed=5)
    for gm in TP.LOWERINGS:
        got = TO.sierpinski_sum(tm, block=16, grid_mode=gm)
        np.testing.assert_allclose(float(got), float(JR.sierpinski_sum_ref(jm)),
                                   rtol=1e-5)


def test_partials_are_per_step_in_step_order():
    _, tm = make_pair(16, "float32", seed=2, integer=True)
    for gm in TP.LOWERINGS:
        plan, n, block = TW.prepare_launch(tm, block=4, grid_mode=gm)
        parts = TW.sum_partials_plain(tm, plan, n, block)
        assert parts.shape == (plan.steps_per_launch,)
        bx, by, valid = plan.step_coords(0, plan.steps_per_launch, "cpu")
        x = as_f32(tm)
        for t in range(plan.steps_per_launch):
            x0, y0 = 4 * int(bx[t]), 4 * int(by[t])
            tile = x[y0:y0 + 4, x0:x0 + 4]
            y, xx = np.mgrid[y0:y0 + 4, x0:x0 + 4]
            member = (xx & (15 - y)) == 0
            if valid is not None and not valid[t]:
                member[:] = False
            assert float(parts[t]) == tile[member].sum()


def test_combine_is_a_sequential_f32_chain():
    # past 2**24 a running f32 total of ones stops growing: only a
    # strictly sequential chain gives exactly 2**24
    ones = torch.ones(2 ** 24 + 10)
    assert float(TW.sum_combine_plain(ones)) == 2.0 ** 24
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    acc = np.float32(0)
    for v in x:
        acc = np.float32(acc + v)
    assert float(TW.sum_combine_plain(torch.from_numpy(x))) == float(acc)


def test_sum_chunks_agree_with_one_pass(monkeypatch):
    _, tm = make_pair(64, "float32", seed=4)
    want = {gm: TO.sierpinski_sum(tm, block=4, grid_mode=gm)
            for gm in TP.LOWERINGS}
    monkeypatch.setattr(TW, "PLAIN_CHUNK_CELLS", 80)  # 5 tiles per chunk
    for gm in TP.LOWERINGS:
        assert torch.equal(TO.sierpinski_sum(tm, block=4, grid_mode=gm),
                           want[gm])


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "normal"])
def test_compact_sum_matches_reference(fractal, n, block, s, grid_mode,
                                       integer):
    """Compact storage, uncoarsened and coarsened by s: integer states
    bit-equal; normal ones within 1e-6 of the sum of magnitudes of the
    JAX package's total at the same coarsening (the order inside a
    superblock differs, and a total that cancels to a few units is no
    scale for that), and within 1e-4 between coarsenings (the reduction
    tile changes, as tests/test_sched.py:131 allows)."""
    jm, tm = pack_pair(fractal, n, block, "float32", seed=3 * n + s,
                       integer=integer)
    kw = dict(block=block, grid_mode=grid_mode, fractal=fractal,
              storage="compact", n=n)
    totals = {}
    mag = float(TO.sierpinski_sum(tm.abs(), **kw))
    for coarsen in (1, s):
        got = TO.sierpinski_sum(tm, coarsen=coarsen, **kw)
        want = JO.sierpinski_sum(jm, coarsen=coarsen,
                                 backend="tpu-interpret", **kw)
        assert got.dtype == torch.float32 and got.ndim == 0
        if integer:
            assert float(got) == float(want)
        else:
            assert abs(float(got) - float(want)) <= 1e-6 * mag
        totals[coarsen] = float(got)
    np.testing.assert_allclose(totals[s], totals[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
def test_coarsened_partials_are_per_superblock(storage, grid_mode):
    """One partial per scheduled (coarse) step, in the coarse step order,
    each the sum of its superblock's member cells."""
    n, block, s = 32, 4, 2
    if storage == "embedded":
        _, tm = make_pair(n, "float32", seed=5, integer=True)
    else:
        _, tm = pack_pair("sierpinski-gasket", n, block, "float32", seed=5,
                          integer=True)
    plan, n_, blk = TW.prepare_launch(tm, block=block, grid_mode=grid_mode,
                                      storage=storage, n=n, coarsen=s)
    parts = TW.sum_partials_plain(tm, plan, n_, blk)
    assert parts.shape == (plan.steps_per_launch,)
    dense = as_f32(tm if storage == "embedded"
                   else plan.layout.unpack(tm, block))
    bx, by, valid = plan.step_coords(0, plan.steps_per_launch, "cpu")
    span = s * block
    for t in range(plan.steps_per_launch):
        x0, y0 = span * int(bx[t]), span * int(by[t])
        y, x = np.mgrid[y0:y0 + span, x0:x0 + span]
        member = (x & (n - 1 - y)) == 0
        if valid is not None and not valid[t]:
            member[:] = False
        assert float(parts[t]) == dense[y0:y0 + span, x0:x0 + span][
            member].sum()
