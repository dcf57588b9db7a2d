"""The port's fractal write against the JAX package, on the CPU.

On CPU tensors the entry points run the plain versions beside the CUDA
kernels; they are held against ``repro.kernels.ops`` (Pallas,
``backend="tpu-interpret"``) at small sizes and against
``repro.kernels.ref`` at n = 256, under embedded and compact storage and
with superblock coarsening.  Writes must be bit-equal.  Inputs are made
with numpy from a fixed seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import fractal as TF
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from torch_parity import (CASES, COMPACT_CASES, DTYPES, TW, as_f32,
                          make_pair, pack_pair)


@pytest.mark.parametrize("fractal,n,block", CASES)
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_write_matches_reference(fractal, n, block, grid_mode, dtype):
    jm, tm = make_pair(n, dtype, seed=n + block)
    before = tm.clone()
    got = TO.sierpinski_write(tm, 7.3, block=block, grid_mode=grid_mode,
                              fractal=fractal)
    want = JO.sierpinski_write(jm, 7.3, block=block, grid_mode=grid_mode,
                               fractal=fractal, backend="tpu-interpret")
    assert got.dtype == tm.dtype
    np.testing.assert_array_equal(as_f32(got), as_f32(want))
    assert torch.equal(tm, before)  # functional: the input is unchanged


@pytest.mark.parametrize("block", [1, 8, 32, 256])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_write_matches_ref_oracle_n256(block, grid_mode, dtype):
    jm, tm = make_pair(256, dtype, seed=block)
    got = TO.sierpinski_write(tm, -2.5, block=block, grid_mode=grid_mode)
    want = JR.sierpinski_write_ref(jm, -2.5)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))
    np.testing.assert_array_equal(as_f32(TR.sierpinski_write_ref(tm, -2.5)),
                                  as_f32(want))


def test_in_place_write_returns_its_argument():
    m = torch.full((32, 32), 3.0)
    out = TO.sierpinski_write_(m, 1.0, block=8, grid_mode="bounding")
    assert out is m
    mask = torch.from_numpy(TF.membership_grid(32))
    assert torch.equal(m, torch.where(mask, 1.0, 3.0))


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    tm = make_pair(64, "float32", seed=3)[1]
    want = {gm: TO.sierpinski_write(tm, 5.0, block=4, grid_mode=gm)
            for gm in TP.LOWERINGS}
    monkeypatch.setattr(TW, "PLAIN_CHUNK_CELLS", 48)  # 3 tiles per chunk
    for gm in TP.LOWERINGS:
        assert torch.equal(
            TO.sierpinski_write(tm, 5.0, block=4, grid_mode=gm), want[gm])


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("coarsen", [1, "s"])
def test_compact_write_matches_reference(fractal, n, block, s, grid_mode,
                                         coarsen):
    """tests/test_sched.py:131/:170 and tests/test_compact.py's compact
    write, on the packed state itself."""
    coarsen = s if coarsen == "s" else 1
    jm, tm = pack_pair(fractal, n, block, "float32", seed=n + s)
    kw = dict(block=block, grid_mode=grid_mode, fractal=fractal,
              storage="compact", n=n, coarsen=coarsen)
    got = TO.sierpinski_write(tm, 7.3, **kw)
    want = JO.sierpinski_write(jm, 7.3, backend="tpu-interpret", **kw)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))
    # coarsening changes the schedule, not the result
    assert torch.equal(got, TO.sierpinski_write(tm, 7.3, **dict(kw,
                                                                coarsen=1)))


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
def test_compact_write_other_dtypes(dtype, grid_mode):
    jm, tm = pack_pair("sierpinski-gasket", 32, 4, dtype, seed=1)
    kw = dict(block=4, grid_mode=grid_mode, storage="compact", n=32,
              coarsen=2)
    got = TO.sierpinski_write(tm, 3.0, **kw)
    want = JO.sierpinski_write(jm, 3.0, backend="tpu-interpret", **kw)
    assert got.dtype == tm.dtype
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("coarsen", [2, 4, 8])
def test_embedded_coarsened_write_matches_ref_oracle(grid_mode, coarsen):
    jm, tm = make_pair(64, "float32", seed=coarsen)
    got = TO.sierpinski_write(tm, -1.5, block=4, grid_mode=grid_mode,
                              coarsen=coarsen)
    np.testing.assert_array_equal(as_f32(got),
                                  as_f32(JR.sierpinski_write_ref(jm, -1.5)))
