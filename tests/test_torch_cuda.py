"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside a fixture whether a card is
there and skips without one.  This file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import pytest
import torch

from repro_torch.core import fractal as F
from repro_torch.core.compact import compact_layout
from repro_torch.core.plan import LOWERINGS
from repro_torch.kernels import ops

TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
TC = importlib.import_module("repro_torch.kernels.sierpinski_ca")

pytestmark = pytest.mark.cuda

CASES = [("sierpinski-gasket", 64, 1), ("sierpinski-gasket", 64, 8),
         ("sierpinski-gasket", 256, 128), ("sierpinski-gasket", 512, 4),
         ("sierpinski-gasket", 1024, 32), ("sierpinski-carpet", 81, 1),
         ("sierpinski-carpet", 81, 3), ("sierpinski-carpet", 243, 27),
         ("vicsek-cross", 81, 9), ("vicsek-cross", 243, 3)]
DTYPES = [torch.float32, torch.bfloat16, torch.int32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _state(n, dtype, seed, dev, integer=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        return torch.randint(-8, 9, (n, n), generator=g,
                             device=dev).to(dtype)
    return torch.randn((n, n), generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("fractal,n,block", CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain(dev, fractal, n, block, grid_mode, dtype):
    m = _state(n, dtype, n * block, dev)
    plan, n, block = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                       fractal=fractal)
    p = plan.launch_params(n, block, dev)
    TW.check_write_against_plain(m, 7.3, plan, n, block, p)
    TW.check_sum_against_plain(m, plan, n, block, p)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_normal_state_sum_within_tolerance(dev, grid_mode):
    m = _state(729, torch.float32, 3, dev, integer=False)
    plan, n, block = TW.prepare_launch(m, block=9, grid_mode=grid_mode,
                                       fractal="sierpinski-carpet")
    p = plan.launch_params(n, block, dev)
    TW.check_sum_against_plain(m, plan, n, block, p, rtol=1e-5)


def test_entry_points_launch_the_kernels(dev):
    TW.reset_launch_counts()
    m = torch.zeros((64, 64), device=dev)
    out = ops.sierpinski_write(m, 1.0, block=8)
    total = ops.sierpinski_sum(out, block=8, grid_mode="bounding")
    assert TW.launch_counts() == {"sierpinski_write": 1,
                                  "sierpinski_sum_partials": 1,
                                  "sierpinski_sum_combine": 1}
    mask = torch.from_numpy(F.membership_grid(64)).to(dev)
    assert torch.equal(out, mask.to(torch.float32))
    assert float(total) == F.gasket_volume(64) and total.device == dev
    assert torch.equal(m, torch.zeros_like(m))  # functional write
    assert ops.sierpinski_write_(m, 1.0, block=8) is m


def test_kernel_wrappers_reject_what_they_cannot_take(dev):
    m = torch.zeros((64, 64), device=dev)
    plan, n, block = TW.prepare_launch(m, block=8, grid_mode="prefetch_lut")
    p = plan.launch_params(n, block, dev)
    with pytest.raises(ValueError, match="same device"):
        TW.write_cuda(m, 1.0, plan.launch_params(n, block, "cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        TW.write_cuda(torch.zeros((64, 128), device=dev)[:, ::2], 1.0, p)
    with pytest.raises(TypeError):
        TW.write_cuda(m.double(), 1.0, p)
    with pytest.raises(ValueError, match="shape"):
        TW.sum_partials_cuda(torch.zeros((32, 32), device=dev), p)


# ---------------------------------------------------------------------------
# compact storage and coarsening (write / sum), and the fused CA kernel
# ---------------------------------------------------------------------------

#: (fractal, n, block, s): s is the coarsening of the coarsened cases
COMPACT_CASES = [("sierpinski-gasket", 64, 4, 2), ("sierpinski-gasket", 256, 8, 4),
                 ("sierpinski-gasket", 512, 32, 2), ("sierpinski-carpet", 81, 3, 3),
                 ("sierpinski-carpet", 243, 9, 3), ("vicsek-cross", 243, 3, 9)]


def _packed(fractal, n, block, seed, dev, integer=True, binary=False):
    """A packed state whose non-member cells are 0 (the CA invariant)."""
    lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
    spec = F.FRACTALS.get(fractal, F.SIERPINSKI)
    mask = torch.from_numpy(spec.membership_grid(n).copy()).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    if binary:
        x = torch.randint(0, 2, (n, n), generator=g, device=dev).float()
    elif integer:
        x = torch.randint(-8, 9, (n, n), generator=g, device=dev).float()
    else:
        x = torch.randn((n, n), generator=g, device=dev)
    x = torch.where(mask, x, 0)
    return x, lay.pack(x, block)


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
@pytest.mark.parametrize("coarsened", [False, True], ids=["s1", "s"])
def test_compact_kernels_match_plain(dev, fractal, n, block, s, grid_mode,
                                     storage, coarsened):
    emb, packed = _packed(fractal, n, block, n + block, dev)
    m = packed if storage == "compact" else emb
    plan, n_, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                      fractal=fractal, storage=storage, n=n,
                                      coarsen=s if coarsened else 1)
    p = plan.launch_params(n_, blk, dev)
    TW.check_write_against_plain(m, 7.3, plan, n_, blk, p)
    TW.check_sum_against_plain(m, plan, n_, blk, p)


#: (fractal, n, block, s, fuse)
CA_CASES = [("sierpinski-gasket", 64, 8, 2, 3), ("sierpinski-gasket", 256, 16, 4, 16),
            ("sierpinski-gasket", 1024, 32, 2, 32), ("sierpinski-carpet", 81, 3, 3, 3),
            ("sierpinski-carpet", 243, 9, 3, 9), ("vicsek-cross", 243, 9, 3, 9),
            ("sierpinski-gasket", 512, 128, 1, 128), ("sierpinski-gasket", 1024, 32, 2, 64)]


@pytest.mark.parametrize("fractal,n,block,s,fuse", CA_CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_kernel_matches_plain(dev, fractal, n, block, s, fuse, grid_mode,
                                 storage, rule):
    emb, packed = _packed(fractal, n, block, n + fuse, dev, integer=False,
                          binary=rule == "parity")
    a = packed if storage == "compact" else emb
    b = torch.zeros_like(a)
    for coarsen in sorted({1, s}):
        plan, n_, blk = TC.prepare_run(a, b, block=block, grid_mode=grid_mode,
                                       fractal=fractal, storage=storage, n=n,
                                       coarsen=coarsen)
        h = TC.effective_fuse(fuse, fuse, blk, coarsen)
        for steps in sorted({1, h}):
            TC.check_ca_against_plain(a, b, plan, n_, blk, h, steps, rule,
                                      0.2)


def test_ca_entry_points_launch_the_kernel(dev):
    n, block = 256, 16
    emb, packed = _packed("sierpinski-gasket", n, block, 5, dev, binary=True)
    TC.reset_launch_counts()
    got = ops.ca_run(packed.clone(), torch.zeros_like(packed), 10, fuse=4,
                     block=block, storage="compact", n=n)
    assert TC.launch_counts() == {"sierpinski_ca_fused": 3}
    from repro_torch.kernels import ref
    want = emb
    for _ in range(10):
        want = ref.ca_step_ref(want, "parity")
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   block))
    assert torch.equal(lay.unpack(got, block), want)
    one = ops.ca_step(packed, torch.zeros_like(packed), block=block,
                      storage="compact", n=n)
    assert torch.equal(lay.unpack(one, block), ref.ca_step_ref(emb, "parity"))
