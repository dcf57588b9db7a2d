"""The port's fused CA against the JAX package, on the CPU.

On CPU tensors ``ca_run``/``ca_step`` run the plain version beside the
CUDA kernel.  They are held against ``repro.kernels.ops`` (Pallas,
``backend="tpu-interpret"``) and ``repro.kernels.ref``: parity must be
bit-equal; diffusion agrees within ``rtol=1e-5, atol=1e-6``, the JAX
tests' own tolerance (``tests/test_kernels.py``), because XLA may
contract the update differently.  Inputs are made with numpy from a
fixed seed and handed to both packages.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractal as JF
from repro.core.compact import CompactLayout as JLayout
from repro.core.domain import make_fractal_domain as j_fractal_domain
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import plan as TP
from repro_torch.core.compact import CompactLayout as TLayout
from repro_torch.core.domain import make_fractal_domain as t_fractal_domain
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import sierpinski_ca as TCA
from torch_parity import (assert_rule_close, fractal_state,
                          isolate_tune_caches, pair)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# launch schedule arithmetic (tests/test_sched.py's cases)
# ---------------------------------------------------------------------------

def test_launch_schedule_math():
    assert TO.launch_schedule(10, 4) == [4, 4, 2]
    assert TO.launch_schedule(8, 4) == [4, 4]
    assert TO.launch_schedule(3, 8) == [3]
    assert TO.launch_schedule(0, 4) == []
    for steps in range(0, 23):
        for fuse in range(1, 9):
            sched = TO.launch_schedule(steps, fuse)
            assert sched == JO.launch_schedule(steps, fuse)
            assert len(sched) == -(-steps // fuse)  # ceil(T/k) launches
            assert sum(sched) == steps
    with pytest.raises(ValueError):
        TO.launch_schedule(4, 0)
    with pytest.raises(ValueError):
        TO.launch_schedule(-1, 2)


def test_effective_fuse_clamp():
    from repro.kernels import sierpinski_ca as JCA
    assert TCA.effective_fuse(8, 20, 4) == 4
    assert TCA.effective_fuse(8, 20, 4, coarsen=4) == 8
    assert TCA.effective_fuse(16, 5, 32) == 5
    assert TCA.effective_fuse(3, 0, 8) == 1
    for fuse in (1, 3, 8, 40):
        for steps in (0, 1, 5, 33):
            for block, coarsen in ((1, 1), (4, 2), (8, 4), (32, 1)):
                assert TCA.effective_fuse(fuse, steps, block, coarsen) == \
                    JCA.effective_fuse(fuse, steps, block, coarsen)


# ---------------------------------------------------------------------------
# the gasket at n = 16 against the iterated dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_run_n16_matches_ref_oracle(grid_mode, storage, rule):
    n, block, steps = 16, 4, 6
    x = fractal_state("sierpinski-gasket", n, rule == "parity", seed=16)
    want = jnp.asarray(x)
    for _ in range(steps):
        want = JR.ca_step_ref(want, rule)
    _, a = pair(x, "sierpinski-gasket", n, block, storage)
    lay = TLayout(t_fractal_domain("sierpinski-gasket", n // block))
    for coarsen in (1, 2, 4):
        for fuse in (1, 2, 4, 8):  # 6 % 4: a remainder launch
            got = TO.ca_run(a, torch.zeros_like(a), steps, fuse=fuse,
                            rule=rule, block=block, grid_mode=grid_mode,
                            storage=storage, n=n, coarsen=coarsen)
            if storage == "compact":
                got = lay.unpack(got, block)
            assert_rule_close(got, want, rule)


# ---------------------------------------------------------------------------
# carpet and Vicsek at n = 27 against the JAX package's ca_run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fractal", ["sierpinski-carpet", "vicsek-cross"])
@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_run_generalized_fractals(fractal, storage, rule):
    n, block, steps = 27, 3, 4
    x = fractal_state(fractal, n, rule == "parity", seed=27)
    ja, ta = pair(x, fractal, n, block, storage)
    kw = dict(rule=rule, block=block, fractal=fractal, storage=storage, n=n)
    want = JO.ca_run(ja, jnp.zeros_like(ja), steps, fuse=3,
                     backend="tpu-interpret", **kw)
    for grid_mode in TP.LOWERINGS:
        for coarsen, fuse in ((1, 1), (1, 3), (3, 2), (3, 4)):
            got = TO.ca_run(ta, torch.zeros_like(ta), steps, fuse=fuse,
                            grid_mode=grid_mode, coarsen=coarsen, **kw)
            assert_rule_close(got, want, rule)


# ---------------------------------------------------------------------------
# num_stages: the depth of the kernel's ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("num_stages", [2, 3])
def test_num_stages_bit_equal_to_jax(num_stages, storage):
    # the ring's depth changes no bit: the port's ca_run at num_stages=k
    # equals tpu-interpret repro's ca_run at the same depth (its
    # stream_tiles ring of async copies) and the port's one-stage run
    n, block, steps = 16, 4, 5
    x = fractal_state("sierpinski-gasket", n, True, seed=5 + num_stages)
    ja, ta = pair(x, "sierpinski-gasket", n, block, storage)
    kw = dict(rule="parity", block=block, storage=storage, n=n, fuse=2)
    want = JO.ca_run(ja, jnp.zeros_like(ja), steps, num_stages=num_stages,
                     backend="tpu-interpret", **kw)
    got = TO.ca_run(ta, torch.zeros_like(ta), steps, num_stages=num_stages,
                    **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    one = TO.ca_run(ta, torch.zeros_like(ta), steps, num_stages=1, **kw)
    assert torch.equal(got, one)


def test_num_stages_validation():
    x = torch.zeros(16, 16)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="num_stages"):
            TO.ca_run(x, torch.zeros_like(x), 2, block=4, num_stages=bad)
    # deeper requests clamp to the kernel's deepest ring, as the JAX
    # package's gpu target clamps them
    assert TCA._check_stages(9) == TCA.MAX_STAGES


# ---------------------------------------------------------------------------
# ca_step and the dense oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_step_matches_reference(grid_mode, storage, rule):
    n, block = 32, 8
    x = fractal_state("sierpinski-gasket", n, rule == "parity", seed=3)
    ja, ta = pair(x, "sierpinski-gasket", n, block, storage)
    stale = np.zeros_like(x)
    jb, tb = pair(stale, "sierpinski-gasket", n, block, storage)
    kw = dict(rule=rule, block=block, grid_mode=grid_mode, storage=storage,
              n=n)
    want = JO.ca_step(ja, jb, backend="tpu-interpret", **kw)
    before = (ta.clone(), tb.clone())
    got = TO.ca_step(ta, tb, **kw)
    assert_rule_close(got, want, rule)
    assert torch.equal(ta, before[0]) and torch.equal(tb, before[1])


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_step_ref_matches(n, rule):
    x = fractal_state("sierpinski-gasket", n, rule == "parity", seed=n)
    # non-member cells too: the oracle reads them raw and zeroes them
    x = x + (1 - JF.membership_grid(n)).astype(np.float32) * 3
    got = TR.ca_step_ref(torch.from_numpy(x), rule)
    want = JR.ca_step_ref(jnp.asarray(x), rule)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for alpha in (0.1, 0.25):
        got = TR.ca_step_ref(torch.from_numpy(x), "diffusion", alpha)
        want = JR.ca_step_ref(jnp.asarray(x), "diffusion", alpha)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_equals_sequential_bit_for_bit():
    """Inside the port, fused launches equal per-step ones exactly, for
    both rules (the shrinking trapezoid is exact in the interior)."""
    n, block, steps = 32, 8, 7
    for rule in ("parity", "diffusion"):
        x = fractal_state("sierpinski-gasket", n, rule == "parity", seed=9)
        _, a = pair(x, "sierpinski-gasket", n, block, "compact")
        kw = dict(rule=rule, block=block, storage="compact", n=n)
        seq, stale = a, torch.zeros_like(a)
        for _ in range(steps):
            seq, stale = TO.ca_step(seq, stale, **kw), seq
        for fuse, coarsen in ((2, 1), (7, 1), (5, 2), (7, 4)):
            got = TO.ca_run(a, torch.zeros_like(a), steps, fuse=fuse,
                            coarsen=coarsen, **kw)
            assert torch.equal(got, seq), (rule, fuse, coarsen)


def test_ca_run_zero_steps_is_identity():
    x = fractal_state("sierpinski-gasket", 16, True)
    a = torch.from_numpy(x)
    assert TO.ca_run(a, torch.zeros_like(a), 0, fuse=4, block=4) is a


def test_donate_runs_in_place_on_the_two_buffers():
    n, block = 16, 4
    x = torch.from_numpy(fractal_state("sierpinski-gasket", n, True))
    a, b = x.clone(), torch.zeros_like(x)
    want = TO.ca_run(x, torch.zeros_like(x), 3, block=block)
    got = TO.ca_run(a, b, 3, block=block, donate=True)
    assert torch.equal(got, want)
    assert got.data_ptr() in (a.data_ptr(), b.data_ptr())
    assert torch.equal(x, TO.ca_run(x, torch.zeros_like(x), 0, block=block))


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    x = torch.from_numpy(fractal_state("sierpinski-gasket", 32, False))
    kw = dict(rule="diffusion", block=4, fuse=3)
    want = TO.ca_run(x, torch.zeros_like(x), 5, **kw)
    monkeypatch.setattr(TCA, "PLAIN_CHUNK_CELLS", 2000)  # a few tiles each
    assert torch.equal(TO.ca_run(x, torch.zeros_like(x), 5, **kw), want)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,exc,match", [
    (dict(storage="compact", n=None), ValueError, "needs the embedded size"),
    (dict(storage="compact", shape=(32, 32)), ValueError, "does not match"),
    (dict(coarsen=3), ValueError, "must be a power"),
    (dict(coarsen=32), ValueError, "exceeds"),
    # the tuner's knobs: an untuned problem runs the reference's defaults
    (dict(fuse="auto"), None, None),
    (dict(coarsen="auto"), None, None),
    (dict(grid_mode="auto"), None, None),
    (dict(num_stages="auto"), None, None),
    (dict(grid_mode="mma", block=1, fractal="sierpinski-carpet",
          storage="compact", n=6561, shape=(4096, 4096)), ValueError,
     "2\\^24"),
    (dict(dtype=torch.bfloat16), TypeError, "float32"),
    (dict(dtype=torch.int32), TypeError, "float32"),
    (dict(rule="life"), ValueError, "unknown rule"),
    (dict(stale_shape=(8, 8)), ValueError, "must match"),
    (dict(block=6), ValueError, "must divide"),
])
@pytest.mark.parametrize("entry", ["ca_run", "ca_step"])
def test_validation_errors(kw, exc, match, entry, monkeypatch, tmp_path):
    kw = dict(kw)
    n, block = 16, 4
    if exc is None and not (entry == "ca_step" and "fuse" in kw):
        # what the reference does with the same arguments and no tuned
        # entry: the call runs, on its untuned defaults
        isolate_tune_caches(monkeypatch, tmp_path)
        x = fractal_state("sierpinski-gasket", n, True, seed=11)
        ja, ta = pair(x, "sierpinski-gasket", n, block, "embedded")
        if entry == "ca_run":
            want = JO.ca_run(ja, jnp.zeros_like(ja), 3, block=block,
                             backend="tpu-interpret", **kw)
            got = TO.ca_run(ta, torch.zeros_like(ta), 3, block=block, **kw)
        else:
            want = JO.ca_step(ja, jnp.zeros_like(ja), block=block,
                              backend="tpu-interpret", **kw)
            got = TO.ca_step(ta, torch.zeros_like(ta), block=block, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    lay = TLayout(t_fractal_domain("sierpinski-gasket", n // block))
    compact = kw.get("storage") == "compact"
    shape = kw.pop("shape", lay.array_shape(block) if compact else (n, n))
    dtype = kw.pop("dtype", torch.float32)
    a = torch.zeros(shape, dtype=dtype)
    b = torch.zeros(kw.pop("stale_shape", shape), dtype=dtype)
    kw.setdefault("block", block)
    if compact:
        kw.setdefault("n", n)
    if entry == "ca_run":
        call = lambda: TO.ca_run(a, b, 2, **kw)  # noqa: E731
    elif "fuse" in kw:  # ca_step is the one-step case: no fuse option
        exc, match = TypeError, "fuse"
        call = lambda: TO.ca_step(a, b, **kw)  # noqa: E731
    else:
        call = lambda: TO.ca_step(a, b, **kw)  # noqa: E731
    with pytest.raises(exc, match=match):
        call()


def test_reference_raises_the_same_compact_value_error():
    m = jnp.zeros((16, 16))
    with pytest.raises(ValueError) as want:
        JO.ca_step(m, m, block=4, storage="compact", backend="tpu-interpret")
    with pytest.raises(ValueError) as got:
        TO.ca_step(torch.zeros(16, 16), torch.zeros(16, 16), block=4,
                   storage="compact")
    assert str(got.value) == str(want.value)


def test_kernel_wrapper_rejects_cpu_tensors():
    a = torch.zeros(16, 16)
    plan, n, block = TCA.prepare_run(a, torch.zeros(16, 16), block=4)
    p = plan.launch_params(n, block, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TCA.ca_cuda(a, torch.zeros(16, 16), p, 1, 1, "parity", 0.25)
    assert TCA.launch_counts() == {name: 0 for name in TCA.KERNELS}


# ---------------------------------------------------------------------------
# the CA slice as a whole: the example's logic against the JAX package's
# ---------------------------------------------------------------------------

def _load_example():
    path = ROOT / "examples" / "torch_ca_simulation.py"
    spec = importlib.util.spec_from_file_location("torch_ca_simulation",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_example_slice_matches_reference(rule):
    n, block, steps = 64, 8, 16
    ex = _load_example()
    final, info = ex.simulate(n=n, steps=steps, block=block, rule=rule,
                              storage="compact", device="cpu")
    # the JAX example's construction, untuned schedule (fuse 1)
    mask = JF.membership_grid(n)
    state = np.zeros((n, n), np.float32)
    state[n - 1, 0] = 100.0 if rule == "diffusion" else 1.0
    lay = JLayout(j_fractal_domain("sierpinski-gasket", n // block))
    a = lay.pack(jnp.asarray(state * mask), block)
    want = JO.ca_run(a, jnp.zeros_like(a), steps, fuse=1, rule=rule,
                     block=block, storage="compact", n=n,
                     backend="tpu-interpret")
    assert_rule_close(final, want, rule)
    assert info["launches"] == steps
    if rule == "diffusion":
        np.testing.assert_allclose(info["heat"], 100.0, rtol=1e-5)


def test_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_ca_simulation.py"),
         "--device", "cpu", "--n", "32", "--block", "4", "--steps", "6",
         "--fuse", "4", "--coarsen", "2", "--rule", "diffusion"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "invariant OK" in proc.stdout
    assert "heat conserved" in proc.stdout
