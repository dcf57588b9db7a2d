"""The port's slice as a whole, its validation and its isolation.

The quickstart construction runs through ``repro_torch.kernels.ops`` and
matches the JAX package's; the entry points raise the reference's
validation errors and name the roadmap item of every option not ported
yet; and the port (package, examples, chip smoke script) never imports
``jax`` or ``repro``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractal as JF
from repro.kernels import ops as JO
from repro_torch.core import fractal as TF
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as TO
from torch_parity import TW, isolate_tune_caches

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("fractal,n,block,spec", [
    ("sierpinski-gasket", 64, 8, None),
    ("sierpinski-carpet", 81, 9, "sierpinski-carpet")])
def test_quickstart_slice_matches_reference(fractal, n, block, spec):
    """The quickstart's three constructions agree -- bit test, lambda
    image, kernel write -- in the port and against the JAX package;
    then a sum over the written state counts the member cells."""
    if spec is None:
        r = TF.scale_level(n)
        bit = TF.membership_grid(n)
        ref_bit = JF.membership_grid(n)
        lx, ly = TF.lambda_map_linear(torch.arange(3 ** r), r)
    else:
        ts, js = TF.FRACTALS[spec], JF.FRACTALS[spec]
        r = ts.scale_level(n)
        bit = ts.membership_grid(n)
        ref_bit = js.membership_grid(n)
        lx, ly = ts.lambda_map_linear(torch.arange(ts.k ** r), r)
    np.testing.assert_array_equal(bit, ref_bit)
    lam = torch.zeros((n, n), dtype=torch.bool)
    lam[ly, lx] = True
    np.testing.assert_array_equal(lam.numpy(), bit)
    out = TO.sierpinski_write(torch.zeros((n, n)), 1.0, block=block,
                              fractal=fractal)
    want = JO.sierpinski_write(jnp.zeros((n, n), jnp.float32), 1.0,
                               block=block, fractal=fractal,
                               backend="tpu-interpret")
    np.testing.assert_array_equal(out.numpy() > 0, bit)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    for gm in TP.LOWERINGS:
        total = TO.sierpinski_sum(out, block=block, grid_mode=gm,
                                  fractal=fractal)
        ref_total = JO.sierpinski_sum(want, block=block, grid_mode=gm,
                                      fractal=fractal,
                                      backend="tpu-interpret")
        assert total.dtype == torch.float32 and total.ndim == 0
        assert float(total) == float(ref_total) == bit.sum()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(block=6), ValueError, "must divide"),
    (dict(block=16, n=None, shape=(48, 48)), ValueError, "scale level"),
    (dict(block=2, fractal="sierpinski-carpet", shape=(18, 18)), ValueError,
     "power of m"),
    (dict(fractal="koch"), ValueError, "unknown fractal"),
    (dict(grid_mode="bogus"), ValueError, "unknown lowering"),
    # the carpet at n = 3^8, rho = 1 has 8^8 >= 2^24 blocks: beyond the
    # mma chains' exactness bound, refused before any launch
    (dict(grid_mode="mma", block=1, fractal="sierpinski-carpet",
          storage="compact", n=6561, shape=(4096, 4096)), ValueError,
     "2\\^24"),
    # an untuned "auto" runs the reference's defaults
    (dict(grid_mode="auto"), None, None),
    (dict(storage="compact"), ValueError, "needs the embedded size"),
    (dict(coarsen=3), ValueError, "must be a power"),
    (dict(shape=(16, 32)), ValueError, "square"),
    (dict(n=8), ValueError, "does not match"),
])
@pytest.mark.parametrize("entry", ["write", "sum"])
def test_validation_errors(kw, exc, match, entry, monkeypatch, tmp_path):
    kw = dict(kw)
    shape = kw.pop("shape", (16, 16))
    kw.setdefault("block", 4)
    m = torch.zeros(shape)
    call = (lambda: TO.sierpinski_write(m, 1.0, **kw)) if entry == "write" \
        else (lambda: TO.sierpinski_sum(m, **kw))
    if exc is None:
        # what the reference does with the same arguments
        isolate_tune_caches(monkeypatch, tmp_path)
        jm = jnp.zeros(shape)
        want = JO.sierpinski_write(jm, 1.0, backend="tpu-interpret", **kw) \
            if entry == "write" else JO.sierpinski_sum(
                jm, backend="tpu-interpret", **kw)
        assert np.array_equal(call().numpy(), np.asarray(want))
        return
    with pytest.raises(exc, match=match):
        call()


def test_reference_raises_the_same_value_errors():
    for kw in (dict(block=6), dict(block=16, shape=(48, 48)),
               dict(block=4, storage="compact"),
               dict(block=4, storage="compact", n=16, shape=(16, 16))):
        kw = dict(kw)
        shape = kw.pop("shape", (16, 16))
        with pytest.raises(ValueError) as want:
            JO.sierpinski_write(jnp.zeros(shape), 1.0, **kw,
                                backend="tpu-interpret")
        with pytest.raises(ValueError) as got:
            TO.sierpinski_write(torch.zeros(shape), 1.0, **kw)
        assert str(got.value) == str(want.value)


def test_state_checks():
    with pytest.raises(ValueError, match="contiguous"):
        TO.sierpinski_write(torch.zeros(16, 32)[:, ::2], 1.0, block=4)
    with pytest.raises(TypeError, match="not supported"):
        TO.sierpinski_sum(torch.zeros(16, 16, dtype=torch.float64), block=4)
    plan, n, block = TW.prepare_launch(torch.zeros(16, 16), block=4,
                                       grid_mode="prefetch_lut")
    p = plan.launch_params(n, block, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TW.write_cuda(torch.zeros(16, 16), 1.0, p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TW.sum_partials_cuda(torch.zeros(16, 16), p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TW.sum_combine_cuda(torch.zeros(5))
    on_meta = plan.launch_params(n, block, "meta")
    with pytest.raises(ValueError, match="same device"):
        TW.write_cuda(torch.zeros(16, 16), 1.0, on_meta)
    assert TW.launch_counts() == {name: 0 for name in TW.KERNELS}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("torch_*.py"))


def test_port_never_imports_jax_or_repro_ast():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)} imports {name}"


def test_port_import_loads_no_jax_or_repro_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.sierpinski_write\n"
        "import repro_torch.kernels.sierpinski_ca\n"
        "import repro_torch.core.compact\n"
        "import repro_torch.kernels._cuda\n"
        "import repro_torch.data, repro_torch.data.pipeline\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'jaxlib', 'repro.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_torch_quickstart_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "all three constructions agree" in proc.stdout
