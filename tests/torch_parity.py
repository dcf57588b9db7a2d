"""Shared inputs of the port's parity tests: the same states, made with
numpy from a seed, for the JAX package and for the port."""
import importlib

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import fractal as JF
from repro.core.compact import CompactLayout as JLayout
from repro.core.domain import make_fractal_domain as j_fractal_domain
from repro_torch.core.compact import CompactLayout as TLayout
from repro_torch.core.domain import make_fractal_domain as t_fractal_domain

#: The tier-1 run drives six test workers on eight cores, and torch's
#: OpenMP pool would give each worker eight threads that spin beside the
#: other workers'.  The port's tests (small tensors, the kernels' CPU
#: emulations) run torch on one thread instead; every worker imports
#: every test module, so this holds for the whole run.
torch.set_num_threads(1)

#: the kernel module (``repro_torch.kernels.sierpinski_write`` the attribute
#: is the re-exported function, as in the JAX package)
TW = importlib.import_module("repro_torch.kernels.sierpinski_write")

# tests/test_plan.py's fractal cases, plus the gasket at n = 8 and 64/16
CASES = [("sierpinski-gasket", 16, 4), ("sierpinski-gasket", 64, 8),
         ("sierpinski-carpet", 9, 3), ("sierpinski-carpet", 27, 3),
         ("vicsek-cross", 9, 3), ("vicsek-cross", 27, 9),
         ("sierpinski-gasket", 8, 2), ("sierpinski-gasket", 64, 16)]
#: compact-storage cases (fractal, n, block, s): s is a coarsening the
#: block grid allows (tests/test_sched.py's n = 32 and 27 cases)
COMPACT_CASES = [("sierpinski-gasket", 32, 4, 2), ("sierpinski-gasket", 32, 4, 4),
                 ("sierpinski-gasket", 64, 4, 8), ("sierpinski-carpet", 27, 3, 3),
                 ("vicsek-cross", 27, 3, 3), ("vicsek-cross", 81, 3, 9)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def make_pair(n, dtype, seed, integer=False):
    """The same (n, n) state for both packages: a jax array and a torch
    tensor holding identical values of ``dtype``."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, size=(n, n)) if integer
         else rng.normal(size=(n, n))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    exact = t.to(torch.float32).numpy()  # the values after rounding
    return jnp.asarray(exact, jdt), t


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def pack_pair(fractal, n, block, dtype, seed, integer=False):
    """The same packed (compact-storage) state for both packages."""
    jm, tm = make_pair(n, dtype, seed, integer)
    return (JLayout(j_fractal_domain(fractal, n // block)).pack(jm, block),
            TLayout(t_fractal_domain(fractal, n // block)).pack(tm, block))


# ---------------------------------------------------------------------------
# CA states
# ---------------------------------------------------------------------------

#: diffusion tolerance against the JAX package: its own tests' (XLA may
#: contract the update differently; parity is compared bit for bit)
DIFFUSION_TOL = dict(rtol=1e-5, atol=1e-6)


def fractal_state(fractal, n, binary, seed=0):
    """A state that is zero outside the fractal (numpy f32): {0, 1} when
    ``binary``, else normal."""
    rng = np.random.default_rng(seed)
    mask = JF.membership_grid(n) if fractal == "sierpinski-gasket" \
        else JF.FRACTALS[fractal].membership_grid(n)
    x = rng.integers(0, 2, (n, n)) if binary else rng.normal(size=(n, n))
    return (x * mask).astype(np.float32)


def pair(x, fractal, n, block, storage):
    """The same state for both packages under ``storage``."""
    j, t = jnp.asarray(x), torch.from_numpy(x.copy())
    if storage == "compact":
        j = JLayout(j_fractal_domain(fractal, n // block)).pack(j, block)
        t = TLayout(t_fractal_domain(fractal, n // block)).pack(t, block)
    return j, t


def assert_rule_close(got, want, rule):
    """Parity bit-equal, diffusion within DIFFUSION_TOL."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if rule == "parity":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), **DIFFUSION_TOL)


# ---------------------------------------------------------------------------
# attention inputs and the LM stack
# ---------------------------------------------------------------------------

#: kernel parity tolerance per dtype: the JAX tests' own
#: (tests/test_kernels.py, f32 and bf16)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def attn_pair(shape, seed, dtype="float32"):
    """The same normal tensor for both packages: (jax array, torch
    tensor) holding identical values of ``dtype``."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return jnp.asarray(t.to(torch.float32).numpy(), jdt), t


def qkv_pair(b, h, hkv, sq, sk, d, seed, dtype="float32"):
    """(jax q, k, v), (torch q, k, v) with identical values."""
    out = [attn_pair(s, seed + i, dtype) for i, s in enumerate(
        [(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)])]
    return tuple(o[0] for o in out), tuple(o[1] for o in out)


def assert_attn_close(got, want, dtype="float32"):
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def jax_model(arch, seed=0, **replace):
    """The JAX package's smoke config of ``arch`` (with ``replace``),
    its init from PRNGKey(seed), and the port's model holding the same
    weights: (jax cfg, jax params, torch cfg, torch model)."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models import init as j_init
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models.convert import params_from_jax

    jcfg = j_get_config(arch, smoke=True).replace(**replace)
    tcfg = t_get_config(arch, smoke=True).replace(**replace)
    params = j_init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_jax(tree, tcfg, "cpu")


def isolate_tune_caches(monkeypatch, tmp_path):
    """Point both packages' tune caches at fresh files under ``tmp_path``
    (each package has its own variable and file); returns their paths
    ``(reference, port)``."""
    ref, port = str(tmp_path / "repro-tune.json"), \
        str(tmp_path / "repro-torch-tune.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", ref)
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", port)
    return ref, port
