"""Shared inputs of the port's parity tests: the same states, made with
numpy from a seed, for the JAX package and for the port."""
import importlib

import jax.numpy as jnp
import numpy as np
import torch

#: the kernel module (``repro_torch.kernels.sierpinski_write`` the attribute
#: is the re-exported function, as in the JAX package)
TW = importlib.import_module("repro_torch.kernels.sierpinski_write")

# tests/test_plan.py's fractal cases, plus the gasket at n = 8 and 64/16
CASES = [("sierpinski-gasket", 16, 4), ("sierpinski-gasket", 64, 8),
         ("sierpinski-carpet", 9, 3), ("sierpinski-carpet", 27, 3),
         ("vicsek-cross", 9, 3), ("vicsek-cross", 27, 9),
         ("sierpinski-gasket", 8, 2), ("sierpinski-gasket", 64, 16)]
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
