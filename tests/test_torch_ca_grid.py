"""The port's fused CA against the JAX package's ``ca_run`` across the
schedule grid: gasket n = 32, every lowering x storage x coarsen x rule,
with fuse 1, 2, 4 and 8 (5 steps: remainder launches) on the port's
side.  The JAX reference runs ``backend="tpu-interpret"`` once per case
(its own tests hold every fuse depth bit-identical to the sequential
run).  Parity must be bit-equal; diffusion agrees within ``rtol=1e-5,
atol=1e-6``, the JAX tests' own tolerance.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as TO
from torch_parity import assert_rule_close, fractal_state, pair


@pytest.mark.parametrize("grid_mode", TP.LOWERINGS)
@pytest.mark.parametrize("storage", TP.STORAGES)
@pytest.mark.parametrize("coarsen", [1, 2, 4])
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_run_matches_reference(grid_mode, storage, coarsen, rule):
    n, block, steps = 32, 8, 5
    x = fractal_state("sierpinski-gasket", n, rule == "parity",
                      seed=coarsen)
    ja, ta = pair(x, "sierpinski-gasket", n, block, storage)
    kw = dict(rule=rule, block=block, grid_mode=grid_mode, storage=storage,
              n=n, coarsen=coarsen)
    want = JO.ca_run(ja, jnp.zeros_like(ja), steps, fuse=4,
                     backend="tpu-interpret", **kw)
    for fuse in (1, 2, 4, 8):
        got = TO.ca_run(ta, torch.zeros_like(ta), steps, fuse=fuse, **kw)
        assert_rule_close(got, want, rule)
