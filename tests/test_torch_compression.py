"""The port's int8 gradient compression (``repro_torch.optim.
compression``) against the JAX package's ``repro.optim.compression``:

* ``quantize_int8`` / ``dequantize_int8`` / ``compress_roundtrip``
  bit-equal on f32 and bf16 arrays, a zero block (scale 1) and sizes
  that need padding to a block included (both round half to even);
* ``compressed_psum_grads`` on 2 and 4 gloo ranks (over the default
  group, and over a ``(world, 1)`` mesh's DP axis) against the JAX
  package's quantize / dequantize applied to each rank's gradient plus
  residual in one process, summed and divided by the world size: the
  residuals bit-equal, the means within MEAN_ULPS ulps (gloo adds the
  ranks' values in its own order).  The JAX package's own shard_map test does
  not run on this jax (ROADMAP C2).

Rank bodies are in ``tests/torch_train_mesh_ranks.py`` (no JAX)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_train_mesh_ranks as R
from repro.optim import compression as J
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import compression as T

#: the mean of the ranks' f32 values added in another order than the
#: f64 sum: a rounding a partial sum, in ulps of the largest term
MEAN_ULPS = 4


def _array(shape, dtype, seed, zero_block=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    if zero_block:
        x.reshape(-1)[:T.BLOCK] = 0.0
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


CASES = [((1000,), "float32", False), ((3, 256), "float32", True),
         ((7, 33), "float32", False), ((2, 300), "bfloat16", True),
         ((5,), "bfloat16", False), ((4, 64, 3), "float32", False)]


@pytest.mark.parametrize("shape,dtype,zero", CASES)
def test_quantization_bit_equal_to_reference(shape, dtype, zero):
    x = _array(shape, dtype, seed=sum(shape), zero_block=zero)
    jq, js = J.quantize_int8(jnp.asarray(x))
    tq, ts = T.quantize_int8(_torch(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if zero:
        assert ts[0, 0].item() == 1.0
    np.testing.assert_array_equal(
        T.dequantize_int8(tq, ts, shape).numpy(),
        np.asarray(J.dequantize_int8(jq, js, shape)))
    np.testing.assert_array_equal(
        T.compress_roundtrip(_torch(x)).numpy(),
        np.asarray(J.compress_roundtrip(jnp.asarray(x))))


def test_init_residual_is_zero_f32():
    res = T.init_residual({"a": torch.ones(3, dtype=torch.bfloat16),
                           "b": [torch.ones(2, 2)]})
    assert res["a"].dtype == torch.float32 and not res["a"].any()
    assert res["b"][0].shape == (2, 2)


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_grads_matches_reference(world):
    grads = [{"w": _array((7, 40), "float32", 10 + r),
              "b": _array((300,), "float32", 20 + r, zero_block=r == 0)}
             for r in range(world)]
    residual = [{k: _array(v.shape, "float32", 30 + r) * np.float32(1e-3)
                 for k, v in g.items()} for r, g in enumerate(grads)]
    want_res, total, top = [], {}, {}
    for g, r in zip(grads, residual):
        rr = {}
        for k in g:
            gf = jnp.asarray(g[k]) + jnp.asarray(r[k])
            deq = J.compress_roundtrip(gf)
            rr[k] = np.asarray(gf - deq)
            total[k] = total.get(k, 0) + np.asarray(deq, np.float64)
            top[k] = max(top.get(k, 0.0), float(jnp.abs(deq).max()))
        want_res.append(rr)
    want_mean = {k: (v / world).astype(np.float32) for k, v in total.items()}
    got = run_ranks(R.compressed, world, grads, residual)
    for rank, outs in enumerate(got):
        for synced, res in outs:  # the default group, then the mesh's
            for k in want_mean:
                np.testing.assert_array_equal(res[k], want_res[rank][k])
                np.testing.assert_allclose(
                    synced[k], want_mean[k], rtol=0,
                    atol=MEAN_ULPS * 2.0 ** -23 * top[k], err_msg=k)
                assert synced[k].dtype == np.float32
