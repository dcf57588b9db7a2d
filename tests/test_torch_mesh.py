"""Sharded block-space execution (``mesh=``) over gloo ranks on the CPU,
against the JAX package's single-device results.

Each test function spawns one world of CPU ranks (``repro_torch.launch.
mesh.run_ranks``, gloo over localhost, one torch thread a rank), whose
bodies are in ``tests/torch_mesh_ranks.py``; the single-device reference
runs once in this process and is shared by every case that computes the
same result.  Covered, after ``tests/test_shard.py``:

* sharded ``ca_run`` bit-identical to the unsharded run under every
  lowering, storage and (rule, fuse, coarsen), ``num_stages`` 1 and 2,
  on D 2, 3 and 4 ranks (n 32, block 8: a 3 x 3 orthotope, so D 4 leaves
  a rank that owns nothing), and to ``repro.kernels.ref.ca_step_ref``
  (parity bit for bit, diffusion within ``DIFFUSION_TOL``); a carpet
  against tpu-interpret ``repro``; an impulse at every slab-boundary
  block;
* the sharded write bit-equal, the sum exact on integer-valued states
  and within 1e-5 relative on normal ones;
* flash attention under ``rows`` and ``zigzag`` bit-equal to the
  unsharded plain run and within 2e-5 of tpu-interpret ``repro``;
* the JAX package's refusals and the meshes themselves;
* ``verify=True`` on the mesh: the bits of ``verify=False``, the
  sharded searches' candidates unchanged, and a corrupted ghost map
  refused on every rank before any exchange.
"""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.compact import CompactLayout
from repro_torch.core.domain import make_fractal_domain
from repro_torch.launch.mesh import run_ranks
from torch_parity import assert_rule_close, fractal_state

TCA = importlib.import_module("repro_torch.kernels.sierpinski_ca")

N, BLOCK, STEPS = 32, 8, 5
LOWERINGS = ("closed_form", "prefetch_lut", "bounding", "mma")
#: (rule, fuse, coarsen), as tests/test_shard.py's CA matrix
SCHEDULES = (("parity", 3, 1), ("parity", 1, 2), ("diffusion", 2, 1))


def _pack(x, fractal=None, n=N, block=BLOCK):
    dom = make_fractal_domain(fractal or "sierpinski-gasket", n // block)
    return CompactLayout(dom).pack(torch.from_numpy(np.array(x)),
                                   block).numpy()


def _ca_case(a, steps, kw):
    """A case of ``R.ca_cases``: the buffers, and the port's unsharded
    result, which every rank's sharded result must equal bit for bit."""
    b = np.zeros_like(a)
    want = TCA.ca_run(torch.from_numpy(a), torch.from_numpy(b), steps,
                      **kw).numpy()
    return (a, b, steps, kw, want)


def _ref_run(x, rule, steps):
    """repro.kernels.ref's gasket CA, ``steps`` single steps."""
    s = jnp.asarray(x)
    for _ in range(steps):
        s = jref.ca_step_ref(s, rule)
    return np.asarray(s)


@pytest.mark.parametrize("D", (2, 3, 4))
def test_sharded_ca_bit_identical(D):
    states = {rule: fractal_state("sierpinski-gasket", N, rule == "parity")
              for rule in ("parity", "diffusion")}
    refs = {rule: _ref_run(x, rule, STEPS) for rule, x in states.items()}
    cases = []
    for gm in LOWERINGS:
        for storage in ("embedded", "compact"):
            for rule, fuse, coarsen in SCHEDULES:
                # the interior/boundary overlap runs at num_stages 2 on
                # compact storage; embedded has no exchange to overlap
                for stages in (1, 2) if storage == "compact" else (1,):
                    a, ref = states[rule], refs[rule]
                    if storage == "compact":
                        a, ref = _pack(a), _pack(ref)
                    case = _ca_case(a, STEPS, dict(
                        fuse=fuse, rule=rule, block=BLOCK, grid_mode=gm,
                        storage=storage, n=N, coarsen=coarsen,
                        num_stages=stages))
                    assert_rule_close(case[4], ref, rule)
                    cases.append(case)
    got = run_ranks(R.ca_cases, D, cases)
    for rank_out in got:
        for ok, case in zip(rank_out, cases):
            assert ok, (D, case[3])


def test_sharded_ca_generalized_fractal():
    """The carpet on 3 ranks under both storages, against tpu-interpret
    ``repro``."""
    n, block, steps = 27, 3, 4
    x = fractal_state("sierpinski-carpet", n, True, seed=1)
    kw = dict(fuse=2, rule="parity", block=block,
              fractal="sierpinski-carpet", n=n)
    ref = np.asarray(jops.ca_run(
        jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)), steps,
        grid_mode="closed_form", backend="tpu-interpret", donate=False,
        **kw))
    cases = []
    for gm in ("closed_form", "prefetch_lut"):
        for storage in ("embedded", "compact"):
            a, want = x, ref
            if storage == "compact":
                a, want = (_pack(t, "sierpinski-carpet", n, block)
                           for t in (x, ref))
            case = _ca_case(a, steps, dict(grid_mode=gm, storage=storage,
                                           **kw))
            np.testing.assert_array_equal(case[4], want)
            cases.append(case)
    got = run_ranks(R.ca_cases, 3, cases)
    assert all(all(r) for r in got), got


def test_halo_impulse_crosses_shard_boundary():
    from repro_torch.core import fractal as TF
    from repro_torch.core.shard import ShardedPlan
    steps = 6
    dom = make_fractal_domain("sierpinski-gasket", N // BLOCK)
    lay = CompactLayout(dom)
    plan = ShardedPlan(dom, storage="compact", halo=True, axis="data",
                       mesh=types.SimpleNamespace(shape={"data": 2}))
    rows = lay.slots_host()[:, 1]
    edge = dom.coords_host()[(rows == plan.rpd - 1) | (rows == plan.rpd)]
    mask = TF.membership_grid(N)
    states, refs = [], []
    for bx, by in edge:
        s = np.zeros((N, N), np.float32)
        s[by * BLOCK, bx * BLOCK] = 1.0
        s *= mask
        states.append(_pack(s))
        refs.append(_pack(_ref_run(s, "parity", steps)))
    kw = dict(fuse=3, rule="parity", block=BLOCK, grid_mode="closed_form",
              storage="compact", n=N)
    got = run_ranks(R.impulse_cases, 2, states, kw, steps)[0]
    assert len(got) == len(edge) > 0
    for res, want, (bx, by) in zip(got, refs, edge):
        np.testing.assert_array_equal(res, want, err_msg=f"{bx},{by}")


@pytest.mark.parametrize("D", (2, 4))
def test_exchange_ships_the_ghost_windows(D):
    """One exchange from each rank's slab alone: the ghost block holds
    the owners' rows on every cell a round ships (strip rows x column
    window) and zeros elsewhere, and the ranks' payloads add up to
    ``bytes_exchanged``'s trimmed count, at fuse 1 and at full rows."""
    from repro_torch.core.shard import ShardedPlan
    x = _pack(fractal_state("sierpinski-gasket", N, False))
    got = run_ranks(R.exchange_cases, D, x, BLOCK, (1, BLOCK))
    plan = ShardedPlan(make_fractal_domain("sierpinski-gasket", N // BLOCK),
                       storage="compact", halo=True, axis="data",
                       mesh=types.SimpleNamespace(shape={"data": D}))
    for i, h in enumerate((1, BLOCK)):
        assert all(r[i][0] for r in got), (D, h)
        assert sum(r[i][1] for r in got) == \
            plan.halo.bytes_exchanged(plan, BLOCK, h)["trimmed"], (D, h)


def test_collective_faults_hit_the_exchange():
    """``drop_halo`` (a round delivers zeros) and ``delay_halo`` (a round
    applied twice) fire once, at halo round 0 on every rank, and change
    the sharded CA's result; runtime/chaos.py's scenario_drop_halo holds
    the detection and the bit-identical retry."""
    x = _pack(fractal_state("sierpinski-gasket", N, True))
    kw = dict(fuse=2, rule="parity", block=BLOCK, grid_mode="closed_form",
              storage="compact", n=N)
    got = run_ranks(R.chaos_cases, 2, x, kw, 4, ("drop_halo", "delay_halo"))
    for rank_out in got:
        assert rank_out == [(["drop_halo"], False), (["delay_halo"], False)]


@pytest.mark.parametrize("D", (2, 3))
def test_sharded_write_and_sum(D):
    rng = np.random.default_rng(0)
    normal = rng.normal(size=(N, N)).astype(np.float32)
    integer = rng.integers(-8, 9, (N, N)).astype(np.float32)
    cases, want = [], []
    for values in (normal, integer):
        ref_write = np.asarray(jref.sierpinski_write_ref(
            jnp.asarray(values), 7.0))
        ref_sum = float(jref.sierpinski_sum_ref(jnp.asarray(values)))
        for gm in LOWERINGS:
            for storage in ("embedded", "compact"):
                for coarsen in (1, 2):
                    m, rw = values, ref_write
                    if storage == "compact":
                        m, rw = _pack(m), _pack(rw)
                    cases.append((m, 7.0, dict(block=BLOCK, grid_mode=gm,
                                               storage=storage, n=N,
                                               coarsen=coarsen)))
                    want.append((rw, ref_sum, values is integer))
    got = run_ranks(R.write_sum_cases, D, cases)
    for rank_out in got:
        for r, case in zip(rank_out, cases):
            assert r["write_equal"] and r["inplace_equal"] and r["same"], \
                (D, case[2])
    for r, (rw, rs, exact), case in zip(got[0], want, cases):
        np.testing.assert_array_equal(r["write"], rw, err_msg=str(case[2]))
        if exact:
            assert r["sum"] == r["sum_unsharded"] == rs, case[2]
        else:
            np.testing.assert_allclose(r["sum"], r["sum_unsharded"],
                                       rtol=1e-5)
            np.testing.assert_allclose(r["sum"], rs, rtol=1e-5)


@pytest.mark.parametrize("D", (2, 4))
def test_sharded_flash_attention_query_axis(D):
    rng = np.random.default_rng(0)
    b, h, hkv, d = 1, 2, 1, 16
    cases, refs = [], []
    for kind, sq, sk, window in (("causal", 128, 128, 0),
                                 ("local", 128, 128, 32),
                                 ("local", 64, 128, 32),
                                 ("full", 128, 128, 0)):
        q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
        k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
        v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
        for gm in ("closed_form", "prefetch_lut", "bounding", "mma"):
            kw = dict(kind=kind, window=window, block_q=16, block_k=16,
                      grid_mode=gm)
            cases.append((q, k, v, kw))
        refs.append(np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            backend="tpu-interpret", kind=kind, window=window, block_q=16,
            block_k=16)))
    got = run_ranks(R.flash_cases, D, cases)
    for rank_out in got:
        assert all(equal and same for _, equal, same, _ in rank_out), D
    outs = iter(got[0])
    for i, (q, k, v, kw) in enumerate(cases):
        for _ in range(2 if kw["kind"] == "causal" else 1):
            balance, _, _, res = next(outs)
            np.testing.assert_allclose(res, refs[i // 4], rtol=2e-5,
                                       atol=2e-5, err_msg=f"{kw} {balance}")


def test_sharded_refusals_and_meshes():
    """The JAX package's ValueErrors for a sharded flash call (the same
    messages), and the meshes of a 4-rank world."""
    q48 = np.zeros((1, 1, 48, 8), np.float32)
    q64 = np.zeros((1, 1, 64, 8), np.float32)
    cases = [(q48, dict(kind="causal", block_q=16, block_k=16)),
             (q64, dict(kind="full", block_q=16, block_k=16,
                        shard_balance="zigzag")),
             (q64, dict(kind="causal", block_q=16, block_k=16,
                        shard_balance="zigzag")),
             (q64, dict(kind="causal", block_q=16, block_k=16,
                        shard_balance="snake")),
             (q64, dict(kind="full", block_q=16, block_k=16, seq_pos=3))]
    import jax
    jmesh = jax.make_mesh((1,), ("data",))
    want = []
    for x, kw in cases:
        with pytest.raises(ValueError) as err:
            jops.flash_attention(jnp.asarray(x), jnp.asarray(x),
                                 jnp.asarray(x), backend="tpu-interpret",
                                 mesh=_ShapeMesh(jmesh, 4), **kw)
        want.append(str(err.value))
    got = run_ranks(R.flash_refusals, 4, cases)
    assert all(r == want for r in got), (got[0], want)
    meshes = run_ranks(R.mesh_checks, 4)
    for rank, m in enumerate(meshes):
        assert m["sizes"] == [4, 1, 4, 1, 4, 1] and m["rank"] == rank
        assert m["none"] is None and m["device"] == "cpu"
        assert "must equal the product" in m["errors"][0]
        assert "not divisible by tp=5" in m["errors"][1]
        assert "--mesh expects" in m["errors"][2]
        # the production meshes need 256 / 512 ranks
        assert "product of mesh_shape (16, 16)" in m["errors"][3]
        assert "product of mesh_shape (2, 16, 16)" in m["errors"][4]


@pytest.mark.parametrize("D", (2, 3))
def test_verify_flag_on_the_mesh(D):
    rng = np.random.default_rng(2)
    m = _pack(rng.integers(-8, 9, (N, N)).astype(np.float32))
    x = _pack(fractal_state("sierpinski-gasket", N, True))
    q = rng.normal(size=(1, 2, 192, 8)).astype(np.float32)
    got = run_ranks(R.verify_cases, D, m, x, q)
    for runs, searched, refused in got:
        assert [name for name, _, _ in runs] == ["write", "sum", "ca_run",
                                                 "flash"]
        assert all(equal and same for _, equal, same in runs), runs
        assert searched == {"write": True, "ca": True}
        assert refused is not None and "launch ghost map" in refused


class _ShapeMesh:
    """A JAX mesh whose 'data' axis reads as ``D`` wide: the JAX package
    validates a sharded flash call from ``mesh.shape`` before it builds
    anything on the mesh."""

    def __init__(self, mesh, D):
        self._mesh, self.shape = mesh, {"data": D}

    def __getattr__(self, name):
        return getattr(self._mesh, name)
