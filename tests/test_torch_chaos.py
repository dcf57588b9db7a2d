"""The port's fault injector against the JAX package's: seeded plans
draw the same schedule and cross-load both ways, the kernel-layer
faults (through the launch hook) leave the write, sum and CA outputs the
reference's faulted tpu-interpret launches leave, the hook is restored
on exit, and the CPU chaos matrix passes, none skipped: the collective
fault (drop_halo) on 2 gloo ranks, and the SIGTERM successor resuming on
the 2-rank elastic mesh ((1, 2): tensor-parallel) it restores onto."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import chaos as JC
from repro_torch.kernels import _cuda
from repro_torch.runtime import chaos as TC
from torch_parity import TW, fractal_state, make_pair


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(sites=("serve.decode", "serve.prefill")),
    dict(sites=("serve.decode", "serve.prefill"),
         kinds=("transient_error", "poison_result"), n_faults=3,
         horizon=6),
    dict(sites=("pallas",), kinds=("poison_tile", "corrupt_table"),
         n_faults=5, horizon=4),
    dict(sites=("a", "b", "c"), kinds=TC.HOST_FAULTS, n_faults=8,
         horizon=32, modes=("jax",)),
]


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_from_seed_equals_reference(seed, case):
    kw = PLAN_CASES[case]
    got = TC.FaultPlan.from_seed(seed, **kw).to_json()
    want = JC.FaultPlan.from_seed(seed, **kw).to_json()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_plans_cross_load_both_ways():
    assert TC.ALL_FAULTS == JC.ALL_FAULTS
    assert (TC.PALLAS_SITE, TC.PPERMUTE_SITE) == \
        (JC.PALLAS_SITE, JC.PPERMUTE_SITE)
    faults = [("poison_tile", "pallas", 0, "bitflip", 3, None),
              ("drop_halo", "ppermute", 1, "", 0, None),
              ("transient_error", "serve.decode", 2, "jax", 0, 0),
              ("sigterm", "serve.decode", 4, "", 0, None)]
    jplan = JC.FaultPlan(9, [JC.FaultSpec(*f) for f in faults])
    tplan = TC.FaultPlan.from_json(json.loads(json.dumps(jplan.to_json())))
    assert tplan.to_json() == jplan.to_json()
    back = JC.FaultPlan.from_json(json.loads(json.dumps(tplan.to_json())))
    assert back.to_json() == jplan.to_json()
    assert tplan.has_traced_faults and tplan.sites() == jplan.sites()
    for site, idx, rung in (("serve.decode", 2, 0), ("serve.decode", 2, 1),
                            ("serve.decode", 2, None), ("pallas", 0, None)):
        assert [f.to_json() for f in tplan.for_call(site, idx, rung)] == \
            [f.to_json() for f in jplan.for_call(site, idx, rung)]
    with pytest.raises(ValueError, match="unknown fault kind"):
        TC.FaultSpec("meteor", "pallas", 0)


# ---------------------------------------------------------------------------
# kernel-layer faults vs the reference's faulted launches
# ---------------------------------------------------------------------------

def _faulted(spec_args, run_j, run_t):
    """(reference output, port output) of one launch under the same
    one-fault plan."""
    with JC.ChaosInjector(JC.FaultPlan(0, [JC.FaultSpec(*spec_args)])) as jc:
        want = np.asarray(jnp.asarray(run_j(), jnp.float32))
    with TC.ChaosInjector(TC.FaultPlan(0, [TC.FaultSpec(*spec_args)])) as tc:
        got = run_t().to(torch.float32).numpy()
    assert len(jc.events) == len(tc.events) == 1
    return want, got


WRITE_CASES = [  # (fault, mode, step, grid_mode, n, block)
    ("poison_tile", "nan", 0, "closed_form", 16, 4),
    ("poison_tile", "inf", 2, "closed_form", 16, 4),
    ("poison_tile", "bitflip", 5, "closed_form", 16, 4),
    ("poison_tile", "nan", 3, "closed_form", 32, 8),
    ("corrupt_table", "", 1, "prefetch_lut", 16, 4),
    ("corrupt_table", "", 1, "prefetch_lut", 32, 8),
    ("corrupt_table", "", 4, "bounding", 16, 4),
]


@pytest.mark.parametrize("fault,mode,step,grid_mode,n,block", WRITE_CASES)
def test_faulted_write_equals_reference(fault, mode, step, grid_mode, n,
                                        block):
    from repro.kernels.sierpinski_write import sierpinski_write as jwrite
    jm, tm = make_pair(n, "float32", seed=n + step)
    kw = dict(block=block, grid_mode=grid_mode, coarsen=1, num_stages=1)
    want, got = _faulted((fault, "pallas", 0, mode, step),
                         lambda: jwrite(jm, 1.0, **kw),
                         lambda: TW.sierpinski_write(tm, 1.0, **kw))
    clean = TW.sierpinski_write(tm, 1.0, **kw).numpy()
    assert not np.array_equal(got, clean, equal_nan=True)   # it landed
    np.testing.assert_array_equal(got, want)   # NaNs in the same places
    if mode == "nan":
        assert np.isnan(got).sum() == block * block


@pytest.mark.parametrize("fault,mode", [("corrupt_table", ""),
                                        ("poison_tile", "nan")])
def test_faulted_sum_equals_reference(fault, mode):
    from repro.kernels.sierpinski_write import sierpinski_sum as jsum
    jm, tm = make_pair(16, "float32", seed=3, integer=True)
    kw = dict(block=4, grid_mode="closed_form", coarsen=1, num_stages=1)
    want, got = _faulted((fault, "pallas", 0, mode, 2),
                         lambda: jsum(jm, **kw),
                         lambda: TW.sierpinski_sum(tm, **kw))
    np.testing.assert_array_equal(got.reshape(()), want.reshape(()))
    assert float(got) != float(TW.sierpinski_sum(tm, **kw))


@pytest.mark.parametrize("fault,mode,step", [("corrupt_table", "", 2),
                                             ("poison_tile", "bitflip", 1)])
def test_faulted_ca_launch_equals_reference(fault, mode, step):
    from repro.kernels.sierpinski_ca import ca_step as jstep
    from repro_torch.kernels.sierpinski_ca import ca_step as tstep
    x = fractal_state("sierpinski-gasket", 16, binary=True, seed=1)
    stale = fractal_state("sierpinski-gasket", 16, binary=True, seed=2)
    kw = dict(rule="parity", block=4, grid_mode="closed_form", coarsen=1,
              num_stages=1)
    want, got = _faulted(
        (fault, "pallas", 0, mode, step),
        lambda: jstep(jnp.asarray(x), jnp.asarray(stale), **kw),
        lambda: tstep(torch.from_numpy(x), torch.from_numpy(stale), **kw))
    clean = tstep(torch.from_numpy(x), torch.from_numpy(stale), **kw)
    assert not np.array_equal(got, clean.numpy())
    np.testing.assert_array_equal(got, want)


def test_fault_past_the_grid_and_unfaulted_indices_change_nothing():
    m = torch.zeros((16, 16))
    kw = dict(block=4, grid_mode="closed_form", coarsen=1, num_stages=1)
    clean = TW.sierpinski_write(m, 1.0, **kw)
    plan = TC.FaultPlan(0, [TC.FaultSpec("poison_tile", "pallas", 0,
                                         mode="nan", step=10 ** 6),
                            TC.FaultSpec("poison_tile", "pallas", 5,
                                         mode="nan")])
    with TC.ChaosInjector(plan) as chaos:
        assert torch.equal(TW.sierpinski_write(m, 1.0, **kw), clean)
        assert torch.equal(TW.sierpinski_write(m, 1.0, **kw), clean)
    assert chaos.counters["pallas"] == 2 and len(chaos.events) == 1


def test_launch_hook_restored_on_exit():
    assert _cuda.LAUNCH_HOOK is None
    outer = TC.ChaosInjector(TC.FaultPlan(0))
    with outer:
        assert _cuda.LAUNCH_HOOK == outer.around_launch
        inner = TC.ChaosInjector(TC.FaultPlan(1))
        with inner:
            assert _cuda.LAUNCH_HOOK == inner.around_launch
        assert _cuda.LAUNCH_HOOK == outer.around_launch
    prev = _cuda.set_launch_hook(None)      # nothing left installed
    assert prev is None
    with pytest.raises(RuntimeError):
        with TC.ChaosInjector(TC.FaultPlan(0)):
            raise RuntimeError("boom")
    assert _cuda.LAUNCH_HOOK is None


# ---------------------------------------------------------------------------
# host layer and the matrix
# ---------------------------------------------------------------------------

def test_wrap_host_faults():
    plan = TC.FaultPlan(0, [
        TC.FaultSpec("transient_error", "s", 0, mode="jax"),
        TC.FaultSpec("transient_error", "s", 1),
        TC.FaultSpec("fatal_error", "s", 2),
        TC.FaultSpec("poison_result", "s", 3),
        TC.FaultSpec("transient_error", "s", 4, rung=0)])
    chaos = TC.ChaosInjector(plan)
    state = torch.ones(3)
    fn = chaos.wrap("s", lambda: (state, [torch.arange(2)]),
                    rung=lambda: 1)
    with pytest.raises(torch.AcceleratorError, match="UNAVAILABLE"):
        fn()
    with pytest.raises(TC.TransientFault):
        fn()
    with pytest.raises(ValueError, match="fatal"):
        fn()
    out = fn()
    assert torch.isnan(out[0]).all() and torch.equal(out[1][0],
                                                     torch.arange(2))
    assert torch.equal(state, torch.ones(3))       # not poisoned in place
    fn()                                           # rung-0 fault, rung 1
    assert [e["index"] for e in chaos.events] == [0, 1, 2, 3]


def test_matrix_cli_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "chaos.json")
    rc = TC.main(["--matrix", "--smoke", "--device", "cpu", "--out", path])
    assert rc == 0
    rep = json.load(open(path))
    assert rep["ok"] and rep["backend"] == "cpu" and rep["num_failed"] == 0
    status = {r["fault"]: r for r in rep["results"]}
    # the halo round dropped on 2 gloo ranks this scenario spawns:
    # detected by the spot check, recovered bit-identically
    assert status["drop_halo"]["status"] == "recovered"
    assert status["drop_halo"]["detected"] and \
        status["drop_halo"]["bit_identical"]
    # the drained stream resumed bit-identically on the successor's mesh
    assert status["sigterm"]["status"] == "recovered"
    assert status["sigterm"]["mesh"] == [1, 2]
    for name, r in status.items():
        assert r["status"] in ("recovered", "reported"), r
    assert status["poison_tile"]["detected"] and \
        status["corrupt_table"]["bit_identical"]
    assert "9 scenarios, 0 failed, 0 skipped" in capsys.readouterr().out
