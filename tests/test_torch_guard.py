"""The port's guarded runtime against the JAX package's: the error
taxonomy (every reference case plus the torch / CUDA families), the
backoff schedule draw for draw, validation over nested tensor trees
with the reference's messages, GuardedCall's retry / fatal / exhaustion
/ validation / deadline semantics, the ladder's transitions, the failure
report's keys, and the fault-tolerance helpers."""
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as JFT
from repro.runtime import guard as JG
from repro_torch.distributed import fault_tolerance as TFT
from repro_torch.kernels import _cuda
from repro_torch.runtime import guard as TG


def _no_backoff(mod=TG):
    return mod.Backoff(base_s=0.0, jitter=0.0)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def _reference_cases():
    """tests/test_runtime.py::test_classify_error_taxonomy's cases, with
    the JAX runtime error replaced by the torch accelerator error in the
    port's list."""
    from jax.errors import JaxRuntimeError

    def both(make):
        return make(JG), make(TG)

    return [
        (both(lambda m: m.TransientFault("x")), "transient"),
        (both(lambda m: m.ValidationError("nan")), "transient"),
        ((TimeoutError(), TimeoutError()), "transient"),
        ((ConnectionError(), ConnectionError()), "transient"),
        ((JaxRuntimeError("UNAVAILABLE: socket closed"),
          torch.AcceleratorError("UNAVAILABLE: socket closed")),
         "transient"),
        ((JaxRuntimeError("INVALID_ARGUMENT: shape mismatch"),
          torch.AcceleratorError("INVALID_ARGUMENT: shape mismatch")),
         "fatal"),
        ((RuntimeError("RESOURCE_EXHAUSTED: oom"),) * 2, "transient"),
        ((RuntimeError("boom"),) * 2, "fatal"),
        ((ValueError("shape"),) * 2, "fatal"),
        ((TypeError(),) * 2, "fatal"),
        ((KeyError("k"),) * 2, "fatal"),
    ]


@pytest.mark.parametrize("i", range(11))
def test_classify_error_reference_taxonomy(i):
    (jexc, texc), want = _reference_cases()[i]
    assert JG.classify_error(jexc) == want
    assert TG.classify_error(texc) == want


class _FakeLib:
    @staticmethod
    def cuda_error_string(status):
        return {2: b"out of memory",
                700: b"an illegal memory access was encountered",
                716: b"misaligned address",
                715: b"an illegal instruction was encountered",
                719: b"unspecified launch failure",
                710: b"device-side assert triggered"}[status]


@pytest.mark.parametrize("status,want", [
    (2, "transient"), (700, "fatal"), (716, "fatal"), (715, "fatal"),
    (719, "fatal"), (710, "fatal")])
def test_classify_error_cuda_status_of_raise_on(status, want):
    """``_cuda.raise_on``'s "CUDA error N (...)": out of memory is worth
    a retry, the sticky errors are not."""
    with pytest.raises(RuntimeError, match=f"CUDA error {status}") as e:
        _cuda.raise_on(_FakeLib, status, "write kernel")
    assert TG.classify_error(e.value) == want


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "transient"),
    (RuntimeError("CUDA build failed:\nflash_attention: nvcc exit 1"),
     "fatal"),
    (RuntimeError("nvcc not found (set CUDA_HOME)"), "fatal"),
    (torch.AcceleratorError("CUDA error: an illegal memory access was "
                            "encountered"), "fatal"),
    (torch.AcceleratorError("CUDA error: device-side assert triggered"),
     "fatal"),
    (torch.AcceleratorError("CUDA error: misaligned address"), "fatal"),
    (torch.AcceleratorError("CUDA error: unspecified launch failure"),
     "fatal"),
    (torch.AcceleratorError("CUDA error: an illegal instruction was "
                            "encountered"), "fatal"),
    (torch.AcceleratorError("CUDA error: launch timed out"), "transient"),
    (torch.AcceleratorError("unimplemented dtype"), "fatal"),
])
def test_classify_error_torch_families(exc, want):
    assert TG.classify_error(exc) == want


def test_accelerator_error_type_is_torch_s():
    assert TG.accelerator_error_type() is torch.AcceleratorError
    assert TFT.accelerator_runtime_errors() is torch.AcceleratorError


# ---------------------------------------------------------------------------
# backoff / validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_equals_reference(seed):
    kw = dict(base_s=0.1, factor=2.0, max_s=0.5, jitter=0.5, seed=seed)
    a, b = TG.Backoff(**kw), JG.Backoff(**kw)
    assert [a.delay(i) for i in range(1, 9)] == \
        [b.delay(i) for i in range(1, 9)]
    flat = TG.Backoff(base_s=0.2, jitter=0.0, seed=seed)
    assert flat.delay(3) == JG.Backoff(base_s=0.2, jitter=0.0,
                                       seed=seed).delay(3) == 0.8


def _messages(fn_j, fn_t):
    with pytest.raises(JG.ValidationError) as ej:
        fn_j()
    with pytest.raises(TG.ValidationError) as et:
        fn_t()
    return str(ej.value), str(et.value)


def test_validate_finite_nested_trees_reference_messages():
    TG.validate_finite({"a": torch.ones(3), "b": torch.arange(4)})
    TG.validate_finite(({"k": torch.zeros(2, dtype=torch.bfloat16)},
                        [np.ones(2)], None))
    bad = np.array([1.0, np.nan, np.inf], np.float32)
    tree_j = {"z": [jnp.ones(2)], "x": {"y": jnp.asarray(bad)},
              "c": (jnp.ones(1), jnp.asarray(bad))}
    tree_t = {"z": [torch.ones(2)], "x": {"y": torch.from_numpy(bad)},
              "c": (torch.ones(1), torch.from_numpy(bad))}
    mj, mt = _messages(lambda: JG.validate_finite(tree_j, "decode"),
                       lambda: TG.validate_finite(tree_t, "decode"))
    assert mj == mt == ("decode: 2 non-finite values in leaf c/1 "
                        "(shape (3,))")
    mj, mt = _messages(
        lambda: JG.validate_finite(np.array([np.inf])),
        lambda: TG.validate_finite(torch.tensor([float("inf")])))
    assert mj == mt
    # bf16 leaves are screened too
    with pytest.raises(TG.ValidationError, match="leaf 1/0"):
        TG.validate_finite((torch.ones(2), [torch.full(
            (2,), float("nan"), dtype=torch.bfloat16)]))


@pytest.mark.parametrize("bad,dtype,at", [
    (float("nan"), torch.float32, "2"), (float("inf"), torch.bfloat16, "1"),
    (float("-inf"), torch.float16, "3/0"), (None, torch.float64, "")])
def test_validate_finite_one_pass_over_mixed_dtypes(bad, dtype, at):
    """The screen reduces each device's leaves by dtype in one fused
    max-|x|: one bad value in any leaf of any float dtype is found, and
    named as the per-leaf walk names it; empty leaves and huge finite
    f64 values pass."""
    tree = [torch.zeros(0), torch.ones(4, dtype=torch.bfloat16),
            torch.full((64, 64), 3.0), [torch.ones(5, dtype=torch.float16),
                                        torch.tensor([1e300, -1e300],
                                                     dtype=torch.float64)],
            torch.arange(6)]
    if bad is None:
        TG.validate_finite(tree)
        return
    leaf = {"1": tree[1], "2": tree[2], "3/0": tree[3][0]}[at]
    assert leaf.dtype == dtype
    leaf.view(-1)[leaf.numel() // 2] = bad
    with pytest.raises(TG.ValidationError,
                       match=f"1 non-finite values in leaf {at} "):
        TG.validate_finite(tree, "decode")


def test_spot_check_reference_messages():
    ref_np = {"w": np.arange(6, dtype=np.float32)}
    ref_t = {"w": torch.arange(6, dtype=torch.float32)}
    TG.spot_check(ref_t)({"w": torch.arange(6, dtype=torch.float32)})
    TG.spot_check(ref_np)({"w": torch.arange(6, dtype=torch.float32)})
    mj, mt = _messages(
        lambda: JG.spot_check(ref_np)({"w": ref_np["w"] + 1}),
        lambda: TG.spot_check(ref_t)({"w": ref_t["w"] + 1}))
    assert mj == mt == "output: leaf 0 differs from reference in 6 elements"
    mj, mt = _messages(
        lambda: JG.spot_check(ref_np)({"w": ref_np["w"], "v": 1.0}),
        lambda: TG.spot_check(ref_t)({"w": ref_t["w"], "v": 1.0}))
    assert mj == mt
    mj, mt = _messages(
        lambda: JG.spot_check(ref_np, "canary")({"w": np.zeros(5)}),
        lambda: TG.spot_check(ref_t, "canary")({"w": torch.zeros(5)}))
    assert mj == mt
    # atol: within passes, past it fails; NaN never equals
    TG.spot_check(ref_t, atol=0.1)({"w": ref_t["w"] + 0.05})
    with pytest.raises(TG.ValidationError):
        TG.spot_check(ref_t, atol=0.1)({"w": ref_t["w"] + 0.5})
    nan = torch.tensor([float("nan")])
    with pytest.raises(TG.ValidationError):
        TG.spot_check(nan)(nan.clone())


# ---------------------------------------------------------------------------
# GuardedCall
# ---------------------------------------------------------------------------

def _flaky(mod, fail_until, exc):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < fail_until:
            raise exc(mod)
        return torch.tensor(42.0)
    return fn, calls


def _kinds(g):
    return [e.kind for e in g.events]


def test_guarded_call_retries_transient_like_reference():
    out = {}
    for mod in (JG, TG):
        fn, calls = _flaky(mod, 3, lambda m: m.TransientFault("injected"))
        g = mod.GuardedCall(fn, "step", retries=3, backoff=_no_backoff(mod))
        assert float(g()) == 42.0
        out[mod] = (calls["n"], g.recoveries, _kinds(g))
    assert out[TG] == out[JG] == (
        3, 1, ["transient", "retry", "transient", "retry", "ok"])


def test_guarded_call_fatal_reports_immediately(tmp_path):
    reports = {}
    for mod in (JG, TG):
        fn, calls = _flaky(mod, 9, lambda m: ValueError("shape mismatch"))
        g = mod.GuardedCall(fn, "decode", retries=3,
                            backoff=_no_backoff(mod))
        with pytest.raises(mod.GuardExhausted) as e:
            g()
        assert calls["n"] == 1 and e.value.report.classification == "fatal"
        path = e.value.report.write(str(tmp_path / f"{mod.__name__}.json"))
        reports[mod] = json.load(open(path))
    assert reports[TG].keys() == reports[JG].keys()
    assert set(reports[TG]["events"][0]) == set(reports[JG]["events"][0])
    for k in ("name", "error", "error_type", "classification",
              "attempts", "transitions"):
        assert reports[TG][k] == reports[JG][k], k
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_guarded_call_exhaustion_and_build_failure():
    for mod in (JG, TG):
        fn, calls = _flaky(mod, 99, lambda m: m.TransientFault("injected"))
        g = mod.GuardedCall(fn, "s", retries=2, backoff=_no_backoff(mod))
        with pytest.raises(mod.GuardExhausted) as e:
            g()
        assert e.value.report.classification == "exhausted"
        assert e.value.report.attempts == 3 == calls["n"]
    # a kernel that fails to build is never retried
    fn, calls = _flaky(TG, 99, lambda m: RuntimeError(
        "CUDA build failed:\nsierpinski_write: nvcc exit 2"))
    g = TG.GuardedCall(fn, "s", retries=3, backoff=_no_backoff())
    with pytest.raises(TG.GuardExhausted) as e:
        g()
    assert calls["n"] == 1 and e.value.report.classification == "fatal"


def test_guarded_call_validation_failure_retries():
    outs = iter([{"x": torch.tensor([float("nan")])},
                 {"x": torch.tensor([1.0])}])
    seen = []
    g = TG.GuardedCall(lambda: next(outs), "decode", retries=2,
                       backoff=_no_backoff(),
                       validators=[TG.validate_finite],
                       before_retry=lambda: seen.append("refresh"))
    assert float(g()["x"][0]) == 1.0
    assert _kinds(g) == ["validation", "retry", "ok"]
    assert seen == ["refresh"] and g.recoveries == 1


def test_guarded_call_deadline_recorded_and_enforced(monkeypatch):
    """A clock that advances 1 s a reading: every call overruns a 0.5 s
    deadline; recorded, and with enforce_deadline a transient failure
    that exhausts a zero-retry guard -- the same events in both
    packages."""
    import itertools
    import time as time_mod
    kinds = {}
    for mod in (JG, TG):
        clock = itertools.count(0.0, 1.0)
        monkeypatch.setattr(time_mod, "perf_counter", lambda: next(clock))
        g = mod.GuardedCall(lambda: torch.tensor(1.0), "s", deadline_s=0.5,
                            retries=0, backoff=_no_backoff(mod))
        g()
        g2 = mod.GuardedCall(lambda: torch.tensor(1.0), "s", deadline_s=0.5,
                             retries=0, enforce_deadline=True,
                             backoff=_no_backoff(mod))
        with pytest.raises(mod.GuardExhausted, match="deadline"):
            g2()
        kinds[mod] = (_kinds(g), _kinds(g2))
    assert kinds[TG] == kinds[JG] == (["deadline", "ok"],
                                      ["deadline", "transient"])


def test_guard_event_fields_by_name():
    ev = TG.GuardEvent("serve.decode", "ok", attempt=1)
    assert ev["kind"] == "ok" and ev["name"] == "serve.decode"


# ---------------------------------------------------------------------------
# ladder / state / sampling keys
# ---------------------------------------------------------------------------

def test_degradation_ladder_transitions_equal_reference():
    rungs = [{"decode_kernel": "blockspace", "grid_lowering": "mma"},
             {"decode_kernel": "xla", "grid_lowering": "mma"},
             {"decode_kernel": "xla", "grid_lowering": "closed_form"}]
    logs = {}
    for mod in (JG, TG):
        seen = []
        lad = mod.DegradationLadder(rungs, on_transition=seen.append)
        steps = [lad.step_down(f"r{i}") for i in range(3)]
        logs[mod] = (steps, lad.level, lad.degraded, lad.exhausted(),
                     [{k: v for k, v in t.items() if k != "time"}
                      for t in lad.transitions], len(seen))
        with pytest.raises(ValueError):
            mod.DegradationLadder([])
    assert logs[TG] == logs[JG]
    assert logs[TG][0] == [True, True, False]
    assert [s.value for s in TG.ServerState] == \
        [s.value for s in JG.ServerState]


def test_sample_key_pure_function_of_coordinates():
    a = TG.sample_key(3, 10, 4)
    assert a == TG.sample_key(3, 10, 4)
    assert len(set(a)) == 4
    assert a != TG.sample_key(3, 11, 4) != TG.sample_key(4, 10, 4)
    assert a[2] == TG.coordinate_seed(3, 2, 10)


# ---------------------------------------------------------------------------
# fault tolerance helpers
# ---------------------------------------------------------------------------

def test_heartbeat_straggle_callback_fires():
    seen = []
    hb = TFT.Heartbeat(deadline_s=0.0, on_straggle=seen.append)
    hb.last -= 1.0
    dt = hb.beat()
    assert dt >= 1.0 and hb.straggle_events == 1 and seen
    assert TFT.Heartbeat(deadline_s=1e9).beat() < 1e9


def test_preemption_guard_install_restore_and_fire():
    before = signal.getsignal(signal.SIGTERM)
    with TFT.PreemptionGuard() as g:
        assert not g.fired
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.fired
    assert signal.getsignal(signal.SIGTERM) is before


def test_retry_step_classifies_like_reference():
    for mod, ft in ((JG, JFT), (TG, TFT)):
        calls, retried = {"n": 0}, []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise mod.TransientFault("injected")
            return 7

        assert ft.retry_step(flaky, retries=3, backoff_s=0.0,
                             on_retry=lambda a, e: retried.append(a),
                             sleep=lambda s: None) == 7
        assert retried == [1, 2]
        calls["n"] = 0

        def fatal():
            calls["n"] += 1
            raise ValueError("shape")

        with pytest.raises(ValueError):
            ft.retry_step(fatal, retries=3, sleep=lambda s: None)
        assert calls["n"] == 1

        def always():
            raise mod.TransientFault("injected")

        with pytest.raises(mod.TransientFault):
            ft.retry_step(always, retries=2, sleep=lambda s: None)
    with pytest.raises(torch.AcceleratorError):   # transient, exhausted
        TFT.retry_step(lambda: (_ for _ in ()).throw(
            torch.AcceleratorError("UNAVAILABLE")), retries=1,
            sleep=lambda s: None)
