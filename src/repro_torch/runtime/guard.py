"""Guarded execution: detect, degrade, recover.

The port's counterpart of the JAX package's ``runtime/guard.py``: the
runtime layer for everything a plan check cannot see -- transient device
errors, NaN-producing tiles, stragglers, preemptions.  The pieces
compose bottom-up:

``classify_error``     -- transient-vs-fatal triage, taught the torch /
                          CUDA families: an out-of-memory error is worth
                          a retry; a failed build or a sticky device
                          error (illegal address, device-side assert)
                          fails identically on every retry.
``Backoff``            -- deterministic jittered exponential backoff
                          (seeded numpy generator, the JAX package's
                          schedule draw for draw).
``GuardedCall``        -- wraps one step function (prefill / decode)
                          with a per-call deadline, output validation,
                          classified retries, and an event log; the
                          output's CUDA streams are synchronised inside
                          the guard, so an asynchronous launch error
                          surfaces there.  Exhausted retries raise
                          :class:`GuardExhausted` carrying a
                          machine-readable :class:`FailureReport`.
``DegradationLadder``  -- an ordered list of execution configs
                          (blockspace -> xla decode, an exotic lowering
                          -> closed_form); ``step_down`` records each
                          transition.
``ServerState``        -- the serving state machine's states
                          (healthy -> degraded -> draining).

Outputs are nested tuples / lists / dicts of tensors (numpy arrays and
Python scalars are accepted as leaves too).  :func:`validate_finite` and
:func:`spot_check` reduce on the tensors' own devices; only a bool per
device crosses to the host.

Sampling keys (:func:`sample_key`) are a pure function of (seed, slot,
position), seeded through numpy's ``SeedSequence`` into a
``torch.Generator``: a retried or replayed step draws the same token.
These streams differ from the JAX package's ``jax.random`` streams.

Nothing here imports the kernels or the model stack: the serving layer
wraps its own callables.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------

class TransientFault(RuntimeError):
    """An error known to be transient (injected faults, explicit
    retryable conditions).  Always classified ``transient``."""


class ValidationError(RuntimeError):
    """A guarded call produced output that failed validation (NaN/inf
    screen, spot-check mismatch).  Classified ``transient``: the step
    is re-executed, not the process killed."""


class DeadlineExceeded(TimeoutError):
    """A guarded call overran its per-call deadline."""


class GuardExhausted(RuntimeError):
    """Retries exhausted (or a fatal error was classified); carries the
    structured :class:`FailureReport` as ``.report``."""

    def __init__(self, message: str, report: "FailureReport"):
        super().__init__(message)
        self.report = report


#: substrings (lowercased) marking a generic RuntimeError as transient
#: -- the status families that a retry can actually fix (the JAX
#: package's list, plus CUDA's "out of memory" status string).
TRANSIENT_MARKERS = (
    "resource_exhausted", "resource exhausted", "deadline",
    "unavailable", "preempt", "transient", "data loss", "aborted",
    "connection reset", "socket closed", "too many open files",
    "cancelled", "injected", "out of memory",
)

#: substrings marking an accelerator error as *fatal* even though the
#: type says runtime: compile/shape problems that fail identically on
#: every retry.
FATAL_MARKERS = (
    "invalid_argument", "invalid argument", "unimplemented",
    "failed_precondition", "shape", "mosaic", "lowering", "dtype",
)

#: substrings marking a kernel build failure or a sticky CUDA error as
#: fatal whatever the type: ``_cuda.build``'s "CUDA build failed", nvcc's
#: own errors, and the device errors after which the CUDA context is
#: unusable (``_cuda.raise_on``'s "CUDA error N (...)" carries
#: ``cudaGetErrorString``'s text).
DEVICE_FATAL_MARKERS = (
    "cuda build failed", "nvcc", "illegal memory access",
    "misaligned address", "illegal instruction",
    "unspecified launch failure", "device-side assert",
)


def accelerator_error_type() -> type:
    """The torch type of an error raised by the device runtime
    (``torch.AcceleratorError``; plain ``RuntimeError`` on a torch
    without it)."""
    return getattr(torch, "AcceleratorError", RuntimeError)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (worth retrying) or ``"fatal"`` (re-raise now).

    Explicit transient types (:class:`TransientFault`,
    :class:`ValidationError`, :class:`DeadlineExceeded`, timeouts,
    connection errors, ``torch.OutOfMemoryError``) are transient.
    Python-level programming errors (TypeError/ValueError/KeyError/...)
    are fatal, and so is any error naming a kernel build failure or a
    sticky device error (:data:`DEVICE_FATAL_MARKERS`).  Accelerator
    errors are transient *unless* their message carries a
    compile/shape-family marker; generic RuntimeErrors are fatal unless
    their message carries a transient-family marker.
    """
    if isinstance(exc, (TransientFault, ValidationError, DeadlineExceeded,
                        TimeoutError, ConnectionError, BrokenPipeError,
                        torch.OutOfMemoryError)):
        return "transient"
    if isinstance(exc, (TypeError, ValueError, KeyError, IndexError,
                        AttributeError, NotImplementedError,
                        ZeroDivisionError, AssertionError)):
        return "fatal"
    msg = str(exc).lower()
    if any(m in msg for m in DEVICE_FATAL_MARKERS):
        return "fatal"
    if isinstance(exc, accelerator_error_type()):
        if any(m in msg for m in FATAL_MARKERS):
            return "fatal"
        return "transient"
    if isinstance(exc, (OSError, RuntimeError)):
        if any(m in msg for m in TRANSIENT_MARKERS):
            return "transient"
        return "fatal"
    return "fatal"


# ---------------------------------------------------------------------------
# backoff
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Backoff:
    """Jittered exponential backoff with a deterministic schedule.

    ``delay(attempt)`` for attempt 1, 2, ... is
    ``min(base * factor**(attempt-1), max_s)`` scaled by a uniform
    jitter in ``[1 - jitter, 1 + jitter]`` drawn from a seeded numpy
    generator -- two guards with the same seed sleep the same schedule
    (replay determinism), two with different seeds decorrelate."""

    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 5.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delay(self, attempt: int) -> float:
        raw = min(self.base_s * self.factor ** max(attempt - 1, 0),
                  self.max_s)
        if self.jitter <= 0:
            return raw
        lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
        return raw * float(self._rng.uniform(lo, hi))


# ---------------------------------------------------------------------------
# output trees
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree, path=()):
    """``(path, leaf)`` pairs of a nested tuple / list / dict, in the JAX
    package's flattening order (dict keys sorted); None is an empty
    subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_leaves_with_path(x, path + (i,))
    else:
        yield path, tree


def tree_map_with_path(fn: Callable, tree, path=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (the
    structure kept; paths as :func:`tree_leaves_with_path` gives them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, x, path + (i,))
               for i, x in enumerate(tree)]
        return type(tree)(out) if type(tree) in (list, tuple) else \
            type(tree)(*out)
    return fn(path, tree)


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf (structure kept)."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def path_name(path) -> str:
    """A leaf path as the JAX package names it: keys and indices joined
    by ``/``."""
    return "/".join(str(k) for k in path) or "<leaf>"


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def synchronize(out: Any) -> None:
    """Wait for the current stream of every CUDA device that holds a
    tensor of ``out`` (the counterpart of ``jax.block_until_ready``)."""
    devices = {leaf.device for _, leaf in tree_leaves_with_path(out)
               if isinstance(leaf, torch.Tensor)
               and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _all_finite(tensors: List[torch.Tensor]) -> bool:
    """Whether every value of ``tensors`` (non-empty, on one device) is
    finite: one fused max-|x| over each dtype's tensors (a NaN or an inf
    carries through it), then one stack and one reduction; a single
    bool reaches the host."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    norms = [n for ts in by_dtype.values()
             for n in torch._foreach_norm(ts, float("inf"))]
    return bool(torch.isfinite(torch.stack(norms)).all())


def validate_finite(out: Any, what: str = "output") -> None:
    """NaN/inf screen over every floating leaf of ``out``; raises
    :class:`ValidationError` naming the first offending leaf.  Each
    device reduces all its leaves in a few launches (see
    :func:`_all_finite`); the leaf is looked for, and its count taken,
    only on failure."""
    leaves = [(p, _as_tensor(x)) for p, x in tree_leaves_with_path(out)]
    leaves = [(p, t) for p, t in leaves
              if t.is_floating_point() and t.numel()]
    by_dev: Dict[torch.device, List[torch.Tensor]] = {}
    for _, t in leaves:
        by_dev.setdefault(t.device, []).append(t)
    if all(_all_finite(ts) for ts in by_dev.values()):
        return
    for path, t in leaves:
        fin = torch.isfinite(t)
        if not bool(fin.all()):
            bad = int(t.numel() - int(fin.sum()))
            raise ValidationError(
                f"{what}: {bad} non-finite values in leaf "
                f"{path_name(path)} (shape {tuple(t.shape)})")


def spot_check(reference: Any, what: str = "output",
               atol: float = 0.0) -> Callable[[Any], None]:
    """Validator factory: the guarded output must match ``reference``
    (bit-identical by default -- the repo invariant).  The serving
    layer uses this for its periodic substrate canary: recompute a small
    known-good launch and compare.  The comparison runs on the output's
    device (the reference is copied there once)."""
    ref_leaves = [_as_tensor(x) for _, x in tree_leaves_with_path(reference)]
    on_dev: Dict[torch.device, List[torch.Tensor]] = {}

    def check(out: Any) -> None:
        got = [_as_tensor(x) for _, x in tree_leaves_with_path(out)]
        if len(got) != len(ref_leaves):
            raise ValidationError(
                f"{what}: structure mismatch vs reference "
                f"({len(got)} leaves vs {len(ref_leaves)})")
        for i, (a, b0) in enumerate(zip(got, ref_leaves)):
            if a.shape != b0.shape:
                raise ValidationError(
                    f"{what}: leaf {i} shape {tuple(a.shape)} vs "
                    f"reference {tuple(b0.shape)}")
            refs = on_dev.setdefault(a.device, [None] * len(ref_leaves))
            if refs[i] is None:
                refs[i] = b0.to(a.device)
            b = refs[i]
            if a.dtype != b.dtype:
                dt = torch.promote_types(a.dtype, b.dtype)
                a, b = a.to(dt), b.to(dt)
            if atol > 0:
                ok = torch.allclose(a, b, rtol=1e-5, atol=atol,
                                    equal_nan=False)
            else:
                ok = torch.equal(a, b)
            if not ok:
                n_bad = int((a != b).sum())
                raise ValidationError(
                    f"{what}: leaf {i} differs from reference in "
                    f"{n_bad} elements")

    return check


# ---------------------------------------------------------------------------
# structured reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardEvent:
    """One observation in a guard's life: an attempt, a failure, a
    retry, a recovery, a degradation."""

    name: str                      # call-site name
    kind: str                      # ok | transient | fatal | retry |
    #                                deadline | validation | degrade
    attempt: int = 0
    error: str = ""
    elapsed_s: float = 0.0
    time: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __getitem__(self, field: str):
        """``event["kind"]``: fields read by name, as the servers' own
        dict events (admit, preempt, degrade, ...) in the same list."""
        return getattr(self, field)


@dataclasses.dataclass
class FailureReport:
    """Machine-readable terminal failure record: what failed, how it
    was classified, what was tried, and the full event trail."""

    name: str
    error: str
    error_type: str
    classification: str
    attempts: int
    events: List[GuardEvent] = dataclasses.field(default_factory=list)
    transitions: List[dict] = dataclasses.field(default_factory=list)
    time: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [e.to_json() if isinstance(e, GuardEvent) else e
                       for e in self.events]
        return d

    def write(self, path: str) -> str:
        """Atomically publish the report as JSON (tmp + rename)."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".report.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path


# ---------------------------------------------------------------------------
# the guarded call
# ---------------------------------------------------------------------------

class GuardedCall:
    """Wrap a step function with deadline, validation, and classified
    jittered retries.

    >>> g = GuardedCall(decode_fn, "decode", retries=2,
    ...                 validators=[validate_finite])
    >>> logits, cache = g(model, tok, cache, pos)

    Semantics per call:

    1. run ``fn``, then synchronise the CUDA streams of its output's
       tensors so asynchronous launch errors surface *here*, inside the
       guard;
    2. if a ``deadline_s`` is set and the call overran it, record a
       ``deadline`` event (and, with ``enforce_deadline``, treat it as
       a transient failure);
    3. run every validator over the output (raising
       :class:`ValidationError` counts as a transient failure);
    4. on a transient failure: sleep the backoff, call
       ``before_retry``, and re-execute -- up to ``retries`` times;
    5. on a fatal failure: raise :class:`GuardExhausted` immediately
       with the report;
    6. on exhaustion: raise :class:`GuardExhausted` with the report.

    A step that writes state in place (the decode caches) must be
    idempotent for a retry to be exact: the port's decode steps rewrite
    the same cache rows from the same inputs.

    The event log (``.events``) persists across calls; ``on_event``
    observes each event as it happens.
    """

    def __init__(self, fn: Callable, name: str = "call", *,
                 retries: int = 3, backoff: Optional[Backoff] = None,
                 deadline_s: Optional[float] = None,
                 enforce_deadline: bool = False,
                 validators: Sequence[Callable[[Any], None]] = (),
                 classify: Callable[[BaseException], str] = classify_error,
                 on_event: Optional[Callable[[GuardEvent], None]] = None,
                 before_retry: Optional[Callable[[], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.fn = fn
        self.name = name
        self.retries = int(retries)
        self.backoff = backoff or Backoff()
        self.deadline_s = deadline_s
        self.enforce_deadline = enforce_deadline
        self.validators = tuple(validators)
        self.classify = classify
        self.on_event = on_event
        self.before_retry = before_retry
        self.sleep = sleep
        self.events: List[GuardEvent] = []
        self.calls = 0
        self.recoveries = 0

    # -- internals ----------------------------------------------------------

    def _event(self, kind: str, attempt: int, error: str = "",
               elapsed: float = 0.0) -> GuardEvent:
        ev = GuardEvent(name=self.name, kind=kind, attempt=attempt,
                        error=error, elapsed_s=elapsed, time=time.time())
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)
        return ev

    def _report(self, exc: BaseException, classification: str,
                attempts: int) -> FailureReport:
        return FailureReport(
            name=self.name, error=str(exc),
            error_type=type(exc).__name__,
            classification=classification, attempts=attempts,
            events=list(self.events), time=time.time())

    # -- the call -----------------------------------------------------------

    def __call__(self, *args, **kwargs):
        self.calls += 1
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            try:
                out = self.fn(*args, **kwargs)
                synchronize(out)
                elapsed = time.perf_counter() - t0
                if self.deadline_s is not None and elapsed > self.deadline_s:
                    self._event("deadline", attempt,
                                f"{elapsed:.3f}s > {self.deadline_s:.3f}s",
                                elapsed)
                    if self.enforce_deadline:
                        raise DeadlineExceeded(
                            f"{self.name}: {elapsed:.3f}s exceeded the "
                            f"{self.deadline_s:.3f}s deadline")
                for v in self.validators:
                    v(out)
                self._event("ok", attempt, elapsed=elapsed)
                if attempt > 1:
                    self.recoveries += 1
                return out
            except Exception as e:  # noqa: BLE001 - triage point
                elapsed = time.perf_counter() - t0
                kind = self.classify(e)
                self._event("validation" if isinstance(e, ValidationError)
                            else kind, attempt, str(e), elapsed)
                if kind == "fatal":
                    raise GuardExhausted(
                        f"{self.name}: fatal ({type(e).__name__}): {e}",
                        self._report(e, "fatal", attempt)) from e
                if attempt > self.retries:
                    raise GuardExhausted(
                        f"{self.name}: retries exhausted after "
                        f"{attempt} attempts: {e}",
                        self._report(e, "exhausted", attempt)) from e
                delay = self.backoff.delay(attempt)
                self._event("retry", attempt, f"backoff {delay:.3f}s")
                self.sleep(delay)
                if self.before_retry is not None:
                    self.before_retry()


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

class DegradationLadder:
    """Ordered fallback configs, fastest/most-aggressive first.

    Each rung is an opaque dict the owner knows how to apply
    (``{"decode_kernel": "blockspace", ...}`` -> ... ->
    ``{"decode_kernel": "xla"}``).  ``step_down(reason)`` moves one
    rung and records the transition; it returns ``False`` at the
    bottom (nothing left to degrade to -- time for the failure
    report)."""

    def __init__(self, rungs: Sequence[Dict[str, Any]],
                 on_transition: Optional[Callable[[dict], None]] = None):
        if not rungs:
            raise ValueError("a ladder needs at least one rung")
        self.rungs = [dict(r) for r in rungs]
        self.level = 0
        self.transitions: List[dict] = []
        self.on_transition = on_transition

    def current(self) -> Dict[str, Any]:
        return dict(self.rungs[self.level])

    @property
    def degraded(self) -> bool:
        return self.level > 0

    def exhausted(self) -> bool:
        return self.level >= len(self.rungs) - 1

    def step_down(self, reason: str = "") -> bool:
        if self.exhausted():
            return False
        rec = {"from_level": self.level, "to_level": self.level + 1,
               "from": self.current(),
               "to": dict(self.rungs[self.level + 1]),
               "reason": reason, "time": time.time()}
        self.level += 1
        self.transitions.append(rec)
        if self.on_transition:
            self.on_transition(rec)
        return True


class ServerState(str, enum.Enum):
    """The serving state machine: HEALTHY serves at the top rung;
    DEGRADED serves on a lower rung after repeated failures; DRAINING
    stops accepting work, checkpoints decode state, and exits so a
    successor can restore and resume."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DRAINING = "draining"


# ---------------------------------------------------------------------------
# deterministic sampling keys
# ---------------------------------------------------------------------------

def coordinate_seed(*coords: int) -> int:
    """A 32-bit generator seed that is a pure function of integer
    coordinates (numpy ``SeedSequence`` over their low 32 bits)."""
    return int(np.random.SeedSequence(
        [int(c) & 0xFFFFFFFF for c in coords]).generate_state(1)[0])


def sample_key(base_key: int, pos: int, batch: int) -> List[int]:
    """Per-slot sampling seeds derived from ``(seed, slot, position)``
    -- a pure function of the coordinates, so a retried or replayed
    decode step reproduces the identical token stream (a stateful
    generator would advance on every retry).  ``base_key`` is the
    serving seed; slot ``s`` of the batch gets
    ``coordinate_seed(base_key, s, pos)``."""
    return [coordinate_seed(base_key, s, pos) for s in range(int(batch))]
