"""Fault-tolerance runtime pieces that live outside the step function:

* ``Heartbeat``        -- per-step deadline watchdog (straggler/hang
                          detection): records the event and calls back so
                          the launcher can restart from the last
                          checkpoint.
* ``PreemptionGuard``  -- SIGTERM-aware flag: the serving loop checks it
                          every step and checkpoints its decode state
                          before exiting.
* ``retry_step``       -- re-execute a step function on transient device
                          errors (see
                          :func:`repro_torch.runtime.guard.classify_error`)
                          with seeded exponential backoff.

The serving layer uses ``PreemptionGuard``; the trainer
(:mod:`repro_torch.launch.train`) uses all three.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class Heartbeat:
    def __init__(self, deadline_s: float = 300.0,
                 on_straggle: Optional[Callable[[float], None]] = None):
        self.deadline_s = deadline_s
        self.on_straggle = on_straggle
        self.last = time.monotonic()
        self.straggle_events = 0

    def beat(self):
        now = time.monotonic()
        dt = now - self.last
        self.last = now
        if dt > self.deadline_s:
            self.straggle_events += 1
            if self.on_straggle:
                self.on_straggle(dt)
        return dt


class PreemptionGuard:
    """Install with ``with PreemptionGuard() as g: ... if g.fired: ...``"""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self.fired = False
        self._old = {}

    def _handler(self, signum, frame):
        self.fired = True

    def __enter__(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        return False


def retry_step(fn, *args, retries: int = 3, backoff_s: float = 1.0,
               on_retry: Optional[Callable[[int, Exception], None]] = None,
               jitter: float = 0.5, seed: int = 0,
               sleep: Callable[[float], None] = time.sleep):
    """Run ``fn(*args)``, retrying only errors classified *transient*
    (out of memory, device loss, preemption -- see
    :func:`repro_torch.runtime.guard.classify_error`) with
    seeded-jittered exponential backoff.  Fatal errors (shape, build,
    sticky device and programming errors) re-raise immediately:
    retrying those just fails slower.  Exhausted retries re-raise the
    last transient error."""
    from repro_torch.runtime.guard import Backoff, classify_error
    backoff = Backoff(base_s=backoff_s, jitter=jitter, seed=seed)
    attempt = 0
    while True:
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - triage point
            if classify_error(e) == "fatal":
                raise
            attempt += 1
            if attempt > retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            sleep(backoff.delay(attempt))


def accelerator_runtime_errors() -> type:
    """The torch type of device-runtime errors (the counterpart of the
    JAX package's ``jax_runtime_errors``)."""
    from repro_torch.runtime.guard import accelerator_error_type
    return accelerator_error_type()
