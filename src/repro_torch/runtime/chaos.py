"""Deterministic fault injection for the port's block-space runtime.

A :class:`FaultPlan` is a seeded, replayable schedule of faults keyed
by *call site* and *call index*: the same seed injects the same faults
at the same points of the same program.  Plans are the JAX package's:
the same constants, site names and JSON, and :meth:`FaultPlan.from_seed`
draws the same schedule for the same seed, so a plan's JSON loads in
either package.

:class:`ChaosInjector` realizes a plan at these layers:

Kernel layer (the ``"pallas"`` site, kept so plans stay portable;
rides the launch hook of :mod:`repro_torch.kernels._cuda`, around every
launch of the write, sum and CA entry points -- the hand-written kernel
on the card, its plain version on the CPU).  Each fault acts on the
launch's output after the launch, on the linear grid step ``step``
selects (:meth:`GridPlan.linear_step` order):

* ``corrupt_table`` -- that step's write never lands: its output tile is
  left as it was before the launch (a CA step's stale-buffer tile, the
  write's input tile); on the sum, that step's partial is zeroed before
  the combine;
* ``poison_tile``   -- that step's output tile (or the sum's partial)
  is overwritten with NaN / inf / a sign-flip ("bitflip": finite
  garbage that only a spot-check catches, not the NaN screen).

Collective layer (``drop_halo``, ``delay_halo``): every round of a
compact CA's halo exchange (:meth:`repro_torch.core.shard.HaloPlan.
exchange`, one point-to-point batch per round) passes through the
injector's exchange hook, which counts it at :data:`PPERMUTE_SITE`:

* ``drop_halo``  -- that round delivers zeros;
* ``delay_halo`` -- that round is applied twice (what arrived is sent
  through the same round again: ghost rows from two hops away).

Each rank runs its own injector on the same plan, so a fault fires on
every rank's round of the same index, and the ranks' rounds stay
matched.

Host layer (``wrap(site, fn)`` around prefill/decode steps):

* ``transient_error`` -- raise a transient fault (``mode="jax"`` keeps
  its name for portable plans and raises ``torch.AcceleratorError``, the
  device-runtime type the classifier calls transient);
* ``fatal_error``     -- raise a ValueError (mis-shaped/compile
  family: must NOT be retried);
* ``poison_result``   -- NaN out every float leaf of the step's output,
  as new tensors (the step's in-place state is left as it was);
* ``sigterm``         -- deliver SIGTERM to the process mid-step (a
  :class:`~repro_torch.distributed.fault_tolerance.PreemptionGuard`
  must be installed, as the servers do).

File layer (module functions): :func:`tear_checkpoint` truncates the
latest checkpoint and leaves a torn ``.tmp`` directory behind;
:func:`corrupt_tune_cache` plants a malformed winner entry under the
port's own tune-cache key.

Nothing is traced: every launch reads the live schedule, so
:meth:`ChaosInjector.refresh` (the guards' ``before_retry``) has nothing
to drop.

``python -m repro_torch.runtime.chaos --matrix [--smoke] [--device
cpu|cuda]`` runs the chaos matrix on the card by default: one scenario
per fault class, each asserting the fault is *detected* and then either
*recovered* (bit-identical to the fault-free run) or *reported*
(structured machine-readable failure report).  Exit status 1 on any
failed scenario.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import signal
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import shard
from repro_torch.kernels import _cuda

from .guard import (Backoff, GuardedCall, GuardExhausted, TransientFault,
                    accelerator_error_type, spot_check, tree_map,
                    validate_finite)

#: every fault class the harness can inject, by layer.
PALLAS_FAULTS = ("corrupt_table", "poison_tile")
COLLECTIVE_FAULTS = ("drop_halo", "delay_halo")
HOST_FAULTS = ("transient_error", "fatal_error", "poison_result",
               "sigterm")
FILE_FAULTS = ("torn_checkpoint", "corrupt_tune_cache")
ALL_FAULTS = PALLAS_FAULTS + COLLECTIVE_FAULTS + HOST_FAULTS + FILE_FAULTS

#: the reserved site names of the non-host layers (the JAX package's:
#: ``"pallas"`` counts the port's kernel launches).
PALLAS_SITE = "pallas"
PPERMUTE_SITE = "ppermute"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    kind:  one of :data:`ALL_FAULTS`.
    site:  call-site name -- :data:`PALLAS_SITE` (per kernel launch),
           :data:`PPERMUTE_SITE` (per halo round), or any
           host site a caller wraps (``"serve.decode"``, ...).
    index: 0-based call index at that site.
    mode:  kind-specific variant (poison: nan|inf|bitflip;
           transient_error: ""|jax).
    step:  linear grid step of the launch a kernel fault hits.
    rung:  when set, the fault only fires while the caller reports
           this degradation-ladder rung (persistent rung-0 failures
           that vanish after step-down).
    """

    kind: str
    site: str
    index: int
    mode: str = ""
    step: int = 0
    rung: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ALL_FAULTS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {ALL_FAULTS}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A replayable per-call-site fault schedule.

    Either list the faults explicitly or derive the whole schedule
    from one seed (:meth:`from_seed`); ``to_json``/``from_json`` make
    a plan portable into a bug report.
    """

    def __init__(self, seed: int, faults: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.faults = list(faults)

    @classmethod
    def from_seed(cls, seed: int, *, sites: Sequence[str],
                  kinds: Sequence[str] = ("transient_error",
                                          "poison_result"),
                  n_faults: int = 4, horizon: int = 16,
                  modes: Sequence[str] = ("", "jax")) -> "FaultPlan":
        """Derive a randomized-but-deterministic schedule: ``n_faults``
        faults drawn over ``sites x kinds x [0, horizon)`` from a numpy
        generator seeded with ``seed`` alone (the JAX package's draws,
        in its order)."""
        rng = np.random.default_rng(seed)
        seen, faults = set(), []
        for _ in range(n_faults * 4):
            if len(faults) >= n_faults:
                break
            site = sites[int(rng.integers(len(sites)))]
            kind = kinds[int(rng.integers(len(kinds)))]
            index = int(rng.integers(horizon))
            if (site, index) in seen:
                continue
            seen.add((site, index))
            mode = ""
            if kind == "transient_error":
                mode = modes[int(rng.integers(len(modes)))]
            elif kind == "poison_tile":
                mode = ("nan", "inf", "bitflip")[int(rng.integers(3))]
            faults.append(FaultSpec(kind=kind, site=site, index=index,
                                    mode=mode))
        return cls(seed, faults)

    def for_call(self, site: str, index: int,
                 rung: Optional[int] = None) -> List[FaultSpec]:
        out = []
        for f in self.faults:
            if f.site != site or f.index != index:
                continue
            if f.rung is not None and rung is not None and f.rung != rung:
                continue
            out.append(f)
        return out

    def sites(self) -> set:
        return {f.site for f in self.faults}

    @property
    def has_traced_faults(self) -> bool:
        """True when the plan injects kernel- or collective-layer faults
        (the JAX package bakes those into a trace; the port reads the
        schedule at every launch)."""
        return any(f.site in (PALLAS_SITE, PPERMUTE_SITE)
                   for f in self.faults)

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_json() for f in self.faults]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(d["seed"], [FaultSpec(**f) for f in d["faults"]])


# ---------------------------------------------------------------------------
# injection
# ---------------------------------------------------------------------------

def _poison_value(val: torch.Tensor, mode: str) -> torch.Tensor:
    if not val.is_floating_point():
        return -val - 1
    if mode == "inf":
        return torch.full_like(val, float("inf"))
    if mode == "bitflip":
        # finite garbage: survives the NaN screen, only a spot check
        # catches it
        return -val + torch.ones((), dtype=val.dtype, device=val.device)
    return torch.full_like(val, float("nan"))


def _step_tile(record, step: int, t: torch.Tensor) -> torch.Tensor:
    """The view of ``t`` that grid step ``step`` of the launch writes:
    its storage supertile (write, CA) or its partial (sum)."""
    if record.dst is None:
        return t[step:step + 1]
    plan = record.plan
    row, col = plan.storage_index(step, step + 1, "cpu")
    th, tw = plan.supertile_shape((record.block, record.block))
    r, c = int(row[0]) * th, int(col[0]) * tw
    return t[r:r + th, c:c + tw]


class ChaosInjector:
    """Realize a :class:`FaultPlan` against a live program.

    Use as a context manager around the workload: entry installs the
    launch hook (kernel-layer faults); exit restores the previous hook.
    Host-layer faults need no context -- ``wrap(site, fn)`` consults the
    plan on every call.

    Call counters live on the injector: a retried launch consumes the
    *next* index, so a fault scheduled at one index fires exactly once.
    ``events`` is the evidence trail (what fired, where, when).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counters: collections.Counter = collections.Counter()
        self.events: List[dict] = []
        self._prev_hook = None

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "ChaosInjector":
        self._prev_hook = _cuda.set_launch_hook(self.around_launch)
        self._prev_exchange = shard.set_exchange_hook(self.around_exchange)
        return self

    def __exit__(self, *exc):
        _cuda.set_launch_hook(self._prev_hook)
        shard.set_exchange_hook(self._prev_exchange)
        return False

    def refresh(self) -> None:
        """Nothing to drop: no launch is traced, each reads the live
        schedule.  Kept so guards can pass it as ``before_retry``, as
        with the JAX package's injector."""

    # -- bookkeeping ---------------------------------------------------------

    def _count(self, site: str) -> int:
        idx = self.counters[site]
        self.counters[site] += 1
        return idx

    def _event(self, fault: FaultSpec, site: str, index: int,
               note: str = "") -> None:
        self.events.append({"kind": fault.kind, "site": site,
                            "index": index, "mode": fault.mode,
                            "note": note, "time": time.time()})

    # -- launch hook (kernel layer) ------------------------------------------

    def around_launch(self, record, run: Callable):
        """The launch hook: run the launch, then apply this launch
        index's kernel faults to its output."""
        idx = self._count(PALLAS_SITE)
        faults = [f for f in self.plan.for_call(PALLAS_SITE, idx)
                  if f.kind in PALLAS_FAULTS]
        if not faults:
            return run()
        step = faults[0].step
        live = 0 <= step < record.plan.steps_per_launch
        for f in faults:
            self._event(f, PALLAS_SITE, idx, f"{record.kernel} step {step}")
        before = None
        if live and record.dst is not None and any(
                f.kind == "corrupt_table" for f in faults):
            before = _step_tile(record, step, record.dst).clone()
        out = run()
        if not live:
            return out
        for f in faults:
            tile = _step_tile(record, step, out)
            if f.kind == "corrupt_table":
                if before is None:
                    tile.zero_()
                else:
                    tile.copy_(before)
            else:
                tile.copy_(_poison_value(tile, f.mode))
        return out

    # -- exchange hook (collective layer) ------------------------------------

    def around_exchange(self, round_fn: Callable, payload: torch.Tensor):
        """The exchange hook: run one halo round (``round_fn(payload)``
        returns what arrived), then apply this round index's collective
        faults to what arrived."""
        idx = self._count(PPERMUTE_SITE)
        out = round_fn(payload)
        for f in self.plan.for_call(PPERMUTE_SITE, idx):
            if f.kind == "drop_halo":
                self._event(f, PPERMUTE_SITE, idx, "round dropped")
                out = torch.zeros_like(out)
            elif f.kind == "delay_halo":
                self._event(f, PPERMUTE_SITE, idx, "round delayed")
                out = round_fn(out)
        return out

    # -- host layer ----------------------------------------------------------

    def wrap(self, site: str, fn: Callable,
             rung: Optional[Callable[[], int]] = None) -> Callable:
        """Wrap a step function so scheduled host faults fire at their
        call index.  ``rung`` (a zero-arg callable) reports the current
        degradation-ladder level for rung-conditioned faults."""

        def call(*args, **kwargs):
            idx = self._count(site)
            r = rung() if rung is not None else None
            faults = self.plan.for_call(site, idx, rung=r)
            poison = None
            for f in faults:
                self._event(f, site, idx)
                if f.kind == "transient_error":
                    if f.mode == "jax":
                        raise _injected_device_error(site, idx)
                    raise TransientFault(
                        f"chaos: injected transient fault at "
                        f"{site}#{idx}")
                if f.kind == "fatal_error":
                    raise ValueError(
                        f"chaos: injected fatal (shape-family) error "
                        f"at {site}#{idx}")
                if f.kind == "sigterm":
                    os.kill(os.getpid(), signal.SIGTERM)
                if f.kind == "poison_result":
                    poison = f
            out = fn(*args, **kwargs)
            if poison is not None:
                out = tree_map(
                    lambda x: torch.full_like(x, float("nan"))
                    if isinstance(x, torch.Tensor) and x.is_floating_point()
                    else x, out)
            return out

        return call


def _injected_device_error(site: str, idx: int) -> Exception:
    """A real device-runtime error type (UNAVAILABLE family), so the
    guard's classifier is exercised against the genuine type."""
    return accelerator_error_type()(
        f"UNAVAILABLE: chaos: injected device loss at {site}#{idx}")


# ---------------------------------------------------------------------------
# file-layer faults
# ---------------------------------------------------------------------------

def tear_checkpoint(directory: str, step: Optional[int] = None,
                    mode: str = "truncate") -> str:
    """Simulate a preemption mid-save: truncate the (latest) step's
    ``params.npz`` mid-file (``mode="truncate"``) or delete its
    ``meta.json`` (``mode="meta"``), and leave a torn ``.tmp``
    directory behind -- the exact debris an interrupted
    :meth:`~repro_torch.checkpoint.manager.CheckpointManager.save`
    leaves.  Returns the path of the torn step directory."""
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    if step is not None:
        names = [n for n in names if int(n.split("_")[1]) == step]
    if not names:
        raise FileNotFoundError(f"no checkpoints to tear in {directory}")
    victim = os.path.join(directory, names[-1])
    npz = os.path.join(victim, "params.npz")
    if mode == "meta":
        os.unlink(os.path.join(victim, "meta.json"))
    else:
        size = os.path.getsize(npz)
        with open(npz, "rb") as f:
            head = f.read(max(1, size // 2))
        with open(npz, "wb") as f:
            f.write(head)
    # the half-written tmp dir of the save that never finished
    torn_tmp = victim + ".tmp"
    os.makedirs(torn_tmp, exist_ok=True)
    with open(os.path.join(torn_tmp, "params.npz"), "wb") as f:
        f.write(b"not a zipfile")
    return victim


def corrupt_tune_cache(path: str, kernel: str, params: dict,
                       device=None) -> str:
    """Plant a malformed winner entry under the exact lookup key the
    entry points' ``"auto"`` resolve uses for ``device`` (the card
    unless the caller names another): structurally valid JSON whose
    config is garbage (unknown lowering, non-integer fuse).  Returns
    the corrupted key."""
    from repro_torch.core.tune import TuneCache, _with_backend
    key = TuneCache.key(kernel, _with_backend(dict(params), device))
    data = {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        pass
    data[key] = {"config": {"lowering": "lambda-overflow",
                            "storage": "holographic",
                            "fuse": "many", "coarsen": -3},
                 "us": 0.0, "tuned_at": time.time()}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".chaos.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)
    return key


# ---------------------------------------------------------------------------
# the chaos matrix: one scenario per fault class
# ---------------------------------------------------------------------------

def _result(fault: str, status: str, **detail) -> dict:
    return {"fault": fault, "status": status, **detail}


def _no_backoff() -> Backoff:
    return Backoff(base_s=0.0, jitter=0.0)


def _write_scenario(fault: str, grid_mode: str, spec: FaultSpec,
                    validator, seed: int, smoke: bool, device) -> dict:
    """A guarded write with one kernel fault at launch 0: detected by
    ``validator``, recovered bit-identically on the retry."""
    from repro_torch.kernels.sierpinski_write import sierpinski_write
    n, block = (16, 4) if smoke else (32, 8)
    m = torch.zeros((n, n), dtype=torch.float32, device=device)

    def run():
        return sierpinski_write(m, 1.0, block=block, grid_mode=grid_mode,
                                coarsen=1, num_stages=1)

    clean = run()
    with ChaosInjector(FaultPlan(seed, [spec])) as chaos:
        guard = GuardedCall(
            run, "write", retries=2, backoff=_no_backoff(),
            validators=[validator(clean)], before_retry=chaos.refresh)
        out = guard()
    detected = any(e.kind == "validation" for e in guard.events)
    recovered = bool(torch.equal(out, clean))
    status = "recovered" if (detected and recovered and chaos.events) \
        else "failed"
    return _result(fault, status, detected=detected,
                   bit_identical=recovered, launches=chaos.counters[
                       PALLAS_SITE],
                   guard_events=[e.kind for e in guard.events])


def scenario_poison_tile(seed: int, smoke: bool, device="cuda") -> dict:
    """NaN-poisoned output tile -> NaN screen -> retry -> recover."""
    return _write_scenario(
        "poison_tile", "closed_form",
        FaultSpec("poison_tile", PALLAS_SITE, 0, mode="nan"),
        lambda clean: (lambda o: validate_finite(o, "write output")),
        seed, smoke, device)


def scenario_corrupt_table(seed: int, smoke: bool, device="cuda") -> dict:
    """Corrupt LUT row (a step's write never lands) -> spot check ->
    recover."""
    return _write_scenario(
        "corrupt_table", "prefetch_lut",
        FaultSpec("corrupt_table", PALLAS_SITE, 0, step=1),
        lambda clean: spot_check(clean, "lambda-plan spot check"),
        seed, smoke, device)


def _drop_halo_rank(rank: int, world: int, seed: int, device: str) -> dict:
    """One rank of :func:`scenario_drop_halo`: the sharded compact CA,
    clean, then guarded under a plan that drops halo round 0."""
    import importlib

    from repro_torch.core import fractal as F
    from repro_torch.core.compact import compact_layout
    from repro_torch.core.domain import make_fractal_domain
    from repro_torch.launch import mesh as mesh_lib
    ca = importlib.import_module("repro_torch.kernels.sierpinski_ca")
    n, block, steps = 32, 8, 4
    mesh = mesh_lib.make_mesh((world, 1), mesh_lib.AXES, device=device)
    dev = mesh_lib.mesh_device(mesh)
    lay = compact_layout(make_fractal_domain("sierpinski-gasket",
                                             n // block))
    rng = np.random.default_rng(0)
    emb = (rng.integers(0, 2, (n, n)) * F.membership_grid(n))
    state = lay.pack(torch.from_numpy(emb.astype(np.float32)).to(dev), block)
    buf = torch.zeros_like(state)

    def run():
        return ca.ca_run(state, buf, steps, fuse=2, rule="parity",
                         block=block, grid_mode="closed_form",
                         storage="compact", n=n, coarsen=1, num_stages=1,
                         mesh=mesh, shard_axis="data")

    clean = run()
    plan = FaultPlan(seed, [FaultSpec("drop_halo", PPERMUTE_SITE, 0)])
    with ChaosInjector(plan) as chaos:
        guard = GuardedCall(
            run, "ca_sharded", retries=2, backoff=_no_backoff(),
            validators=[spot_check(clean, "halo spot check")],
            before_retry=chaos.refresh)
        out = guard()
    return {"events": len(chaos.events),
            "detected": any(e.kind == "validation" for e in guard.events),
            "recovered": bool(torch.equal(out, clean)),
            "rounds": chaos.counters[PPERMUTE_SITE]}


def scenario_drop_halo(seed: int, smoke: bool, device="cuda") -> dict:
    """A dropped halo round of the sharded compact CA on a mesh of 2
    ranks this scenario spawns (gloo; on the card both ranks share it)
    -> spot check -> retry -> recover, bit-identical to the clean run on
    every rank."""
    from repro_torch.launch.mesh import run_ranks
    reps = run_ranks(_drop_halo_rank, 2, seed, torch.device(device).type)
    if not all(r["events"] for r in reps):
        return _result("drop_halo", "skipped",
                       reason="no halo round executed")
    detected = all(r["detected"] for r in reps)
    recovered = all(r["recovered"] for r in reps)
    status = "recovered" if (detected and recovered) else "failed"
    return _result("drop_halo", status, detected=detected,
                   bit_identical=recovered,
                   rounds=[r["rounds"] for r in reps])


def _quickstart(full_width: bool = False):
    from repro_torch.configs import get_config
    return get_config("quickstart", smoke=not full_width)


def _tiny_server(device, scfg=None, chaos=None, decode_kernel: str = "",
                 full_width: bool = False):
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.models import init
    cfg = _quickstart(full_width)
    if decode_kernel:
        cfg = cfg.replace(attn_decode_kernel=decode_kernel)
    model = init(cfg, torch.Generator(device=device).manual_seed(0), device)
    scfg = scfg or ServeConfig(max_len=24, temperature=0.7, seed=11,
                               retries=3, backoff_base_s=0.0)
    return cfg, model, Server(cfg, model, scfg, chaos=chaos)


def scenario_transient_runtime(seed: int, smoke: bool,
                               device="cuda") -> dict:
    """Injected device error mid-decode -> classified transient ->
    retried -> token stream bit-identical to the fault-free run."""
    from repro_torch.launch.serve import Server
    max_new = 4 if smoke else 6
    cfg, model, server = _tiny_server(device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8))
    ref = server.generate(prompts, max_new=max_new)

    plan = FaultPlan(seed, [
        FaultSpec("transient_error", "serve.decode", 1, mode="jax"),
        FaultSpec("transient_error", "serve.prefill", 0)])
    chaos = ChaosInjector(plan)
    faulty = Server(cfg, model, server.scfg, chaos=chaos)
    out = faulty.generate(prompts, max_new=max_new)
    detected = len(chaos.events) >= 2
    recovered = bool(np.array_equal(out, ref))
    status = "recovered" if (detected and recovered) else "failed"
    return _result("transient_error", status, detected=detected,
                   bit_identical=recovered,
                   injected=len(chaos.events))


def scenario_torn_checkpoint(seed: int, smoke: bool, device="cuda") -> dict:
    """Torn checkpoint dir -> restore falls back to the previous good
    step; an explicitly requested torn step raises (reported)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        p1 = {"w": torch.arange(8, dtype=torch.float32, device=device)}
        p2 = {"w": p1["w"] * 2}
        mgr.save(1, p1)
        mgr.save(2, p2)
        tear_checkpoint(d)
        template = {"w": torch.zeros(8, dtype=torch.float32, device=device)}
        step, params, _, meta = mgr.restore(None, template)
        fell_back = step == 1 and torch.equal(params["w"], p1["w"])
        skipped = meta.get("skipped_torn_steps") == [2]
        reported = False
        try:
            mgr.restore(2, template)
        except Exception:
            reported = True
        # a later save must clear the torn .tmp debris
        mgr.save(3, p2)
        debris = [n for n in os.listdir(d) if n.endswith(".tmp")]
    ok = fell_back and skipped and reported and not debris
    return _result("torn_checkpoint", "recovered" if ok else "failed",
                   fell_back=fell_back, skipped_recorded=skipped,
                   explicit_raises=reported, tmp_cleaned=not debris)


def scenario_corrupt_tune_cache(seed: int, smoke: bool,
                                device="cuda") -> dict:
    """Malformed tune-cache winner -> lookup rejects it, the kernel
    runs on defaults instead of crashing on garbage knobs."""
    from repro_torch.core import tune
    from repro_torch.kernels.sierpinski_ca import ca_run
    n, block = 16, 4
    params = {"fractal": "sierpinski-gasket", "n": n, "block": block,
              "rule": "parity"}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tune.json")
        old = os.environ.get(tune.CACHE_ENV)
        os.environ[tune.CACHE_ENV] = path
        try:
            corrupt_tune_cache(path, "ca", params, device)
            got = tune.best("ca", params,
                            default={"lowering": "closed_form"},
                            device=device)
            rejected = got == {"lowering": "closed_form"}
            state = torch.zeros((n, n), dtype=torch.float32, device=device)
            out = ca_run(state, torch.zeros_like(state), 1, fuse="auto",
                         block=block, grid_mode="auto", coarsen="auto",
                         num_stages=1, donate=False)
            ran = bool(torch.isfinite(out).all())
        finally:
            if old is None:
                os.environ.pop(tune.CACHE_ENV, None)
            else:
                os.environ[tune.CACHE_ENV] = old
    ok = rejected and ran
    return _result("corrupt_tune_cache",
                   "recovered" if ok else "failed",
                   entry_rejected=rejected, kernel_ran=ran)


def _sigterm_successor(rank, world, d, device_type, full_width):
    """One rank of the SIGTERM scenario's successor: elastic-restore the
    parameters onto the mesh of the ranks that are there and resume the
    drained generation on it; returns the rank's stream and the mesh's
    (data, model) shape."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.launch.mesh import axis_size, rank_device
    from repro_torch.launch.serve import Server
    from repro_torch.models import Model
    cfg = _quickstart(full_width)
    template = Model(cfg, rank_device(rank, device_type))
    mesh, _, model, _ = elastic_restore(
        CheckpointManager(os.path.join(d, "params"), keep=1), template, cfg,
        device=device_type)
    out = Server(cfg, model, _sigterm_scfg(d), mesh=mesh).resume()
    return {"tokens": out,
            "mesh": (axis_size(mesh, "data"), axis_size(mesh, "model"))}


def _sigterm_scfg(d):
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(max_len=24, temperature=0.7, seed=5, retries=3,
                       backoff_base_s=0.0, ckpt_dir=os.path.join(d, "decode"),
                       ckpt_every=1)


def scenario_sigterm_mid_decode(seed: int, smoke: bool, device="cuda",
                                full_width: bool = False) -> dict:
    """SIGTERM mid-decode -> drain + decode-state checkpoint -> a
    successor of 2 processes this scenario spawns (gloo; on the
    card they share it) elastic-restores the parameters onto the mesh of
    the ranks that are there and resumes to a stream bit-identical to
    the unfaulted run's on every rank.  quickstart's smoke config, or
    its full width with ``full_width``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import ServeConfig, Server
    max_new = 6 if smoke else 8
    with tempfile.TemporaryDirectory() as d:
        # fault-free reference run (no decode checkpointing: the torn
        # run below must resume from ITS OWN checkpoints)
        cfg, model, server = _tiny_server(
            device, ServeConfig(max_len=24, temperature=0.7, seed=5,
                                retries=3, backoff_base_s=0.0),
            full_width=full_width)
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 8))
        ref = server.generate(prompts, max_new=max_new)

        pmgr = CheckpointManager(os.path.join(d, "params"), keep=1)
        pmgr.save(0, model)

        plan = FaultPlan(seed, [FaultSpec("sigterm", "serve.decode", 2)])
        faulty = Server(cfg, model, _sigterm_scfg(d),
                        chaos=ChaosInjector(plan))
        partial = faulty.generate(prompts, max_new=max_new)
        drained = (faulty.state.value == "draining"
                   and partial.shape[1] < max_new)
        del model, server, faulty  # the successor's ranks share the card

        # "restart": the successor's ranks restore the parameters onto
        # their mesh and resume from the decode-state checkpoint
        reps = run_ranks(_sigterm_successor, 2, d,
                         torch.device(device).type, full_width)
        outs = [r["tokens"] for r in reps]
        recovered = all(bool(np.array_equal(o, ref)) for o in outs)
    status = "recovered" if (drained and recovered) else "failed"
    return _result("sigterm", status, drained=drained,
                   bit_identical=recovered,
                   resumed_tokens=int(outs[0].shape[1]),
                   mesh=list(reps[0]["mesh"]))


def scenario_fatal_report(seed: int, smoke: bool, device="cuda") -> dict:
    """A fatal (shape-family) error must NOT be retried: one attempt,
    classified fatal, structured report emitted."""

    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("chaos: injected fatal (shape mismatch)")

    guard = GuardedCall(bad, "train_step", retries=3,
                        backoff=_no_backoff())
    report = None
    try:
        guard()
    except GuardExhausted as e:
        report = e.report
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "failure_report.json")
        written = False
        if report is not None:
            report.write(path)
            with open(path) as f:
                written = json.load(f)["classification"] == "fatal"
    ok = (report is not None and report.classification == "fatal"
          and calls["n"] == 1 and written)
    return _result("fatal_error", "reported" if ok else "failed",
                   attempts=calls["n"],
                   classification=getattr(report, "classification", None))


def scenario_serve_randomized(seed: int, smoke: bool,
                              device="cuda") -> dict:
    """The serve smoke: randomized transient/poison injection across
    prefill+decode; generation must complete with zero corrupted
    outputs, bit-identical to the fault-free run."""
    from repro_torch.launch.serve import Server
    max_new = 6 if smoke else 10
    cfg, model, server = _tiny_server(device)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8))
    ref = server.generate(prompts, max_new=max_new)

    plan = FaultPlan.from_seed(
        seed, sites=("serve.decode", "serve.prefill"),
        kinds=("transient_error", "poison_result"),
        n_faults=3 if smoke else 4, horizon=max_new)
    chaos = ChaosInjector(plan)
    faulty = Server(cfg, model, server.scfg, chaos=chaos)
    out = faulty.generate(prompts, max_new=max_new)
    finite = bool(np.all(out >= 0))
    recovered = bool(np.array_equal(out, ref))
    status = "recovered" if (recovered and finite) else "failed"
    return _result("serve_randomized", status, bit_identical=recovered,
                   injected=len(chaos.events),
                   plan=plan.to_json())


MATRIX = (
    scenario_poison_tile,
    scenario_corrupt_table,
    scenario_drop_halo,
    scenario_transient_runtime,
    scenario_torn_checkpoint,
    scenario_corrupt_tune_cache,
    scenario_sigterm_mid_decode,
    scenario_fatal_report,
    scenario_serve_randomized,
)


def run_matrix(seed: int = 0, smoke: bool = False,
               only: Optional[Sequence[str]] = None,
               verbose: bool = True, device="cuda") -> List[dict]:
    results = []
    for fn in MATRIX:
        name = fn.__name__.replace("scenario_", "")
        if only and name not in only:
            continue
        try:
            r = fn(seed, smoke, device)
        except Exception as e:  # noqa: BLE001 - matrix must report
            r = _result(name, "failed", error=f"{type(e).__name__}: {e}")
        results.append(r)
        if verbose:
            extra = "" if r["status"] != "skipped" else \
                f" ({r.get('reason', '')})"
            print(f"  chaos {r['fault']}: {r['status']}{extra}")
    return results


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.chaos",
        description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", action="store_true",
                    help="run the full fault-injection matrix")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="serve smoke under randomized injection only")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced problem sizes (CI gate)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated scenario subset")
    ap.add_argument("--out", default=None,
                    help="write the JSON chaos report here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if not (args.matrix or args.serve_smoke):
        ap.error("nothing to do: pass --matrix or --serve-smoke")
    only = tuple(s for s in args.only.split(",") if s) or None
    if args.serve_smoke and not args.matrix:
        only = ("serve_randomized",)
    dev = backend_lib.default_device(args.device)

    t0 = time.perf_counter()
    results = run_matrix(seed=args.seed, smoke=args.smoke, only=only,
                         verbose=not args.quiet, device=dev)
    n_failed = sum(r["status"] == "failed" for r in results)
    n_skipped = sum(r["status"] == "skipped" for r in results)
    report = {
        "ok": n_failed == 0,
        "seed": args.seed,
        "backend": backend_lib.resolve(dev).name,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "num_scenarios": len(results),
        "num_failed": n_failed,
        "num_skipped": n_skipped,
        "seconds": time.perf_counter() - t0,
        "results": results,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print(f"chaos matrix: {len(results)} scenarios, "
          f"{n_failed} failed, {n_skipped} skipped "
          f"(backend {report['backend']}, {report['devices']} devices)")
    return 0 if n_failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
