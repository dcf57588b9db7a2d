"""Persisted autotuner over the block-space scheduling axes.

Navarro et al. ("Efficient GPU Thread Mapping on Embedded 2D Fractals",
2020) show the best realization of the fractal map is configuration
dependent: which of the lowerings wins flips with problem size, block
geometry and hardware.  This module searches the axes the kernels
expose -- ``lowering x storage x fuse x coarsen x stages`` for the CA,
``lowering x storage x coarsen`` for write/sum, ``lowering x block`` for
flash attention, ``lowering x page_size`` for paged decode -- measures
each viable candidate on the device it runs on, and persists the winner
to a JSON cache keyed by ``(kernel, problem, backend, card)`` so a
process pays the search once per configuration, ever.

Two consumption paths, as in the JAX package:

* explicit: ``autotune_ca / autotune_write / autotune_flash /
  autotune_paged`` run the search and return ``(config, us, trials)``
  (``--autotune`` on the examples, ``python -m repro_torch.core.tune``);
* implicit: the kernel entry points accept ``"auto"`` for their
  scheduling knobs, which is a cache *lookup only* -- never a
  measurement -- falling back to the JAX package's untuned defaults when
  no entry exists; an explicit value is never overridden.

Keys carry the target the tensors' device picks: ``"backend": "cuda"``
with the card's name (``torch.cuda.get_device_name``), or ``"backend":
"cpu"`` for the plain versions.  A CPU winner never answers for the
card, nor one card's winner for another.  The searchers take
``device=None`` (the card); on the CPU they time the plain versions,
which is for the tests only.

The cache file defaults to ``~/.cache/repro-torch-tune.json`` and is
overridden by the ``REPRO_TORCH_TUNE_CACHE`` environment variable.  It is
the port's own: a winner measured by the JAX package (whose file and
variable differ) never answers the port, nor the reverse.  Writes merge
with the file under ``fcntl.flock`` and land atomically (tmp + rename).

``mesh=`` on :func:`autotune_ca`, :func:`autotune_write` and
:func:`autotune_paged` (the serving mesh's slot-sharded paged decode)
tunes the sharded run (every rank of the mesh calls the searcher): the
key names the shard count (:func:`shard_params`), the search
warm-starts from the single-device winner when one is cached (only it
and its one-knob neighbours are measured), and each trial's time is the
slowest rank's, so every rank keeps the same winner.

``verify=True`` on a searcher statically verifies each candidate's plan
after ``build`` and before it is timed (the plan the entry point would
launch, through the check its own ``verify=True`` runs,
:mod:`repro_torch.analysis`; nothing is launched for it): a failing
plan is rejected, never measured or persisted, as in the JAX package.

Run: ``python -m repro_torch.core.tune [--smoke] [--cache PATH] [--force]
[--device cpu]``.
"""
from __future__ import annotations

import importlib
import json
import os
import tempfile
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from . import backend as backend_lib

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"

#: measurement defaults: enough to get a stable median without making a
#: full search take minutes on the plain versions (the JAX package's)
MEASURE_WARMUP = 1
MEASURE_ITERS = 3


def default_cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-tune.json")


def _pos_int(v, hi: int = 1 << 20) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and 0 < v <= hi


def _sane_config(config: dict) -> bool:
    """A cached winner is only trusted if every knob the kernels act on
    carries a value the tuner could actually have produced -- an
    unknown lowering / storage or a non-positive-integer schedule
    factor marks the entry corrupt (tampered file, version skew, torn
    write) and the lookup treats it as a miss so the kernel runs on
    defaults.  Keys outside the known-knob set are left alone: callers
    may cache richer configs (and tests cache synthetic ones)."""
    if not config:
        return False
    from .plan import LOWERINGS
    checks = {
        "lowering": lambda v: v in LOWERINGS,
        "storage": lambda v: v in ("embedded", "compact"),
        "fuse": _pos_int,
        "coarsen": _pos_int,
        "stages": _pos_int,
        "num_stages": _pos_int,
        "block_q": _pos_int,
        "block_k": _pos_int,
        "page_size": _pos_int,
        "num_warps": lambda v: v is None or _pos_int(v, 64),
    }
    for k, v in config.items():
        check = checks.get(k)
        if check is not None and not check(v):
            return False
    return True


class TuneCache:
    """JSON-persisted map from tuning key to winning config.

    Entries are ``{"config": {...}, "us": float, "tuned_at": epoch}``
    keyed by the sorted-JSON of ``{"kernel": ..., **params}``.  The
    backend (and the card's name on the card) is always part of
    ``params``, enforced by :func:`autotune` / :func:`best` rather than
    trusted to callers.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data = None

    @staticmethod
    def key(kernel: str, params: dict) -> str:
        return json.dumps({"kernel": kernel, **params}, sort_keys=True)

    def _load(self) -> dict:
        if self._data is None:
            self._data = {}
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    self._data = data
            except (OSError, ValueError):
                pass  # missing or corrupt cache == empty cache
        return self._data

    def get(self, kernel: str, params: dict) -> Optional[dict]:
        entry = self._load().get(self.key(kernel, params))
        if not isinstance(entry, dict) or not isinstance(
                entry.get("config"), dict):
            return None
        config = dict(entry["config"])
        if not _sane_config(config):
            return None  # corrupt / tampered entry reads as a miss
        return config

    def put(self, kernel: str, params: dict, config: dict, us: float,
            save: bool = True) -> None:
        self._load()[self.key(kernel, params)] = {
            "config": dict(config), "us": round(float(us), 2),
            "tuned_at": time.time()}
        if save:
            self.save()

    def save(self) -> None:
        """Merge-on-save: under an exclusive lock, re-read the file and
        union it with the in-memory entries (ours win on conflict)
        before the atomic write, so concurrent tuning processes append
        to the cache instead of clobbering each other's entries.  A
        corrupt or partially-written file on disk merges as empty.  The
        flock closes the read-merge-write window; on platforms without
        fcntl the merge still narrows it to the dump itself."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        try:
            import fcntl
            lock = open(self.path + ".lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock = None
        try:
            ours = self._load()
            merged = {}
            try:
                with open(self.path) as f:
                    disk = json.load(f)
                if isinstance(disk, dict):
                    merged.update(disk)
            except (OSError, ValueError):
                pass
            merged.update(ours)
            self._data = merged
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tune.tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(merged, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        finally:
            if lock is not None:
                lock.close()

    def __len__(self) -> int:
        return len(self._load())


_DEFAULT: Optional[TuneCache] = None


def default_cache() -> TuneCache:
    """Process-wide cache bound to the current default path (re-made
    when REPRO_TORCH_TUNE_CACHE changes, so tests can redirect it)."""
    global _DEFAULT
    path = default_cache_path()
    if _DEFAULT is None or _DEFAULT.path != path:
        _DEFAULT = TuneCache(path)
    return _DEFAULT


def _device(device=None) -> torch.device:
    """The device a search or lookup is for: the caller's, else the card
    (without requiring one to be present: a key names it only)."""
    return torch.device("cuda" if device is None else device)


def _with_backend(params: dict, device=None) -> dict:
    """Stamp the target of ``device`` (the card unless the caller names
    another) into the key params: ``"backend": "cuda"`` and the card's
    name, or ``"backend": "cpu"``.  Params that already carry a backend
    are the caller's own key and pass unchanged."""
    p = dict(params)
    if "backend" in p:
        return p
    dev = _device(device)
    p["backend"] = backend_lib.resolve(dev).name
    if dev.type == "cuda":
        p["device"] = torch.cuda.get_device_name(dev)
    return p


def shard_params(params: dict, mesh, shard_axis: str) -> dict:
    """Qualify a tuning key with the shard count a kernel will actually
    run at (the size of the mesh's ``shard_axis``), so a single-device
    winner never answers for a sharded run and different shard counts
    never collide.  Unsharded lookups (``mesh=None``) keep the
    unqualified key, so existing caches remain valid."""
    if mesh is None:
        return params
    from repro_torch.launch.mesh import axis_size
    return {**params, "devices": axis_size(mesh, shard_axis)}


def mesh_agree(mesh, shard_axis: str) -> Optional[Callable[[float], float]]:
    """For a sharded search: the largest of the ranks' times of a trial
    (a maximum over the axis's process group), so that every rank ranks
    the trials alike and keeps the same winner -- a rank whose "auto"
    resolved another schedule than its peers would desert their
    collectives.  None for an unsharded search."""
    if mesh is None:
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group
    group = axis_group(mesh, shard_axis)

    def agree(us: float) -> float:
        t = torch.tensor([us], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t)
    return agree


def _search_device(device, mesh) -> torch.device:
    """Where a search runs: the caller's device, else this rank's device
    of ``mesh``, else the card."""
    if device is None and mesh is not None:
        from repro_torch.launch.mesh import mesh_device
        return mesh_device(mesh)
    return backend_lib.default_device(device)


def measure(fn: Callable, *args, warmup: int = MEASURE_WARMUP,
            iters: int = MEASURE_ITERS, device=None) -> float:
    """Median microseconds per call of ``fn(*args)`` on ``device`` (the
    card unless the caller names another): on the card each call is
    bracketed by CUDA events on the current stream after the warm-up
    (host time between its launches included); on the CPU by
    ``time.perf_counter``."""
    dev = _device(device)
    for _ in range(warmup):
        fn(*args)
    samples = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            stop.record(stream)
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(samples))


def _axis_distance(a: dict, b: dict) -> int:
    """How many knobs two configs disagree on (missing = default)."""
    return sum(1 for k in set(a) | set(b) if a.get(k) != b.get(k))


def autotune(kernel: str, params: dict, candidates: Iterable[dict],
             build: Callable[[dict], Callable], *,
             cache: Optional[TuneCache] = None, force: bool = False,
             warmup: int = MEASURE_WARMUP, iters: int = MEASURE_ITERS,
             verbose: bool = False, seed_config: Optional[dict] = None,
             device=None, agree: Optional[Callable[[float], float]] = None,
             verify: Optional[Callable[[dict], None]] = None):
    """Generic search: measure every viable candidate, persist the winner.

    ``build(config)`` returns a zero-arg measurable callable, or raises
    ValueError / NotImplementedError to declare the candidate inviable
    for this problem (e.g. fuse > supertile, coarsen on a non-fractal
    domain, tiles past the card's shared memory) -- inviable candidates
    are skipped, not errors.

    ``verify(config)``, when given, runs after ``build`` and before any
    measurement; raising the plan verifier's ``PlanVerificationError``
    rejects the candidate, so a plan that fails static analysis is never
    timed, let alone persisted as a winner (any other error propagates).
    Under ``agree`` a candidate any rank rejects is rejected on every
    rank.  The kernel-specific searchers wire it to
    :mod:`repro_torch.analysis` through their ``verify=True``.

    ``seed_config`` warm-starts the search from a related problem's
    winner: only the seed and its one-knob neighbours are measured, seed
    first, instead of the full cross product.

    ``device`` (the card unless the caller names another) is where the
    candidates run: it stamps the key and clocks the measurement.
    ``agree`` (a sharded search's) maps each trial's time to the time
    every rank keeps (:func:`mesh_agree`).

    Returns ``(config, us, trials)`` where trials is the full
    [(config, us)] measurement log; on a cache hit ``(config, None,
    [])``.
    """
    cache = cache if cache is not None else default_cache()
    params = _with_backend(params, device)
    if not force:
        hit = cache.get(kernel, params)
        if hit is not None:
            return hit, None, []
    candidates = list(candidates)
    if seed_config is not None:
        near = [c for c in candidates
                if _axis_distance(c, seed_config) <= 1]
        if near:
            near.sort(key=lambda c: _axis_distance(c, seed_config))
            if verbose:
                print(f"  warm-start from {seed_config}: measuring "
                      f"{len(near)} of {len(candidates)} candidates")
            candidates = near
    trials = []
    best_cfg, best_us = None, float("inf")
    for cfg in candidates:
        try:
            fn = build(cfg)
        except (ValueError, NotImplementedError) as e:
            if verbose:
                print(f"  skip {cfg}: {e}")
            continue
        if verify is not None:
            refused = _refusal(verify, cfg)
            if agree is not None and agree(float(refused is not None)) \
                    and refused is None:
                refused = "another rank's plan failed verification"
            if refused is not None:
                if verbose:
                    print(f"  reject {cfg}: plan verification failed: "
                          f"{refused}")
                continue
        us = measure(fn, warmup=warmup, iters=iters, device=device)
        if agree is not None:
            us = agree(us)
        trials.append((dict(cfg), us))
        if verbose:
            print(f"  {cfg} -> {us:.1f} us")
        if us < best_us:
            best_cfg, best_us = dict(cfg), us
    if best_cfg is None:
        raise ValueError(f"autotune({kernel}): no viable candidate "
                         f"for {params}")
    cache.put(kernel, params, best_cfg, best_us)
    return best_cfg, best_us, trials


def _refusal(verify: Callable[[dict], None], cfg: dict) -> Optional[str]:
    """``verify(cfg)``'s ``PlanVerificationError`` as a message, or None
    when the plan verifies."""
    from repro_torch.analysis.verifier import PlanVerificationError
    try:
        verify(cfg)
    except PlanVerificationError as e:
        return str(e)
    return None


def best(kernel: str, params: dict, default: Optional[dict] = None,
         cache: Optional[TuneCache] = None, device=None) -> Optional[dict]:
    """Cache lookup only (the ``"auto"`` path): the tuned config for
    this (kernel, params) on ``device``'s target, or ``default``."""
    cache = cache if cache is not None else default_cache()
    hit = cache.get(kernel, _with_backend(params, device))
    return hit if hit is not None else default


# ---------------------------------------------------------------------------
# Kernel-specific search spaces + searchers.  Each synthesizes its own
# operands from a seeded numpy generator (random state masked to the
# fractal / random qkv), so callers only describe the problem; the
# returned config is then passed to the real entry points.
# ---------------------------------------------------------------------------

#: the full (unrestricted) storage axis.  A search restricted to a
#: subset gets its own cache key (see :func:`_axis_param`): its winner
#: prescribes a storage, so it must never answer -- or overwrite -- the
#: unrestricted key the kernels' ``"auto"`` lookups use.
ALL_STORAGES = ("embedded", "compact")
ALL_FLASH_BLOCKS = (64, 128, 256)
#: the full page-size axis the paged-decode search sweeps.  Page size
#: trades pool fragmentation (small pages waste less tail) against
#: gather granularity (large pages mean fewer table rows per step).
ALL_PAGE_SIZES = (8, 16, 32, 64)
#: rows of the embedded CA state drawn per numpy call (bounds the host
#: memory of an n = 2**16 search)
_STATE_BAND_CELLS = 1 << 26


def _kernels(name: str):
    """The kernel module ``repro_torch.kernels.<name>`` (the package
    re-exports entry points of the same names)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _axis_param(params: dict, name: str, value, full) -> dict:
    """Stamp a candidate-axis restriction into the cache key params
    when (and only when) it deviates from the full default axis."""
    if tuple(sorted(map(str, value))) != tuple(sorted(map(str, full))):
        params[name] = "+".join(sorted(map(str, value)))
    return params


def _fuse_axis(block: int, coarsen: int, max_fuse: int) -> Sequence[int]:
    """Fuse depths to try: powers of two up to min(max_fuse, supertile
    side) -- the fused halo ring must fit inside one neighbour tile."""
    out, f = [], 1
    while f <= min(max_fuse, block * coarsen):
        out.append(f)
        f *= 2
    return out


def _coarsen_axis(fractal: str, n: int, block: int,
                  max_coarsen: int) -> Sequence[int]:
    from . import fractal as F
    m = 2 if fractal in ("sierpinski", "sierpinski-gasket") \
        else F.FRACTALS[fractal].m
    out, s = [], 1
    while s <= max_coarsen and (n // block) % s == 0 and s < n // block:
        out.append(s)
        s *= m
    return out or [1]


def ca_candidates(fractal: str, n: int, block: int, *,
                  storages=ALL_STORAGES, max_fuse: int = 8,
                  max_coarsen: int = 4, device=None):
    """lowering x storage x coarsen x fuse x stages.  The ring depth is
    an axis on the card, where the fused kernel has a ``cp.async`` ring
    (``csrc/sierpinski_ca.cu``); the plain version has none."""
    from .plan import LOWERINGS
    stages_axis = (1, 2) if _device(device).type == "cuda" else (1,)
    for storage in storages:
        for lowering in LOWERINGS:
            for coarsen in _coarsen_axis(fractal, n, block, max_coarsen):
                for fuse in _fuse_axis(block, coarsen, max_fuse):
                    for stages in stages_axis:
                        yield {"lowering": lowering, "storage": storage,
                               "fuse": fuse, "coarsen": coarsen,
                               "stages": stages}


def fractal_state(fractal: str, n: int, block: int, device,
                  seed: int = 0) -> torch.Tensor:
    """The (n, n) f32 embedded CA state of the searches: 0/1 cells from
    the bits of a seeded numpy generator's bytes, masked to the fractal,
    drawn and expanded on ``device`` in row bands so an n = 2**16 state
    never lives on the host whole."""
    dom = _kernels("sierpinski_write").resolve_fractal_domain(fractal, n,
                                                              block)
    rng = np.random.default_rng(seed)
    state = torch.empty((n, n), dtype=torch.float32, device=device)
    rows = max(1, _STATE_BAND_CELLS // n)
    x = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    for y0 in range(0, n, rows):
        y1 = min(n, y0 + rows)
        cells = (y1 - y0) * n
        raw = np.frombuffer(rng.bytes(-(-cells // 8)), np.uint8)
        bits = (torch.from_numpy(raw.copy()).to(device)[:, None]
                >> shifts) & 1
        bits = bits.reshape(-1)[:cells].reshape(y1 - y0, n)
        y = torch.arange(y0, y1, dtype=torch.int64, device=device)[:, None]
        state[y0:y1] = torch.where(dom.cell_member(x, y, n), bits, 0)
    return state


def autotune_ca(*, fractal: str = "sierpinski-gasket", n: int = 256,
                block: int = 16, rule: str = "parity", steps: int = 8,
                storages=ALL_STORAGES, max_fuse: int = 8,
                max_coarsen: int = 4, cache: Optional[TuneCache] = None,
                force: bool = False, verbose: bool = False, device=None,
                mesh=None, shard_axis: str = "data", verify: bool = False):
    """Search the CA scheduling axes for (fractal, n, block, rule) on
    ``device`` (the card unless the caller names another): every
    candidate runs :func:`~repro_torch.kernels.sierpinski_ca.ca_run` for
    ``steps`` steps, in place on the searcher's own two buffers (the
    n x n embedded pair, and their packed copies when the compact
    storage is searched)."""
    from .compact import compact_layout
    ca, sw = _kernels("sierpinski_ca"), _kernels("sierpinski_write")

    base = _axis_param(
        {"fractal": fractal, "n": n, "block": block, "rule": rule},
        "storages", storages, ALL_STORAGES)
    params = shard_params(base, mesh, shard_axis)
    dev = _search_device(device, mesh)
    # warm-start a sharded search from the single-device winner
    seed = best("ca", base, cache=cache, device=dev) \
        if mesh is not None else None
    state = fractal_state(fractal, n, block, dev)
    operands = {"embedded": (state, torch.zeros_like(state))}
    if "compact" in storages:
        lay = compact_layout(sw.resolve_fractal_domain(fractal, n, block))
        operands["compact"] = tuple(lay.pack(t, block)
                                    for t in operands["embedded"])
    if "embedded" not in storages:
        del operands["embedded"]
    del state

    def geometry(cfg):
        return dict(block=block, grid_mode=cfg["lowering"],
                    fractal=fractal, storage=cfg["storage"], n=n,
                    coarsen=cfg["coarsen"])

    def build(cfg):
        a, b = operands[cfg["storage"]]
        kw = dict(geometry(cfg), rule=rule, num_stages=cfg.get("stages", 1))
        ca.check_run(a, b, **kw)
        return lambda: ca.ca_run(a, b, steps, fuse=cfg["fuse"],
                                 donate=True, mesh=mesh,
                                 shard_axis=shard_axis, **kw)

    def check(cfg):
        """ca_run's ``verify=True`` without the run."""
        a, b = operands[cfg["storage"]]
        if mesh is None:
            plan = ca.check_run(a, b, rule=rule, **geometry(cfg),
                                num_stages=cfg.get("stages", 1))[0]
        else:
            plan = sw.mesh_plan(
                a, mesh, shard_axis, **geometry(cfg), domain=None,
                halo=cfg["storage"] == "compact")[0]
        sw.verify_launch(plan, "ca", a.device)

    cands = ca_candidates(fractal, n, block, storages=storages,
                          max_fuse=max_fuse, max_coarsen=max_coarsen,
                          device=dev)
    return autotune("ca", params, cands, build, cache=cache, force=force,
                    verbose=verbose, device=dev, seed_config=seed,
                    agree=mesh_agree(mesh, shard_axis),
                    verify=check if verify else None)


def write_candidates(fractal: str, n: int, block: int, *,
                     storages=ALL_STORAGES, max_coarsen: int = 4):
    from .plan import LOWERINGS
    for storage in storages:
        for lowering in LOWERINGS:
            for coarsen in _coarsen_axis(fractal, n, block, max_coarsen):
                yield {"lowering": lowering, "storage": storage,
                       "coarsen": coarsen}


def autotune_write(*, fractal: str = "sierpinski-gasket", n: int = 256,
                   block: int = 16, storages=ALL_STORAGES,
                   max_coarsen: int = 4,
                   cache: Optional[TuneCache] = None, force: bool = False,
                   verbose: bool = False, device=None, mesh=None,
                   shard_axis: str = "data", verify: bool = False):
    """Search lowering x storage x coarsen for the write microbenchmark:
    the in-place :func:`~repro_torch.kernels.sierpinski_write.
    sierpinski_write_` of a zero state (the form the paper times), on
    ``device`` (the card unless the caller names another).  The winner
    also answers :func:`sierpinski_sum`'s ``"auto"`` lookups, as in the
    JAX package."""
    from .compact import compact_layout
    sw = _kernels("sierpinski_write")

    base = _axis_param({"fractal": fractal, "n": n, "block": block},
                       "storages", storages, ALL_STORAGES)
    params = shard_params(base, mesh, shard_axis)
    dev = _search_device(device, mesh)
    seed = best("write", base, cache=cache, device=dev) \
        if mesh is not None else None
    lay = compact_layout(sw.resolve_fractal_domain(fractal, n, block))
    shapes = {"embedded": lay.embedded_shape(block),
              "compact": lay.array_shape(block)}
    operands = {s: torch.zeros(shapes[s], dtype=torch.float32, device=dev)
                for s in storages}

    def geometry(cfg):
        return dict(block=block, grid_mode=cfg["lowering"], fractal=fractal,
                    storage=cfg["storage"], n=n, coarsen=cfg["coarsen"])

    def build(cfg):
        m = operands[cfg["storage"]]
        kw = geometry(cfg)
        plan, _, blk = sw.prepare_launch(m, **kw)
        if plan.target.kernels:
            plan.launch_params(n, blk, m.device)
        return lambda: sw.sierpinski_write_(
            m, 1.0, num_stages=1, mesh=mesh, shard_axis=shard_axis, **kw)

    def check(cfg):
        """sierpinski_write_'s ``verify=True`` without the write."""
        m = operands[cfg["storage"]]
        plan = sw.prepare_launch(m, **geometry(cfg))[0] if mesh is None \
            else sw.mesh_plan(m, mesh, shard_axis, **geometry(cfg),
                              domain=None)[0]
        sw.verify_launch(plan, "write", m.device)

    cands = write_candidates(fractal, n, block, storages=storages,
                             max_coarsen=max_coarsen)
    return autotune("write", params, cands, build, cache=cache,
                    force=force, verbose=verbose, device=dev,
                    seed_config=seed, agree=mesh_agree(mesh, shard_axis),
                    verify=check if verify else None)


def flash_candidates(sq: int, sk: int, *, blocks=ALL_FLASH_BLOCKS):
    """lowering x block geometry.  The port's tile kernels fix their
    warps and ring depth per instantiation (``csrc/flash_attention.cu``),
    so the JAX package's gpu axes num_warps / num_stages are not
    searched."""
    from .plan import LOWERINGS
    for lowering in LOWERINGS:
        for b in blocks:
            if b <= min(sq, sk) and sq % b == 0 and sk % b == 0:
                yield {"lowering": lowering, "block_q": b, "block_k": b}


def autotune_flash(*, kind: str = "causal", batch: int = 1, heads: int = 4,
                   kv_heads: Optional[int] = None, sq: int = 1024,
                   sk: Optional[int] = None, d: int = 64, window: int = 0,
                   blocks=ALL_FLASH_BLOCKS, dtype=torch.float32,
                   cache: Optional[TuneCache] = None, force: bool = False,
                   verbose: bool = False, device=None, verify: bool = False):
    """Search lowering x block geometry for flash attention on ``device``
    (the card unless the caller names another), on seeded normal q/k/v
    of ``dtype``.  A block whose tiles the kernels refuse (shared memory
    past the card's limit) is inviable: ``build`` runs the launch's
    checks."""
    fa = _kernels("flash_attention")
    sk = sq if sk is None else sk
    kv_heads = heads if kv_heads is None else kv_heads
    params = _axis_param(
        {"kind": kind, "batch": batch, "heads": heads,
         "kv_heads": kv_heads, "sq": sq, "sk": sk, "d": d,
         "window": window},
        "blocks", blocks, ALL_FLASH_BLOCKS)
    dev = backend_lib.default_device(device)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
               for shape in ((batch, heads, sq, d),
                             (batch, kv_heads, sk, d),
                             (batch, kv_heads, sk, d)))

    def schedule(cfg):
        return dict(kind=kind, window=window, block_q=cfg["block_q"],
                    block_k=cfg["block_k"], grid_mode=cfg["lowering"])

    def build(cfg):
        kw = schedule(cfg)
        fa.check_launch(fa.flash_schedule(q.shape, k.shape, **kw),
                        q.dtype, dev)
        return lambda: fa.flash_attention(q, k, v, **kw)

    def check(cfg):
        """flash_attention's ``verify=True`` without the launch."""
        fa.verify_schedule(fa.flash_schedule(q.shape, k.shape,
                                             **schedule(cfg)), dev)

    return autotune("flash", params,
                    flash_candidates(sq, sk, blocks=blocks), build,
                    cache=cache, force=force, verbose=verbose, device=dev,
                    verify=check if verify else None)


def paged_candidates(seq: int, *, page_sizes=ALL_PAGE_SIZES):
    """lowering x page_size for the paged decode kernel.  Page sizes
    larger than the sequence are inviable (a one-page pool degenerates
    to the contiguous layout and is covered by the flash search)."""
    from .plan import LOWERINGS
    for lowering in LOWERINGS:
        for ps in page_sizes:
            if ps <= seq:
                yield {"lowering": lowering, "page_size": ps}


def paged_operands(k, v, page_size: int):
    """A page pool holding the contiguous caches ``k``/``v`` (B, Hkv,
    seq, d) at ``page_size`` and its page table: slot b owns pages
    ``1 + b * npages ...`` (``batch * ceil(seq / ps) + 1`` pages with the
    null page), as a serving process at that page size holds them."""
    from . import paged as paged_lib
    batch, kv_heads, seq, d = k.shape
    npages = paged_lib.pages_for(seq, page_size)
    pool = paged_lib.init_pool(batch * npages + 1, kv_heads, page_size, d,
                               dtype=k.dtype, device=k.device)
    table = 1 + torch.arange(batch * npages, dtype=torch.int32,
                             device=k.device).reshape(batch, npages)
    for b_ in range(batch):
        paged_lib.write_prefill_pages(pool, table[b_], k[b_], v[b_])
    return pool, table


def autotune_paged(*, batch: int = 4, heads: int = 4,
                   kv_heads: Optional[int] = None, seq: int = 256,
                   d: int = 64, window: int = 0,
                   page_sizes=ALL_PAGE_SIZES, dtype=torch.float32,
                   cache: Optional[TuneCache] = None, force: bool = False,
                   verbose: bool = False, device=None, mesh=None,
                   shard_axis: str = "data", verify: bool = False):
    """Search lowering x page_size for the paged decode kernel on
    ``device`` (the card unless the caller names another).

    Every candidate decodes the *same* logical caches (seeded normal
    K/V of ``seq`` tokens, every slot at position ``seq``): they are
    scattered into a pool at each candidate's page size
    (:func:`paged_operands`), so the measurement isolates the layout
    axis.  The winner's page size is the caller's to apply: the paged
    entry point takes a pool, not a page size.

    ``mesh=`` tunes the slot-sharded decode of the serving mesh
    (:func:`repro_torch.models.attention.decode_attention_paged` with
    ``mesh=``: each rank decodes its ``batch / D`` slots against the
    whole pool, the groups gathered) under the key qualified by the
    shard count, warm-started from the D = 1 winner."""
    fa = _kernels("flash_attention")
    kv_heads = heads if kv_heads is None else kv_heads
    base = _axis_param(
        {"batch": batch, "heads": heads, "kv_heads": kv_heads,
         "seq": seq, "d": d, "window": window},
        "page_sizes", page_sizes, ALL_PAGE_SIZES)
    params = shard_params(base, mesh, shard_axis)
    dev = _search_device(device, mesh)
    seed = best("paged", base, cache=cache, device=dev) \
        if mesh is not None else None
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
               for shape in ((batch, heads, 1, d),
                             (batch, kv_heads, seq, d),
                             (batch, kv_heads, seq, d)))
    pos = torch.full((batch,), seq, dtype=torch.int32, device=dev)
    pools = {ps: paged_operands(k, v, ps)
             for ps in page_sizes if ps <= seq}

    def build(cfg):
        pool, table = pools[cfg["page_size"]]
        fa.check_launch(fa.paged_schedule(q.shape, pool.shape, table.shape,
                                          window=window), q.dtype, dev)
        if mesh is None:
            return lambda: fa.paged_flash_attention(
                q, pool, table, pos, window=window,
                grid_mode=cfg["lowering"])
        from repro_torch.models.attention import decode_attention_paged
        return lambda: decode_attention_paged(
            q, pool, table, pos, window=window, grid_mode=cfg["lowering"],
            mesh=mesh, shard_axis=shard_axis)

    def check(cfg):
        """The paged decode's ``verify=True`` without the launch: the
        plan of this rank's slot group under ``mesh``."""
        from repro_torch.models.attention import slot_group
        pool, table = pools[cfg["page_size"]]
        group = slot_group(batch, mesh, shard_axis, q, pool) \
            if mesh is not None else None
        sl = slice(None) if group is None else group[0]
        fa.verify_paged(q[sl], pool, table[sl], window=window,
                        grid_mode=cfg["lowering"])

    return autotune("paged", params,
                    paged_candidates(seq, page_sizes=page_sizes), build,
                    cache=cache, force=force, verbose=verbose, device=dev,
                    seed_config=seed, agree=mesh_agree(mesh, shard_axis),
                    verify=check if verify else None)


# ---------------------------------------------------------------------------
# CLI: the four searches; --smoke is a tiny search that exercises the
# measure -> persist -> reload path in seconds.
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny search space")
    ap.add_argument("--cache", default=None, help="cache file path")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even on a cache hit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' times "
                         "the plain versions)")
    args = ap.parse_args(argv)
    dev = backend_lib.default_device(args.device)
    cache = TuneCache(args.cache) if args.cache else default_cache()
    if args.smoke:
        n, block, max_fuse, max_coarsen, blocks = 32, 8, 2, 2, (32,)
        sq, pseq, psizes = 64, 32, (8, 16)
    else:
        n, block, max_fuse, max_coarsen, blocks = 256, 16, 8, 4, (64, 128)
        sq, pseq, psizes = 512, 256, (16, 32, 64)
    common = dict(cache=cache, force=args.force, verbose=True, device=dev)
    for name, fn in (
        ("ca", lambda: autotune_ca(n=n, block=block, max_fuse=max_fuse,
                                   max_coarsen=max_coarsen, **common)),
        ("write", lambda: autotune_write(n=n, block=block,
                                         max_coarsen=max_coarsen,
                                         **common)),
        ("flash", lambda: autotune_flash(sq=sq, d=32, blocks=blocks,
                                         **common)),
        ("paged", lambda: autotune_paged(batch=2, heads=2, seq=pseq,
                                         d=32, page_sizes=psizes,
                                         **common)),
    ):
        cfg, us, trials = fn()
        tag = f"{us:.1f} us, {len(trials)} trials" if us is not None \
            else "cache hit"
        print(f"{name}: best={cfg} ({tag})")
    # reload through a fresh cache object to prove the persistence path
    fresh = TuneCache(cache.path)
    print(f"cache {cache.path}: {len(fresh)} entries")


if __name__ == "__main__":
    main()
