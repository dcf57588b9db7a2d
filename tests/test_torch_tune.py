"""The port's tuner (``repro_torch.core.tune``) against the JAX package's.

The cache, the generic search and the four searchers are the
reference's (``tests/test_sched.py``, ``test_runtime.py``,
``test_paged.py`` cases, at n <= 32 with one or two candidates per
axis); the ``"auto"`` lookups of the port's entry points give the
reference's results for the same cached winner (tpu-interpret ``repro``,
bit-equal where the packages are bit-equal, flash attention within the
f32 tolerance).  Every test redirects both packages' cache files under
``tmp_path``; the tests that check the cache fake ``measure``.
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractal as JF
from repro.core import tune as JT
from repro.core.domain import TriangularDomain as JTri
from repro.kernels import ops as JO
from repro_torch.core import tune as TT
from repro_torch.core.domain import TriangularDomain as TTri
from repro_torch.core.plan import LOWERINGS
from repro_torch.kernels import ops as TO
from repro_torch.kernels import sierpinski_ca as TCA
from torch_parity import (assert_attn_close, fractal_state,
                          isolate_tune_caches, pair, qkv_pair)

TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
ROOT = Path(__file__).resolve().parents[1]
GASKET = "sierpinski-gasket"


@pytest.fixture(autouse=True)
def _caches(monkeypatch, tmp_path):
    return isolate_tune_caches(monkeypatch, tmp_path)


def _seq_ca(a, b, steps, **kw):
    """``steps`` sequential one-step runs: what every fused schedule must
    equal bit for bit."""
    for _ in range(steps):
        a, b = TO.ca_run(a, b, 1, fuse=1, **kw), a
    return a


# ---------------------------------------------------------------------------
# the cache (tests/test_sched.py, tests/test_runtime.py)
# ---------------------------------------------------------------------------

def test_tune_cache_roundtrip(tmp_path):
    path = str(tmp_path / "tune.json")
    c = TT.TuneCache(path)
    params = {"n": 64, "backend": "cpu"}
    assert c.get("ca", params) is None
    c.put("ca", params, {"lowering": "prefetch_lut", "fuse": 4}, 123.4)
    assert c.get("ca", params) == {"lowering": "prefetch_lut", "fuse": 4}
    # a fresh object must read the persisted file
    fresh = TT.TuneCache(path)
    assert fresh.get("ca", params) == {"lowering": "prefetch_lut",
                                       "fuse": 4}
    assert len(fresh) == 1


def test_tune_cache_respects_backend_keys(tmp_path):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    c.put("ca", {"n": 64, "backend": "cuda", "device": "NVIDIA H100"},
          {"lowering": "bounding"}, 1.0)
    c.put("ca", {"n": 64, "backend": "cpu"}, {"lowering": "closed_form"},
          2.0)
    assert c.get("ca", {"n": 64, "backend": "cuda",
                        "device": "NVIDIA H100"}) == {"lowering": "bounding"}
    # best() stamps the device's target into unqualified params
    assert TT.best("ca", {"n": 64}, cache=c, device="cpu") == \
        {"lowering": "closed_form"}
    assert TT.best("ca", {"n": 9999}, {"lowering": "x"}, cache=c,
                   device="cpu") == {"lowering": "x"}


def test_cuda_entries_never_answer_another_target(tmp_path, monkeypatch):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    params = {"fractal": GASKET, "n": 16, "block": 4}
    for name, lowering in (("NVIDIA H100 80GB HBM3", "mma"),
                           ("NVIDIA A100-SXM4-80GB", "bounding")):
        c.put("write", {**params, "backend": "cuda", "device": name},
              {"lowering": lowering, "coarsen": 2}, 1.0)
    # neither card's winner answers the CPU ...
    assert TT.best("write", params, cache=c, device="cpu") is None
    assert TW.resolve_auto_schedule(
        "write", params, device="cpu",
        grid_mode=("auto", "lowering", "closed_form"),
        coarsen=("auto", "coarsen", 1)) == ("closed_form", 1)
    # ... and each card reads only its own name (no card is needed to
    # form the key)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert TT._with_backend(params, "cuda") == {
        **params, "backend": "cuda", "device": "NVIDIA H100 80GB HBM3"}
    assert TT.best("write", params, cache=c, device="cuda") == \
        {"lowering": "mma", "coarsen": 2}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA L4")
    assert TT.best("write", params, cache=c, device="cuda") is None
    # and a CPU winner never answers the card
    c.put("ca", {"n": 16, "backend": "cpu"}, {"fuse": 4}, 1.0)
    assert TT.best("ca", {"n": 16}, cache=c, device="cuda") is None


def test_tune_cache_tolerates_corrupt_file(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    c = TT.TuneCache(str(path))
    assert c.get("ca", {"n": 1, "backend": "cpu"}) is None
    c.put("ca", {"n": 1, "backend": "cpu"}, {"fuse": 2}, 1.0)
    assert TT.TuneCache(str(path)).get(
        "ca", {"n": 1, "backend": "cpu"}) == {"fuse": 2}


def test_tune_cache_rejects_corrupt_entry(_caches):
    # tests/test_runtime.py's chaos case: a structurally valid entry
    # with garbage knobs, planted under the exact lookup key, reads as a
    # miss and the kernels run on defaults
    path = _caches[1]
    params = {"fractal": GASKET, "n": 16, "block": 4, "rule": "parity"}
    key = TT.TuneCache.key("ca", TT._with_backend(params, "cpu"))
    Path(path).write_text(json.dumps({key: {
        "config": {"lowering": "lambda-overflow", "storage": "holographic",
                   "fuse": "many", "coarsen": -3},
        "us": 0.0, "tuned_at": 0.0}}))
    assert TT.best("ca", params, default={"lowering": "closed_form"},
                   device="cpu") == {"lowering": "closed_form"}
    x = torch.from_numpy(fractal_state(GASKET, 16, True, seed=2))
    assert torch.equal(
        TO.ca_run(x, torch.zeros_like(x), 3, block=4, grid_mode="auto",
                  coarsen="auto"),
        TO.ca_run(x, torch.zeros_like(x), 3, block=4, fuse=1))
    # a sane entry still round-trips
    cache = TT.TuneCache(path)
    cache.put("ca", TT._with_backend(params, "cpu"),
              {"lowering": "prefetch_lut", "fuse": 2, "coarsen": 1}, 9.0)
    assert TT.best("ca", params, cache=cache, device="cpu")["fuse"] == 2


def test_save_merges_concurrent_writers(tmp_path):
    path = str(tmp_path / "tune.json")
    # two objects loaded before either wrote: the second save keeps the
    # first's entry (merge under the lock, ours win on conflict)
    a, b = TT.TuneCache(path), TT.TuneCache(path)
    a.get("ca", {"n": 0, "backend": "cpu"})
    b.get("ca", {"n": 0, "backend": "cpu"})
    a.put("ca", {"n": 1, "backend": "cpu"}, {"fuse": 1}, 1.0)
    b.put("write", {"n": 2, "backend": "cpu"}, {"coarsen": 2}, 2.0)
    fresh = TT.TuneCache(path)
    assert len(fresh) == 2
    assert fresh.get("ca", {"n": 1, "backend": "cpu"}) == {"fuse": 1}
    assert fresh.get("write", {"n": 2, "backend": "cpu"}) == {"coarsen": 2}
    # and two processes writing at once
    code = ("import sys; from repro_torch.core import tune; "
            "n = int(sys.argv[2]); tune.TuneCache(sys.argv[1]).put("
            "'paged', {'n': n, 'backend': 'cpu'}, {'fuse': n}, n)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, path, str(n)],
                              env=env) for n in (3, 4)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    fresh = TT.TuneCache(path)
    assert len(fresh) == 4
    assert fresh.get("paged", {"n": 4, "backend": "cpu"}) == {"fuse": 4}
    assert not list(tmp_path.glob("*.tune.tmp"))


# ---------------------------------------------------------------------------
# the generic search
# ---------------------------------------------------------------------------

def test_autotune_picks_min_and_caches(tmp_path, monkeypatch):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    fake_us = {"a": 30.0, "b": 10.0, "c": 20.0}
    monkeypatch.setattr(TT, "measure", lambda fn, *a, **k: fake_us[fn()])

    def build(cfg):
        if cfg["name"] == "inviable":
            raise ValueError("cannot build")
        return lambda: cfg["name"]

    cands = [{"name": k} for k in ("a", "inviable", "b", "c")]
    cfg, us, trials = TT.autotune("k", {"n": 1}, cands, build, cache=c,
                                  device="cpu")
    assert cfg == {"name": "b"} and us == 10.0 and len(trials) == 3
    assert TT.best("k", {"n": 1}, cache=c, device="cpu") == cfg
    # second call is a pure cache hit: no measurement
    monkeypatch.setattr(TT, "measure",
                        lambda *a, **k: pytest.fail("measured on hit"))
    cfg2, us2, trials2 = TT.autotune("k", {"n": 1}, cands, build, cache=c,
                                     device="cpu")
    assert cfg2 == {"name": "b"} and us2 is None and trials2 == []


def test_autotune_no_viable_candidate_raises(tmp_path):
    c = TT.TuneCache(str(tmp_path / "tune.json"))

    def build(cfg):
        raise NotImplementedError("nope")
    with pytest.raises(ValueError, match="no viable candidate"):
        TT.autotune("k", {"n": 2}, [{"a": 1}], build, cache=c, device="cpu")


def test_autotune_seed_config_measures_one_knob_neighbours(tmp_path,
                                                           monkeypatch):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    seen = []
    monkeypatch.setattr(TT, "measure",
                        lambda fn, *a, **k: seen.append(fn()) or 1.0)
    cands = [{"x": x, "y": y} for x in (1, 2, 3) for y in (1, 2, 3)]
    TT.autotune("k", {"n": 3}, cands, lambda cfg: lambda: dict(cfg),
                cache=c, seed_config={"x": 2, "y": 2}, device="cpu")
    assert seen[0] == {"x": 2, "y": 2}
    assert sorted(map(str, seen)) == sorted(map(str, [
        {"x": 2, "y": 2}, {"x": 1, "y": 2}, {"x": 3, "y": 2},
        {"x": 2, "y": 1}, {"x": 2, "y": 3}]))


def test_measure_times_on_the_cpu():
    calls = []
    us = TT.measure(lambda: calls.append(1), device="cpu")
    assert us >= 0 and len(calls) == TT.MEASURE_WARMUP + TT.MEASURE_ITERS


SEARCHES = {
    "ca": lambda **k: TT.autotune_ca(n=16, block=8, steps=2, max_fuse=2,
                                     max_coarsen=2, **k),
    "write": lambda **k: TT.autotune_write(n=16, block=4, max_coarsen=2,
                                           **k),
    "flash": lambda **k: TT.autotune_flash(sq=64, d=8, heads=2,
                                           blocks=(16, 32), **k),
    "paged": lambda **k: TT.autotune_paged(batch=2, heads=2, seq=32, d=8,
                                           page_sizes=(8, 16), **k)}


def test_searchers_name_the_unported_options(tmp_path):
    """``verify=True`` on each searcher: every candidate's plan verifies,
    so the candidate set is the one searched without it."""
    for name, search in SEARCHES.items():
        runs = [search(verify=v, force=True, device="cpu",
                       cache=TT.TuneCache(str(tmp_path / f"{name}{v}.json")))
                for v in (False, True)]
        assert [t for t, _ in runs[1][2]] == [t for t, _ in runs[0][2]], name
    # an object that is not a mesh: the reference's own error (its
    # searchers read mesh.shape through shard_params); the paged searcher
    # tunes the serving mesh's slot-sharded decode with a mesh
    # (tests/test_torch_serve_mesh.py)
    for fn in (TT.autotune_ca, TT.autotune_write, TT.autotune_paged):
        with pytest.raises(AttributeError):
            fn(mesh=object(), device="cpu")
    assert TT.shard_params({"n": 1}, None, "data") == {"n": 1}


def test_autotune_rejects_failing_candidates(tmp_path):
    # tests/test_analysis.py's case
    from repro_torch.analysis import PlanVerificationError
    measured = []

    def build(cfg):
        return lambda: measured.append(cfg["x"])

    def vfy(cfg):
        if cfg["x"] == "bad":
            raise PlanVerificationError("seeded verification failure")

    cfg, us, trials = TT.autotune(
        "_test", {"p": 1}, [{"x": "bad"}, {"x": "good"}], build,
        cache=TT.TuneCache(str(tmp_path / "t.json")), verify=vfy,
        device="cpu")
    assert cfg == {"x": "good"}
    assert all(t[0] == {"x": "good"} for t in trials)
    assert "bad" not in measured              # rejected before measuring


def test_autotune_all_rejected_raises(tmp_path):
    from repro_torch.analysis import PlanVerificationError

    def vfy(cfg):
        raise PlanVerificationError("seeded")

    with pytest.raises(ValueError, match="no viable candidate"):
        TT.autotune("_test", {"p": 1}, [{"x": 1}],
                    lambda cfg: (lambda: None),
                    cache=TT.TuneCache(str(tmp_path / "t.json")),
                    verify=vfy, device="cpu")


def test_autotune_verify_lets_other_errors_through(tmp_path):
    """Only a plan that fails verification is rejected: any other error
    of the ``verify`` callback surfaces."""
    def vfy(cfg):
        raise ValueError("not a verification failure")

    with pytest.raises(ValueError, match="not a verification failure"):
        TT.autotune("_test", {"p": 1}, [{"x": 1}],
                    lambda cfg: (lambda: None),
                    cache=TT.TuneCache(str(tmp_path / "t.json")),
                    verify=vfy, device="cpu")


@pytest.mark.parametrize("name", ["ca", "write"])
def test_searchers_verify_without_launching(name, tmp_path):
    """``verify=True`` checks a candidate's plan without launching it:
    a search makes the launches of ``verify=False``, no more."""
    from repro_torch.kernels import _cuda
    counts = []
    for v in (False, True):
        launches = []

        def hook(record, run):
            launches.append(record.kernel)
            return run()
        prev = _cuda.set_launch_hook(hook)
        try:
            SEARCHES[name](verify=v, force=True, device="cpu",
                           cache=TT.TuneCache(str(tmp_path / f"{v}.json")))
        finally:
            _cuda.set_launch_hook(prev)
        counts.append(len(launches))
    assert counts[0] > 0 and counts[1] == counts[0]


@pytest.mark.parametrize("name", ["ca", "write", "flash", "paged"])
def test_searchers_reject_a_plan_that_fails_verification(name, tmp_path,
                                                         monkeypatch):
    """A plan the verifier fails -- every mma plan, here -- is rejected by
    ``verify=True`` and never measured; without it the same candidates
    are timed."""
    from repro_torch.analysis import verifier as TV
    real = TV.verify_plan

    def fail_mma(plan, **kw):
        report = real(plan, **kw)
        if plan.lowering == "mma":
            report.findings.append(TV.Finding("table", "seeded"))
        return report
    monkeypatch.setattr(TV, "verify_plan", fail_mma)
    cache = TT.TuneCache(str(tmp_path / "t.json"))
    _, _, trials = SEARCHES[name](verify=True, cache=cache, device="cpu")
    assert trials and all(t["lowering"] != "mma" for t, _ in trials)
    _, _, every = SEARCHES[name](verify=False, cache=cache, force=True,
                                 device="cpu")
    assert any(t["lowering"] == "mma" for t, _ in every)


def test_tune_keys_qualified_by_shard_count(monkeypatch, tmp_path):
    """tests/test_shard.py:408's: a sharded run consults the
    shard-count-qualified key (the mesh axis size), unsharded runs keep
    the unqualified key, so single-device winners never answer for
    sharded runs and different shard counts never collide -- the same
    keys as the reference's shard_params."""
    import types

    isolate_tune_caches(monkeypatch, tmp_path)
    base = {"fractal": "sierpinski-gasket", "n": 32, "block": 8,
            "rule": "parity"}
    mesh2 = types.SimpleNamespace(shape={"data": 2})
    mesh4 = types.SimpleNamespace(shape={"data": 4})
    assert TT.shard_params(base, None, "data") == base
    for mesh in (mesh2, mesh4):
        assert TT.shard_params(base, mesh, "data") == \
            JT.shard_params(base, mesh, "data")
    assert TT.shard_params(base, mesh2, "data")["devices"] == 2
    cache = TT.default_cache()
    cache.put("ca", TT._with_backend(dict(base), "cpu"),
              {"lowering": "bounding", "fuse": 1, "coarsen": 1}, 1.0,
              save=False)
    cache.put("ca", TT._with_backend({**base, "devices": 2}, "cpu"),
              {"lowering": "prefetch_lut", "fuse": 4, "coarsen": 1}, 1.0,
              save=False)
    ca = importlib.import_module("repro_torch.kernels.sierpinski_ca")
    assert ca.auto_schedule(n=32, block=8, device="cpu")[0] == "bounding"
    assert ca.auto_schedule(n=32, block=8, mesh=mesh2, device="cpu") == \
        ("prefetch_lut", 4, 1, 1)
    # an untuned shard count: the defaults
    assert ca.auto_schedule(n=32, block=8, mesh=mesh4, device="cpu") == \
        ("closed_form", 1, 1, 1)


# ---------------------------------------------------------------------------
# the searchers on the CPU (the plain versions, under the cpu key)
# ---------------------------------------------------------------------------

def test_restricted_search_gets_its_own_cache_key(tmp_path):
    # an embedded-only search must not answer (or be answered by) the
    # unrestricted key that the "auto" lookups use, nor a search
    # restricted to the other storage
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    kw = dict(n=16, block=8, steps=2, max_fuse=1, max_coarsen=1, cache=c,
              device="cpu")
    cfg_e, us_e, tr_e = TT.autotune_ca(storages=("embedded",), **kw)
    assert us_e is not None
    assert all(t["storage"] == "embedded" for t, _ in tr_e)
    cfg_c, us_c, tr_c = TT.autotune_ca(storages=("compact",), **kw)
    assert us_c is not None  # measured, not a cross-restriction hit
    assert all(t["storage"] == "compact" for t, _ in tr_c)
    key = {"fractal": GASKET, "n": 16, "block": 8, "rule": "parity"}
    assert TT.best("ca", key, cache=c, device="cpu") is None
    # the full-axis search owns the unrestricted key
    cfg, us, _ = TT.autotune_ca(storages=TT.ALL_STORAGES, **kw)
    assert us is not None
    assert TT.best("ca", key, cache=c, device="cpu") == cfg


def test_autotune_ca_end_to_end(tmp_path):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    cfg, us, trials = TT.autotune_ca(n=16, block=8, steps=2,
                                     storages=("embedded",), max_fuse=2,
                                     max_coarsen=1, cache=c, device="cpu")
    assert cfg["lowering"] in LOWERINGS
    assert cfg["fuse"] in (1, 2) and cfg["coarsen"] == 1
    # every lowering x 2 fuse depths; the plain version has no ring, so
    # the CPU searches one depth
    assert cfg["stages"] == 1
    assert us > 0 and len(trials) == len(LOWERINGS) * 2
    assert us == min(t for _, t in trials)
    # and the kernels can consume the result directly
    x = torch.from_numpy(fractal_state(GASKET, 16, True, seed=4))
    out = TO.ca_run(x, torch.zeros_like(x), 3, block=8,
                    grid_mode=cfg["lowering"], fuse=cfg["fuse"],
                    coarsen=cfg["coarsen"], num_stages=cfg["stages"])
    assert torch.equal(out, _seq_ca(x, torch.zeros_like(x), 3, block=8))


def test_ca_candidates_search_the_ring_on_the_card_only():
    cpu = list(TT.ca_candidates(GASKET, 64, 8, device="cpu"))
    card = list(TT.ca_candidates(GASKET, 64, 8, device="cuda"))
    assert {c["stages"] for c in cpu} == {1}
    assert {c["stages"] for c in card} == {1, 2}
    assert len(card) == 2 * len(cpu)
    # lowerings in LOWERINGS' own order (no mma hoist)
    assert list(dict.fromkeys(c["lowering"] for c in card)) == \
        list(LOWERINGS)


def test_autotune_write_and_the_sum_lookup(tmp_path):
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    cfg, us, trials = TT.autotune_write(n=16, block=4, max_coarsen=2,
                                        cache=c, device="cpu")
    assert len(trials) == len(LOWERINGS) * 2 * 2
    assert us == min(t for _, t in trials)
    assert cfg == TT.best("write", {"fractal": GASKET, "n": 16, "block": 4},
                          cache=c, device="cpu")


def test_autotune_write_counts_refused_candidates_as_inviable(
        tmp_path, monkeypatch):
    # a candidate the kernels refuse raises in build, never in measure
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    real = TW.prepare_launch

    def refuse_mma(m, **kw):
        if kw["grid_mode"] == "mma":
            raise ValueError("refused")
        return real(m, **kw)
    monkeypatch.setattr(TW, "prepare_launch", refuse_mma)
    _, _, trials = TT.autotune_write(n=16, block=4, max_coarsen=1,
                                     storages=("embedded",), cache=c,
                                     device="cpu")
    assert [t["lowering"] for t, _ in trials] == \
        [lo for lo in LOWERINGS if lo != "mma"]


def test_autotune_flash_skips_what_the_launch_refuses(tmp_path,
                                                      monkeypatch):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    measured = []
    real_measure = TT.measure

    def spy(fn, *a, **k):
        measured.append(fn)
        return real_measure(fn, *a, **k)

    def refuse(sched, dtype, device):
        if sched.block_q == 32:
            raise ValueError("shared memory")
    monkeypatch.setattr(TT, "measure", spy)
    monkeypatch.setattr(fa, "check_launch", refuse)
    cfg, us, trials = TT.autotune_flash(sq=64, d=8, heads=2, blocks=(16, 32),
                                        cache=c, device="cpu")
    assert {t["block_q"] for t, _ in trials} == {16}
    assert len(trials) == len(measured) == len(LOWERINGS)
    assert cfg["block_q"] == cfg["block_k"] == 16
    assert list(TT.flash_candidates(64, 64, blocks=(16, 48, 128))) == [
        {"lowering": lo, "block_q": 16, "block_k": 16} for lo in LOWERINGS]


def test_autotune_paged_page_size_knob(_caches):
    # tests/test_paged.py's case
    cfg, us, trials = TT.autotune_paged(batch=2, heads=2, seq=32, d=8,
                                        page_sizes=(8, 16), device="cpu")
    assert cfg["page_size"] in (8, 16) and "lowering" in cfg
    assert len(trials) == 2 * len(LOWERINGS)
    # the winner persists and answers the lookup-only path
    params = {"batch": 2, "heads": 2, "kv_heads": 2, "seq": 32, "d": 8,
              "window": 0, "page_sizes": "16+8"}
    assert TT.best("paged", params, device="cpu") == cfg
    # a corrupt page_size marks the entry as a cache miss
    cache = TT.TuneCache(_caches[1])
    cache.put("paged", TT._with_backend(params, "cpu"),
              {**cfg, "page_size": 0}, 1.0)
    assert TT.TuneCache(_caches[1]).get(
        "paged", TT._with_backend(params, "cpu")) is None


def test_paged_operands_decode_like_the_contiguous_caches():
    # the pool each page-size candidate decodes holds the same caches: at
    # block_k == page_size paged decode equals the contiguous one
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 4, 1, 8), (2, 2, 24, 8), (2, 2, 24, 8)))
    pos = torch.tensor([23, 17], dtype=torch.int32)
    for ps in (8, 16):
        pool, table = TT.paged_operands(k, v, ps)
        assert tuple(table.shape) == (2, -(-24 // ps))
        got = TO.paged_flash_attention(q, pool, table, pos)
        kp = torch.nn.functional.pad(k, (0, 0, 0, table.shape[1] * ps - 24))
        vp = torch.nn.functional.pad(v, (0, 0, 0, table.shape[1] * ps - 24))
        want = TO.flash_attention(q, kp, vp, kind="full", block_q=1,
                                  block_k=ps, seq_pos=pos)
        assert torch.equal(got, want)


def test_cli_smoke_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    TT.main(["--smoke", "--device", "cpu", "--cache", path])
    out = capsys.readouterr().out
    for name in ("ca", "write", "flash", "paged"):
        assert f"{name}: best=" in out
    assert f"cache {path}: 4 entries" in out
    # the second run is all cache hits
    TT.main(["--smoke", "--device", "cpu", "--cache", path])
    assert capsys.readouterr().out.count("(cache hit)") == 4


def test_example_autotunes_on_the_cpu(_caches, capsys):
    path = ROOT / "examples" / "torch_ca_simulation.py"
    spec = importlib.util.spec_from_file_location("torch_ca_simulation",
                                                  path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ex.main(["--device", "cpu", "--n", "16", "--block", "4", "--steps",
             "3", "--autotune"])
    out = capsys.readouterr().out
    assert "autotuned: {" in out and "measured" in out
    assert "invariant OK" in out
    # the storage-restricted key only: "auto" lookups stay on defaults
    assert len(TT.TuneCache(_caches[1])) == 1
    assert "num_stages=1" in out


# ---------------------------------------------------------------------------
# "auto" at the entry points
# ---------------------------------------------------------------------------

def test_grid_mode_auto_resolves_from_cache():
    n, block = 16, 4
    x = torch.from_numpy(fractal_state(GASKET, n, True, seed=6))
    b = torch.zeros_like(x)
    want = TO.ca_step(x, b, block=block)
    # untuned: auto falls back to the closed_form default
    assert torch.equal(TO.ca_step(x, b, block=block, grid_mode="auto"), want)
    # tuned: auto adopts the cached lowering/fuse/coarsen
    TT.default_cache().put(
        "ca", TT._with_backend({"fractal": GASKET, "n": n, "block": block,
                                "rule": "parity"}, "cpu"),
        {"lowering": "prefetch_lut", "storage": "embedded", "fuse": 2,
         "coarsen": 2, "stages": 3}, 1.0)
    assert TCA.auto_schedule(n=n, block=block, device="cpu") == \
        ("prefetch_lut", 2, 2, 3)
    seq = _seq_ca(x, b, 4, block=block)
    got = TO.ca_run(x, b, 4, fuse="auto", grid_mode="auto", coarsen="auto",
                    block=block)
    assert torch.equal(got, seq)
    # explicit values are never overridden by the cache
    assert TCA.auto_schedule(n=n, block=block, grid_mode="bounding", fuse=1,
                             coarsen=1, num_stages=2, device="cpu") == \
        ("bounding", 1, 1, 2)
    got = TO.ca_run(x, b, 4, fuse=1, grid_mode="bounding", coarsen=1,
                    block=block)
    assert torch.equal(got, seq)
    # another rule is another key: the defaults
    assert TCA.auto_schedule(n=n, block=block, rule="diffusion",
                             device="cpu") == ("closed_form", 1, 1, 1)


def test_tuned_depth_is_clamped_like_any_other():
    TT.default_cache().put(
        "ca", TT._with_backend({"fractal": GASKET, "n": 16, "block": 4,
                                "rule": "parity"}, "cpu"),
        {"stages": 9}, 1.0)
    assert TCA.check_run(torch.zeros(16, 16), torch.zeros(16, 16), block=4,
                         num_stages=TCA.auto_schedule(
                             n=16, block=4, device="cpu")[3])[3] == \
        TCA.MAX_STAGES


def test_write_and_sum_auto_never_apply_a_cached_storage():
    n, block = 16, 4
    TT.default_cache().put(
        "write", TT._with_backend({"fractal": GASKET, "n": n,
                                   "block": block}, "cpu"),
        {"lowering": "bounding", "storage": "compact", "coarsen": 2}, 1.0)
    m = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    # the embedded state stays embedded; lowering and coarsen are adopted
    got = TO.sierpinski_write(m, 3.0, block=block, grid_mode="auto",
                              coarsen="auto")
    assert torch.equal(got, TO.sierpinski_write(
        m, 3.0, block=block, grid_mode="bounding", coarsen=2))
    assert torch.equal(
        TO.sierpinski_sum(m, block=block, grid_mode="auto", coarsen="auto"),
        TO.sierpinski_sum(m, block=block, grid_mode="bounding", coarsen=2))
    # an explicit coarsen is kept
    assert torch.equal(
        TO.sierpinski_sum(m, block=block, grid_mode="auto", coarsen=1),
        TO.sierpinski_sum(m, block=block, grid_mode="bounding", coarsen=1))
    # a miss (another block) gives the defaults
    assert torch.equal(
        TO.sierpinski_sum(m, block=8, grid_mode="auto", coarsen="auto"),
        TO.sierpinski_sum(m, block=8))


def _put_both(kernel, params, cfg):
    """The same winner in both packages' caches, each under its own key
    (the reference's tpu-interpret target, the port's cpu target)."""
    JT.default_cache().put(kernel, JT._with_backend(JT.target_params(
        dict(params), "tpu-interpret")), cfg, 1.0)
    TT.default_cache().put(kernel, TT._with_backend(params, "cpu"), cfg, 1.0)


@pytest.mark.parametrize("storage", ["embedded", "compact"])
def test_auto_parity_with_the_reference(storage):
    n, block = 16, 4
    x = fractal_state(GASKET, n, True, seed=8)
    ja, ta = pair(x, GASKET, n, block, storage)
    # each package's cache is its own: the reference's winner does not
    # answer the port, nor the reverse
    JT.default_cache().put("ca", JT._with_backend(JT.target_params(
        {"fractal": GASKET, "n": n, "block": block, "rule": "parity"},
        "tpu-interpret")), {"lowering": "bounding", "fuse": 2}, 1.0)
    assert TCA.auto_schedule(n=n, block=block, device="cpu") == \
        ("closed_form", 1, 1, 1)
    _put_both("ca", {"fractal": GASKET, "n": n, "block": block,
                     "rule": "parity"},
              {"lowering": "prefetch_lut", "storage": storage, "fuse": 2,
               "coarsen": 2, "stages": 2})
    _put_both("write", {"fractal": GASKET, "n": n, "block": block},
              {"lowering": "mma", "storage": storage, "coarsen": 2})
    auto = dict(block=block, storage=storage, n=n, grid_mode="auto",
                coarsen="auto", num_stages="auto")
    want = JO.ca_run(ja, jnp.zeros_like(ja), 5, fuse="auto",
                     backend="tpu-interpret", **auto)
    got = TO.ca_run(ta, torch.zeros_like(ta), 5, fuse="auto", **auto)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, TO.ca_run(
        ta, torch.zeros_like(ta), 5, fuse=2, block=block, storage=storage,
        n=n, grid_mode="prefetch_lut", coarsen=2, num_stages=2))
    want = JO.ca_step(ja, jnp.zeros_like(ja), backend="tpu-interpret",
                      **auto)
    got = TO.ca_step(ta, torch.zeros_like(ta), **auto)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = JO.sierpinski_write(ja, 2.0, backend="tpu-interpret", **auto)
    got = TO.sierpinski_write(ta, 2.0, **auto)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = JO.sierpinski_sum(ja, backend="tpu-interpret", **auto)
    got = TO.sierpinski_sum(ta, **auto)
    assert float(got) == float(want)


def test_flash_auto_adopts_the_cached_blocks():
    b, h, hkv, s, d = 1, 2, 1, 64, 16
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(b, h, hkv, s, s, d, seed=12)
    _put_both("flash", {"kind": "causal", "batch": b, "heads": h,
                        "kv_heads": hkv, "sq": s, "sk": s, "d": d,
                        "window": 0},
              {"lowering": "prefetch_lut", "block_q": 16, "block_k": 16})
    auto = dict(grid_mode="auto", block_q="auto", block_k="auto",
                num_warps="auto", num_stages="auto")
    got = TO.flash_attention(tq, tk, tv, **auto)
    assert torch.equal(got, TO.flash_attention(
        tq, tk, tv, grid_mode="prefetch_lut", block_q=16, block_k=16))
    assert not torch.equal(got, TO.flash_attention(tq, tk, tv))
    assert_attn_close(got, JO.flash_attention(jq, jk, jv,
                                              backend="tpu-interpret", **auto))
    # explicit blocks are never overridden; num_warps / num_stages are
    # taken and change nothing, as on the reference's TPU structure
    assert torch.equal(
        TO.flash_attention(tq, tk, tv, grid_mode="auto", block_q=32,
                           block_k=32, num_warps=4, num_stages=3),
        TO.flash_attention(tq, tk, tv, grid_mode="prefetch_lut",
                           block_q=32, block_k=32))
    # another key (another kind) is a miss: the defaults
    assert torch.equal(TO.flash_attention(tq, tk, tv, kind="full", **auto),
                       TO.flash_attention(tq, tk, tv, kind="full"))


def test_paged_entry_takes_the_knobs_as_the_reference_does():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 2, 1, 8), (2, 1, 32, 8), (2, 1, 32, 8)))
    pool, table = TT.paged_operands(k, v, 8)
    pos = torch.tensor([31, 20], dtype=torch.int32)
    base = TO.paged_flash_attention(q, pool, table, pos)
    for kw in (dict(num_warps=4), dict(num_stages=2), dict(num_stages=0),
               dict(num_warps="auto", num_stages="auto")):
        assert torch.equal(TO.paged_flash_attention(q, pool, table, pos,
                                                    **kw), base)
    with pytest.raises(ValueError, match="unknown lowering 'auto'"):
        TO.paged_flash_attention(q, pool, table, pos, grid_mode="auto")


def test_domain_calls_are_keyed_by_the_fractal_argument():
    # the reference keys a domain= call by ``fractal`` (its default, the
    # gasket) and n: a gasket winner's coarsen then reaches a triangle
    # call, which refuses it where explicit defaults run; the port does
    # the same (ROADMAP Queue C: a fault of the reference)
    n, block = 16, 4
    _put_both("write", {"fractal": GASKET, "n": n, "block": block},
              {"lowering": "prefetch_lut", "storage": "embedded",
               "coarsen": 2})
    jm, tm = jnp.zeros((n, n)), torch.zeros(n, n)
    jd, td = JTri(n // block), TTri(n // block)
    np.testing.assert_array_equal(
        TO.sierpinski_write(tm, 1.0, block=block, domain=td,
                            grid_mode="auto").numpy(),
        np.asarray(JO.sierpinski_write(jm, 1.0, block=block, domain=jd,
                                       grid_mode="auto",
                                       backend="tpu-interpret")))
    with pytest.raises(ValueError) as want:
        JO.sierpinski_write(jm, 1.0, block=block, domain=jd,
                            coarsen="auto", backend="tpu-interpret")
    with pytest.raises(ValueError) as got:
        TO.sierpinski_write(tm, 1.0, block=block, domain=td, coarsen="auto")
    assert str(got.value) == str(want.value)
    assert "needs a fractal domain" in str(got.value)
    # explicit defaults run
    assert float(TO.sierpinski_write(tm, 1.0, block=block, domain=td,
                                     coarsen=1).sum()) == 160.0


# ---------------------------------------------------------------------------
# the searchers on another fractal (ROADMAP C8): the port's time the named
# fractal, the reference's time the gasket whatever ``fractal`` says
# ---------------------------------------------------------------------------

CARPET = "sierpinski-carpet"


def _carpet_ref(state, n, steps=0, value=None):
    """``repro.kernels.ref``'s write and parity step with the carpet's
    membership in place of the gasket's (the oracles take the gasket's
    ``membership_grid``): ``value`` written at every member cell, or
    ``steps`` parity steps."""
    from repro.kernels import ref as JR
    member = jnp.asarray(JF.FRACTALS[CARPET].membership_grid(n))
    s = jnp.asarray(state)
    if value is not None:
        return np.asarray(jnp.where(member, jnp.asarray(value, s.dtype), s))
    for _ in range(steps):
        nb = [JR._neighbor_shift(s, dy, dx)
              for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]
        s = jnp.where(member, jnp.mod(s + nb[0] + nb[1] + nb[2] + nb[3], 2),
                      0).astype(s.dtype)
    return np.asarray(s)


def _unpacked(t, storage, n, block):
    if storage == "embedded":
        return t.numpy()
    from repro_torch.core.compact import compact_layout
    lay = compact_layout(TW.resolve_fractal_domain(CARPET, n, block))
    return lay.unpack(t, block).numpy()


def test_searchers_tune_the_named_fractal(tmp_path):
    n, block, steps = 81, 9, 3
    c = TT.TuneCache(str(tmp_path / "tune.json"))
    x = fractal_state(CARPET, n, True, seed=81)
    geo = dict(block=block, fractal=CARPET, n=n)

    cfg, us, trials = TT.autotune_write(max_coarsen=2, cache=c,
                                        device="cpu", **geo)
    assert us > 0 and trials and cfg["lowering"] in LOWERINGS
    assert cfg == TT.best("write", {"fractal": CARPET, "n": n,
                                    "block": block}, cache=c, device="cpu")
    _, ta = pair(x, CARPET, n, block, cfg["storage"])
    got = TO.sierpinski_write(ta, 2.0, grid_mode=cfg["lowering"],
                              storage=cfg["storage"],
                              coarsen=cfg["coarsen"], **geo)
    np.testing.assert_array_equal(_unpacked(got, cfg["storage"], n, block),
                                  _carpet_ref(x, n, value=2.0))

    cfg, us, trials = TT.autotune_ca(steps=2, max_fuse=2, max_coarsen=2,
                                     cache=c, device="cpu", **geo)
    assert us > 0 and trials and cfg["lowering"] in LOWERINGS
    _, ta = pair(x, CARPET, n, block, cfg["storage"])
    got = TO.ca_run(ta, torch.zeros_like(ta), steps, fuse=cfg["fuse"],
                    grid_mode=cfg["lowering"], storage=cfg["storage"],
                    coarsen=cfg["coarsen"], num_stages=cfg["stages"], **geo)
    np.testing.assert_array_equal(_unpacked(got, cfg["storage"], n, block),
                                  _carpet_ref(x, n, steps=steps))

    # the reference's searchers run the gasket default on the carpet's
    # geometry and refuse it (ROADMAP C8)
    want = ("n/block = 9 blocks per side is not a valid scale level of "
            "fractal 'sierpinski-gasket'")
    for search in (JT.autotune_write, JT.autotune_ca):
        with pytest.raises(ValueError, match=want):
            search(storages=("embedded",), max_coarsen=1,
                   cache=JT.TuneCache(str(tmp_path / "ref.json")),
                   interpret=True, **geo)
