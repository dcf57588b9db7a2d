"""The port's guarded servers: transient and poisoned steps recovered
bit-identically, the degradation ladders (blockspace -> xla,
paged-blockspace -> paged-xla) serving the lower rung's streams, an
exhausted ladder's failure report, SIGTERM drain and resume -- also from
a decode checkpoint the JAX Server wrote -- the substrate canary, the ``--chaos-seed`` CLI, falcon-mamba-7b's
guarded decode recovering a poisoned and a failed step to the unfaulted
stream (an SSM decode step is not idempotent, so a retry must start
from the states the failed attempt was given), and servers dropped with
the cyclic collector off freeing their model."""
import json
import os

import numpy as np
import pytest

from repro_torch.launch import serve as S
from repro_torch.runtime import chaos as TC
from repro_torch.runtime.guard import (GuardEvent, GuardExhausted,
                                       ServerState, ValidationError)
from test_torch_serve import LOGIT_ATOL, _margins
from torch_parity import jax_model

MAX_NEW = 6


@pytest.fixture(scope="module")
def quickstart():
    return jax_model("quickstart")


@pytest.fixture(scope="module")
def jax_greedy(quickstart):
    """The JAX Server's uninterrupted greedy stream on prompts whose
    top-2 margins are >= 100x the logit tolerance at every step."""
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    jcfg, jp, tcfg, tm = quickstart
    prompts = _prompts(jcfg, (2, 8), 2)
    want = JServer(jcfg, jp, JServeConfig(max_len=16, guard=False)).generate(
        prompts, max_new=MAX_NEW)
    margins = _margins(tm, tcfg, prompts, want)
    assert margins.min() >= 100 * LOGIT_ATOL, margins.min()
    return prompts, want


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _kinds(server):
    return [e.kind for e in server.events if isinstance(e, GuardEvent)]


def test_transient_and_poisoned_steps_recover_bit_identically(quickstart):
    _, _, tcfg, tm = quickstart
    scfg = S.ServeConfig(max_len=16, temperature=0.7, seed=11,
                         backoff_base_s=0.0)
    prompts = _prompts(tcfg, (2, 8), 0)
    ref = S.Server(tcfg, tm, scfg).generate(prompts, MAX_NEW)
    plan = TC.FaultPlan(0, [
        TC.FaultSpec("transient_error", "serve.prefill", 0),
        TC.FaultSpec("transient_error", "serve.decode", 1, mode="jax"),
        TC.FaultSpec("poison_result", "serve.decode", 3)])
    chaos = TC.ChaosInjector(plan)
    srv = S.Server(tcfg, tm, scfg, chaos=chaos)
    out = srv.generate(prompts, MAX_NEW)
    assert np.array_equal(out, ref) and len(chaos.events) == 3
    kinds = _kinds(srv)
    assert kinds.count("transient") == 2 and "validation" in kinds
    assert srv.state == ServerState.HEALTHY and srv.ladder.level == 0
    assert srv._decode.recoveries == 2 and srv._prefill.recoveries == 1
    # the unguarded server serves the same stream with no events
    bare = S.Server(tcfg, tm, S.ServeConfig(max_len=16, temperature=0.7,
                                            seed=11, guard=False))
    assert np.array_equal(bare.generate(prompts, MAX_NEW), ref)
    assert bare.events == []


def test_ladder_blockspace_to_xla(quickstart):
    _, _, tcfg, tm = quickstart
    scfg = S.ServeConfig(max_len=16, temperature=0.5, seed=9, retries=2,
                         backoff_base_s=0.0)
    prompts = _prompts(tcfg, (2, 4), 3)
    want = S.Server(tcfg.replace(attn_decode_kernel="xla"), tm,
                    scfg).generate(prompts, MAX_NEW)
    plan = TC.FaultPlan(0, [TC.FaultSpec("transient_error", "serve.decode",
                                         i, rung=0) for i in range(3)])
    srv = S.Server(tcfg.replace(attn_decode_kernel="blockspace"), tm, scfg,
                   chaos=TC.ChaosInjector(plan))
    assert srv.ladder.rungs[0]["decode_kernel"] == "blockspace"
    with pytest.warns(RuntimeWarning, match="stepped down"):
        out = srv.generate(prompts, MAX_NEW)
    assert srv.state == ServerState.DEGRADED and srv.ladder.level == 1
    (t,) = srv.ladder.transitions
    assert (t["from"]["decode_kernel"], t["to"]["decode_kernel"]) == \
        ("blockspace", "xla")
    assert srv._decode_cfg.attn_decode_kernel == "xla"
    assert np.array_equal(out, want)
    assert any(isinstance(e, dict) and e["kind"] == "degrade"
               for e in srv.events)
    # an exotic lowering adds the closed_form rung
    rungs = S.Server._rungs(tcfg.replace(attn_decode_kernel="blockspace",
                                         grid_lowering="mma"))
    assert rungs[-1] == {"decode_kernel": "xla",
                         "grid_lowering": "closed_form"}


def test_paged_ladder_to_paged_xla(quickstart):
    _, _, tcfg, tm = quickstart
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, tcfg.vocab_size, (n,)) for n in (7, 12, 5)]
    kw = dict(max_len=32, num_slots=2, page_size=8, num_pages=16,
              retries=1, backoff_base_s=0.0)
    want = S.PagedServer(tcfg.replace(attn_decode_kernel="xla"), tm,
                         S.PagedServeConfig(**kw)).run(reqs, max_new=4)
    plan = TC.FaultPlan(0, [TC.FaultSpec("transient_error", "serve.decode",
                                         i, rung=0) for i in range(2)])
    srv = S.PagedServer(tcfg.replace(attn_decode_kernel="blockspace"), tm,
                        S.PagedServeConfig(**kw),
                        chaos=TC.ChaosInjector(plan))
    with pytest.warns(RuntimeWarning, match="stepped down"):
        out = srv.run(reqs, max_new=4)
    assert srv.state == ServerState.DEGRADED and srv.ladder.level == 1
    assert srv.ladder.transitions[0]["to"] == {"decode_kernel": "xla"}
    for rid in want:
        assert np.array_equal(out[rid], want[rid]), rid
    assert srv.alloc.free_pages == kw["num_pages"] - 1


def test_exhausted_ladder_writes_failure_report(quickstart, tmp_path):
    _, _, tcfg, tm = quickstart              # xla: a single-rung ladder
    scfg = S.ServeConfig(max_len=16, retries=1, backoff_base_s=0.0,
                         report_dir=str(tmp_path))
    plan = TC.FaultPlan(0, [TC.FaultSpec("transient_error", "serve.decode",
                                         i) for i in range(4)])
    srv = S.Server(tcfg, tm, scfg, chaos=TC.ChaosInjector(plan))
    with pytest.raises(GuardExhausted):
        srv.generate(_prompts(tcfg, (2, 4), 0), max_new=4)
    reports = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert reports == ["failure_serve_decode.json"]
    rep = json.load(open(tmp_path / reports[0]))
    assert rep["classification"] == "exhausted"
    assert rep["name"] == "serve.decode" and rep["attempts"] == 2


@pytest.mark.parametrize("paged", [False, True])
def test_fatal_decode_error_raises_on_its_rung(quickstart, tmp_path, paged):
    """A fatal error on the blockspace rung is reported and re-raised:
    the server never steps down to the plain decode over it."""
    _, _, tcfg, tm = quickstart
    cfg = tcfg.replace(attn_decode_kernel="blockspace")
    plan = TC.FaultPlan(0, [TC.FaultSpec("fatal_error", "serve.decode", 1,
                                         rung=0)])
    kw = dict(max_len=16, backoff_base_s=0.0, report_dir=str(tmp_path))
    if paged:
        srv = S.PagedServer(cfg, tm, S.PagedServeConfig(
            num_slots=2, page_size=8, num_pages=8, **kw),
            chaos=TC.ChaosInjector(plan))
        run = lambda: srv.run([_prompts(tcfg, (5,), 0)], max_new=4)
    else:
        srv = S.Server(cfg, tm, S.ServeConfig(**kw),
                       chaos=TC.ChaosInjector(plan))
        run = lambda: srv.generate(_prompts(tcfg, (2, 4), 0), max_new=4)
    assert len(srv.ladder.rungs) == 2
    with pytest.raises(GuardExhausted, match="fatal") as e:
        run()
    assert e.value.report.classification == "fatal"
    assert srv.ladder.level == 0 and srv.ladder.transitions == []
    assert srv.state == ServerState.HEALTHY
    assert _kinds(srv) == ["ok", "ok", "fatal"]
    rep = json.load(open(tmp_path / "failure_serve_decode.json"))
    assert rep["classification"] == "fatal" and rep["attempts"] == 1
    assert rep["transitions"] == []


def _jax_kinds(events):
    return [e["kind"] if isinstance(e, dict) else e.kind for e in events]


def test_same_fault_plan_as_the_jax_server(quickstart, jax_greedy):
    """One fault plan through ``repro``'s Server and the port's, greedy:
    the same guard and ladder events, recoveries, transitions, failure
    report and stream.  The first generation recovers a transient
    prefill, steps blockspace -> xla after two rung-0 faults and recovers
    a poisoned step; the second exhausts the bottom rung."""
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    from repro.runtime import chaos as JC
    jcfg, jp, tcfg, tm = quickstart
    faults = [dict(kind="transient_error", site="serve.prefill", index=0),
              dict(kind="transient_error", site="serve.decode", index=0,
                   rung=0),
              dict(kind="transient_error", site="serve.decode", index=1,
                   mode="jax", rung=0),
              dict(kind="poison_result", site="serve.decode", index=3),
              dict(kind="transient_error", site="serve.decode", index=8),
              dict(kind="transient_error", site="serve.decode", index=9)]
    plan = {"seed": 0, "faults": [TC.FaultSpec(**f).to_json()
                                  for f in faults]}
    kw = dict(max_len=16, retries=1, backoff_base_s=0.0)
    prompts, uninterrupted = jax_greedy
    jsrv = JServer(jcfg.replace(attn_decode_kernel="blockspace"), jp,
                   JServeConfig(**kw),
                   chaos=JC.ChaosInjector(JC.FaultPlan.from_json(plan)))
    tsrv = S.Server(tcfg.replace(attn_decode_kernel="blockspace"), tm,
                    S.ServeConfig(**kw),
                    chaos=TC.ChaosInjector(TC.FaultPlan.from_json(plan)))
    want = jsrv.generate(prompts, max_new=MAX_NEW)
    with pytest.warns(RuntimeWarning, match="stepped down"):
        got = tsrv.generate(prompts, max_new=MAX_NEW)
    assert np.array_equal(want, uninterrupted)
    assert np.array_equal(got, want)
    with pytest.raises(Exception) as ej:
        jsrv.generate(prompts, max_new=MAX_NEW)
    with pytest.raises(GuardExhausted) as et:
        tsrv.generate(prompts, max_new=MAX_NEW)
    assert type(ej.value).__name__ == "GuardExhausted"
    assert _jax_kinds(tsrv.events) == _jax_kinds(jsrv.events)
    assert "degrade" in _jax_kinds(tsrv.events)
    for g in ("_prefill", "_decode"):
        assert getattr(tsrv, g).recoveries == getattr(jsrv, g).recoveries
    assert tsrv._decode.recoveries == 1 and tsrv._prefill.recoveries == 1

    def moves(transitions):
        return [(t["from_level"], t["to_level"], t["from"], t["to"])
                for t in transitions]

    assert moves(tsrv.ladder.transitions) == moves(jsrv.ladder.transitions)
    assert tsrv.state == ServerState.DEGRADED
    assert tsrv.state.value == jsrv.state.value
    rt, rj = et.value.report.to_json(), ej.value.report.to_json()
    assert sorted(rt) == sorted(rj)
    for key in ("name", "classification", "attempts"):
        assert rt[key] == rj[key], key
    assert rt["classification"] == "exhausted"
    assert [e["kind"] for e in rt["events"]] == \
        [e["kind"] for e in rj["events"]]
    assert moves(rt["transitions"]) == moves(rj["transitions"])


def test_sigterm_drains_and_resume_is_uninterrupted(quickstart, tmp_path):
    _, _, tcfg, tm = quickstart
    kw = dict(max_len=16, temperature=0.7, seed=5, backoff_base_s=0.0)
    prompts = _prompts(tcfg, (2, 8), 1)
    ref = S.Server(tcfg, tm, S.ServeConfig(**kw)).generate(prompts, MAX_NEW)
    scfg = S.ServeConfig(ckpt_dir=str(tmp_path), ckpt_every=1, **kw)
    plan = TC.FaultPlan(0, [TC.FaultSpec("sigterm", "serve.decode", 2)])
    srv = S.Server(tcfg, tm, scfg, chaos=TC.ChaosInjector(plan))
    partial = srv.generate(prompts, MAX_NEW)
    assert srv.state == ServerState.DRAINING and partial.shape[1] == 4
    assert np.array_equal(partial, ref[:, :4])
    with pytest.raises(RuntimeError, match="draining"):
        srv.generate(prompts, MAX_NEW)
    successor = S.Server(tcfg, tm, scfg)
    out = successor.resume()
    assert np.array_equal(out, ref)
    assert successor.state == ServerState.HEALTHY
    assert successor.events[-1]["kind"] == "resume"


def test_resume_of_a_jax_decode_checkpoint(quickstart, jax_greedy,
                                          tmp_path):
    """The JAX Server drains on SIGTERM into its decode checkpoint; the
    port's Server resumes it, greedy, to the JAX uninterrupted stream
    (on prompts whose top-2 margins are >= 100x the logit tolerance)."""
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    from repro.runtime import chaos as JC
    jcfg, jp, tcfg, tm = quickstart
    prompts, want = jax_greedy
    jsrv = JServer(jcfg, jp, JServeConfig(
        max_len=16, backoff_base_s=0.0, ckpt_dir=str(tmp_path),
        ckpt_every=1), chaos=JC.ChaosInjector(JC.FaultPlan(0, [
            JC.FaultSpec("sigterm", "serve.decode", 2)])))
    partial = jsrv.generate(prompts, max_new=MAX_NEW)
    assert jsrv.state.value == "draining" and partial.shape[1] < MAX_NEW
    out = S.Server(tcfg, tm, S.ServeConfig(
        max_len=16, ckpt_dir=str(tmp_path))).resume()
    assert np.array_equal(out, want)


def test_check_substrate(quickstart):
    _, _, tcfg, tm = quickstart
    srv = S.Server(tcfg, tm, S.ServeConfig(max_len=16, spot_check_every=2))
    with TC.ChaosInjector(TC.FaultPlan(0)) as count:
        srv.generate(_prompts(tcfg, (2, 4), 0), MAX_NEW)
    # decode steps 2 and 4 ran a canary: one write launch each
    assert count.counters["pallas"] == (MAX_NEW - 1) // 2
    assert srv._canary_ref is not None
    # a finite corruption of a later canary is caught
    plan = TC.FaultPlan(0, [TC.FaultSpec("poison_tile", "pallas", 0,
                                         mode="bitflip", step=3)])
    with TC.ChaosInjector(plan):
        with pytest.raises(ValidationError, match="lambda canary"):
            srv.check_substrate()
    srv.check_substrate()


def test_chaos_seed_cli(capsys, tmp_path):
    S.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "4", "--chaos-seed", "7", "--temperature", "0",
            "--ckpt-dir", str(tmp_path)])
    S.main(["--device", "cpu", "--paged", "--batch", "3", "--prompt-len",
            "8", "--max-new", "3", "--chaos-seed", "3"])
    out = capsys.readouterr().out
    assert "chaos: 4 faults scheduled (seed 7)" in out
    assert "recoveries, state healthy" in out
    assert "faults fired, state healthy" in out
    assert "generated shape: (2, 4)" in out
    assert os.listdir(tmp_path)           # decode-state checkpoints


def test_ssm_decode_retries_give_the_unfaulted_stream():
    """falcon-mamba-7b's smoke stack under a poisoned and a transient
    decode step: each step's retry reruns it on the cache the faulted
    attempt was given, and the stream and every step's logits equal an
    unfaulted server's, bit for bit (greedy tokens alone would hide a
    state advanced twice: the smoke stack's dt ~ 0.01 moves logits
    little)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init
    cfg = get_config("falcon-mamba-7b", smoke=True)
    model = init(cfg, torch.Generator().manual_seed(3), "cpu")
    scfg = S.ServeConfig(max_len=32, backoff_base_s=0.0)
    prompts = _prompts(cfg, (2, 16), 5)
    logits = {"want": [], "got": []}

    def keep(key):
        return lambda pos, lg: logits[key].append(lg.clone())

    want = S.Server(cfg, model, scfg).generate(prompts, MAX_NEW,
                                               on_step=keep("want"))
    plan = TC.FaultPlan(0, [
        TC.FaultSpec("poison_result", "serve.decode", 1),
        TC.FaultSpec("transient_error", "serve.decode", 3)])
    chaos = TC.ChaosInjector(plan)
    srv = S.Server(cfg, model, scfg, chaos=chaos)
    assert np.array_equal(srv.generate(prompts, MAX_NEW,
                                       on_step=keep("got")), want)
    assert len(logits["got"]) == len(logits["want"]) == MAX_NEW
    assert all(torch.equal(a, b) for a, b in zip(logits["got"],
                                                  logits["want"]))
    assert len(chaos.events) == 2 and srv._decode.recoveries == 2
    kinds = _kinds(srv)
    assert "validation" in kinds and "transient" in kinds
    assert srv.state == ServerState.HEALTHY and srv.ladder.level == 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("with_chaos", [False, True])
def test_dropped_server_frees_its_model_without_the_collector(paged,
                                                               with_chaos):
    """A server and its guarded calls hold no reference cycle: with the
    cyclic collector off, dropping a server that has served (its model
    referenced by it alone) frees the model's parameters at once, with
    a chaos plan attached or not."""
    import gc
    import weakref

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init
    cfg = get_config("quickstart", smoke=True)
    plan = TC.FaultPlan(0, [TC.FaultSpec("transient_error", "serve.decode",
                                         1)])
    chaos = TC.ChaosInjector(plan) if with_chaos else None
    kw = dict(max_len=16, backoff_base_s=0.0)
    prompts = _prompts(cfg, (2, 4), 0)
    enabled = gc.isenabled()
    gc.disable()
    try:
        model = init(cfg, torch.Generator().manual_seed(0), "cpu")
        param = weakref.ref(model.lm_head.w)
        if paged:
            srv = S.PagedServer(cfg, model, S.PagedServeConfig(
                num_slots=2, page_size=8, num_pages=8, **kw), chaos=chaos)
            srv.run([p for p in prompts], max_new=3)
        else:
            srv = S.Server(cfg, model, S.ServeConfig(**kw), chaos=chaos)
            srv.generate(prompts, 3)
        if with_chaos:
            assert chaos.events
        del model
        assert param() is not None
        del srv
        assert param() is None
    finally:
        if enabled:
            gc.enable()
