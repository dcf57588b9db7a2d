"""The port's servers against the JAX package's and against each other:
greedy token streams of Server equal the JAX Server's (on prompts whose
top-2 logit margins the test asserts to be >= 100x the logit
tolerance), PagedServer equals the single-request oracle, preemption is
deterministic and leak-free, a too-small pool raises, the guarded
runtime's entry points are there (the serving mesh too: a one-rank mesh
serves the single-device stream), and the reports carry their fields.  The MoE stacks (deepseek-v2-236b with
MLA, llama4-maverick-400b-a17b with GQA) serve the same greedy streams as
the JAX Server, llama4's PagedServer those of the single-request oracle,
and the CLI takes both archs.  The SSM and hybrid stacks
(falcon-mamba-7b, zamba2-2.7b) serve the JAX Server's greedy streams,
also when drained mid-stream and resumed by a successor, and the CLI
takes them; PagedServer refuses them and both servers refuse the
embedding-input stacks (musicgen-large, internvl2-26b)."""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve as S
from repro_torch.models import model as TM
from torch_parity import jax_model

#: the logit tolerance of tests/test_torch_model.py (LOGIT_TOL), as an
#: absolute bound on logits of magnitude <= ~5
LOGIT_ATOL = 2e-5 + 1e-5 * 5


@pytest.fixture(scope="module")
def quickstart():
    return jax_model("quickstart")


def _prompts(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _margins(model, cfg, prompts, stream):
    """Top-2 logit margin of every step of ``stream`` (teacher-forced
    through the port's prefill and decode)."""
    logits, cache = TM.prefill(model, torch.from_numpy(prompts),
                               max_len=prompts.shape[1] + stream.shape[1],
                               cfg=cfg)
    margins = []
    pos = prompts.shape[1] - 1
    for i in range(stream.shape[1]):
        top = torch.topk(logits[:, 0].float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        if i + 1 < stream.shape[1]:
            pos += 1
            logits, cache = TM.decode_step(
                model, torch.tensor(stream[:, i:i + 1]), cache, pos, cfg)
    return np.stack(margins, 1)


@pytest.mark.parametrize("decode_kernel,lowering", [
    ("xla", ""), ("blockspace", ""), ("blockspace", "mma")])
def test_server_greedy_streams_equal_jax(quickstart, decode_kernel,
                                         lowering):
    """Greedy streams equal the JAX Server's; with grid_lowering="mma"
    the decode kernels take the mma lowering (and both prefills its
    triangular schedule)."""
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    jcfg, jp, tcfg, tm = quickstart
    jcfg = jcfg.replace(grid_lowering=lowering)
    tcfg = tcfg.replace(attn_decode_kernel=decode_kernel,
                        grid_lowering=lowering)
    prompts = _prompts(jcfg, (3, 16), seed=2)
    want = JServer(jcfg, jp, JServeConfig(max_len=32, temperature=0.0,
                                          guard=False)).generate(
        prompts, max_new=12)
    got = S.Server(tcfg, tm, S.ServeConfig(max_len=32)).generate(
        prompts, max_new=12)
    assert got.shape == (3, 12)
    margins = _margins(tm, tcfg, prompts, want)
    assert margins.min() >= 100 * LOGIT_ATOL, margins.min()
    assert np.array_equal(got, want)


def test_server_eos_and_sampling_replay(quickstart):
    _, _, tcfg, tm = quickstart
    prompts = _prompts(tcfg, (2, 8), seed=3)
    kw = dict(max_len=24, temperature=0.8, top_k=16, seed=4)
    a = S.Server(tcfg, tm, S.ServeConfig(**kw)).generate(prompts, 10)
    b = S.Server(tcfg, tm, S.ServeConfig(**kw)).generate(prompts, 10)
    assert np.array_equal(a, b)                  # keyed on (seed, slot, pos)
    eos = int(a[0, 2])
    c = S.Server(tcfg, tm, S.ServeConfig(eos_id=eos, **kw)).generate(
        prompts, 10)
    assert np.array_equal(c[0, :3], a[0, :3]) and (c[0, 3:] == eos).all()


def _mixed(cfg, lens=(7, 12, 5)):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]


def test_paged_server_matches_single_request_oracle(quickstart):
    _, _, tcfg, tm = quickstart
    reqs = _mixed(tcfg)
    cfg = tcfg.replace(attn_decode_kernel="blockspace")
    out = S.PagedServer(cfg, tm, S.PagedServeConfig(
        max_len=32, num_slots=2, page_size=8, num_pages=16)).run(
        reqs, max_new=4)
    oracle = S.Server(tcfg.replace(attn_decode_kernel="xla"), tm,
                      S.ServeConfig(max_len=32))
    for rid, prompt in enumerate(reqs):
        want = oracle.generate(prompt[None], max_new=4)[0]
        assert np.array_equal(out[rid], want), rid


def test_paged_server_preemption_deterministic_and_leak_free(quickstart):
    _, _, tcfg, tm = quickstart
    cfg = tcfg.replace(attn_decode_kernel="blockspace")
    reqs = _mixed(cfg, lens=(14, 18, 10))
    kw = dict(max_len=48, temperature=0.7, top_k=16, seed=5,
              num_slots=3, page_size=8)
    starved = S.PagedServer(cfg, tm, S.PagedServeConfig(num_pages=8, **kw))
    out = starved.run(reqs, max_new=8)
    assert any(e["kind"] == "preempt" for e in starved.events), \
        "pool was not starved enough to preempt"
    roomy = S.PagedServer(cfg, tm, S.PagedServeConfig(num_pages=32, **kw))
    ref = roomy.run(reqs, max_new=8)
    for rid in ref:
        assert np.array_equal(out[rid], ref[rid]), rid
    for srv in (starved, roomy):            # every page returned
        assert srv.alloc.free_pages == srv.scfg.num_pages - 1


def test_paged_server_too_small_pool_raises(quickstart):
    _, _, tcfg, tm = quickstart
    srv = S.PagedServer(tcfg, tm, S.PagedServeConfig(
        max_len=32, num_slots=1, page_size=4, num_pages=3))
    with pytest.raises(RuntimeError, match="pool"):
        srv.run([np.arange(6) % tcfg.vocab_size], max_new=16)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit(0, np.arange(30), 8)
    # the guarded runtime is ported, and so is the serving mesh: a
    # one-rank (1, 1) mesh serves the single-device stream
    from repro_torch.runtime.chaos import ChaosInjector, FaultPlan
    paged = S.PagedServer(tcfg, tm, S.PagedServeConfig(),
                          chaos=ChaosInjector(FaultPlan(0)))
    assert paged.chaos is not None and paged.ladder.level == 0
    import torch_serve_mesh_ranks as R
    from repro_torch.launch.mesh import run_ranks
    prompts = _prompts(tcfg, (2, 8), 5)
    want = S.Server(R.config("quickstart"), tm,
                    S.ServeConfig(max_len=12)).generate(prompts, 4)
    state = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    got = run_ranks(R.serve, 1, "quickstart", state, prompts, 4,
                    [(1, 1)])[0][(1, 1)]
    assert np.array_equal(got["tokens"], want) and got["same"]
    srv = S.Server(tcfg, tm, S.ServeConfig())
    with pytest.raises(RuntimeError, match="resume\\(\\) needs "
                       "ServeConfig.ckpt_dir"):
        srv.resume()
    srv.check_substrate()        # the first canary is the reference...
    srv.check_substrate()        # ...which a second one equals


def test_throughput_reports_and_cli(quickstart, capsys):
    _, _, tcfg, tm = quickstart
    srv = S.PagedServer(tcfg, tm, S.PagedServeConfig(
        max_len=32, num_slots=2, page_size=8, num_pages=16))
    rep = S.paged_throughput_report(srv, _mixed(tcfg), max_new=3)
    assert rep["tokens"] == 9 and rep["requests"] == 3
    assert rep["tok_per_s"] > 0 and rep["decode_steps"] > 0
    assert 0.0 <= rep["mean_fragmentation"] <= 1.0
    assert 0.0 < rep["peak_utilization"] <= 1.0
    rep = S.throughput_report(S.Server(tcfg, tm, S.ServeConfig(max_len=16)),
                              2, 8, 4)
    assert rep["tokens"] == 8 and rep["tok_per_s"] > 0
    S.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "3", "--decode-kernel", "blockspace"])
    S.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "3", "--decode-kernel", "blockspace",
            "--grid-lowering", "mma"])
    S.main(["--device", "cpu", "--paged", "--batch", "3", "--prompt-len",
            "8", "--max-new", "3", "--arch", "gemma3-12b"])
    out = capsys.readouterr().out
    assert "generated shape: (2, 3)" in out and "'requests': 3" in out


# ---------------------------------------------------------------------------
# the MoE / MLA stacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["deepseek-v2-236b",
                                        "llama4-maverick-400b-a17b"])
def family(request):
    """The port's seeded init carried across to the JAX package: (jax
    cfg, jax params, torch cfg, torch model)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    from repro_torch.models import init
    from repro_torch.models.convert import params_to_jax
    arch = request.param
    tcfg = get_config(arch, smoke=True)
    tm = init(tcfg, torch.Generator().manual_seed(1), "cpu")
    return (j_get_config(arch, smoke=True),
            jax.tree.map(jnp.asarray, params_to_jax(tm)), tcfg, tm)


def test_family_server_greedy_streams_equal_jax(family):
    """Both prefill all prompts at once, so the MoE capacity follows
    batch x prompt alike; the streams are equal."""
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    jcfg, jp, tcfg, tm = family
    prompts = _prompts(jcfg, (3, 16), seed=4)
    want = JServer(jcfg, jp, JServeConfig(max_len=32, temperature=0.0,
                                          guard=False)).generate(
        prompts, max_new=8)
    cfg = tcfg.replace(attn_decode_kernel="blockspace")
    got = S.Server(cfg, tm, S.ServeConfig(max_len=32)).generate(
        prompts, max_new=8)
    margins = _margins(tm, cfg, prompts, want)
    assert margins.min() >= 100 * LOGIT_ATOL, margins.min()
    assert np.array_equal(got, want)


def test_family_paged_server_matches_single_request_oracle(family):
    _, _, tcfg, tm = family
    reqs = _mixed(tcfg)
    if tcfg.use_mla:  # MLA caches are not (K, V) pages
        with pytest.raises(ValueError, match="attention-only"):
            S.PagedServer(tcfg, tm, S.PagedServeConfig())
        return
    out = S.PagedServer(tcfg.replace(attn_decode_kernel="blockspace"), tm,
                        S.PagedServeConfig(max_len=32, num_slots=2,
                                           page_size=8, num_pages=16)).run(
        reqs, max_new=4)
    oracle = S.Server(tcfg, tm, S.ServeConfig(max_len=32))
    for rid, prompt in enumerate(reqs):
        assert np.array_equal(out[rid], oracle.generate(prompt[None], 4)[0])


def test_family_cli(capsys):
    for arch in ("deepseek-v2-236b", "llama4-maverick-400b-a17b"):
        S.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "8", "--max-new", "3", "--decode-kernel",
                "blockspace"])
    S.main(["--device", "cpu", "--paged", "--arch",
            "llama4-maverick-400b-a17b", "--batch", "3", "--prompt-len",
            "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated shape: (2, 3)") == 2
    assert "'requests': 3" in out


# ---------------------------------------------------------------------------
# the SSM and hybrid stacks
# ---------------------------------------------------------------------------

SSM_SERVE = dict(shape=(3, 16), max_new=8, max_len=32)


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-2.7b"])
def ssm_serve(request):
    """The port's seeded init carried across to the JAX package, prompts
    and the JAX Server's greedy stream: (torch cfg, torch model,
    prompts, stream)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import Server as JServer
    from repro_torch.configs import get_config
    from repro_torch.models import init
    from repro_torch.models.convert import params_to_jax
    arch = request.param
    tcfg = get_config(arch, smoke=True)
    tm = init(tcfg, torch.Generator().manual_seed(2), "cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_jax(tm))
    prompts = _prompts(tcfg, SSM_SERVE["shape"], seed=4)
    want = JServer(j_get_config(arch, smoke=True), jp, JServeConfig(
        max_len=SSM_SERVE["max_len"], guard=False)).generate(
        prompts, max_new=SSM_SERVE["max_new"])
    return tcfg.replace(attn_decode_kernel="blockspace"), tm, prompts, want


def test_ssm_server_streams_equal_jax_and_resume(ssm_serve, tmp_path):
    """Greedy streams equal the JAX Server's (top-2 margins >= 100x the
    logit tolerance at every step); a server drained by SIGTERM after
    its second decode step checkpoints, and a successor's resume()
    replays prompts and tokens through the SSM (and shared-block)
    caches to the same stream."""
    from repro_torch.runtime import chaos as TC
    from repro_torch.runtime.guard import ServerState
    cfg, tm, prompts, want = ssm_serve
    c = SSM_SERVE
    got = S.Server(cfg, tm, S.ServeConfig(max_len=c["max_len"])).generate(
        prompts, max_new=c["max_new"])
    margins = _margins(tm, cfg, prompts, want)
    assert margins.min() >= 100 * LOGIT_ATOL, margins.min()
    assert np.array_equal(got, want)
    scfg = S.ServeConfig(max_len=c["max_len"], ckpt_dir=str(tmp_path),
                         ckpt_every=1, backoff_base_s=0.0)
    plan = TC.FaultPlan(0, [TC.FaultSpec("sigterm", "serve.decode", 2)])
    srv = S.Server(cfg, tm, scfg, chaos=TC.ChaosInjector(plan))
    partial = srv.generate(prompts, max_new=c["max_new"])
    assert srv.state == ServerState.DRAINING
    assert 0 < partial.shape[1] < c["max_new"]
    assert np.array_equal(partial, want[:, :partial.shape[1]])
    assert np.array_equal(S.Server(cfg, tm, scfg).resume(), want)


def test_ssm_and_embedding_stacks_refuse_what_they_cannot_serve(capsys):
    from repro_torch.configs import get_config
    from repro_torch.models import init
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg = get_config(arch, smoke=True)
        model = init(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="attention-only"):
            S.PagedServer(cfg, model, S.PagedServeConfig())
        S.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "8", "--max-new", "3", "--decode-kernel",
                "blockspace"])
    assert capsys.readouterr().out.count("generated shape: (2, 3)") == 2
    for arch in ("musicgen-large", "internvl2-26b"):
        cfg = get_config(arch, smoke=True)
        model = init(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="input_mode 'embeddings'"):
            S.Server(cfg, model, S.ServeConfig())
        with pytest.raises(ValueError, match="input_mode 'embeddings'"):
            S.PagedServer(cfg, model, S.PagedServeConfig())
