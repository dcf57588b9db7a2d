"""Serving on a (data, model) mesh over gloo ranks on the CPU, against
single-device runs (the JAX package's mesh paths do not run on this jax,
ROADMAP C2): ``Server(mesh=)`` on 2x1, 1x2 and 2x2 gives the JAX
package's single-device greedy tokens on quickstart and gemma3-12b
smoke configs in f32, every rank the same tokens, its step logits
bit-equal to the port's single-device run on a data-only mesh and
within ``TP_LOGIT_TOL`` of it under tensor parallelism; ``PagedServer``
on a laid-out model and the registered decode mesh (2x1, 1x2) gives the
single-device PagedServer's tokens; a batch that does not tile the data
axis runs the decode kernel unsharded; llama4-maverick (MoE experts),
deepseek-v2 (MLA, MoE) and zamba2 (Mamba-2, the shared block) serve on
1x2 through the gather at use; the slot-sharded decode entry points
equal their unsharded runs; ``restore(shardings=)`` onto 1x2 and
``elastic_restore`` onto 3 ranks (which picks (3, 1)) serve a
single-device checkpoint's tokens; ``autotune_paged(mesh=)`` keys its
winner by the shard count and warm-starts from the D = 1 winner.

Each world of ranks runs once per module and every case that reads it
shares it; the rank bodies are in ``tests/torch_serve_mesh_ranks.py``
(no JAX)."""
import numpy as np
import pytest
import torch

import torch_serve_mesh_ranks as R
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import Server as JServer
from repro_torch.launch import serve as S
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as TA
from torch_parity import jax_model

#: step logits of a tensor-parallel run against the single-device run,
#: f32: each wo / MLP projection sums its partial products over the
#: ranks in another order, ~1e-7 relative a layer; logits of magnitude
#: <= ~5 then differ by a few 1e-6
TP_LOGIT_TOL = 2e-5
#: a greedy token may differ from the single-device run only where that
#: run's top-2 logit margin is at most this
TOKEN_MARGIN = 100 * TP_LOGIT_TOL
MAX_NEW = 6
PAGED_KW = dict(max_len=32, num_slots=4, page_size=4, num_pages=20)


def _state(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _prompts(cfg, batch, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, 8))


def _requests(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 12)),))
            for _ in range(6)]


def _one_device(arch, model, prompts, requests=None):
    cfg = R.config(arch)
    srv = S.Server(cfg, model, S.ServeConfig(
        max_len=prompts.shape[1] + MAX_NEW))
    toks, logits, _ = R.generate(srv, prompts, MAX_NEW)
    paged = None
    if requests is not None:
        psrv = S.PagedServer(cfg, model, S.PagedServeConfig(**PAGED_KW))
        paged = psrv.run(requests, max_new=MAX_NEW)
    return toks, logits, paged


def _assert_stream(toks, logits, ref_toks, ref_logits, tol, what):
    """Tokens equal but where the reference margin is <= TOKEN_MARGIN
    (a row is compared up to its first differing token), logits within
    ``tol`` up to there."""
    top = np.sort(ref_logits, -1)
    margin = top[..., -1] - top[..., -2]
    for r in range(toks.shape[0]):
        neq = np.nonzero(toks[r] != ref_toks[r])[0]
        last = int(neq[0]) if len(neq) else toks.shape[1] - 1
        d = np.abs(logits[r, :last + 1] - ref_logits[r, :last + 1]).max()
        assert d <= tol, (what, r, d)
        if len(neq):
            assert margin[r, last] <= TOKEN_MARGIN, (what, r, last)


@pytest.fixture(scope="module", params=["quickstart", "gemma3-12b"])
def world(request):
    """One arch's reference runs and its mesh worlds: the JAX package's
    single-device greedy tokens, the port's single-device Server and
    PagedServer, the 2-rank world (2x1, 1x2 with PagedServer; 2x1 at a
    batch of 3) and the 4-rank world (2x2)."""
    arch = request.param
    jcfg, params, _, tm = jax_model(arch)
    cfg = R.config(arch)
    prompts, odd = _prompts(cfg, 4), _prompts(cfg, 3, seed=1)
    jtoks = np.asarray(JServer(jcfg.replace(attn_decode_kernel="blockspace"),
                               params, JServeConfig(max_len=8 + MAX_NEW))
                       .generate(prompts, max_new=MAX_NEW))
    requests = _requests(cfg)
    toks, logits, paged = _one_device(arch, tm, prompts, requests)
    odd_toks = _one_device(arch, tm, odd)[0]
    state = _state(tm)
    two = run_ranks(R.serve, 2, arch, state, prompts, MAX_NEW,
                    [(2, 1), (1, 2)], requests, PAGED_KW, odd)
    four = run_ranks(R.serve, 4, arch, state, prompts, MAX_NEW, [(2, 2)])
    return dict(arch=arch, cfg=cfg, jtoks=jtoks, toks=toks, logits=logits,
                paged=paged, odd_toks=odd_toks,
                meshes={**{s: [r[s] for r in two] for s in [(2, 1), (1, 2)]},
                        (2, 2): [r[(2, 2)] for r in four]},
                odd=[r["odd"] for r in two])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_server_on_mesh_gives_jax_greedy_tokens(world, shape):
    assert np.array_equal(world["toks"], world["jtoks"])
    for res in world["meshes"][shape]:
        assert res["same"]
        assert np.array_equal(res["tokens"], world["jtoks"]), shape
        _assert_stream(res["tokens"], res["logits"], world["toks"],
                       world["logits"], TP_LOGIT_TOL, shape)
        # the decode kernel ran on the rank's slot group on every decode
        # step of every layer when the data axis shards
        steps = world["cfg"].n_layers * (MAX_NEW - 1)
        assert res["slots"]["flash_attention_decode"] == (
            steps if shape[0] > 1 else 0)
        # tensor parallelism: embedding, head, attention and MLP of every
        # layer run on their pieces
        assert res["tp_modules"] == (2 + 2 * world["cfg"].n_layers
                                     if shape[1] > 1 else 0)


def test_data_only_mesh_is_bit_equal_to_one_device(world):
    """2x1 runs the same arithmetic per slot as one device (the plain
    decode on a slot group here; on the card the same split count per
    slot keeps it so)."""
    for res in world["meshes"][(2, 1)]:
        assert np.array_equal(res["tokens"], world["toks"])
        assert np.array_equal(res["logits"], world["logits"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_paged_server_on_mesh(world, shape):
    for res in world["meshes"][shape]:
        assert set(res["paged"]) == set(world["paged"])
        for rid, want in world["paged"].items():
            assert np.array_equal(res["paged"][rid], want), (shape, rid)
        cfg = world["cfg"]
        assert res["pool_heads"] == cfg.n_kv_heads // shape[1]
        assert (res["paged_slots"]["paged_flash_attention"] > 0) == \
            (shape[0] > 1)


def test_batch_that_does_not_tile_runs_unsharded(world):
    for res in world["odd"]:
        assert res["slots"]["flash_attention_decode"] == 0
        assert np.array_equal(res["tokens"], world["odd_toks"])


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "zamba2-2.7b"])
def test_gathered_families_on_tensor_parallel_mesh(arch):
    """MoE experts, MLA and the Mamba/shared blocks are gathered at use
    on 1x2 (the dense MLP of deepseek's first layer and llama4's GQA run
    tensor-parallel); tokens and logits as one device's (held to the JAX
    package's by tests/test_torch_serve.py)."""
    from repro_torch.models import model as TM
    cfg = R.config(arch)
    tm = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(cfg, 2)
    toks, logits, _ = _one_device(arch, tm, prompts)
    for res in run_ranks(R.serve, 2, arch, _state(tm), prompts, MAX_NEW,
                         [(1, 2)]):
        res = res[(1, 2)]
        assert res["same"] and res["calls"] > 0
        _assert_stream(res["tokens"], res["logits"], toks, logits,
                       TP_LOGIT_TOL, arch)
        assert np.array_equal(res["tokens"], toks)


def test_slot_sharded_decode_entry_points():
    """Every rank's slot group through decode_attention_flash /
    decode_attention_paged with mesh=, gathered, equals the unsharded
    entry point bit for bit and the plain masked decode within 2e-5."""
    from repro_torch.core import paged as P
    rng = np.random.default_rng(0)
    b, h, hkv, s, d, ps = 4, 4, 2, 32, 16, 8
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    pool = P.init_pool(1 + b * s // ps, hkv, ps, d, torch.float32, "cpu")
    table = np.zeros((b, s // ps), np.int32)
    for i in range(b):
        pages = 1 + i * (s // ps) + np.arange(s // ps)
        table[i] = pages
        P.write_prefill_pages(pool, torch.from_numpy(pages),
                              torch.from_numpy(k[i]), torch.from_numpy(v[i]))
    ppos = np.array([31, 7, 19, 0], np.int32)
    for rank in run_ranks(R.slot_decode, 2, q, k, v, 20, pool.numpy(), table,
                          ppos):
        for one, plain, calls in rank:
            assert one == 0.0 and plain <= 2e-5 and calls == 1


def test_restore_onto_mesh_and_elastic_restore(tmp_path):
    """A single-device checkpoint restored onto 1x2 (restore(shardings=))
    and onto the 3-rank world's elastic mesh ((3, 1): quickstart's
    vocabulary of 1024 does not tile 3) serves the single-device
    tokens."""
    from repro_torch.checkpoint.manager import CheckpointManager
    arch = "quickstart"
    _, _, _, tm = jax_model(arch)
    CheckpointManager(str(tmp_path), keep=1).save(0, tm)
    prompts = _prompts(R.config(arch), 6, seed=2)
    toks = _one_device(arch, tm, prompts)[0]
    for got, shape, pieces in run_ranks(R.restore_and_serve, 2, arch,
                                        str(tmp_path), prompts, MAX_NEW,
                                        (1, 2)):
        assert np.array_equal(got, toks) and shape == (1, 2) and pieces
    for got, shape, pieces in run_ranks(R.restore_and_serve, 3, arch,
                                        str(tmp_path), prompts, MAX_NEW,
                                        None):
        assert np.array_equal(got, toks) and shape == (3, 1)
        assert not pieces  # a model axis of 1 cuts nothing


def test_autotune_paged_on_mesh(tmp_path):
    """The sharded search's key carries ``devices``; it warm-starts from
    the cached D = 1 winner (the seed measured first, only its one-knob
    neighbours after), and every rank keeps the same winner."""
    from repro_torch.core import tune
    path = str(tmp_path / "tune.json")
    cache = tune.TuneCache(path)
    one, _, full = tune.autotune_paged(batch=4, heads=2, seq=32, d=16,
                                       page_sizes=(8, 16), cache=cache,
                                       device="cpu")
    got = run_ranks(R.tune_paged, 2, path)
    cfgs = [g[0] for g in got]
    assert cfgs[0] == cfgs[1]
    for cfg, trials, keys in got:
        assert trials[0][0] == one
        assert len(trials) < len(full)
        assert any('"devices": 2' in key for key in keys)
        assert any('"devices"' not in key for key in keys)
    TA.set_decode_mesh(None)
