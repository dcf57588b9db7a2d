"""The port's LM stack against the JAX package's, on the same weights
(carried across with params_from_jax): quickstart and gemma3-12b smoke
configs, full forward, prefill logits and caches, 8 decode steps under
the plain and the block-space decode, and the paged decode step; the MoE
stacks (deepseek-v2-236b with MLA and a dense first layer,
llama4-maverick-400b-a17b with GQA and MoE every 2nd layer) the same way
with their aux losses, MLA caches and the absorbed decode, and llama4's
paged decode (deepseek-v2's MLA stack refuses paged serving, as in the
JAX package); the SSM, hybrid and embedding-input stacks (falcon-mamba-7b,
zamba2-2.7b, musicgen-large, internvl2-26b) through forward, prefill
(caches in the JAX layout) and 16 decode steps against the JAX package
and against the port's own prefill of the extended sequence, decode steps
that rerun bit-equal on the same cache, and their refusal of paged
serving.

LOGIT_TOL: f32 matmuls and reductions summed in another order, a few
layers deep; the largest difference seen is ~5e-6 on logits of
magnitude ~4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import paged as TP
from repro_torch.models import init
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, params_to_jax
from torch_parity import jax_model

LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
ARCHS = ["quickstart", "gemma3-12b"]
#: the JAX package's decode steps compiled once per config (eagerly, every
#: step would trace the interpreted kernel again; the bits are the same)
J_DECODE_STEP = jax.jit(JM.decode_step, static_argnums=(4,))
J_DECODE_STEP_PAGED = jax.jit(JM.decode_step_paged, static_argnums=(6,))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **tol)


@pytest.fixture(scope="module", params=ARCHS)
def stacks(request):
    return jax_model(request.param)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_conversion_round_trip_exact(stacks):
    jcfg, jp, tcfg, tm = stacks
    tree = params_to_jax(tm)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(KeyError, match="no 'final_norm.scale'"):
        params_from_jax({k: v for k, v in want.items()
                         if k != "final_norm"}, tcfg, "cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_jax({**want, "extra": {"w": np.zeros(1)}}, tcfg, "cpu")
    bad = {**want, "lm_head": {"w": want["lm_head"]["w"][:, :8]}}
    with pytest.raises(ValueError, match="lm_head.w"):
        params_from_jax(bad, tcfg, "cpu")


def test_forward_and_prefill_match_jax(stacks):
    jcfg, jp, tcfg, tm = stacks
    toks = _tokens(jcfg, (2, 24))
    jl, _ = JM.logits_fn(jp, jnp.asarray(toks), jcfg)
    tl, aux = TM.logits_fn(tm, torch.from_numpy(toks))
    _close(tl, jl)
    assert float(aux) == 0.0
    jlog, jcache = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=32)
    tlog, tcache = TM.prefill(tm, torch.from_numpy(toks), max_len=32)
    _close(tlog, jlog)
    prefix, period, n_groups = JM.group_layout(jcfg)
    assert prefix == 0 and len(tcache) == period * n_groups
    zeros = TM.init_cache(tcfg, 2, 32, "cpu")
    assert [tuple(k.shape) for k, _ in zeros] == \
        [tuple(k.shape) for k, _ in tcache]
    assert not any(bool(k.any()) or bool(v.any()) for k, v in zeros)
    for i, (k, v) in enumerate(tcache):
        jk, jv = jcache["blocks"][f"slot_{i % period}"]["mixer"]
        assert k.shape == (2, tcfg.n_kv_heads, 32, tcfg.hd)
        _close(k, jk[i // period])
        _close(v, jv[i // period])


@pytest.mark.parametrize("decode_kernel", ["xla", "blockspace"])
def test_decode_steps_match_jax(stacks, decode_kernel):
    jcfg, jp, tcfg, tm = stacks
    jcfg = jcfg.replace(attn_decode_kernel=decode_kernel)
    tcfg = tcfg.replace(attn_decode_kernel=decode_kernel)
    toks = _tokens(jcfg, (2, 24), seed=1)
    jlog, jcache = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=32)
    tlog, tcache = TM.prefill(tm, torch.from_numpy(toks), 32, tcfg)
    tok = np.argmax(np.asarray(jlog), -1)
    for step in range(8):
        pos = 24 + step
        jlog, jcache = J_DECODE_STEP(jp, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos, jnp.int32), jcfg)
        tlog, tcache = TM.decode_step(tm, torch.from_numpy(tok), tcache,
                                      pos, tcfg)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)


@pytest.mark.parametrize("decode_kernel", ["xla", "blockspace"])
def test_paged_decode_step_matches_jax(stacks, decode_kernel):
    jcfg, jp, tcfg, tm = stacks
    jcfg = jcfg.replace(attn_decode_kernel=decode_kernel)
    tcfg = tcfg.replace(attn_decode_kernel=decode_kernel)
    ps, lens = 8, [13, 6]
    jpools = JM.init_paged_cache(jcfg, 8, ps)
    tpools = TM.init_paged_cache(tcfg, 8, ps, "cpu")
    table = np.zeros((2, 3), np.int32)
    table[0, :2], table[1, :1] = [3, 1], [5]
    for slot, n in enumerate(lens):
        toks = _tokens(jcfg, (1, n), seed=slot)
        pages = table[slot, :TP.pages_for(n, ps)]
        _, jc = JM.prefill(jp, jnp.asarray(toks), jcfg)
        jpools = JM.scatter_prefill_pages(jpools, jc, jnp.asarray(pages),
                                          jcfg)
        _, tc = TM.prefill(tm, torch.from_numpy(toks), cfg=tcfg)
        TM.scatter_prefill_pages(tpools, tc, torch.from_numpy(pages), tcfg)
    table[1, 1] = 2                               # slot 1 grows a page
    pos = np.asarray(lens, np.int32)
    act = np.asarray([True, True])
    tok = _tokens(jcfg, (2, 1), seed=7)
    for _ in range(3):
        jlog, jpools = J_DECODE_STEP_PAGED(
            jp, jnp.asarray(tok), jpools, jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(act), jcfg)
        tlog, tpools = TM.decode_step_paged(
            tm, torch.from_numpy(tok), tpools, torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(act), tcfg)
        _close(tlog, jlog)
        tok, pos = np.argmax(np.asarray(jlog), -1), pos + 1
    for i, pool in enumerate(tpools):
        jpool = jpools["blocks"][f"slot_{i % len(jcfg.attn_pattern)}"][
            "mixer"][i // len(jcfg.attn_pattern)]
        _close(pool[1:], jpool[1:])               # page 0 is scratch


def test_configs_and_init_match_jax():
    from repro.configs import get_config as j_get_config
    for arch in ARCHS:
        for smoke in (True, False):
            t = get_config(arch, smoke=smoke)
            j = j_get_config(arch, smoke=smoke)
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                {f: getattr(j, f) for f in j.__dataclass_fields__}
            assert t.param_count() == j.param_count()
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-2")
    cfg = get_config("quickstart", smoke=True)
    # every mixer and input mode of the JAX package builds
    assert isinstance(TM.Model(cfg.replace(ssm_kind="mamba1"), "cpu")
                      .layers[0].mixer, TM.ssm_lib.Mamba1)
    assert not hasattr(TM.Model(cfg.replace(input_mode="embeddings"),
                                "cpu"), "embed")
    # init: the JAX package's shapes and scales, from a torch generator
    model = init(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                        jax_model_cfg("quickstart")))
    shapes = jax.tree.map(lambda a: a.shape, params_to_jax(model))
    assert shapes == jax.tree.map(lambda a: a.shape, jp)
    w = model.layers[0].mixer.wq
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(model.embed.table.std()) - 0.01) < 1e-3
    assert torch.equal(model.final_norm.scale, torch.ones(cfg.d_model))


def jax_model_cfg(arch):
    from repro.configs import get_config as j_get_config
    return j_get_config(arch, smoke=True)


@pytest.mark.parametrize("make", [
    lambda cfg: TM.Model(cfg),
    lambda cfg: init(cfg, torch.Generator().manual_seed(0)),
    lambda cfg: params_from_jax({}, cfg),
    lambda cfg: TM.init_cache(cfg, 2, 32),
    lambda cfg: TP.init_pool(4, cfg.n_kv_heads, 8, cfg.hd),
], ids=["Model", "init", "params_from_jax", "init_cache", "init_pool"])
def test_builders_default_to_the_card(monkeypatch, make):
    # with no device named, the builders take the card (the port's rule,
    # core/backend.py::default_device) and raise without one instead of
    # building on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("quickstart", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        make(cfg)


# ---------------------------------------------------------------------------
# the MoE / MLA stacks
# ---------------------------------------------------------------------------

FAMILIES = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
J_LOGITS = jax.jit(JM.logits_fn, static_argnums=(2,))
J_PREFILL = jax.jit(JM.prefill, static_argnums=(2, 3))
#: the SSM, hybrid and embedding-input stacks
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-2.7b", "musicgen-large",
             "internvl2-26b"]


@pytest.fixture(scope="module", params=FAMILIES)
def families(request):
    """The port's seeded init carried across to the JAX package (faster
    than ``jax.random`` init of the MoE stacks on the CPU): (jax cfg,
    jax params, torch cfg, torch model)."""
    from repro.configs import get_config as j_get_config
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    tm = init(tcfg, torch.Generator().manual_seed(0), "cpu")
    return jcfg, jax.tree.map(jnp.asarray, params_to_jax(tm)), tcfg, tm


def test_family_configs_match_jax_and_the_rest_refuse():
    """Every configuration of the JAX package is registered, equal field
    for field; none refuses (the last four came with the SSM, hybrid and
    embedding-input stacks)."""
    from repro.configs import _MODULES as J_MODULES
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import _MODULES
    assert sorted(_MODULES) == sorted(J_MODULES)
    for arch in FAMILIES + SSM_ARCHS:
        for smoke in (True, False):
            t = get_config(arch, smoke=smoke)
            j = j_get_config(arch, smoke=smoke)
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                {f: getattr(j, f) for f in j.__dataclass_fields__}
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()


def test_family_forward_prefill_and_decode_match_jax(families):
    jcfg, jp, tcfg, tm = families
    toks = _tokens(jcfg, (2, 24), seed=3)
    jl, jaux = J_LOGITS(jp, jnp.asarray(toks), jcfg)
    tl, taux = TM.logits_fn(tm, torch.from_numpy(toks))
    _close(tl, jl)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jlog, jcache = J_PREFILL(jp, jnp.asarray(toks), jcfg, 32)
    tlog, tcache = TM.prefill(tm, torch.from_numpy(toks), max_len=32)
    _close(tlog, jlog)
    prefix, period, _ = JM.group_layout(jcfg)
    zeros = TM.init_cache(tcfg, 2, 32, "cpu")
    for i, (pair, zero) in enumerate(zip(tcache, zeros)):
        want = (jcache[f"prefix_{i}"]["mixer"] if i < prefix else [
            t[(i - prefix) // period] for t in
            jcache["blocks"][f"slot_{(i - prefix) % period}"]["mixer"]])
        for got, z, w in zip(pair, zero, want):
            assert got.shape == z.shape and not z.any()
            _close(got, w)
    if tcfg.use_mla:  # the compressed cache: L + dr values a token
        assert tcache[0][0].shape == (2, 32, tcfg.kv_lora_rank)
        assert tcache[0][1].shape == (2, 32, tcfg.qk_rope_dim)
    tok = np.argmax(np.asarray(jlog), -1)
    for step in range(8):
        pos = 24 + step
        jlog, jcache = J_DECODE_STEP(jp, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos, jnp.int32), jcfg)
        tlog, tcache = TM.decode_step(tm, torch.from_numpy(tok), tcache,
                                      pos)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1)


def test_family_paged_decode_step_matches_jax(families):
    jcfg, jp, tcfg, tm = families
    if tcfg.use_mla:  # MLA caches are not (K, V) pages
        with pytest.raises(ValueError, match="attention-only"):
            TM.init_paged_cache(tcfg, 8, 8, "cpu")
        return
    jcfg = jcfg.replace(attn_decode_kernel="blockspace")
    tcfg = tcfg.replace(attn_decode_kernel="blockspace")
    ps, lens = 8, [12, 12]        # one prefill shape: one JAX compile
    jpools = JM.init_paged_cache(jcfg, 8, ps)
    tpools = TM.init_paged_cache(tcfg, 8, ps, "cpu")
    table = np.zeros((2, 3), np.int32)
    table[0, :2], table[1, :2] = [3, 1], [5, 2]
    for slot, n in enumerate(lens):
        toks = _tokens(jcfg, (1, n), seed=slot)
        pages = table[slot, :TP.pages_for(n, ps)]
        _, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, None)
        jpools = JM.scatter_prefill_pages(jpools, jc, jnp.asarray(pages),
                                          jcfg)
        _, tc = TM.prefill(tm, torch.from_numpy(toks), cfg=tcfg)
        TM.scatter_prefill_pages(tpools, tc, torch.from_numpy(pages), tcfg)
    pos = np.asarray(lens, np.int32)
    act = np.asarray([True, False])      # an inactive slot still routes
    tok = _tokens(jcfg, (2, 1), seed=7)
    for _ in range(3):
        jlog, jpools = J_DECODE_STEP_PAGED(
            jp, jnp.asarray(tok), jpools, jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(act), jcfg)
        tlog, tpools = TM.decode_step_paged(
            tm, torch.from_numpy(tok), tpools, torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(act), tcfg)
        _close(tlog[:1], jlog[:1])
        tok, pos = np.argmax(np.asarray(jlog), -1), pos + act
    _, period, _ = JM.group_layout(jcfg)
    for i, pool in enumerate(tpools):
        _close(pool[1:], jpools["blocks"][f"slot_{i % period}"]["mixer"][
            i // period][1:])


# ---------------------------------------------------------------------------
# the SSM, hybrid and embedding-input stacks
# ---------------------------------------------------------------------------

#: a prefill of SSM_PREFILL positions, then SSM_STEPS decode steps.  The
#: JAX package decodes through its plain decode attention, the port
#: through its block-space decode (the path chip_smoke.py serves; its
#: plain version on the CPU)
SSM_PREFILL, SSM_STEPS = 16, 16


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_stacks(request):
    """The port's seeded init carried across to the JAX package, inputs
    of SSM_PREFILL + SSM_STEPS positions (tokens, or normal embeddings)
    and the JAX package's forward logits, prefill (logits, caches) and
    decode logits and caches: (jax cfg, jax params, torch cfg, torch
    model, inputs, reference)."""
    from repro.configs import get_config as j_get_config
    arch = request.param
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    tm = init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_jax(tm))
    n = SSM_PREFILL + SSM_STEPS
    rng = np.random.default_rng(5)
    x = (rng.integers(0, tcfg.vocab_size, (2, n))
         if tcfg.input_mode == "tokens"
         else rng.normal(size=(2, n, tcfg.d_model)).astype(np.float32))
    logits, _ = J_LOGITS(jp, jnp.asarray(x), jcfg)
    plog, pcache = J_PREFILL(jp, jnp.asarray(x[:, :SSM_PREFILL]), jcfg, n)
    cache, steps = pcache, []
    for j in range(SSM_STEPS):
        pos = SSM_PREFILL + j
        lg, cache = J_DECODE_STEP(jp, jnp.asarray(x[:, pos:pos + 1]), cache,
                                  jnp.asarray(pos, jnp.int32), jcfg)
        steps.append(np.asarray(lg))
    ref = {"logits": np.asarray(logits), "prefill": np.asarray(plog),
           "cache": pcache, "steps": steps, "final_cache": cache}
    return jcfg, jp, tcfg.replace(attn_decode_kernel="blockspace"), tm, x, \
        ref


def _jax_layer_cache(jcache, cfg, i):
    """Layer ``i``'s cache in the JAX layout, as the port's tuple."""
    prefix, period, _ = JM.group_layout(cfg)
    node = (jcache[f"prefix_{i}"] if i < prefix else jax.tree.map(
        lambda a: a[(i - prefix) // period],
        jcache["blocks"][f"slot_{(i - prefix) % period}"]))
    return tuple(node["mixer"]) + tuple(node.get("shared", ()))


def test_ssm_conversion_round_trip_and_init(ssm_stacks):
    jcfg, _, tcfg, tm, _, _ = ssm_stacks
    tree = params_to_jax(tm)
    want = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == \
        jax.tree.map(lambda a: tuple(a.shape), want)
    back = params_from_jax(tree, tcfg, "cpu")
    for (name, a), (_, b) in zip(tm.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b), name
    assert hasattr(tm, "embed") == (tcfg.input_mode == "tokens")
    assert hasattr(tm, "shared_attn") == bool(tcfg.hybrid_attn_period)
    if tcfg.ssm_kind:
        m = tm.layers[0].mixer
        assert torch.equal(m.D, torch.ones_like(m.D))
        np.testing.assert_allclose(
            float(torch.nn.functional.softplus(m.dt_bias[0])), 0.01,
            rtol=1e-5)


def test_ssm_forward_prefill_and_decode_match_jax(ssm_stacks):
    jcfg, _, tcfg, tm, x, ref = ssm_stacks
    n = SSM_PREFILL + SSM_STEPS
    tl, aux = TM.logits_fn(tm, torch.from_numpy(x))
    _close(tl, ref["logits"])
    assert float(aux) == 0.0
    tlog, tcache = TM.prefill(tm, torch.from_numpy(x[:, :SSM_PREFILL]), n,
                              tcfg)
    _close(tlog, ref["prefill"])
    zeros = TM.init_cache(tcfg, 2, n, "cpu")
    for i, (got, zero) in enumerate(zip(tcache, zeros)):
        want = _jax_layer_cache(ref["cache"], jcfg, i)
        assert len(got) == len(zero) == len(want)
        for g, z, w in zip(got, zero, want):
            assert g.shape == z.shape == w.shape and g.dtype == z.dtype
            assert not z.any()
            _close(g, w)
    for j in range(SSM_STEPS):
        pos = SSM_PREFILL + j
        tlog, tcache = TM.decode_step(tm, torch.from_numpy(
            x[:, pos:pos + 1]), tcache, pos, tcfg)
        _close(tlog, ref["steps"][j])
        # the port's own prefill of the extended sequence
        _close(tlog[:, 0], tl[:, pos].detach().numpy())
    for i, got in enumerate(tcache):
        for g, w in zip(got, _jax_layer_cache(ref["final_cache"], jcfg, i)):
            _close(g, w)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_decode_step_reruns_bit_equal(arch):
    """A decode step run twice on one cache (a guarded retry, the
    ladder's next rung) gives bit-equal logits and states, and leaves
    the SSM states it was given untouched (the attention caches are
    written at pos in place, idempotently).  Paged serving refuses the
    stack, as in the JAX package."""
    tcfg = get_config(arch, smoke=True).replace(
        attn_decode_kernel="blockspace")
    tm = init(tcfg, torch.Generator().manual_seed(1), "cpu")
    n = SSM_PREFILL + SSM_STEPS
    x = _tokens(tcfg, (2, n), seed=6)
    _, cache = TM.prefill(tm, torch.from_numpy(x[:, :SSM_PREFILL]), n, tcfg)
    before = [tuple(t.clone() for t in c) for c in cache]
    tok = torch.from_numpy(x[:, SSM_PREFILL:SSM_PREFILL + 1])
    l1, c1 = TM.decode_step(tm, tok, cache, SSM_PREFILL, tcfg)
    l2, c2 = TM.decode_step(tm, tok, cache, SSM_PREFILL, tcfg)
    assert torch.equal(l1, l2)
    for old, a, b, c in zip(before, c1, c2, cache):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert torch.equal(c[0], old[0]) and torch.equal(c[1], old[1])
        assert not torch.equal(a[0], old[0])
    with pytest.raises(ValueError, match="attention-only"):
        TM.init_paged_cache(tcfg, 8, 8, "cpu")
