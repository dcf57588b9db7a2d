"""The port's MoE and MLA blocks against the JAX package's, on the same
weights (the port's seeded init, carried across as numpy) and the same
numpy inputs:

* ``moe_block``: outputs within MOE_TOL, identical expert indices and
  the same aux loss, with capacity to spare and with tokens dropped
  (capacity_factor 1.0 and 0.5); ``moe_block_dense_ref`` against the
  JAX oracle, and against ``moe_block`` where nothing is dropped;
* ``mla_block`` (with and without a q LoRA rank) and the absorbed
  ``mla_decode`` step by step, each against the JAX package's, and the
  decode against the port's own prefill (as tests/test_moe_mla.py);
* the flash VJP at a V head dim unlike the QK one (MLA's 16 against 24
  here, 128 against 192 in deepseek-v2), above a lowered
  ``flash_threshold``: ``mla_block``'s parameter gradients against
  ``jax.grad``;
* the parameter conversion of a bf16 MoE stack: the f32 router kept,
  the round trip exact.

MOE_TOL: f32 matmuls summed in another order (~1e-6 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import convert
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig as TConfig

MOE_TOL = dict(rtol=1e-5, atol=2e-5)
#: parameter gradients: each leaf's largest error held to GRAD_TOL times
#: its largest magnitude (as tests/test_torch_train.py)
GRAD_TOL = 1e-5
#: the JAX package's blocks compiled whole (eagerly, each new shape
#: compiles every op on its own; the values are the same)
J_MOE = jax.jit(JMOE.moe_block, static_argnums=(2,))
J_MOE_DENSE = jax.jit(JMOE.moe_block_dense_ref, static_argnums=(2,))
J_MLA = jax.jit(JMLA.mla_block, static_argnums=(2,),
                static_argnames=("return_cache",))


def _cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


def _moe_cfgs(**kw):
    base = dict(d_model=32, d_ff_expert=64, n_experts=8, top_k=2, moe=True,
                n_shared_experts=1, capacity_factor=8.0, dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return _cfgs(**base)


def _mla_cfgs(**kw):
    base = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, use_mla=True,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return _cfgs(**base)


def _jax_params(module):
    """The module's parameters as the JAX package's nested dict."""
    tree = {}
    for name, p in module.named_parameters():
        node = tree
        *head, leaf = name.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


def _x(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, torch.from_numpy(x), jnp.asarray(x)


def _close(got, want, tol=MOE_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,shared,cf", [
    (2, 1, 8.0), (2, 1, 1.0), (2, 1, 0.5), (1, 0, 8.0), (4, 2, 1.0)])
def test_moe_block_matches_jax(top_k, shared, cf):
    jcfg, tcfg = _moe_cfgs(top_k=top_k, n_shared_experts=shared,
                           capacity_factor=cf)
    m = TMOE.MoE(tcfg, "cpu")
    TMOE.init_moe(m, torch.Generator().manual_seed(top_k))
    jp = _jax_params(m)
    _, tx, jx = _x((4, 32, 32), seed=top_k + shared)
    jout, jaux = J_MOE(jp, jx, jcfg)
    tout, taux = TMOE.moe_block(m, tx, tcfg)
    _close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the same routing: identical expert indices, gates within tolerance
    probs, gates, idx = TMOE.route(m, tx.reshape(-1, 32), tcfg)
    jlogits = jx.reshape(-1, 32) @ jp["router"]
    jg, jidx = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1), top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jg / jnp.sum(jg, -1, keepdims=True))
    # the capacity: cf 1.0 and 0.5 drop tokens, 8.0 drops none
    cap = TMOE._capacity(128, tcfg)
    assert cap == JMOE._capacity(128, jcfg)
    load = np.bincount(idx.numpy().reshape(-1), minlength=8)
    assert (load.max() > cap) == (cf < 8.0), (load, cap)
    # the dense oracle: the JAX package's, and equal to moe_block when
    # nothing is dropped
    dense = TMOE.moe_block_dense_ref(m, tx, tcfg)
    _close(dense, J_MOE_DENSE(jp, jx, jcfg))
    if cf == 8.0:
        _close(tout, dense)


def test_moe_aux_and_grads_follow_jax():
    jcfg, tcfg = _moe_cfgs(router_aux_weight=1.0, capacity_factor=1.0)
    m = TMOE.MoE(tcfg, "cpu")
    TMOE.init_moe(m, torch.Generator().manual_seed(5))
    jp = _jax_params(m)
    _, tx, jx = _x((2, 16, 32), seed=5)

    def jloss(p):
        out, aux = JMOE.moe_block(p, jx, jcfg)
        return jnp.sum(out ** 2) + aux
    want = jax.jit(jax.grad(jloss))(jp)
    m.requires_grad_()
    out, aux = TMOE.moe_block(m, tx, tcfg)
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(torch.sum(out ** 2) + aux,
                                list(params.values()))
    assert float(torch.abs(grads[0]).sum()) > 0      # the router learns
    for (name, _), g in zip(params.items(), grads):
        w = np.asarray(want[name] if "." not in name
                       else want["shared"][name.split(".")[1]])
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)
    # a collapsed router pays more aux loss, as in the JAX package
    with torch.no_grad():
        m.router.zero_()[:, 0] = 10.0
        assert float(TMOE.moe_block(m, tx, tcfg)[1]) > float(aux)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora_rank", [32, 0])
def test_mla_block_and_absorbed_decode_match_jax(q_lora_rank):
    jcfg, tcfg = _mla_cfgs(q_lora_rank=q_lora_rank)
    m = TMLA.MLA(tcfg, "cpu")
    TMLA.init_mla(m, torch.Generator().manual_seed(1))
    assert hasattr(m, "wq") == (not q_lora_rank)
    jp = _jax_params(m)
    s = 12
    _, tx, jx = _x((2, s, 64), seed=q_lora_rank)
    jout, (jc, jr) = J_MLA(jp, jx, jcfg, jnp.arange(s), return_cache=True)
    tout, (tc, tr) = TMLA.mla_block(m, tx, tcfg, torch.arange(s),
                                    return_cache=True)
    _close(tout, jout)
    _close(tc, jc)
    _close(tr, jr)
    jcache = (jnp.zeros((2, s, 16)), jnp.zeros((2, s, 8)))
    tcache = (torch.zeros(2, s, 16), torch.zeros(2, s, 8))
    jdecode = jax.jit(JMLA.mla_decode, static_argnums=(2,))
    ys = []
    for t in range(s):
        jy, jcache = jdecode(jp, jx[:, t:t + 1], jcfg, jcache,
                             jnp.asarray(t, jnp.int32))
        ty, tcache = TMLA.mla_decode(m, tx[:, t:t + 1], tcfg, tcache, t)
        _close(ty, jy)
        ys.append(ty)
    _close(tcache[0], jcache[0])
    _close(tcache[1], jcache[1])
    # the absorbed decode against the materialised prefill
    _close(torch.cat(ys, 1), tout, dict(rtol=1e-4, atol=1e-4))


def test_mla_flash_vjp_at_unlike_head_dims_matches_jax_grad():
    # S 16 above flash_threshold 8, chunk 4: q and k carry dn + dr = 24
    # values a head, v dv = 16; causal under both schedules
    for schedule in ("dense", "triangular"):
        jcfg, tcfg = _mla_cfgs(flash_threshold=8, attn_chunk=4,
                               attn_schedule=schedule)
        m = TMLA.MLA(tcfg, "cpu")
        TMLA.init_mla(m, torch.Generator().manual_seed(2))
        jp = _jax_params(m)
        _, tx, jx = _x((2, 16, 64), seed=3)
        pos = np.arange(16)

        def jloss(p):
            return jnp.sum(JMLA.mla_block(p, jx, jcfg, jnp.asarray(pos))
                           ** 2)
        jl, want = jax.jit(jax.value_and_grad(jloss))(jp)
        m.requires_grad_()
        params = dict(m.named_parameters())
        loss = torch.sum(TMLA.mla_block(m, tx, tcfg,
                                        torch.from_numpy(pos)) ** 2)
        _close(loss, jl, dict(rtol=1e-5, atol=0))
        for name, g in zip(params, torch.autograd.grad(
                loss, list(params.values()))):
            w = np.asarray(want[name])
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), \
                (schedule, name, err)


# ---------------------------------------------------------------------------
# conversion of a bf16 MoE stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_bf16_moe_params_round_trip_keeps_the_f32_router(arch):
    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    tcfg = get_config(arch, smoke=True).replace(param_dtype="bfloat16")
    jcfg = j_get_config(arch, smoke=True).replace(param_dtype="bfloat16")
    model = TM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    routers = [n for n, p in model.named_parameters() if "router" in n]
    assert routers and all(
        (p.dtype == torch.float32) == ("router" in n)
        for n, p in model.named_parameters())
    tree = convert.params_to_jax(model)
    # the JAX package's layout (its init promotes most matrices to f32
    # through a numpy-scalar scale; the port keeps param_dtype)
    shapes = jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(shapes)):
        assert a.shape == b.shape, path
        if "router" in jax.tree_util.keystr(path):
            assert b.dtype == jnp.float32, path
    # JAX arrays of the port's dtypes (bf16, the router f32) back into
    # the port: exact
    jtree = jax.tree_util.tree_map_with_path(lambda path, a: jnp.asarray(
        a, jnp.float32 if "router" in jax.tree_util.keystr(path)
        else jnp.bfloat16), tree)
    back = convert.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                                   "cpu")
    for (name, p), q in zip(model.named_parameters(), back.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name
    for a, b in zip(jax.tree.leaves(convert.params_to_jax(back)),
                    jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    # the decay mask: MLA's bare norms are exempt by their JAX paths
    paths = convert.jax_paths(model)
    if tcfg.use_mla:
        assert paths["layers.0.mixer.q_norm"] == "prefix_0/mixer/q_norm"
        assert paths["layers.1.ffn.router"] == "blocks/slot_0/ffn/router"
    else:
        assert paths["layers.1.ffn.shared.wo"] == \
            "blocks/slot_1/ffn/shared/wo"
