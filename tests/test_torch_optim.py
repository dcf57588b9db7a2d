"""The port's AdamW against the JAX package's ``repro.optim.adamw`` on
the same numpy parameters and gradients: several steps under each
schedule and moment dtype (clipping on some of them), the learning-rate
schedule, and the decay mask on JAX paths -- over every parameter of the
SSM and hybrid stacks too (the Mamba mixers' ``dt_bias``, ``A_log``,
``D`` and ``norm_scale``, zamba2's ``shared_attn`` subtree), whose JAX
paths ``convert.jax_paths`` gives.

OPT_TOL: f32 updates computed in the same order; XLA may contract a
multiply-add, so an ulp or two apart.  BF16_TOL: bf16 moments may round
to neighbouring bf16 values where the f32 results straddle a rounding
boundary (one bf16 ulp, 2^-8 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro_torch.optim import adamw as TO

OPT_TOL = dict(rtol=2e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-7)

#: a JAX-layout tree whose paths cover the decay mask's exemptions
SHAPES = {"blocks": {"slot_0": {"mixer": {"wq": (2, 6, 4), "bq": (2, 4)},
                                "norm1": {"scale": (2, 6)}}},
          "embed": {"table": (10, 6)}, "lm_head": {"w": (6, 10)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_apply_updates_matches_jax(schedule, moments):
    rng = np.random.default_rng(0)
    shapes = _flat(SHAPES)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
              moment_dtype=moments, clip_norm=4.0)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = _nest({k: jnp.asarray(v) for k, v in init.items()})
    js = JO.init_state(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ts = TO.init_state(tp, tcfg)
    tol = BF16_TOL if moments == "bfloat16" else OPT_TOL
    jstep = jax.jit(lambda p, g, st: JO.apply_updates(p, g, st, jcfg))
    for step in range(5):
        # gradients of norm ~2..8: clipped on some steps
        g = {k: (rng.normal(size=s) * (0.3 + step)).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = jstep(
            jp, _nest({k: jnp.asarray(v) for k, v in g.items()}), js)
        _, ts, tm = TO.apply_updates(
            tp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts,
            tcfg)
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **OPT_TOL)
        for k, v in _flat(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), v, **OPT_TOL,
                                       err_msg=k)
        for name in ("m", "v"):
            for k, v in _flat(js[name]).items():
                assert ts[name][k].dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    ts[name][k].float().numpy(),
                    np.asarray(v.astype(jnp.float32)), **tol, err_msg=k)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    steps = np.arange(0, 50, dtype=np.int32)
    want = np.asarray(JO.schedule_lr(JO.AdamWConfig(**kw),
                                     jnp.asarray(steps)))
    got = TO.schedule_lr(TO.AdamWConfig(**kw), torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, **OPT_TOL)


def test_decay_mask_reads_jax_paths():
    for path in ("blocks/slot_0/mixer/bq", "prefix_0/norm1/scale",
                 "final_norm/scale", "blocks/slot_0/mixer/bv"):
        assert not TO._decay_mask(path) and not JO._decay_mask(path)
    for path in ("blocks/slot_0/mixer/wq", "embed/table", "lm_head/w"):
        assert TO._decay_mask(path) and JO._decay_mask(path)
    # a module name never matches "/bq": the caller passes JAX paths
    assert TO._decay_mask("layers.3.mixer.bq")


@pytest.mark.parametrize("param_dtype,moments", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_update_in_chunks_is_bit_equal(monkeypatch, param_dtype, moments):
    # an update CHUNK values at a time (here 7, which divides no
    # parameter) gives the bits of one pass over each whole parameter;
    # its temporaries hold at most CHUNK values
    rng = np.random.default_rng(3)
    shapes = _flat(SHAPES)
    dt = getattr(torch, param_dtype)
    init = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dt) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dt) for k, s in shapes.items()} for _ in range(3)]
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, moment_dtype=moments)
    runs = []
    for chunk in (TO.CHUNK, 7):
        monkeypatch.setattr(TO, "CHUNK", chunk)
        p = {k: v.clone() for k, v in init.items()}
        st = TO.init_state(p, cfg)
        for g in grads:
            _, st, _ = TO.apply_updates(p, g, st, cfg)
        runs.append((p, st))
        sizes = {b.numel() for b in TO._leaf_buffers(
            p["embed/table"], st["m"]["embed/table"],
            st["v"]["embed/table"]) if b is not None}
        assert sizes == {min(chunk, 60)}
    (p0, s0), (p1, s1) = runs
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(s0["m"][k], s1["m"][k]), k
        assert torch.equal(s0["v"][k], s1["v"][k]), k


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_decay_mask_of_ssm_and_shared_parameters_matches_jax(arch):
    """Each parameter's JAX path is its leaf's path in the JAX tree, and
    the port's mask on it is the reference's: exactly the norms, biases,
    dt_bias, A_log and D are exempt."""
    from repro_torch.configs import get_config
    from repro_torch.models import convert
    from repro_torch.models.model import Model
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "meta")
    paths = convert.jax_paths(model)
    tree = convert.tree_like_jax(dict(model.named_parameters()), cfg)
    want = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert set(paths.values()) == want
    exempt = {p for p in want if not JO._decay_mask(p)}
    assert {p for p in want if not TO._decay_mask(p)} == exempt
    leaves = {p.rsplit("/", 1)[1] for p in exempt}
    assert {"dt_bias", "A_log", "D", "scale"} <= leaves
    assert not {"in_proj", "conv_w", "out_proj", "x_proj", "wq"} & leaves
    if cfg.hybrid_attn_period:
        assert "shared_attn/norm1/scale" in exempt
        assert "shared_attn/in_proj" in want - exempt
        assert "blocks/slot_1/mixer/norm_scale" in exempt
