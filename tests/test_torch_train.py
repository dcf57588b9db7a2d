"""The port's training path against the JAX package's, on the same numpy
inputs and the same weights (the port's seeded init, carried across as
numpy):

* the synthetic pipeline: batches, host slices and resume bit-equal;
* the flash VJP (``flash_attention_xla``'s backward) against ``jax.vjp``
  of the reference: dense and triangular schedules, causal / local /
  full, GQA, sk > sq, chunk < S -- within ATTN_TOL (2e-5) in f32;
* ``loss_fn`` and every parameter's gradient against ``jax.grad``
  (quickstart and gemma3-12b smoke configs with the flash path on,
  under remat and logit_chunk on and off, gemma3-12b in f32 and in its
  own bf16 compute over f32 parameters; the dense qwen / phi3 configs
  with one AdamW step) -- within GRAD_TOL (f32) or BF16_*;
* the MoE stacks (deepseek-v2-236b: MLA through the flash VJP at V
  head dim 16 against QK 24, a dense first layer; llama4-maverick: GQA,
  MoE every 2nd layer): ``loss_fn``, its ``aux_loss`` and every
  gradient against ``jax.grad`` under remat and logit chunks on and off,
  and 3 ``Trainer`` steps (bf16 AdamW moments, ``repro``'s META
  setting for both) against the JAX package's from one checkpoint;
* the SSM, hybrid and embedding-input stacks (falcon-mamba-7b: Mamba-1;
  zamba2-2.7b: Mamba-2 with the shared block, whose remat groups hold
  one application of it; musicgen-large and internvl2-26b on (B, S, D)
  embeddings), the attention through the flash VJP: ``loss_fn`` and
  every gradient against ``jax.grad`` under remat and logit chunks on
  and off, and 3 ``Trainer`` steps against the JAX package's from one
  checkpoint (embedding batches from the pipeline, as f32);
* ``Trainer``: 4 steps against the JAX package's ``Trainer`` from the
  same initial checkpoint (also at grad_accum 2, and 3 steps in bf16
  under chip_smoke.py's gemma3-12b optimizer), a JAX checkpoint
  resumed by the port and the port's restored by the JAX package,
  restart + serve, a falling loss, the fatal-step failure report, an
  out-of-memory error in the backward or part-way through the update
  retried to an unfaulted step's exact state, and the CLI.

The JAX references are built once per module (module-scoped fixtures).
GRAD_TOL: f32 gradients through a few layers, summed in another order;
each leaf's largest error is held to GRAD_TOL times that leaf's largest
magnitude (elements that nearly cancel, such as embedding rows summed
over repeated tokens, have no useful elementwise relative error); the
largest seen is 2e-6.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import train as TT
from repro_torch.launch.serve import ServeConfig, Server
from repro_torch.models import attention as TA
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from torch_parity import ATTN_TOL

GRAD_TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
#: Trainer metrics over 4 steps: the AdamW updates carry the gradients'
#: rounding into the next step's weights
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)


def _models(arch, seed=0, **replace):
    """The JAX package's and the port's smoke configs of ``arch`` (with
    ``replace``) and one set of weights for both: the port's seeded init
    carried across as numpy (faster than ``jax.random`` init on the
    CPU).  Returns (jax cfg, jax params, port cfg, port model)."""
    from repro.configs import get_config as j_get_config
    jcfg = j_get_config(arch, smoke=True).replace(**replace)
    tcfg = get_config(arch, smoke=True).replace(**replace)
    tm = TM.init(tcfg, torch.Generator().manual_seed(seed), "cpu")
    if tcfg.qkv_bias:  # non-zero biases, so their gradients show
        with torch.no_grad():
            for layer in tm.layers:
                for name in ("bq", "bk", "bv"):
                    getattr(layer.mixer, name).normal_(
                        0.0, 0.1, generator=torch.Generator().manual_seed(1))
    # JAX's own copy: on the CPU jnp.asarray aliases a numpy array, and
    # params_to_jax's unstacked leaves are views of the port's parameters,
    # which AdamW updates in place while a dispatched JAX step may still
    # be reading them
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      convert.params_to_jax(tm))
    return jcfg, jp, tcfg, tm


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _tree_close(got, want, tol, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), **tol,
                                       err_msg=f"{path}/{k}")


def _grads_close(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _grads_close(got[k], want[k], f"{path}/{k}")
            continue
        w = np.asarray(want[k])
        err = float(np.abs(np.asarray(got[k]) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), \
            f"{path}/{k}: error {err}, largest |gradient| {np.abs(w).max()}"


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,hosts", [
    (dict(vocab_size=1024, seq_len=64, global_batch=4), 1),
    (dict(vocab_size=512, seq_len=33, global_batch=6, seed=3), 3),
    (dict(vocab_size=300, seq_len=16, global_batch=2,
          input_mode="embeddings", d_model=8, motif_len=4, n_motifs=5), 1),
])
def test_pipeline_batches_bit_equal(kw, hosts):
    for host in range(hosts):
        j = JPipeline(JDataConfig(**kw), host, hosts)
        t = SyntheticPipeline(DataConfig(**kw), host, hosts)
        for _ in range(3):
            a, b = j.next_batch(), t.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
        # resume from the state dict: the next batch, bit for bit
        r = SyntheticPipeline(DataConfig(**kw), host, hosts)
        r.load_state_dict(t.state_dict())
        assert t.state_dict() == j.state_dict() == {"step": 3}
        want = j.next_batch()
        for k, v in r.next_batch().items():
            assert np.array_equal(v, want[k])
    with pytest.raises(ValueError, match="divide"):
        SyntheticPipeline(DataConfig(global_batch=4), 0, 3)


# ---------------------------------------------------------------------------
# the flash VJP
# ---------------------------------------------------------------------------

# (schedule, kind, window, heads, kv heads, sq, sk, chunk)
FLASH_CASES = [
    ("dense", "causal", 0, 4, 4, 32, 32, 8),
    ("dense", "local", 12, 4, 2, 32, 32, 8),
    ("dense", "full", 0, 4, 1, 32, 32, 16),
    ("dense", "causal", 0, 4, 2, 16, 32, 8),
    ("triangular", "causal", 0, 4, 2, 32, 32, 8),
    ("triangular", "local", 12, 4, 2, 32, 32, 8),
    ("triangular", "causal", 0, 2, 2, 16, 48, 8),
    ("triangular", "local", 10, 4, 2, 16, 48, 8),
    ("closed_form", "full", 0, 2, 2, 32, 32, 32),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_vjp_matches_jax(case):
    schedule, kind, window, h, hkv, sq, sk, chunk = case
    rng = np.random.default_rng(sq + sk + h)
    d = 16
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            [(2, h, sq, d), (2, hkv, sk, d), (2, hkv, sk, d), (2, h, sq, d)]]
    kw = dict(kind=kind, window=window, chunk=chunk, schedule=schedule)

    @jax.jit
    def ref(q, k, v, do):
        o, vjp = jax.vjp(
            lambda q, k, v: JA.flash_attention_xla(q, k, v, **kw), q, k, v)
        return o, vjp(do)
    o, want = ref(*map(jnp.asarray, arrs))
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
    out = TA.flash_attention_xla(*qkv, **kw)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(arrs[3]))
    _close(out, o, dict(rtol=ATTN_TOL["float32"], atol=ATTN_TOL["float32"]))
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=ATTN_TOL["float32"],
                          atol=ATTN_TOL["float32"]))
    # and against autograd through the port's simple_attention
    plain = torch.autograd.grad(
        TA.simple_attention(*qkv, kind=kind, window=window), qkv,
        torch.from_numpy(arrs[3]))
    for g, w in zip(got, plain):
        _close(g, w, dict(rtol=ATTN_TOL["float32"],
                          atol=ATTN_TOL["float32"]))


def test_flash_vjp_keeps_chunk_memory():
    """The backward saves q, k, v, o and lse (no S x S scores)."""
    q = torch.randn(1, 2, 64, 8, requires_grad=True)
    k = torch.randn(1, 2, 64, 8, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        TA.flash_attention_xla(q, k, k, chunk=16)
    assert max(int(np.prod(s)) for s in saved) == 64 * 2 * 8


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

#: case -> (arch, knobs): the flash path on at S 32 (chunk 8); the JAX
#: reference runs without remat and logit chunks, which change its
#: memory, not its values.  "gemma3-12b-bf16" keeps gemma3-12b's own
#: dtypes (bf16 compute over f32 parameters), held to BF16_* below.
GRAD_CASES = {
    "quickstart": ("quickstart", dict(flash_threshold=16, attn_chunk=8,
                                      remat=False, logit_chunk=0)),
    "gemma3-12b": ("gemma3-12b", dict(flash_threshold=16, remat=False,
                                      logit_chunk=0)),
    "gemma3-12b-bf16": ("gemma3-12b", dict(
        flash_threshold=16, remat=False, logit_chunk=0, dtype="bfloat16",
        param_dtype="float32")),
}
#: bf16 compute: the loss within BF16_LOSS_TOL (a mean in f32 of
#: bf16-rounded logits; 1.8e-4 seen), and each gradient leaf's largest
#: error from the reference's bf16 gradients at most BF16_GRAD_RATIO
#: times the reference's own bf16 error (its largest distance from its
#: f32 gradients, 2.5-4.7 % of the leaf's largest magnitude here); the
#: largest ratio seen is 1.31
BF16_LOSS_TOL = dict(rtol=1e-3, atol=0)
BF16_GRAD_RATIO = 2.0
#: 3 Trainer steps in bf16: the updates carry the gradients' bf16
#: rounding into the next step's weights (1.4e-3 seen)
BF16_TRAIN_TOL = dict(rtol=5e-3, atol=0)


def _batch(cfg, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    return float(total), jax.tree.map(np.asarray, grads)


def _port_grads(model, batch, cfg):
    model.requires_grad_()
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    total, metrics = TM.loss_fn(model, tb, cfg)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return total, metrics, dict(zip(params, grads))


def _bf16_grads_close(got, want, want32, path=""):
    for k in want:
        if isinstance(want[k], dict):
            _bf16_grads_close(got[k], want[k], want32[k], f"{path}/{k}")
            continue
        w = np.asarray(want[k]).astype(np.float32)
        err = float(np.abs(np.asarray(got[k]) - w).max())
        own = float(np.abs(w - np.asarray(want32[k])).max())
        assert err <= BF16_GRAD_RATIO * own, \
            f"{path}/{k}: error {err}, the reference's own bf16 error {own}"


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grad_ref(request):
    arch, knobs = GRAD_CASES[request.param]
    jcfg, jp, tcfg, tm = _models(arch, **knobs)
    batch = _batch(jcfg)
    f32 = (_jax_grads(jcfg.replace(dtype="float32"), jp, batch)[1]
           if jcfg.dtype == "bfloat16" else None)
    return tcfg, tm, batch, _jax_grads(jcfg, jp, batch), f32


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("logit_chunk", [8, 0])
def test_loss_and_grads_match_jax(grad_ref, remat, logit_chunk):
    tcfg, tm, batch, (jloss, jgrads), jgrads32 = grad_ref
    cfg = tcfg.replace(remat=remat, logit_chunk=logit_chunk)
    total, metrics, grads = _port_grads(tm, batch, cfg)
    assert float(metrics["tokens"]) == batch["labels"].size
    assert float(metrics["aux_loss"]) == 0.0
    grads = convert.tree_to_jax(grads, cfg)
    if jgrads32 is None:
        _close(total, jloss, LOSS_TOL)
        _grads_close(grads, jgrads)
    else:
        _close(total, jloss, BF16_LOSS_TOL)
        _bf16_grads_close(grads, jgrads, jgrads32)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "qwen2.5-32b",
                                  "phi3-mini-3.8b"])
def test_dense_configs_loss_grads_and_adamw_step(arch):
    from repro.configs import get_config as j_get_config
    for smoke in (True, False):
        t, j = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
    jcfg, jp, tcfg, tm = _models(arch)
    batch = _batch(jcfg)
    jloss, jgrads = _jax_grads(jcfg, jp, batch)
    total, _, grads = _port_grads(tm, batch, tcfg)
    _close(total, jloss, LOSS_TOL)
    _grads_close(convert.tree_to_jax(grads, tcfg), jgrads)
    # one AdamW step from the reference's gradients on both sides
    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jnew, jstate, jm = jax.jit(lambda p, g: JO.apply_updates(
        p, g, JO.init_state(p, JO.AdamWConfig(**ocfg)),
        JO.AdamWConfig(**ocfg)))(jp, jgrads)
    params = dict(tm.named_parameters())
    tgrads = {k: torch.from_numpy(np.array(v)) for k, v in zip(
        params, _per_layer(jgrads, tcfg, params))}
    with torch.no_grad():
        _, tstate, tmet = TO.apply_updates(
            params, tgrads, TO.init_state(params, TO.AdamWConfig(**ocfg)),
            TO.AdamWConfig(**ocfg), convert.jax_paths(tm))
    _close(tmet["grad_norm"], jm["grad_norm"], LOSS_TOL)
    _tree_close(convert.params_to_jax(tm), jax.tree.map(np.asarray, jnew),
                LOSS_TOL)
    _tree_close(convert.tree_to_jax(tstate["m"], tcfg),
                jax.tree.map(np.asarray, jstate["m"]), LOSS_TOL)
    if tcfg.qkv_bias:  # the biases are exempt from decay: /bq, /bk, /bv
        paths = convert.jax_paths(tm)
        assert paths["layers.1.mixer.bq"] == "blocks/slot_0/mixer/bq"
        assert not TO._decay_mask(paths["layers.1.mixer.bq"])


def _per_layer(tree, cfg, params):
    """A JAX-layout tree's leaves in ``params``' order (port names)."""
    flat = {}
    for name, t in params.items():
        flat[name] = torch.empty(t.shape)
    convert.fill_from_jax(flat, tree, cfg)
    return [flat[name].numpy() for name in params]


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _pipe(pkg_cfg, pkg_pipe, cfg, seq_len=32, batch=4):
    return pkg_pipe(pkg_cfg(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=batch))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's Trainer from one initial checkpoint (step 0,
    parameters only): 7 steps at grad_accum 1 with a checkpoint every 4
    (at step 4, and 7 at exit), and 4 steps at grad_accum 2."""
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import Trainer as JTrainer
    jcfg, jp, tcfg, _ = _models("quickstart")
    init = tmp_path_factory.mktemp("init")
    JManager(str(init)).save(0, jax.tree.map(np.asarray, jp))
    runs = {}
    for accum, steps, every in ((1, 7, 4), (2, 4, 0)):
        d = tmp_path_factory.mktemp(f"jax_accum{accum}")
        shutil.copytree(init, d, dirs_exist_ok=True)
        jt = JTrainer(jcfg, JTrainConfig(
            steps=steps, grad_accum=accum, log_every=100, ckpt_every=every,
            ckpt_dir=str(d), optimizer=JO.AdamWConfig(lr=1e-3,
                                                      warmup_steps=2,
                                                      total_steps=8)))
        _, _, hist = jt.run(_pipe(JDataConfig, JPipeline, jcfg))
        runs[accum] = (d, hist)
    return jcfg, tcfg, init, runs


def _port_trainer(cfg, d, accum=1, steps=4, **kw):
    return TT.Trainer(cfg, TT.TrainConfig(
        steps=steps, grad_accum=accum, log_every=100, ckpt_dir=str(d),
        optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
        **kw), device="cpu")


def _metrics_close(got, want):
    for key in ("loss", "grad_norm", "lr", "aux_loss", "tokens"):
        _close(np.array([h[key] for h in got]),
               np.array([h[key] for h in want]), TRAIN_TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax_trainer(jax_runs, tmp_path, accum):
    _, tcfg, init, runs = jax_runs
    shutil.copytree(init, tmp_path, dirs_exist_ok=True)
    _, _, hist = _port_trainer(tcfg, tmp_path, accum).run(
        _pipe(DataConfig, SyntheticPipeline, tcfg))
    assert len(hist) == 4
    _metrics_close(hist, runs[accum][1][:4])
    if accum == 2:  # the JAX package's metrics under accumulation
        assert all(h["tokens"] == 0.0 and h["aux_loss"] == 0.0
                   for h in hist)


def test_bf16_first_steps_match_jax_trainer(tmp_path):
    """gemma3-12b's own dtypes (bf16 compute over f32 parameters), the
    flash path, remat and logit chunks on, under the optimizer of
    chip_smoke.py's gemma3-12b run (lr 1e-4 at full rate from the first
    step, 3 steps): the port's Trainer and the JAX package's, from one
    initial checkpoint, give the same losses and grad norms within
    BF16_TRAIN_TOL.  Run with ``-s`` to see them."""
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import Trainer as JTrainer
    jcfg, jp, tcfg, _ = _models("gemma3-12b", flash_threshold=16,
                                remat=True, logit_chunk=8, dtype="bfloat16",
                                param_dtype="float32")
    JManager(str(tmp_path / "jax")).save(0, jax.tree.map(np.asarray, jp))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    opt = dict(lr=1e-4, warmup_steps=1, total_steps=3)
    data = dict(vocab_size=jcfg.vocab_size, seq_len=64, global_batch=1)
    _, _, want = JTrainer(jcfg, JTrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "jax"),
        optimizer=JO.AdamWConfig(**opt))).run(JPipeline(JDataConfig(**data)))
    _, _, got = TT.Trainer(tcfg, TT.TrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "port"),
        optimizer=TO.AdamWConfig(**opt)), device="cpu").run(
            SyntheticPipeline(DataConfig(**data)))
    for key in ("loss", "grad_norm"):
        print(key, "jax", [float(h[key]) for h in want], "port",
              [h[key] for h in got])
        _close(np.array([h[key] for h in got]),
               np.array([float(h[key]) for h in want]), BF16_TRAIN_TOL)


#: the MoE stacks at S 32 with the flash path on (chunk 8): deepseek-v2's
#: MLA runs the flash VJP at V head dim 16 against QK 24
MOE_GRAD_KNOBS = dict(flash_threshold=16, attn_chunk=8, remat=False,
                      logit_chunk=0)


@pytest.fixture(scope="module", params=["deepseek-v2-236b",
                                        "llama4-maverick-400b-a17b"])
def moe_grad_ref(request):
    jcfg, jp, tcfg, tm = _models(request.param, **MOE_GRAD_KNOBS)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    return tcfg, tm, batch, float(total), float(metrics["aux_loss"]), \
        jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat,logit_chunk", [(True, 8), (False, 0)])
def test_moe_loss_aux_and_grads_match_jax(moe_grad_ref, remat, logit_chunk):
    tcfg, tm, batch, jloss, jaux, jgrads = moe_grad_ref
    cfg = tcfg.replace(remat=remat, logit_chunk=logit_chunk)
    total, metrics, grads = _port_grads(tm, batch, cfg)
    assert jaux > 0
    _close(metrics["aux_loss"], jaux, LOSS_TOL)
    _close(total, jloss, LOSS_TOL)
    _close(total, (metrics["loss"] + metrics["aux_loss"]).detach(),
           LOSS_TOL)
    grads = convert.tree_to_jax(grads, cfg)
    _grads_close(grads, jgrads)
    routers = [k for k in grads["blocks"]["slot_0" if tcfg.use_mla
                                          else "slot_1"]["ffn"]]
    assert "router" in routers


@pytest.mark.parametrize("arch", ["deepseek-v2-236b"])
def test_moe_trainer_matches_jax_trainer(arch, tmp_path):
    """3 steps of each package's Trainer from one initial checkpoint,
    bf16 AdamW moments: the same losses, aux losses and grad norms
    (deepseek-v2: MLA and MoE behind a dense first layer; llama4's
    period-2 groups are held by the gradient test above)."""
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import Trainer as JTrainer
    jcfg, jp, tcfg, _ = _models(arch, **MOE_GRAD_KNOBS)
    JManager(str(tmp_path / "jax")).save(0, jax.tree.map(np.asarray, jp))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3,
               moment_dtype="bfloat16")
    _, _, want = JTrainer(jcfg, JTrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "jax"),
        optimizer=JO.AdamWConfig(**opt))).run(
        _pipe(JDataConfig, JPipeline, jcfg))
    _, opt_state, got = TT.Trainer(tcfg, TT.TrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "port"),
        optimizer=TO.AdamWConfig(**opt)), device="cpu").run(
            _pipe(DataConfig, SyntheticPipeline, tcfg))
    assert all(h["aux_loss"] > 0 for h in got)
    assert opt_state["m"]["layers.1.ffn.wi"].dtype == torch.bfloat16
    _metrics_close(got, [{k: float(v) for k, v in h.items()} for h in want])


def test_checkpoints_cross_between_the_packages(jax_runs, tmp_path):
    jcfg, tcfg, _, runs = jax_runs
    jdir, jhist = runs[1]
    # the JAX checkpoint at step 4 (5 updates taken, pipeline at batch
    # 5) resumes in the port: its steps 4, 5 are the JAX run's 5, 6
    shutil.copytree(os.path.join(jdir, "step_0000000004"),
                    tmp_path / "step_0000000004")
    pipe = _pipe(DataConfig, SyntheticPipeline, tcfg)
    tr = _port_trainer(tcfg, tmp_path, steps=7)
    step, model, opt = tr.restore_or_init(pipe)
    assert step == 4 and pipe.state_dict() == {"step": 5}
    assert int(opt["count"]) == 5
    model, opt, hist = tr.run(_pipe(DataConfig, SyntheticPipeline, tcfg))
    assert len(hist) == 3
    _metrics_close(hist[:2], jhist[5:7])
    # the port's checkpoint (step 7) restores in the JAX package
    abs_p = JM.abstract_init(jcfg)
    s, jp, jopt, meta = JManager(str(tmp_path)).restore(
        None, abs_p, JO.init_state(abs_p, JO.AdamWConfig()))
    assert s == 7 and meta["data_state"] == {"step": 8}
    _tree_close(jax.tree.map(np.asarray, jp), convert.params_to_jax(model),
                dict(rtol=0, atol=0))
    assert int(jopt["count"]) == 8
    _tree_close(jax.tree.map(np.asarray, jopt["v"]),
                convert.tree_to_jax(opt["v"], tcfg), dict(rtol=0, atol=0))


def test_train_restart_serve_roundtrip(tmp_path):
    cfg = get_config("quickstart", smoke=True)
    tcfg = TT.TrainConfig(steps=8, log_every=100, ckpt_every=4,
                          ckpt_dir=str(tmp_path),
                          optimizer=TO.AdamWConfig(lr=1e-3, total_steps=8))

    def pipe():
        return SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))

    # phase 1: train to step 8 (checkpoints at 4 and exit)
    t1 = TT.Trainer(cfg, tcfg, device="cpu")
    _, _, hist1 = t1.run(pipe())
    assert len(hist1) == 8
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8]

    # phase 2: restart -- must resume at 8 with the next batch, train 4 more
    tcfg2 = TT.TrainConfig(steps=12, log_every=100, ckpt_dir=str(tmp_path),
                           optimizer=TO.AdamWConfig(lr=1e-3, total_steps=12))
    p2 = pipe()
    t2 = TT.Trainer(cfg, tcfg2, device="cpu")
    step, _, opt = t2.restore_or_init(p2)
    assert step == 8 and p2.state_dict() == {"step": 8}
    assert int(opt["count"]) == 8
    _, _, hist2 = t2.run(p2)
    assert len(hist2) == 4  # only the remaining steps

    # phase 3: serve from the final checkpoint
    mgr = CheckpointManager(str(tmp_path))
    shapes = dict(TM.Model(cfg, "meta").named_parameters())
    _, tree, _, _ = mgr.restore(None, convert.tree_like_jax(shapes, cfg))
    model = convert.params_from_jax(tree, cfg, "cpu")
    server = Server(cfg, model, ServeConfig(max_len=48, temperature=0.0))
    out = server.generate(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)),
        max_new=4)
    assert out.shape == (2, 4)
    assert (out >= 0).all() and (out < cfg.padded_vocab).all()


def test_loss_improves_on_learnable_data(tmp_path):
    cfg = get_config("quickstart", smoke=True)
    tcfg = TT.TrainConfig(steps=25, log_every=100, ckpt_dir=str(tmp_path),
                          optimizer=TO.AdamWConfig(lr=5e-3, warmup_steps=3,
                                                   total_steps=25))
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=64, global_batch=4))
    _, _, hist = TT.Trainer(cfg, tcfg, device="cpu").run(pipe)
    assert np.mean([h["loss"] for h in hist[-5:]]) < \
        np.mean([h["loss"] for h in hist[:5]])


def test_trainer_writes_failure_report_on_fatal_step(tmp_path):
    cfg = get_config("quickstart", smoke=True)
    tcfg = TT.TrainConfig(steps=2, log_every=100, ckpt_dir=str(tmp_path),
                          step_retries=1, retry_backoff_s=0.0)
    tr = TT.Trainer(cfg, tcfg, device="cpu")
    tr._step = lambda p, o, b: (_ for _ in ()).throw(
        ValueError("injected fatal shape error"))
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=2))
    with pytest.raises(ValueError):
        tr.run(pipe)
    reports = [f for f in os.listdir(tmp_path)
               if f.startswith("failure_step_")]
    assert reports
    rep = json.load(open(tmp_path / reports[0]))
    assert rep["classification"] == "fatal"


def _run_state(tmp_path, name):
    cfg = get_config("quickstart", smoke=True)
    tr = TT.Trainer(cfg, TT.TrainConfig(
        steps=2, log_every=100, ckpt_dir=str(tmp_path / name),
        retry_backoff_s=0.0, optimizer=TO.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=4)), device="cpu")
    model, opt, hist = tr.run(SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)))
    return dict(model.named_parameters()), opt, hist


#: where an out-of-memory error strikes in the second of two steps:
#: after the backward filled the gradients, or in the update's
#: temporaries of its first, tenth or last parameter (the earlier ones
#: already written); the retried step must equal an unfaulted one
RETRY_SITES = [("backward", 1), ("update", 0), ("update", 9),
               ("update", -1)]


@pytest.mark.parametrize("site,at", RETRY_SITES)
def test_retried_step_equals_unfaulted_step(tmp_path, monkeypatch, site,
                                            at):
    want_p, want_o, want_h = _run_state(tmp_path, "clean")
    n, calls = len(want_p), []
    if site == "backward":  # loss_fn's call ``at`` is step 1's first
        def loss_fn(model, batch, cfg):
            calls.append(None)
            loss, metrics = TM.loss_fn(model, batch, cfg)
            if len(calls) - 1 == at:
                loss.backward()  # the gradients filled, then the fault
                raise torch.OutOfMemoryError("injected out of memory")
            return loss, metrics
        monkeypatch.setattr(TT, "loss_fn", loss_fn)
        want_calls = 3
    else:  # the update's temporaries of step 1's parameter ``at``
        real = TO._leaf_buffers

        def leaf_buffers(*args):
            calls.append(None)
            if len(calls) - 1 == n + at % n:
                raise torch.OutOfMemoryError("injected out of memory")
            return real(*args)
        monkeypatch.setattr(TO, "_leaf_buffers", leaf_buffers)
        want_calls = 2 * n + 1
    got_p, got_o, got_h = _run_state(tmp_path, "faulted")
    assert len(calls) == want_calls  # it struck once, and was retried
    assert got_h == [{**h, "step_time_s": g["step_time_s"]}
                     for h, g in zip(want_h, got_h)]
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
        assert torch.equal(got_o["m"][k], want_o["m"][k]), k
        assert torch.equal(got_o["v"][k], want_o["v"][k]), k
    assert int(got_o["count"]) == int(want_o["count"]) == 2


def test_first_steps_example_runs_on_the_cpu(capsys):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch_first_steps.py")
    spec = importlib.util.spec_from_file_location("torch_first_steps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--smoke", "--device", "cpu", "--only", "as_run,lr_tenth"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["variant"] for r in rows] == ["as_run", "lr_tenth"]
    for r in rows:  # one seeded start: the same loss before any update
        assert len(r["losses"]) == 3 and len(r["first_batch_losses"]) == 4
        assert r["first_batch_losses"][0] == rows[0]["losses"][0]
        assert r["peak_gib"] is None


def test_trainer_refusals_and_cli(tmp_path, capsys):
    cfg = get_config("quickstart", smoke=True)
    for kw in (dict(fsdp=True), dict(seq_shard_acts=True)):
        # mesh layouts: on one device they change nothing, as in repro
        tr = TT.Trainer(cfg, TT.TrainConfig(ckpt_dir=str(tmp_path), **kw),
                        device="cpu")
        assert tr.mesh is None and tr.param_specs is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        TT.Trainer(cfg, TT.TrainConfig(ckpt_dir=str(tmp_path)),
                   mesh=object(), device="cpu")
    for kw in (dict(ssm_kind="mamba2"), dict(input_mode="embeddings")):
        # every mixer and input mode of the JAX package trains
        TT.Trainer(cfg.replace(**kw), TT.TrainConfig(ckpt_dir=str(tmp_path)),
                   device="cpu")
    args = ["--arch", "quickstart", "--smoke", "--steps", "2",
            "--global-batch", "2", "--seq-len", "16", "--ckpt-dir",
            str(tmp_path / "cli")]
    if not torch.cuda.is_available():  # no silent move to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.main(args)
    TT.main(args + ["--device", "cpu", "--grad-accum", "2"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "step 0: loss=" in out
    assert CheckpointManager(str(tmp_path / "cli")).all_steps() == [2]


# ---------------------------------------------------------------------------
# the SSM, hybrid and embedding-input stacks
# ---------------------------------------------------------------------------

SSM_ARCHS = ["falcon-mamba-7b", "zamba2-2.7b", "musicgen-large",
             "internvl2-26b"]
#: S 32 in chunks of 16 (the smoke ssd_chunk), the attention through the
#: flash path (chunk 8)
SSM_KNOBS = dict(flash_threshold=16, attn_chunk=8, remat=False,
                 logit_chunk=0)


def _ssm_batch(cfg, seed=0):
    batch = _batch(cfg, seed=seed)
    if cfg.input_mode == "embeddings":
        batch["inputs"] = np.random.default_rng(seed + 1).normal(
            size=batch["inputs"].shape + (cfg.d_model,)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_grad_ref(request):
    jcfg, jp, tcfg, tm = _models(request.param, **SSM_KNOBS)
    batch = _ssm_batch(jcfg)
    return tcfg, tm, batch, _jax_grads(jcfg, jp, batch)


@pytest.mark.parametrize("remat,logit_chunk", [(True, 8), (False, 0)])
def test_ssm_loss_and_grads_match_jax(ssm_grad_ref, remat, logit_chunk):
    tcfg, tm, batch, (jloss, jgrads) = ssm_grad_ref
    cfg = tcfg.replace(remat=remat, logit_chunk=logit_chunk)
    total, metrics, grads = _port_grads(tm, batch, cfg)
    assert float(metrics["tokens"]) == batch["labels"].size
    _close(total, jloss, LOSS_TOL)
    _grads_close(convert.tree_to_jax(grads, cfg), jgrads)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_trainer_matches_jax_trainer(arch, tmp_path):
    """3 steps of each package's Trainer from one initial checkpoint:
    the same losses and grad norms (remat on; embedding batches from
    the pipeline's embeddings mode)."""
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import Trainer as JTrainer
    jcfg, jp, tcfg, _ = _models(arch, **{**SSM_KNOBS, "remat": True})
    JManager(str(tmp_path / "jax")).save(0, jax.tree.map(np.asarray, jp))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    data = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=2,
                input_mode=jcfg.input_mode, d_model=jcfg.d_model)
    _, _, want = JTrainer(jcfg, JTrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "jax"),
        optimizer=JO.AdamWConfig(**opt))).run(JPipeline(JDataConfig(**data)))
    _, _, got = TT.Trainer(tcfg, TT.TrainConfig(
        steps=3, log_every=100, ckpt_dir=str(tmp_path / "port"),
        optimizer=TO.AdamWConfig(**opt)), device="cpu").run(
            SyntheticPipeline(DataConfig(**data)))
    assert len(got) == 3
    _metrics_close(got, [{k: float(v) for k, v in h.items()} for h in want])
