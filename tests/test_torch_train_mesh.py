"""Training on a mesh over gloo ranks on the CPU, against the JAX
package's single-device ``Trainer`` on the same weights and batches
(the JAX package's mesh step does not run on this jax, ROADMAP C2):

* quickstart smoke on 2x1 (DP), 1x2 (TP), 2x2 (DP+TP), 2x1 and 2x2 under
  ``fsdp``, a (pod, data, model) = (2, 2, 1) mesh under ``fsdp`` (the
  batch over pod x data, the FSDP leaves over data and summed over pod),
  and ``grad_accum`` 2 on 2x1 (aux_loss and tokens 0, as the JAX
  package reports them);
* gemma3-12b smoke on 1x2 under ``seq_shard_acts``, with and without
  ``megatron_sp``; falcon-mamba-7b smoke on 1x2 under ``seq_shard_acts``
  (the Mamba-1 scans on the whole sequence); deepseek-v2 smoke on 2x1
  under ``fsdp`` (MLA, the MoE routing the global batch: its loss and
  aux loss are the single-device run's; f32 moments here, as bf16 ones
  put the JAX package's and the port's single-device parameters ~2 lr
  apart already, PR 25's ``test_moe_trainer_matches_jax_trainer`` holds
  its metrics under bf16 moments);
* per-step loss, aux loss, grad norm and tokens within rtol 1e-4 (the
  JAX package's own ``tests/test_distributed.py`` states it), every rank
  the same losses, and the final parameters within PARAM_TOL;
* the 2x2 run's checkpoint restores bit-equal on one device and in the
  JAX package's ``Trainer``, and resumes on a 1x2 mesh as on one device;
  a SIGTERM on one rank checkpoints on every rank at one step;
* ``_dims`` / ``shard_tensor`` of a dimension cut over several axes hold
  JAX's placement (a 4-device subprocess's ``devices_indices_map``);
  ``constrain`` and its kin are no-ops without specs.

AdamW's eps is 1e-5 in these runs: at the default 1e-8 an element whose
gradient is near 1e-8 takes a step of up to lr whose sign follows its
gradient's rounding, so two runs that add their gradients in another
order differ there by up to 2 lr.  With eps the update moves by at most
lr times the gradient's difference over eps: gradients that differ by
~1e-10 then move the parameters by ~1e-8 a step (1e-6 left 2.8e-5 on
the embedding of a 1x2 quickstart run, ~10x less here).

Each world of ranks runs once per module (one ``run_ranks`` per world
size, every case of it a run inside); rank bodies are in
``tests/torch_train_mesh_ranks.py`` (no JAX)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_train_mesh_ranks as R
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import sharding as SH
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO

#: per-step metrics against the JAX package's single-device Trainer
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
#: final parameters: the gradients' rounding, carried through 3 AdamW
#: steps at lr 1e-3; the largest seen is 9e-6
PARAM_TOL = dict(rtol=0, atol=3e-5)
STEPS, BATCH, SEQ = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-5)

#: name -> (arch, config replace, TrainConfig fields, moments)
REFS = {
    "quickstart": ("quickstart", {}, {}, "float32"),
    "quickstart-accum": ("quickstart", {}, {"grad_accum": 2}, "float32"),
    "gemma3": ("gemma3-12b", {}, {}, "float32"),
    "falcon-mamba": ("falcon-mamba-7b", {}, {}, "float32"),
    "deepseek": ("deepseek-v2-236b", {}, {}, "float32"),
}
#: case -> (reference, mesh shape, config replace, TrainConfig fields)
CASES = {
    "quickstart-2x1": ("quickstart", (2, 1), {}, {}),
    "quickstart-1x2": ("quickstart", (1, 2), {}, {}),
    "quickstart-2x2": ("quickstart", (2, 2), {}, {}),
    "quickstart-fsdp-2x1": ("quickstart", (2, 1), {}, {"fsdp": True}),
    "quickstart-fsdp-2x2": ("quickstart", (2, 2), {}, {"fsdp": True}),
    "quickstart-fsdp-pod-2x2x1": ("quickstart", (2, 2, 1), {},
                                  {"fsdp": True}),
    "quickstart-accum-2x1": ("quickstart-accum", (2, 1), {},
                             {"grad_accum": 2}),
    "gemma3-sp-1x2": ("gemma3", (1, 2), {}, {"seq_shard_acts": True}),
    "gemma3-sp-megatron-1x2": ("gemma3", (1, 2), {"megatron_sp": True},
                               {"seq_shard_acts": True}),
    "falcon-mamba-sp-1x2": ("falcon-mamba", (1, 2), {},
                            {"seq_shard_acts": True}),
    "deepseek-fsdp-2x1": ("deepseek", (2, 1), {}, {"fsdp": True}),
}


def _opt(moments):
    return dict(OPT, moment_dtype=moments)


def _like(cfg):
    return convert.tree_like_jax(
        dict(TM.Model(cfg, "meta").named_parameters()), cfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _restore(d, cfg):
    """(step, params, opt state, meta) of the latest checkpoint in ``d``
    (the JAX package's layout, flat numpy)."""
    like = _like(cfg)
    step, p, o, meta = CheckpointManager(str(d)).restore(
        None, like, {"m": like, "v": like, "count": np.zeros((), np.int32)})
    return step, _flat(p), o, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The step-0 checkpoints (the port's seeded smoke init, as numpy),
    the JAX package's single-device Trainer from each, and the two
    worlds of ranks: the 4-rank one (2x2 runs, the pod mesh) first, then
    the 2-rank one, which also resumes the 2x2 checkpoint on 1x2 and
    runs the SIGTERM case."""
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import Trainer as JTrainer
    root = tmp_path_factory.mktemp("train_mesh")
    inits, refs = {}, {}
    for name, (arch, replace, tkw, moments) in REFS.items():
        cfg = get_config(arch, smoke=True).replace(**replace)
        init = root / f"init-{arch}"
        if arch not in inits:
            tm = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
            CheckpointManager(str(init)).save(0, convert.params_to_jax(tm))
            inits[arch] = init
        d = root / f"jax-{name}"
        shutil.copytree(inits[arch], d)
        from repro.configs import get_config as j_get_config
        jcfg = j_get_config(arch, smoke=True).replace(**replace)
        _, _, hist = JTrainer(jcfg, JTrainConfig(
            steps=STEPS, log_every=100, ckpt_dir=str(d), **tkw,
            optimizer=JO.AdamWConfig(**_opt(moments)))).run(
            JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH)))
        refs[name] = ([{k: float(v) for k, v in h.items()} for h in hist],
                      _restore(d, cfg)[1])

    def run_of(case, name=None, steps=STEPS, start=None):
        ref, shape, replace, tkw = CASES[case]
        arch, _, _, moments = REFS[ref]
        d = root / (name or case)
        shutil.copytree(start or inits[arch], d)
        return dict(arch=arch, replace=replace, shape=shape,
                    tcfg=dict(steps=steps, **tkw), opt=_opt(moments),
                    ckpt=str(d), seq=SEQ, batch=BATCH)
    four = [c for c in CASES if np.prod(CASES[c][1]) == 4]
    two = [c for c in CASES if np.prod(CASES[c][1]) == 2]
    res = run_ranks(R.train, 4, [run_of(c) for c in four])
    got = {c: [r[i] for r in res] for i, c in enumerate(four)}
    # the 2x2 checkpoint (step 3) resumed on 1x2 for one more step
    resume = run_of("quickstart-1x2", "resume", STEPS + 1,
                    root / "quickstart-2x2")
    sigterm = dict(run_of("quickstart-2x1", "sigterm", STEPS + 2),
                   sigterm_rank=1, sigterm_step=1)
    res = run_ranks(R.train, 2, [run_of(c) for c in two]
                    + [resume, sigterm])
    got.update({c: [r[i] for r in res]
                for i, c in enumerate(two + ["resume", "sigterm"])})
    return dict(root=root, refs=refs, got=got)


def _metrics_close(got, want, what):
    assert len(got) == len(want), what
    for key in ("loss", "aux_loss", "grad_norm", "lr", "tokens"):
        np.testing.assert_allclose(
            np.array([h[key] for h in got]), np.array([h[key] for h in want]),
            **METRIC_TOL, err_msg=f"{what}: {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_trainer_matches_jax_trainer(runs, case):
    ref, shape, _, tkw = CASES[case]
    want_hist, want_params = runs["refs"][ref]
    ranks = runs["got"][case]
    assert all(r["same"] for r in ranks), case
    _metrics_close(ranks[0]["hist"], want_hist, case)
    if tkw.get("grad_accum", 1) > 1:
        assert all(h["tokens"] == 0.0 and h["aux_loss"] == 0.0
                   for h in ranks[0]["hist"])
    if ref == "deepseek":
        assert all(h["aux_loss"] > 0 for h in ranks[0]["hist"])
    arch = REFS[ref][0]
    cfg = get_config(arch, smoke=True)
    step, params, _, _ = _restore(runs["root"] / case, cfg)
    assert step == STEPS
    for k, w in want_params.items():
        np.testing.assert_allclose(params[k], w, **PARAM_TOL,
                                   err_msg=f"{case} {k}")


def test_mesh_checkpoint_resumes_on_one_device_in_jax_and_on_1x2(runs):
    """The 2x2 run's final checkpoint: the port's one-device Trainer and
    the JAX package's restore it bit-equal (parameters, moments, count,
    pipeline state); one more step on a 1x2 mesh from it equals one more
    step on one device."""
    cfg = get_config("quickstart", smoke=True)
    d = runs["root"] / "quickstart-2x2"
    step, params, opt, meta = _restore(d, cfg)
    assert step == STEPS and meta["data_state"] == {"step": STEPS}
    assert int(opt["count"]) == STEPS
    # the port on one device
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=SEQ, global_batch=BATCH))
    one = TT.Trainer(cfg, TT.TrainConfig(
        steps=STEPS + 1, log_every=100, ckpt_dir=str(d),
        optimizer=TO.AdamWConfig(**OPT)), device="cpu")
    s, model, ostate = one.restore_or_init(pipe)
    assert s == STEPS and pipe.state_dict() == {"step": STEPS}
    got = _flat(convert.params_to_jax(model))
    for k, w in params.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    np.testing.assert_array_equal(
        _flat(convert.tree_to_jax(ostate["v"], cfg))["embed/table"],
        _flat(opt["v"])["embed/table"])
    # the JAX package
    abs_p = JM.abstract_init(
        __import__("repro.configs", fromlist=["get_config"]).get_config(
            "quickstart", smoke=True))
    js, jp, jopt, _ = JManager(str(d)).restore(
        None, abs_p, JO.init_state(abs_p, JO.AdamWConfig()))
    assert js == STEPS and int(jopt["count"]) == STEPS
    for k, w in _flat(jp).items():
        np.testing.assert_array_equal(w, params[k], err_msg=k)
    # one more step on one device against the 1x2 mesh's
    shutil.copytree(d, runs["root"] / "resume-one")
    one = TT.Trainer(cfg, TT.TrainConfig(
        steps=STEPS + 1, log_every=100,
        ckpt_dir=str(runs["root"] / "resume-one"),
        optimizer=TO.AdamWConfig(**OPT)), device="cpu")
    _, _, hist = one.run(SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)))
    mesh_hist = runs["got"]["resume"][0]["hist"]
    assert len(hist) == len(mesh_hist) == 1
    _metrics_close(mesh_hist, hist, "resume on 1x2")
    _, want, _, _ = _restore(runs["root"] / "resume-one", cfg)
    _, got, _, _ = _restore(runs["root"] / "resume", cfg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **PARAM_TOL, err_msg=k)


def test_sigterm_on_one_rank_checkpoints_on_all(runs):
    """Rank 1 receives SIGTERM during step 1: both ranks stop after it,
    and rank 0 writes the checkpoint of step 1 (the step it was in)."""
    res = runs["got"]["sigterm"]
    assert [len(r["hist"]) for r in res] == [2, 2]
    cfg = get_config("quickstart", smoke=True)
    assert CheckpointManager(str(runs["root"] / "sigterm")).all_steps() \
        == [0, 1]
    step, _, _, meta = _restore(runs["root"] / "sigterm", cfg)
    assert step == 1 and meta["data_state"] == {"step": 2}


#: (mesh shape, axis names, spec, global shape)
PLACEMENTS = [
    ((2, 2, 1), ("pod", "data", "model"), (("pod", "data"), None), (8, 3)),
    ((2, 2, 1), ("pod", "data", "model"), (None, ("pod", "data")), (2, 12)),
    ((2, 2), ("data", "model"), (("data", "model"),), (12,)),
    ((2, 2), ("data", "model"), ("model", ("data",)), (4, 6)),
]

_JAX_PLACEMENT = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for shape, axes, spec, gshape in cases:
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(gshape))
    out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(idx[d], gshape)]
                for d in mesh.devices.flat])
print(json.dumps(out))
"""


def test_multi_axis_dims_hold_jax_placement(tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_PLACEMENT, json.dumps(
            [[s, a, [list(e) if isinstance(e, tuple) else e for e in sp], g]
             for s, a, sp, g in PLACEMENTS])],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    res = run_ranks(R.placement, 4, [(s, sp, g) for s, _, sp, g in
                                     PLACEMENTS])
    for i, ((_, _, spec, gshape), bounds) in enumerate(zip(PLACEMENTS,
                                                          want)):
        full = np.arange(int(np.prod(gshape)), dtype=np.float32).reshape(
            gshape)
        for rank, (piece, dims, whole) in enumerate(r[i] for r in res):
            sl = tuple(slice(lo, hi) for lo, hi in bounds[rank])
            np.testing.assert_array_equal(piece, full[sl],
                                          err_msg=f"{spec} rank {rank}")
            np.testing.assert_array_equal(whole, full)
            assert all(isinstance(a, (str, tuple)) for _, a, _, _ in dims)


def test_constrain_and_kin_are_no_ops_without_specs():
    x = torch.randn(2, 8, 4)
    for name in ("residual", "mlp_hidden", "attn_heads", "moe_tokens",
                 "moe_experts"):
        assert SH.constrain(x, name) is x
    assert SH.whole_sequence(x) is x
    xg, rows = SH.global_tokens(x)
    assert xg is x and rows is None and SH.local_rows(x, rows) is x
    stand_in = type("Mesh", (), {"shape": {"data": 2, "model": 2},
                                 "axis_names": ("data", "model")})()
    specs = SH.act_specs(stand_in, seq_shard=True)
    with SH.activation_specs(specs):
        assert SH._ACT_SPECS.get() is specs
        # the names the port computes in place stay no-ops under specs
        for name in ("mlp_hidden", "attn_heads", "moe_tokens",
                     "moe_experts"):
            assert SH.constrain(x, name) is x
    assert SH._ACT_SPECS.get() is None
