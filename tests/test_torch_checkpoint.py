"""The port's CheckpointManager against the JAX package's: atomic
save, keep-k, torn-write recovery, all-torn raising, the same on-disk
format both ways (a dict of f32 / int32 arrays and a decode state of
prompts / tokens), modules and bf16 leaves, and the mesh refusal."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.runtime.chaos import tear_checkpoint as j_tear
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.chaos import tear_checkpoint


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"bias": rng.normal(size=(3,)).astype(np.float32),
                  "ids": rng.integers(-50, 50, (5,)).astype(np.int32)},
            "layers": [rng.normal(size=(2,)).astype(np.float32)
                       for _ in range(2)]}


def _decode_state(seed):
    rng = np.random.default_rng(seed)
    return {"prompts": rng.integers(0, 256, (2, 8)).astype(np.int32),
            "tokens": rng.integers(0, 256, (2, 3)).astype(np.int32)}


def _template(tree, torch_leaves):
    def leaf(x):
        return torch.zeros(x.shape, dtype=torch.from_numpy(x).dtype) \
            if torch_leaves else np.zeros_like(x)
    return {k: ([leaf(x) for x in v] if isinstance(v, list) else
                {kk: leaf(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in tree.items()}


def _equal(got, want):
    for k, w in sorted(want.items()):
        g = got[k]
        if isinstance(w, dict):
            _equal(g, w)
        elif isinstance(w, list):
            for a, b in zip(g, w):
                assert np.array_equal(np.asarray(a), b)
        else:
            assert np.asarray(g).dtype == w.dtype, k
            assert np.array_equal(np.asarray(g), w), k


def test_atomic_save_keep_k_and_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        t = {"w": torch.full((3,), float(step))}
        mgr.save(step, t, extra={"pos": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert mgr.read_meta()["extra"] == {"pos": 3}
    step, got, _, meta = mgr.restore(None, {"w": torch.zeros(3)})
    assert step == 3 and torch.equal(got["w"], torch.full((3,), 3.0))
    assert "skipped_torn_steps" not in meta
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(3, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf v"):
        mgr.restore(3, {"v": torch.zeros(3)})
    # restoring onto a mesh: every leaf cut to this rank's piece, whole
    # where its spec cuts nothing or its axis is 1 (the multi-rank cases
    # are tests/test_torch_serve_mesh.py's)
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import P, NamedSharding
    one = SimpleNamespace(shape={"data": 1, "model": 1})
    _, got, _, _ = mgr.restore(3, {"w": torch.zeros(3)}, shardings={
        "w": NamedSharding(one, P("model"))})
    assert torch.equal(got["w"], torch.full((3,), 3.0))


@pytest.mark.parametrize("mode", ["truncate", "meta"])
def test_torn_write_recovery(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.arange(8.0)})
    mgr.save(2, {"w": torch.arange(8.0) * 2})
    tear_checkpoint(str(tmp_path), mode=mode)
    assert any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    step, got, _, meta = mgr.restore(None, {"w": torch.zeros(8)})
    assert step == 1 and torch.equal(got["w"], torch.arange(8.0))
    assert meta["skipped_torn_steps"] == [2]
    assert len(meta["skipped_torn_errors"]) == 1
    with pytest.raises(Exception):
        mgr.restore(2, {"w": torch.zeros(8)})   # explicit: never swapped
    mgr.save(3, {"w": torch.ones(8)})           # GC clears the debris
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_all_torn_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones(4)})
    tear_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="all 1 candidates torn"):
        mgr.restore(None, {"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore(
            None, {"w": torch.zeros(4)})


@pytest.mark.parametrize("make", [_tree, _decode_state])
@pytest.mark.parametrize("torch_leaves", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, make,
                                               torch_leaves):
    want = make(3)
    JManager(str(tmp_path), keep=2).save(
        7, {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in want.items()}, extra={"pos": 9})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.read_meta()["extra"] == {"pos": 9}
    step, got, _, meta = mgr.restore(None, _template(want, torch_leaves))
    assert step == 7 and meta["step"] == 7
    _equal(got, want)


@pytest.mark.parametrize("make", [_tree, _decode_state])
def test_port_checkpoint_restores_in_reference(tmp_path, make):
    want = make(4)
    as_torch = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                    else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(v))
                for k, v in want.items()}
    CheckpointManager(str(tmp_path)).save(5, as_torch, extra={"n": 1})
    step, got, _, meta = JManager(str(tmp_path)).restore(
        None, _template(want, False))
    assert step == 5 and meta["extra"] == {"n": 1}
    _equal(got, want)
    # and a torn port checkpoint is skipped by the reference too
    CheckpointManager(str(tmp_path)).save(6, as_torch)
    j_tear(str(tmp_path))
    step, _, _, meta = JManager(str(tmp_path)).restore(
        None, _template(want, False))
    assert step == 5 and meta["skipped_torn_steps"] == [6]


def test_module_and_bf16_leaves(tmp_path):
    torch.manual_seed(0)
    src = torch.nn.Sequential(torch.nn.Linear(3, 4),
                              torch.nn.Linear(4, 2)).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, src)
    with np.load(tmp_path / "step_0000000000" / "params.npz") as z:
        assert sorted(z.files) == ["0/bias", "0/weight", "1/bias",
                                   "1/weight"]
        assert z["0/weight"].dtype == np.float32
    dst = torch.nn.Sequential(torch.nn.Linear(3, 4),
                              torch.nn.Linear(4, 2)).to(torch.bfloat16)
    _, got, _, _ = mgr.restore(None, dst)
    assert got is dst
    for (k, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), k
    # a bf16 tensor leaf comes back bit-equal from its f32 copy
    x = torch.randn(5).to(torch.bfloat16)
    mgr.save(1, {"x": x})
    _, got, _, _ = mgr.restore(1, {"x": torch.zeros(5, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)
