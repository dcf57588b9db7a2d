"""The port's sharding rules against the JAX package's, leaf by leaf:
``param_spec_tree`` (FSDP off and on, ``ep_data`` off and on) over the
abstract parameters of all eleven configurations (the port's model on
the ``meta`` device, walked by the JAX paths; a per-layer tensor of a
stacked group takes the stacked spec without its leading ``None``),
``cache_spec_tree`` at model axes of 1, 2 and 16 with a batch that tiles
the data axis and one that does not, ``batch_specs``, ``act_specs``,
``dp_axes`` and ``candidate_meshes(1..32)``.  The reference's spec
functions are pure functions of shapes and axis sizes, so they run on
``jax.sharding.AbstractMesh``; the port's on a stand-in mesh with the
same ``shape``.  Also the placement helpers: ``shard_tensor`` pieces
tile the global tensor under the padded-piece rule."""
import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.distributed import elastic as j_elastic
from repro.distributed import sharding as j_shard
from repro.models import abstract_init
from repro.models import model as j_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import elastic as t_elastic
from repro_torch.distributed import sharding as t_shard
from repro_torch.models import model as t_model
from repro_torch.models.convert import _layer_sources, jax_paths

ARCHS = ("quickstart", "gemma3-12b", "qwen1.5-32b", "qwen2.5-32b",
         "phi3-mini-3.8b", "deepseek-v2-236b", "llama4-maverick-400b-a17b",
         "falcon-mamba-7b", "zamba2-2.7b", "musicgen-large", "internvl2-26b")
#: (data, model) meshes of the cache cases: model axes 1, 2 and 16
CACHE_MESHES = ((2, 1), (2, 2), (1, 16), (2, 16))


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ref_specs(tree):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return {_path(p): (s.spec if isinstance(s, jax.sharding.NamedSharding)
                       else s)
            for p, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: is_spec(x) or isinstance(
                    x, jax.sharding.NamedSharding))}


def _stand_in(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_equals_reference(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    abstract = abstract_init(jcfg)
    model = t_model.Model(tcfg, "meta")
    paths = jax_paths(model)
    for fsdp in (False, True):
        for ep_data in (False, True):
            ref = _ref_specs(j_shard.param_spec_tree(
                abstract, jcfg, fsdp=fsdp, ep_data=ep_data))
            got = t_shard.param_spec_tree(model, tcfg, fsdp=fsdp,
                                          ep_data=ep_data)
            assert set(got) == set(paths)
            assert {paths[n] for n in got} == set(ref)
            for name, spec in got.items():
                want = ref[paths[name]]
                if paths[name].startswith("blocks/"):
                    assert want[0] is None, (arch, name)
                    want = tuple(want)[1:]
                assert tuple(spec) == tuple(want), (arch, name, fsdp,
                                                    ep_data, spec, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_tree_equals_reference(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    max_len = 16
    src = _layer_sources(tcfg)
    for batch in (4, 3):
        shapes = jax.eval_shape(
            lambda: j_model.init_cache(jcfg, batch, max_len))
        caches = t_model.init_cache(tcfg, batch, max_len, device="meta")
        for data, tp in CACHE_MESHES:
            ref = _ref_specs(j_shard.cache_spec_tree(
                shapes, jcfg, AbstractMesh((data, tp), ("data", "model")),
                batch))
            got = t_shard.cache_spec_tree(caches, tcfg, _stand_in(data, tp),
                                          batch)
            assert len(got) == tcfg.n_layers
            n = 0
            for i, layer in enumerate(got):
                prefix, g = src[i]
                for j, sh in enumerate(layer):
                    key = (prefix.replace(".", "/")
                           + (f"mixer/{j}" if j < 2 else f"shared/{j - 2}"))
                    want = tuple(ref[key])
                    if g is not None:
                        assert want[0] is None
                        want = want[1:]
                    assert tuple(sh.spec) == want, (arch, batch, data, tp,
                                                    i, j)
                    n += 1
            # every reference leaf is one of the port's (stacked groups
            # count once per layer)
            assert n >= len(ref)


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), (2, 4)), (("data", "model"), (1, 16)),
    (("pod", "data", "model"), (2, 2, 2))])
def test_batch_act_specs_and_dp_axes_equal_reference(axes, shape):
    jmesh = AbstractMesh(shape, axes)
    tmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                  axis_names=axes)
    assert t_shard.dp_axes(tmesh) == j_shard.dp_axes(jmesh)
    for mode in ("tokens", "embeddings"):
        ref, got = j_shard.batch_specs(jmesh, mode), \
            t_shard.batch_specs(tmesh, mode)
        assert set(ref) == set(got)
        for k in ref:
            assert tuple(got[k].spec) == tuple(ref[k].spec), (mode, k)
            assert got[k].mesh is tmesh
    for seq_shard in (False, True):
        for ep_data in (False, True):
            ref = j_shard.act_specs(jmesh, seq_shard=seq_shard,
                                    ep_data=ep_data)
            got = t_shard.act_specs(tmesh, seq_shard=seq_shard,
                                    ep_data=ep_data)
            assert set(ref) == set(got)
            for k in ref:
                assert tuple(got[k].spec) == tuple(ref[k].spec), k


def test_candidate_meshes_equal_reference():
    for n in range(1, 33):
        for max_model in (16, 4):
            assert t_elastic.candidate_meshes(n, max_model) == \
                j_elastic.candidate_meshes(n, max_model), (n, max_model)
    # the port's elastic shape: the first candidate whose model axis
    # tiles the vocabulary (gemma3-12b's 262144 on 3 ranks: (3, 1))
    cfg = t_get_config("gemma3-12b")
    assert t_elastic.candidate_meshes(3)[0] == (1, 3)
    assert t_elastic.elastic_shape(3, cfg) == (3, 1)
    assert t_elastic.elastic_shape(4, cfg) == (1, 4)
    assert t_elastic.elastic_shape(3) == (1, 3)


def test_partition_spec_normalises_as_jax():
    P, JP = t_shard.P, jax.sharding.PartitionSpec
    for parts in ((("data",), None), ((), None), (("pod", "data"), None),
                  ("model",), ()):
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts


def test_shard_tensor_pieces_tile_the_tensor():
    """Pieces of ceil(n / k), the last ones shorter or empty, in rank
    order, concatenate to the tensor (the rule gather_tensor inverts)."""
    t = torch.arange(7 * 6, dtype=torch.float32).reshape(7, 6)

    class _Mesh:
        def __init__(self, size, rank):
            self.shape, self._rank = {"model": size}, rank

    import repro_torch.launch.mesh as M
    real = M.axis_rank
    for size in (1, 2, 3, 4, 8):
        pieces = []
        for rank in range(size):
            M.axis_rank = lambda mesh, axis: mesh._rank  # noqa: E731
            try:
                pieces.append(t_shard.shard_tensor(
                    t, t_shard.NamedSharding(_Mesh(size, rank),
                                             t_shard.P("model", None))))
            finally:
                M.axis_rank = real
            lo, hi = t_shard.shard_bounds(7, size, rank)
            assert pieces[-1].shape == (hi - lo, 6)
        assert torch.equal(torch.cat(pieces), t)
