"""Rank bodies of tests/test_torch_serve_mesh.py: each runs in one of the
gloo ranks that :func:`repro_torch.launch.mesh.run_ranks` spawns on the
CPU, so this module imports torch and the port only (no JAX).  The
weights arrive as numpy arrays by the port's parameter names (the test
process carried them across from the JAX package's init), and each body
returns numpy results for the test to hold against the single-device
runs."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import shard_model
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as S
from repro_torch.models import attention as TA
from repro_torch.models import model as TM


def config(arch):
    """The smoke config the tests serve: blockspace decode."""
    return get_config(arch, smoke=True).replace(
        attn_decode_kernel="blockspace")


def build(arch, state):
    """The port's model of ``arch`` on the CPU holding ``state``."""
    cfg = config(arch)
    model = TM.Model(cfg, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(state[name]))
    return cfg, model


def generate(srv, prompts, max_new):
    """(tokens, step logits (B, T, V) f32 numpy, slot calls) of one
    greedy Server.generate."""
    steps = []
    TA.reset_slot_calls()
    toks = srv.generate(prompts, max_new,
                        on_step=lambda pos, lg: steps.append(
                            lg[:, 0].float().clone()))
    return toks, torch.stack(steps, 1).numpy(), dict(TA.SLOT_CALLS)


def same_on_every_rank(a: np.ndarray) -> bool:
    t = torch.from_numpy(np.ascontiguousarray(a))
    first = t.clone()
    dist.broadcast(first, 0)
    return bool(torch.equal(first, t))


def serve(rank, world, arch, state, prompts, max_new, shapes, requests=None,
          paged_kw=None, odd=None):
    """Server.generate of ``prompts`` on each (data, model) mesh of
    ``shapes`` (every one over all the ranks), and with ``requests`` a
    PagedServer run on the same mesh, its model laid out and the mesh
    registered for the paged decode; returns per mesh the tokens, step
    logits and slot-group calls, whether every rank sampled the same
    tokens, and the collective calls.  ``odd`` prompts are served on
    the first mesh too (key ``"odd"``)."""
    out = {}
    for shape in shapes:
        mesh = M.make_mesh(shape, M.AXES, device="cpu")
        cfg, model = build(arch, state)
        srv = S.Server(cfg, model, S.ServeConfig(
            max_len=prompts.shape[1] + max_new), mesh=mesh)
        collectives.TRAFFIC.reset()
        toks, logits, slots = generate(srv, prompts, max_new)
        res = {"tokens": toks, "logits": logits, "slots": slots,
               "same": same_on_every_rank(toks),
               "calls": collectives.TRAFFIC.calls,
               "tp_modules": sum(hasattr(m, "_tp") for m in model.modules())}
        if requests is not None:
            cfg, pmodel = build(arch, state)
            shard_model(pmodel, mesh)
            TA.set_decode_mesh(mesh)
            try:
                TA.reset_slot_calls()
                psrv = S.PagedServer(cfg, pmodel,
                                     S.PagedServeConfig(**paged_kw))
                done = psrv.run(requests, max_new=max_new)
            finally:
                TA.set_decode_mesh(None)
            res["paged"] = {k: np.asarray(v) for k, v in done.items()}
            res["paged_slots"] = dict(TA.SLOT_CALLS)
            res["pool_heads"] = int(psrv.pools[0].shape[1]) // 2
        out[shape] = res
        if odd is not None and "odd" not in out:
            cfg, model = build(arch, state)
            srv = S.Server(cfg, model, S.ServeConfig(
                max_len=odd.shape[1] + max_new), mesh=mesh)
            toks, _, slots = generate(srv, odd, max_new)
            out["odd"] = {"tokens": toks, "slots": slots}
    return out


def slot_decode(rank, world, q, k, v, pos, pool, table, ppos):
    """The slot-sharded decode entry points on a (world, 1) mesh against
    the unsharded entry points (the plain versions here) and the plain
    masked decodes: [max |sharded - unsharded|, max |sharded - plain|,
    slot calls] for the flash decode (causal and local) and the paged
    decode."""
    mesh = M.make_mesh((world, 1), M.AXES, device="cpu")
    q, k, v, pool, table, ppos = (torch.from_numpy(x) for x in
                                  (q, k, v, pool, table, ppos))
    out = []
    for kind, window in (("causal", 0), ("local", 5)):
        TA.reset_slot_calls()
        got = TA.decode_attention_flash(q, k, v, pos, kind=kind,
                                        window=window, block_k=8, mesh=mesh)
        one = TA.decode_attention_flash(q, k, v, pos, kind=kind,
                                        window=window, block_k=8)
        plain = TA.decode_attention(q, k, v, pos, kind=kind, window=window)
        out.append((float((got - one).abs().max()),
                    float((got - plain).abs().max()),
                    TA.SLOT_CALLS["flash_attention_decode"]))
    TA.reset_slot_calls()
    got = TA.decode_attention_paged(q, pool, table, ppos, mesh=mesh)
    one = TA.decode_attention_paged(q, pool, table, ppos)
    plain = TA.decode_attention_paged_xla(q, pool, table, ppos)
    out.append((float((got - one).abs().max()),
                float((got - plain).abs().max()),
                TA.SLOT_CALLS["paged_flash_attention"]))
    return out


def restore_and_serve(rank, world, arch, ckpt, prompts, max_new, shape):
    """restore(shardings=) of a single-device checkpoint onto a ``shape``
    mesh (``None``: elastic_restore onto the world's elastic mesh), then
    Server.generate on it: (tokens, the mesh's (data, model), whether
    the model holds pieces)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.elastic import elastic_restore
    cfg = config(arch)
    mgr = CheckpointManager(ckpt, keep=1)
    template = TM.Model(cfg, "cpu")
    if shape is None:
        mesh, _, model, _ = elastic_restore(mgr, template, cfg, device="cpu")
    else:
        mesh = M.make_mesh(shape, M.AXES, device="cpu")
        shardings = SH.named_sharding_tree(
            SH.param_spec_tree(template, cfg), mesh)
        _, model, _, _ = mgr.restore(None, template, shardings=shardings)
    pieces = any(hasattr(p, "_layout") for p in model.parameters())
    srv = S.Server(cfg, model, S.ServeConfig(
        max_len=prompts.shape[1] + max_new), mesh=mesh)
    toks = srv.generate(prompts, max_new)
    return toks, (M.axis_size(mesh, "data"), M.axis_size(mesh, "model")), \
        pieces


def tune_paged(rank, world, cache_path):
    """autotune_paged(mesh=) on a (world, 1) mesh with the cache that
    holds the D = 1 winner: (config, trials, the cache's keys)."""
    import json

    from repro_torch.core import tune
    mesh = M.make_mesh((world, 1), M.AXES, device="cpu")
    cache = tune.TuneCache(cache_path)
    cfg, _, trials = tune.autotune_paged(
        batch=4, heads=2, seq=32, d=16, page_sizes=(8, 16), cache=cache,
        mesh=mesh, device="cpu")
    dist.barrier()
    with open(cache_path) as f:
        keys = list(json.load(f))
    return cfg, trials, keys
