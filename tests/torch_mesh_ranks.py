"""Rank bodies of tests/test_torch_mesh.py: each runs in one of the
gloo ranks that :func:`repro_torch.launch.mesh.run_ranks` spawns on the
CPU, so this module imports torch and the port only (no JAX).  Each body
returns what the test holds against the JAX package's single-device
reference: the global results (identical on every rank, checked here)
and whether each sharded run matched the port's unsharded run bit for
bit."""
import importlib

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as M

FA = importlib.import_module("repro_torch.kernels.flash_attention")
CA = importlib.import_module("repro_torch.kernels.sierpinski_ca")
SW = importlib.import_module("repro_torch.kernels.sierpinski_write")


def _mesh(world):
    return M.make_mesh((world, 1), M.AXES, device="cpu")


def _same_on_every_rank(t: torch.Tensor) -> bool:
    """Whether every rank holds the same bits of ``t``."""
    first = t.clone()
    dist.broadcast(first, 0)
    return bool(torch.equal(first, t))


def ca_cases(rank, world, cases):
    """Each case ``(a, b, steps, kw, want)`` through the sharded
    ``ca_run``: [(bit-equal to ``want``, the unsharded run, and the same
    on every rank)]."""
    mesh = _mesh(world)
    out = []
    for a, b, steps, kw, want in cases:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        got = CA.ca_run(a, b, steps, mesh=mesh, **kw)
        out.append(bool(torch.equal(got, torch.from_numpy(want)))
                   and _same_on_every_rank(got))
    return out


def write_sum_cases(rank, world, cases):
    """Each case ``(m, value, kw)``: the sharded write against the
    unsharded one (bit-equal), the sharded sum beside the unsharded
    sum."""
    mesh = _mesh(world)
    out = []
    for m, value, kw in cases:
        m = torch.from_numpy(m)
        got = SW.sierpinski_write(m, value, mesh=mesh, **kw)
        want = SW.sierpinski_write(m, value, **kw)
        inplace = m.clone()
        SW.sierpinski_write_(inplace, value, mesh=mesh, **kw)
        s_got = SW.sierpinski_sum(m, mesh=mesh, **kw)
        s_want = SW.sierpinski_sum(m, **kw)
        out.append(dict(write_equal=bool(torch.equal(got, want)),
                        inplace_equal=bool(torch.equal(inplace, want)),
                        same=_same_on_every_rank(got)
                        and _same_on_every_rank(s_got.reshape(1)),
                        sum=float(s_got), sum_unsharded=float(s_want),
                        write=got.numpy() if rank == 0 else None))
    return out


def flash_cases(rank, world, cases):
    """Each case ``(q, k, v, kw)`` through sharded flash under both
    balances where they apply, against the unsharded plain run:
    [(balance, bit-equal, same on every rank, output)]."""
    mesh = _mesh(world)
    out = []
    for q, k, v, kw in cases:
        q, k, v = (torch.from_numpy(x) for x in (q, k, v))
        want = FA.flash_attention(q, k, v, **kw)
        for balance in ("contiguous", "zigzag"):
            if balance == "zigzag" and kw.get("kind") != "causal":
                continue
            got = FA.flash_attention(q, k, v, mesh=mesh,
                                     shard_balance=balance, **kw)
            out.append((balance, bool(torch.equal(got, want)),
                        _same_on_every_rank(got),
                        got.numpy() if rank == 0 else None))
    return out


def flash_refusals(rank, world, cases):
    """Each case ``(q, kw)``: the message of the ValueError the sharded
    call raises (None when it does not)."""
    mesh = _mesh(world)
    out = []
    for q, kw in cases:
        q = torch.from_numpy(q)
        try:
            FA.flash_attention(q, q, q, mesh=mesh, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def verify_cases(rank, world, m, x, q):
    """``verify=True`` on the mesh: write, sum, ca_run and flash give the
    bits of ``verify=False`` [(name, bit-equal, same on every rank)]; the
    sharded write and CA searches measure the candidates they measure
    without it {name: same candidates}; then rank 0's launch ghost map
    corrupted (in every rank's process) makes the sharded ca_run refuse
    on every rank before any exchange: the refusal's message or None."""
    import functools
    import tempfile

    from repro_torch.analysis import PlanVerificationError
    from repro_torch.core import tune
    from repro_torch.core.shard import ShardedPlan
    mesh = _mesh(world)
    m, x, q = (torch.from_numpy(t) for t in (m, x, q))
    z = torch.zeros_like(x)
    kw = dict(block=8, n=32)
    calls = {
        "write": lambda **o: SW.sierpinski_write(
            m, 3.0, storage="compact", grid_mode="prefetch_lut", **kw, **o),
        "sum": lambda **o: SW.sierpinski_sum(
            m, storage="compact", grid_mode="mma", **kw, **o),
        "ca_run": lambda **o: CA.ca_run(
            x, z, 4, fuse=2, storage="compact", grid_mode="closed_form",
            num_stages=2, **kw, **o),
        "flash": lambda **o: FA.flash_attention(
            q, q, q, kind="causal", block_q=16, block_k=16,
            shard_balance="zigzag", **o)}
    out = []
    for name, call in calls.items():
        want = call(mesh=mesh)
        got = call(mesh=mesh, verify=True)
        out.append((name, bool(torch.equal(got, want)),
                    _same_on_every_rank(got.reshape(-1))))
    searched = {}
    for name in ("write", "ca"):
        trials = []
        for v in (False, True):
            with tempfile.TemporaryDirectory() as d:
                cache = tune.TuneCache(f"{d}/tune.json")
                search = tune.autotune_write if name == "write" else \
                    functools.partial(tune.autotune_ca, steps=2, max_fuse=2)
                _, _, tr = search(n=32, block=8, max_coarsen=1,
                                  storages=("compact",), mesh=mesh,
                                  device="cpu", cache=cache, verify=v)
            trials.append([c for c, _ in tr])
        searched[name] = trials[0] == trials[1] and len(trials[0]) > 0
    plan = ShardedPlan(SW.resolve_fractal_domain("sierpinski-gasket", 32, 8),
                       "closed_form", storage="compact", backend="cpu",
                       mesh=mesh, halo=True)
    gmap = plan.for_rank(0).shard_params("cpu")[1]
    gmap[int(torch.nonzero(gmap == plan.rpd)[0])] = 0
    try:
        calls["ca_run"](mesh=mesh, verify=True)
        refused = None
    except PlanVerificationError as e:
        refused = str(e)
    return out, searched, refused


def mesh_checks(rank, world):
    """make_mesh / make_host_mesh / resolve_cli_mesh /
    make_production_mesh on a world of ``world`` CPU ranks: (axis
    sizes, this rank's data coordinate, the refusals' messages)."""
    mesh = _mesh(world)
    host = M.make_host_mesh(device="cpu")
    cli = M.resolve_cli_mesh(f"{world}x1", device="cpu")
    errors = []
    for bad in (lambda: M.make_mesh((world + 1,), ("data",), device="cpu"),
                lambda: M.make_host_mesh(world + 1, device="cpu"),
                lambda: M.resolve_cli_mesh("2by2", device="cpu"),
                lambda: M.make_production_mesh(device="cpu"),
                lambda: M.make_production_mesh(multi_pod=True,
                                               device="cpu")):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return dict(sizes=[M.axis_size(x, a) for x in (mesh, host, cli)
                       for a in M.AXES],
                rank=M.axis_rank(mesh, "data"), none=M.resolve_cli_mesh(""),
                device=str(M.mesh_device(mesh)), errors=errors)


def impulse_cases(rank, world, states, kw, steps):
    """The compact CA of every impulse state, sharded: the results."""
    mesh = _mesh(world)
    out = []
    for a in states:
        a = torch.from_numpy(a)
        got = CA.ca_run(a, torch.zeros_like(a), steps, mesh=mesh, **kw)
        out.append(got.numpy() if rank == 0 else None)
    return out


def exchange_cases(rank, world, x, block, fuses):
    """One halo exchange of the packed state ``x`` per fuse depth, each
    rank from its slab alone (then once more through ``extend``): (the
    exchanged ghost rows equal the owners' rows on every cell a round
    ships and are zero elsewhere, and ``extend`` is ``cat`` of the slab
    and them; payload bytes this rank sent in one exchange)."""
    from repro_torch.core.shard import ShardedPlan
    from repro_torch.core.domain import make_fractal_domain
    from repro_torch.distributed import collectives
    mesh = _mesh(world)
    x = torch.from_numpy(x)
    plan = ShardedPlan(make_fractal_domain("sierpinski-gasket", 4),
                       storage="compact", mesh=mesh, axis="data",
                       halo=True).for_rank(rank).bind_block(block)
    halo, ru = plan.halo, plan.row_unit
    rows = plan.rpd * ru
    want = plan.extended(x, block)[rows:]
    out = []
    for h in fuses:
        collectives.TRAFFIC.reset()
        group = M.axis_group(mesh, "data")
        got = halo.exchange(plan, plan.slab(x, block), rank, h, group)
        ext = halo.extend(plan, plan.slab(x, block), rank, h, group)
        shipped = torch.zeros_like(got, dtype=torch.bool).view(
            halo.h_max + 1, ru, -1)
        for _, cls, _, recv, _, rcol, wc in halo.rounds:
            off, nr = halo._strip(cls, ru, min(h, ru))
            for i, c in zip(recv[rank], rcol[rank]):
                if i < halo.h_max:
                    shipped[i, off:off + nr, c * block:(c + wc) * block] \
                        = True
        # the dump row (the last) takes the rounds' padding entries
        shipped, ghosts = shipped.view_as(got)[:-ru], got[:-ru]
        out.append((bool(torch.equal(ghosts[shipped], want[:-ru][shipped]))
                    and not bool(ghosts[~shipped].any())
                    and bool(torch.equal(ext, halo.cat(
                        plan, plan.slab(x, block), got))),
                    collectives.TRAFFIC.sent // 2))
    return out


def chaos_cases(rank, world, a, kw, steps, kinds):
    """The sharded compact CA under a plan with one collective fault at
    halo round 0, per kind: (the events the injector recorded, whether
    the result equals the clean run's)."""
    from repro_torch.runtime import chaos
    mesh = _mesh(world)
    a = torch.from_numpy(a)

    def run():
        return CA.ca_run(a, torch.zeros_like(a), steps, mesh=mesh, **kw)
    clean = run()
    out = []
    for kind in kinds:
        plan = chaos.FaultPlan(0, [chaos.FaultSpec(kind, chaos.PPERMUTE_SITE,
                                                   0)])
        with chaos.ChaosInjector(plan) as inj:
            got = run()
        out.append(([e["kind"] for e in inj.events],
                    bool(torch.equal(got, clean))))
    return out
