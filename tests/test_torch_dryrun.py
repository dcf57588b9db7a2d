"""The port's dry run (``repro_torch.launch.dryrun``, ``op_analysis``)
against the JAX package's ``repro.launch.dryrun`` / ``hlo_analysis``.

* the registry (``ARCHS``, ``SHAPES``, ``META``, ``cells``),
  ``model_flops`` of all 33 cells, ``_parse_overrides`` and the wire
  multipliers: exactly equal;
* rank 0's parameter pieces on both production meshes (the fake group
  of 256 / 512 ranks): element counts per leaf exactly equal to the
  reference's ``NamedSharding(AbstractMesh(...)).shard_shape`` (element
  counts, not bytes: the reference holds its "bf16" matrices in f32);
* ``count``: the exact FLOPs, bytes, peak and written bytes of a small
  program of known ops;
* the quickstart smoke stack on a fake (4, 2) mesh: FLOPs and wire bytes
  above 0, as ``tests/test_distributed.py`` asks of the reference;
* folding the layer stack: equal to the unfolded run;
* three full-width one-device traces (dense GQA train, MoE + MLA decode,
  SSM prefill): FLOPs within 1e-4 of ``model_flops`` corrected by the
  terms each names (the corrections are stated beside each);
* the CLI's record keys, the kernels' meta branches, and the decode
  caches a rank holds against the reference's layout (ROADMAP C9).

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when imported; the import here restores the variable, so this
worker's JAX keeps its one CPU device.
"""
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as JC
from repro.distributed import sharding as j_shard
from repro.launch import hlo_analysis as JH
from repro.models import abstract_init
from repro_torch import configs as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import op_analysis as TO
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.convert import jax_paths


def _import_reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


JD = _import_reference_dryrun()
FA = importlib.import_module("repro_torch.kernels.flash_attention")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_world():
    """Join torch's fake group of ``n`` ranks (rank 0); left after the
    test, so no other test of this worker sees a process group."""
    def join(n):
        TD.join_fake_group(n)
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the registry, model_flops, the overrides and the wire multipliers: exact
# ---------------------------------------------------------------------------

def test_registry_and_model_flops_equal_reference():
    assert TC.ARCHS == JC.ARCHS
    assert TC.SHAPES == JC.SHAPES
    assert TC.META == JC.META
    assert TC.cells(True) == JC.cells(True)
    assert TC.cells() == JC.cells() and len(TC.cells()) == 33
    for arch, shape, _ in TC.cells():
        got = TD.model_flops(TC.get_config(arch), shape)
        want = JD.model_flops(JC.get_config(arch), shape)
        assert got == want, (arch, shape, got, want)
    for opt in (None, "", "attn_schedule=triangular,megatron_sp=true,"
                "grad_accum=4,capacity_factor=1.5,fsdp=False"):
        assert TD._parse_overrides(opt) == JD._parse_overrides(opt)


@pytest.mark.parametrize("n", [2, 4, 16, 256])
def test_wire_multiplier_equals_reference(n):
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        assert TO.wire_multiplier(op, n) == JH._wire_multiplier(op, n)


# ---------------------------------------------------------------------------
# rank 0's parameter pieces on the production meshes
# ---------------------------------------------------------------------------

def _ref_piece_elems(leaf, spec, mesh) -> int:
    """Elements of rank 0's piece of a reference leaf: ``shard_shape``,
    or JAX's padded shard (``ceil(n / k)``) where the tiling is
    uneven."""
    sharding = NamedSharding(mesh, spec)
    try:
        return math.prod(sharding.shard_shape(leaf.shape))
    except ValueError:
        sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = math.prod(sizes[a] for a in names)
            shape[dim] = -(-shape[dim] // k)
        return math.prod(shape)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_rank0_param_pieces_equal_reference(multi_pod, fake_world):
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    jmesh = AbstractMesh(shape, axes)
    fsdp_axes = ("pod", "data") if multi_pod else ("data",)
    for arch in TC.ARCHS:
        fsdp = TC.META[arch]["fsdp"]
        model = TD.rank_model(TC.get_config(arch), mesh, fsdp=fsdp,
                              fsdp_axes=fsdp_axes)
        jcfg = JC.get_config(arch)
        abstract = abstract_init(jcfg)
        specs = j_shard.param_spec_tree(abstract, jcfg, fsdp=fsdp,
                                        fsdp_axes=fsdp_axes)
        leaves = {_path(p): x for p, x in
                  jax.tree_util.tree_leaves_with_path(abstract)}
        ref = {_path(p): s for p, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))}
        paths = jax_paths(model)
        for name, p in model.named_parameters():
            key = paths[name]
            want = _ref_piece_elems(leaves[key], ref[key], jmesh)
            if key.startswith("blocks/"):   # one layer of a stacked group
                want //= leaves[key].shape[0]
            assert p.numel() == want, (arch, chips, name, p.shape, want)


# ---------------------------------------------------------------------------
# count: a small program of known ops
# ---------------------------------------------------------------------------

def test_count_charges_known_ops_exactly(fake_world):
    fake_world(4)
    from repro_torch.distributed import collectives
    f32 = 4
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    w = torch.empty(8, 16, 24, device="meta")

    def program(a, b, w):
        c = a @ b                          # mm: 2 * 64 * 32 * 16 FLOPs
        d = c + 1.0                        # add: no FLOP, c in, d out
        e = d.view(8, 8, 16)               # a view: nothing
        g = torch.bmm(e, w)                # bmm: 2 * 8 * 8 * 16 * 24
        a.mul_(2.0)                        # in place into an argument
        collectives.all_reduce_sum(g)      # 2 (n-1)/n of its bytes
        h = collectives.all_gather(d, 0)   # (n-1) x its operand
        return g, h
    (g, h), cost = TO.count(program, a, b, w)
    assert tuple(h.shape) == (256, 16) and h.device.type == "meta"
    assert cost.flops == 2 * 64 * 32 * 16 + 2 * 8 * 8 * 16 * 24
    assert dict(cost.flops_by_op) == {"aten.mm": 2 * 64 * 32 * 16,
                                      "aten.bmm": 2 * 8 * 8 * 16 * 24}
    mm = (64 * 32 + 32 * 16 + 64 * 16) * f32
    add = 2 * 64 * 16 * f32
    bmm = (8 * 8 * 16 + 8 * 16 * 24 + 8 * 8 * 24) * f32
    mul = 2 * 64 * 32 * f32
    ar, ag = 8 * 8 * 24 * f32, 64 * 16 * f32
    assert cost.bytes_accessed == mm + add + bmm + mul + ar + 4 * ag
    assert cost.coll_bytes == ar + ag
    assert cost.coll_wire_bytes == ar * 2 * 3 / 4 + ag * 3
    assert dict(cost.coll_count) == {"all-reduce": 1, "all-gather": 1}
    # c, d, g live together; then h (d's gather) while g, d live
    assert cost.peak_bytes == (64 * 16 * 2 + 8 * 8 * 24 + 256 * 16) * f32
    assert cost.mutated_bytes == 64 * 32 * f32
    assert cost.live_bytes == (8 * 8 * 24 + 256 * 16) * f32


def test_count_memo_answers_repeats_with_the_same_layouts():
    x = torch.empty(4, 6, device="meta").t()   # a transposed layout

    def program(x):
        outs = [torch.exp(x) for _ in range(3)]
        return outs, torch.exp(x.contiguous())
    (outs, plain), cost = TO.count(program, x)
    want = torch.exp(torch.empty(4, 6).t())
    for o in outs:
        assert o.shape == want.shape and o.stride() == want.stride()
    assert plain.stride() == (4, 1)
    assert cost.bytes_by_op["aten.exp"] == 4 * 2 * 24 * 4


def test_quickstart_smoke_on_a_fake_mesh(fake_world):
    # tests/test_distributed.py's mini dry run of the reference: the
    # quickstart smoke stack on (data 4, model 2)
    fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    cfg = TC.get_config("quickstart", smoke=True)
    cost, mem, _, _ = TD.dry_run(
        cfg, "train", inputs=TD.step_inputs(cfg, "train", 8, 64), mesh=mesh)
    assert cost.flops > 0 and cost.coll_wire_bytes > 0
    assert cost.coll_count["all-reduce"] > 0
    assert mem["peak_est_gib"] > mem["argument_gib"] > 0
    assert TD.model_flops(cfg, "train_4k") > 0


# ---------------------------------------------------------------------------
# folding the layer stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", [("quickstart", 6),
                                         ("zamba2-2.7b", 10)])
def test_folded_stack_equals_the_whole_run(arch, layers, fake_world):
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = TC.get_config(arch, smoke=True).replace(n_layers=layers)
    for kind, b, s, accum in (("train", 8, 32, 2), ("prefill", 2, 32, 1),
                              ("decode", 2, 32, 1)):
        def run(c):
            return TD.dry_run(c, kind, mesh=mesh, grad_accum=accum,
                              seq_shard=True, pos=s - 1,
                              inputs=TD.step_inputs(c, kind, b, s, accum))
        whole, folded = run(cfg), TD.folded(cfg, run)
        for key in ("flops", "bytes_accessed", "coll_bytes",
                    "coll_wire_bytes"):
            assert getattr(folded[0], key) == pytest.approx(
                getattr(whole[0], key), rel=1e-12), (arch, kind, key)
        for key, v in whole[1].items():
            assert folded[1][key] == pytest.approx(v, rel=1e-9), (kind, key)


# ---------------------------------------------------------------------------
# three full-width traces against model_flops
# ---------------------------------------------------------------------------

def _counted(arch, shape):
    cfg, sh = TC.get_config(arch), TC.SHAPES[shape]
    accum = TC.META[arch]["grad_accum"] if sh["kind"] == "train" else 1

    def run(c):
        return TD.dry_run(c, sh["kind"], grad_accum=accum, pos=sh["seq"] - 1,
                          inputs=TD.input_specs(c, shape, accum))
    cost = TD.folded(cfg, run)[0]
    return cfg, sh, cost.flops, TD.model_flops(cfg, shape)


#: the counted FLOPs equal model_flops corrected by each cell's terms to
#: within this (the RMS norms' scales, counted in N, cost no product)
FLOP_RTOL = 1e-4


def test_dense_train_flops_against_model_flops():
    # phi3-mini-3.8b train_4k on one device: 1.3975 x model_flops.  The
    # embedding is a gather (its 6 N_emb D is no FLOP); remat runs each
    # layer's forward again but for its last product (the recomputation
    # stops once the saved tensors are back: the MLP's wo); the logit
    # chunks recompute the head; attention runs the dense flash schedule
    # (S 4096 > flash_threshold 2048): the whole S x S square, not its
    # causal half, forward twice (remat) and a backward that recomputes
    # the scores: 18 B h hd S^2 a layer against model_flops's 6.
    cfg, sh, got, want = _counted("phi3-mini-3.8b", "train_4k")
    b, s = sh["batch"], sh["seq"]
    tokens = b * s
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    head = cfg.vocab_size * d
    layer = (cfg.param_count() - 2 * head) / layers - 2 * d  # no norms
    expect = (want - 6 * head * tokens
              + layers * (2 * layer - 2 * d * f) * tokens
              + 2 * head * tokens
              + 12 * b * cfg.n_heads * cfg.hd * s * s * layers)
    assert got == pytest.approx(expect, rel=FLOP_RTOL)
    assert 1.39 < got / want < 1.41


def test_moe_mla_decode_flops_against_model_flops():
    # deepseek-v2-236b decode_32k on one device, at the cache's last
    # position: 7.23 x model_flops.  The embedding is a gather; MLA's
    # absorbed decode attends in the latent: 2 B h S (2 kv_lora + rope)
    # a layer, where model_flops counts 4 B h hd S with hd = d_model / h
    # = 40; every expert runs its capacity's rows (at least 8: 160 x 8
    # rows for 128 x 6 routed tokens).
    cfg, sh, got, want = _counted("deepseek-v2-236b", "decode_32k")
    b, s, d, h = sh["batch"], sh["seq"], cfg.d_model, cfg.n_heads
    k, e = cfg.top_k, cfg.n_experts
    cap = max(8, -(-math.ceil(cfg.capacity_factor * b * k / e) // 8) * 8)
    moe = sum(cfg.layer_ffn(i) == "moe" for i in range(cfg.n_layers))
    layers = cfg.n_layers
    expect = (want - 2 * cfg.vocab_size * d * b
              - layers * 4 * b * h * cfg.hd * s
              + layers * 2 * b * h * s * (2 * cfg.kv_lora_rank
                                          + cfg.qk_rope_dim)
              + moe * (e * cap - b * k) * 6 * d * cfg.d_ff_expert)
    assert got == pytest.approx(expect, rel=FLOP_RTOL)
    assert 7.2 < got / want < 7.3


def test_ssm_prefill_flops_against_model_flops():
    # falcon-mamba-7b prefill_32k on one device: 0.9254 x model_flops.
    # The embedding is a gather; prefill takes the head at the last
    # position only; A, D, dt_bias and the norms are elementwise in the
    # scan (model_flops counts each parameter as 2 FLOPs a token).  No
    # attention: model_flops counts none for an SSM stack, and it has
    # none.
    cfg, sh, got, want = _counted("falcon-mamba-7b", "prefill_32k")
    b, s, d = sh["batch"], sh["seq"], cfg.d_model
    tokens, di = b * s, cfg.d_inner
    head = cfg.vocab_size * d
    expect = (want - 2 * head * tokens - 2 * head * (tokens - b)
              - 2 * cfg.n_layers * (di * cfg.d_state + 2 * di + 2 * d)
              * tokens)
    assert got == pytest.approx(expect, rel=FLOP_RTOL)
    assert 0.92 < got / want < 0.93


# ---------------------------------------------------------------------------
# the CLI, the kernels' meta branches, the decode caches
# ---------------------------------------------------------------------------

#: the reference's record keys (repro/launch/dryrun.py), ``hlo`` renamed
#: ``ops`` and ``compile_s`` renamed ``trace_s``
REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "grad_accum",
            "trace_s", "mem", "ops", "roofline"}
REF_MEM = {"argument_gib", "output_gib", "temp_gib", "alias_gib",
           "peak_est_gib"}
REF_OPS = {"flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
           "coll_wire_bytes_per_dev", "coll_by_type", "coll_count",
           "xla_cost_flops_unrolled_once"}
REF_ROOF = {"compute_s", "memory_s", "collective_s", "dominant",
            "model_flops_total", "model_flops_per_dev", "useful_ratio",
            "roofline_s", "roofline_frac"}


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi3-mini-3.8b", "--shape", "decode_32k", "--mesh", "single",
         "--json-out", str(out)], capture_output=True, text=True, env=env,
        timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert REF_KEYS <= set(rec) and "hlo" not in rec
    assert REF_MEM <= set(rec["mem"])
    assert set(rec["ops"]) == REF_OPS
    assert set(rec["roofline"]) == REF_ROOF
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["ops"]["flops_per_dev"] > 0
    assert rec["roofline"]["model_flops_total"] == JD.model_flops(
        JC.get_config("phi3-mini-3.8b"), "decode_32k")
    assert "== phi3-mini-3.8b decode_32k mesh=16x16" in r.stdout


def test_kernel_entries_charge_their_schedule_on_meta():
    b, h, hkv, s, d = 2, 8, 2, 512, 64
    q = torch.empty(b, h, s, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16, device="meta")
    out, cost = TO.count(FA.flash_attention, q, k, k, block_q=128,
                         block_k=128)
    assert tuple(out.shape) == (b, h, s, d) and out.device.type == "meta"
    pairs = 4 * 5 // 2                       # the causal triangle's blocks
    assert cost.flops_by_op["flash_attention_tc"] == \
        2.0 * pairs * b * h * 128 * 128 * 2 * d
    # decode at position 300 of a 512 cache: 301 keys a row and head
    q1 = torch.empty(b, h, 1, d, device="meta")
    out, cost = TO.count(FA.flash_attention, q1, k.float(), k.float(),
                         kind="full", block_q=1, seq_pos=300)
    assert tuple(out.shape) == (b, h, 1, d)
    assert cost.flops_by_op["flash_attention_decode"] == \
        4.0 * 301 * b * h * d
    # paged: positions on the CPU are read; pages of 16
    pool = torch.empty(40, 2 * hkv, 16, d, device="meta")
    table = torch.zeros(b, 32, dtype=torch.int32)
    out, cost = TO.count(FA.paged_flash_attention, q1, pool, table,
                         torch.tensor([100, 300]))
    assert tuple(out.shape) == (b, h, 1, d)
    assert cost.flops_by_op["paged_flash_attention"] == \
        4.0 * (101 + 301) * h * d
    # a CPU call still runs the plain version (no charge, no meta)
    qc, kc = torch.randn(1, 2, 32, 16), torch.randn(1, 2, 32, 16)
    got, cost = TO.count(FA.flash_attention, qc, kc, kc, block_q=16,
                         block_k=16)
    assert got.device.type == "cpu" and "flash_attention_tc" not in \
        cost.flops_by_op and torch.isfinite(got).all()


def test_decode_caches_a_rank_holds_against_the_reference_layout(
        fake_world):
    # ROADMAP C9: Server(mesh=) keeps every cache whole on every rank
    # (but a tensor-parallel attention layer's own KV heads), where the
    # reference's cache_spec_tree cuts the batch over data and the heads
    # (or the head dim) over model: on 16 x 16 a rank holds 256 x the
    # reference's piece for gemma3-12b (KV heads 8 do not tile the model
    # axis), 16 x for phi3-mini (32 KV heads do: each rank holds its 2)
    fake_world(256)
    mesh = make_production_mesh(device="cpu")
    for arch, ratio in (("gemma3-12b", 256), ("phi3-mini-3.8b", 16)):
        cfg = TC.get_config(arch).replace(n_layers=6)
        _, mem, extra, _ = TD.dry_run(
            cfg, "decode", mesh=mesh, pos=32767,
            inputs=TD.step_inputs(cfg, "decode", 128, 32768))
        assert extra["cache_gib"] == ratio * extra["cache_reference_gib"]
        whole = 2 * 6 * 128 * cfg.n_kv_heads * 32768 * cfg.hd * 2 / 2 ** 30
        assert extra["cache_gib"] == (whole if ratio == 256 else whole / 16)
