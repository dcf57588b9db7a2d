"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside a fixture whether a card is
there and skips without one.  This file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib
import json

import pytest
import torch

from repro_torch.core import fractal as F
from repro_torch.core.compact import compact_layout
from repro_torch.core.plan import LOWERINGS
from repro_torch.kernels import ops

TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
TC = importlib.import_module("repro_torch.kernels.sierpinski_ca")
FA = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda

CASES = [("sierpinski-gasket", 64, 1), ("sierpinski-gasket", 64, 8),
         ("sierpinski-gasket", 256, 128), ("sierpinski-gasket", 512, 4),
         ("sierpinski-gasket", 1024, 32), ("sierpinski-carpet", 81, 1),
         ("sierpinski-carpet", 81, 3), ("sierpinski-carpet", 243, 27),
         ("vicsek-cross", 81, 9), ("vicsek-cross", 243, 3)]
DTYPES = [torch.float32, torch.bfloat16, torch.int32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _state(n, dtype, seed, dev, integer=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        return torch.randint(-8, 9, (n, n), generator=g,
                             device=dev).to(dtype)
    return torch.randn((n, n), generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("fractal,n,block", CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain(dev, fractal, n, block, grid_mode, dtype):
    m = _state(n, dtype, n * block, dev)
    plan, n, block = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                       fractal=fractal)
    p = plan.launch_params(n, block, dev)
    TW.check_write_against_plain(m, 7.3, plan, n, block, p)
    TW.check_sum_against_plain(m, plan, n, block, p)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_normal_state_sum_within_tolerance(dev, grid_mode):
    m = _state(729, torch.float32, 3, dev, integer=False)
    plan, n, block = TW.prepare_launch(m, block=9, grid_mode=grid_mode,
                                       fractal="sierpinski-carpet")
    p = plan.launch_params(n, block, dev)
    TW.check_sum_against_plain(m, plan, n, block, p, rtol=1e-5)


def test_entry_points_launch_the_kernels(dev):
    TW.reset_launch_counts()
    m = torch.zeros((64, 64), device=dev)
    out = ops.sierpinski_write(m, 1.0, block=8)
    total = ops.sierpinski_sum(out, block=8, grid_mode="bounding")
    assert TW.launch_counts() == {"sierpinski_write": 1,
                                  "sierpinski_sum_partials": 1,
                                  "sierpinski_sum_combine": 1,
                                  "mma_decode_chains": 0}
    ops.sierpinski_sum(out, block=8, grid_mode="mma")
    assert TW.launch_counts()["mma_decode_chains"] == 1
    mask = torch.from_numpy(F.membership_grid(64)).to(dev)
    assert torch.equal(out, mask.to(torch.float32))
    assert float(total) == F.gasket_volume(64) and total.device == dev
    assert torch.equal(m, torch.zeros_like(m))  # functional write
    assert ops.sierpinski_write_(m, 1.0, block=8) is m


def test_kernel_wrappers_reject_what_they_cannot_take(dev):
    m = torch.zeros((64, 64), device=dev)
    plan, n, block = TW.prepare_launch(m, block=8, grid_mode="prefetch_lut")
    p = plan.launch_params(n, block, dev)
    with pytest.raises(ValueError, match="same device"):
        TW.write_cuda(m, 1.0, plan.launch_params(n, block, "cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        TW.write_cuda(torch.zeros((64, 128), device=dev)[:, ::2], 1.0, p)
    with pytest.raises(TypeError):
        TW.write_cuda(m.double(), 1.0, p)
    with pytest.raises(ValueError, match="shape"):
        TW.sum_partials_cuda(torch.zeros((32, 32), device=dev), p)


# ---------------------------------------------------------------------------
# compact storage and coarsening (write / sum), and the fused CA kernel
# ---------------------------------------------------------------------------

#: (fractal, n, block, s): s is the coarsening of the coarsened cases
COMPACT_CASES = [("sierpinski-gasket", 64, 4, 2), ("sierpinski-gasket", 256, 8, 4),
                 ("sierpinski-gasket", 512, 32, 2), ("sierpinski-carpet", 81, 3, 3),
                 ("sierpinski-carpet", 243, 9, 3), ("vicsek-cross", 243, 3, 9)]


def _packed(fractal, n, block, seed, dev, integer=True, binary=False):
    """A packed state whose non-member cells are 0 (the CA invariant)."""
    lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
    spec = F.FRACTALS.get(fractal, F.SIERPINSKI)
    mask = torch.from_numpy(spec.membership_grid(n).copy()).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    if binary:
        x = torch.randint(0, 2, (n, n), generator=g, device=dev).float()
    elif integer:
        x = torch.randint(-8, 9, (n, n), generator=g, device=dev).float()
    else:
        x = torch.randn((n, n), generator=g, device=dev)
    x = torch.where(mask, x, 0)
    return x, lay.pack(x, block)


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
@pytest.mark.parametrize("coarsened", [False, True], ids=["s1", "s"])
def test_compact_kernels_match_plain(dev, fractal, n, block, s, grid_mode,
                                     storage, coarsened):
    emb, packed = _packed(fractal, n, block, n + block, dev)
    m = packed if storage == "compact" else emb
    plan, n_, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                      fractal=fractal, storage=storage, n=n,
                                      coarsen=s if coarsened else 1)
    p = plan.launch_params(n_, blk, dev)
    TW.check_write_against_plain(m, 7.3, plan, n_, blk, p)
    TW.check_sum_against_plain(m, plan, n_, blk, p)


#: (fractal, n, block, s, fuse)
CA_CASES = [("sierpinski-gasket", 64, 8, 2, 3), ("sierpinski-gasket", 256, 16, 4, 16),
            ("sierpinski-gasket", 1024, 32, 2, 32), ("sierpinski-carpet", 81, 3, 3, 3),
            ("sierpinski-carpet", 243, 9, 3, 9), ("vicsek-cross", 243, 9, 3, 9),
            ("sierpinski-gasket", 512, 128, 1, 128), ("sierpinski-gasket", 1024, 32, 2, 64)]


@pytest.mark.parametrize("fractal,n,block,s,fuse", CA_CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_kernel_matches_plain(dev, fractal, n, block, s, fuse, grid_mode,
                                 storage, rule):
    emb, packed = _packed(fractal, n, block, n + fuse, dev, integer=False,
                          binary=rule == "parity")
    a = packed if storage == "compact" else emb
    b = torch.zeros_like(a)
    # every ring depth, the global-scratch path (rho 128 at fuse 128,
    # coarsen 2 at fuse 64) included
    for coarsen in sorted({1, s}):
        plan, n_, blk = TC.prepare_run(a, b, block=block, grid_mode=grid_mode,
                                       fractal=fractal, storage=storage, n=n,
                                       coarsen=coarsen)
        h = TC.effective_fuse(fuse, fuse, blk, coarsen)
        p = plan.launch_params(n_, blk, dev)
        for steps in sorted({1, h}):
            want = TC.ca_launch_plain(a, b.clone(), plan, n_, blk, h, steps,
                                      rule, 0.2)
            for st in (1, 2, 3):
                got = TC.ca_cuda(a, b.clone(), p, h, steps, rule, 0.2, st)
                assert torch.equal(got, want), (coarsen, steps, st)


def test_ca_entry_points_launch_the_kernel(dev):
    n, block = 256, 16
    emb, packed = _packed("sierpinski-gasket", n, block, 5, dev, binary=True)
    TC.reset_launch_counts()
    got = ops.ca_run(packed.clone(), torch.zeros_like(packed), 10, fuse=4,
                     block=block, storage="compact", n=n)
    assert TC.launch_counts() == {"sierpinski_ca_fused": 3,
                                  "mma_decode_chains": 0}
    from repro_torch.kernels import ref
    want = emb
    for _ in range(10):
        want = ref.ca_step_ref(want, "parity")
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   block))
    assert torch.equal(lay.unpack(got, block), want)
    one = ops.ca_step(packed, torch.zeros_like(packed), block=block,
                      storage="compact", n=n)
    assert torch.equal(lay.unpack(one, block), ref.ca_step_ref(emb, "parity"))
    # the ring's depth through the entry points: the same bits, counted
    TC.reset_launch_counts()
    for st in (2, 3, 9):  # 9 clamps to the deepest ring
        deep = ops.ca_run(packed.clone(), torch.zeros_like(packed), 10,
                          fuse=4, block=block, storage="compact", n=n,
                          num_stages=st)
        assert torch.equal(deep, got)
    assert TC.launch_counts()["sierpinski_ca_fused"] == 9


def test_ca_ring_geometry(dev):
    # small working tiles: the requested depth on a persistent grid; a
    # rho = 128 tile at fuse 4 (76 KB) fits two tiles but not four, so
    # depth 3 runs at 1; at fuse 128 it takes the global-scratch path
    # (depth 0)
    n, block = 256, 16
    _, packed = _packed("sierpinski-gasket", n, block, 5, dev)
    plan, n_, blk = TC.prepare_run(packed, torch.zeros_like(packed),
                                   block=block, storage="compact", n=n)
    p = plan.launch_params(n_, blk, dev)
    for st in (1, 2, 3):
        slots, ctas = TC.ring_geometry(p, 4, st)
        assert slots == st and 1 <= ctas <= p.steps
    emb, _ = _packed("sierpinski-gasket", 512, 128, 5, dev)
    plan, n_, blk = TC.prepare_run(emb, torch.zeros_like(emb), block=128)
    p = plan.launch_params(n_, blk, dev)
    assert TC.ring_geometry(p, 128, 3)[0] == 0
    assert TC.ring_geometry(p, 4, 3)[0] == 1
    with pytest.raises(ValueError, match="ring"):
        TC.ca_cuda(emb, torch.zeros_like(emb), p, 1, 1, "parity", 0.2, 5)


# ---------------------------------------------------------------------------
# block-space flash attention and paged decode
# ---------------------------------------------------------------------------

def _randn(shape, seed, dev, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


#: (kind, window, (H, Hkv), S, D, block): MHA, GQA and MQA heads
FLASH_CASES = [("causal", 0, (4, 4), 256, 64, 64),
               ("causal", 0, (4, 2), 256, 128, 128),
               ("causal", 0, (8, 1), 256, 32, 64),
               ("local", 64, (4, 2), 512, 64, 64),
               ("local", 128, (2, 2), 512, 256, 128),
               ("full", 0, (4, 1), 256, 256, 64),
               ("full", 0, (2, 2), 128, 16, 32)]


@pytest.mark.parametrize("kind,window,heads,s,d,block", FLASH_CASES)
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, kind, window, heads, s, d, block,
                                    grid_mode, dtype):
    h, hkv = heads
    q = _randn((2, h, s, d), 1, dev, dtype)
    k = _randn((2, hkv, s, d), 2, dev, dtype)
    v = _randn((2, hkv, s, d), 3, dev, dtype)
    sched = FA.flash_schedule(q.shape, k.shape, kind=kind, window=window,
                              block_q=block, block_k=block,
                              grid_mode=grid_mode)
    FA.check_flash_against_plain(q, k, v, sched)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_kernel_compact_kv_and_decode(dev, grid_mode):
    from repro_torch.core.compact import pack_kv
    # rectangular local with compact KV: the first visited tile of the
    # first query rows is wholly masked
    q = _randn((1, 4, 128, 64), 4, dev, torch.float32)
    k = _randn((1, 2, 512, 64), 5, dev, torch.float32)
    v = _randn((1, 2, 512, 64), 6, dev, torch.float32)
    full = FA.flash_schedule(q.shape, k.shape, kind="local", window=128,
                             block_q=64, block_k=64, grid_mode=grid_mode)
    kc = pack_kv(k, full.domain, 64).contiguous()
    vc = pack_kv(v, full.domain, 64).contiguous()
    sched = FA.flash_schedule(q.shape, kc.shape, kind="local", window=128,
                              block_q=64, block_k=64, grid_mode=grid_mode,
                              storage="compact", kv_seq_len=512)
    _, emb = FA.check_flash_against_plain(q, k, v, full)
    _, comp = FA.check_flash_against_plain(q, kc, vc, sched)
    assert torch.equal(emb, comp)
    # decode: scalar and per-row seq_pos, with and without a window
    qd = _randn((3, 4, 1, 64), 7, dev, torch.float32)
    kd = _randn((3, 2, 512, 64), 8, dev, torch.float32)
    vd = _randn((3, 2, 512, 64), 9, dev, torch.float32)
    for pos, win in ((300, 0), ([37, 511, 128], 0), ([37, 511, 200], 100)):
        sched = FA.flash_schedule(qd.shape, kd.shape, kind="full",
                                  window=win, block_q=1, block_k=128,
                                  grid_mode=grid_mode, has_pos=True)
        FA.check_flash_against_plain(
            qd, kd, vd, sched, FA.seq_pos_vector(pos, 3, dev))


@pytest.mark.parametrize("ps,d,dtype,heads", [
    (16, 64, torch.float32, (8, 4)), (128, 256, torch.bfloat16, (8, 4)),
    (64, 128, torch.float32, (8, 4)),
    # llama4-maverick's heads: a group of 5 in a chunk of kMaxGroup 8
    (16, 128, torch.bfloat16, (40, 8)),
    # internvl2-26b's: a group of 6
    (16, 128, torch.bfloat16, (48, 8))])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_kernel_bit_equal_to_contiguous(dev, ps, d, dtype, heads,
                                              window):
    from repro_torch.core import paged as P
    (h, hkv), b, smax = heads, 3, 512
    q = _randn((b, h, 1, d), 10, dev, dtype)
    k = _randn((b, hkv, smax, d), 11, dev, dtype)
    v = _randn((b, hkv, smax, d), 12, dev, dtype)
    npg = smax // ps
    perm = torch.randperm(b * npg, generator=torch.Generator().manual_seed(3))
    pool = P.init_pool(b * npg + 1, hkv, ps, d, dtype, dev)
    table = torch.zeros((b, npg), dtype=torch.int32)
    for i in range(b):
        table[i] = perm[i * npg:(i + 1) * npg] + 1
        P.write_prefill_pages(pool, table[i].to(dev), k[i], v[i])
    table = table.to(dev)
    pos = torch.tensor([37, 511, 200], dtype=torch.int32, device=dev)
    psched = FA.paged_schedule(q.shape, pool.shape, table.shape,
                               window=window)
    _, paged = FA.check_paged_against_plain(q, pool, table, pos, psched)
    sched = FA.flash_schedule(q.shape, k.shape, kind="full", window=window,
                              block_q=1, block_k=ps, has_pos=True)
    contiguous = FA.flash_cuda(q, k, v, sched, pos)
    assert torch.equal(paged, contiguous)


#: decode cases (heads (H, Hkv), d, dtype): MHA, GQA 16/8 and 4/2, MQA
#: 8/1, a group of 16 q heads (two head chunks), llama4-maverick's 40/8
#: (a group of 5: 5 of a chunk's 8 rows), the decode heads of the
#: hybrid and embedding-input stacks -- zamba2-2.7b's shared block 32/32
#: x 80, musicgen-large's 32/32 x 64, internvl2-26b's 48/8 x 128 (a
#: group of 6) -- and head dims whose rows are not whole 16-byte pieces
#: (element loads)
DECODE_CASES = [((4, 4), 64, torch.float32), ((16, 8), 256, torch.bfloat16),
                ((40, 8), 128, torch.bfloat16),
                ((32, 32), 80, torch.bfloat16), ((32, 32), 64, torch.bfloat16),
                ((48, 8), 128, torch.bfloat16),
                ((16, 8), 256, torch.float32), ((4, 2), 128, torch.bfloat16),
                ((8, 1), 64, torch.bfloat16), ((8, 1), 256, torch.float32),
                ((16, 1), 32, torch.float32), ((6, 2), 36, torch.bfloat16),
                ((2, 2), 30, torch.float32)]


@pytest.mark.parametrize("heads,d,dtype", DECODE_CASES)
@pytest.mark.parametrize("window", [0, 300])
def test_decode_kernel_matches_plain(dev, heads, d, dtype, window):
    # positions at tile and split edges of 64-key blocks (256-key splits),
    # every lowering bit-equal, compact KV the same launch
    h, hkv = heads
    q = _randn((5, h, 1, d), 60, dev, dtype)
    k = _randn((5, hkv, 1024, d), 61, dev, dtype)
    v = _randn((5, hkv, 1024, d), 62, dev, dtype)
    pos = torch.tensor([0, 63, 256, 700, 1023], dtype=torch.int32,
                       device=dev)
    FA.reset_launch_counts()
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind="full",
                                  window=window, block_q=1, block_k=64,
                                  grid_mode=gm, has_pos=True)
        assert FA.flash_route(sched, dtype) == "decode"
        outs.append(FA.check_flash_against_plain(q, k, v, sched, pos)[1])
    assert all(torch.equal(o, outs[0]) for o in outs)
    comp = FA.flash_schedule(q.shape, k.shape, kind="full", window=window,
                             block_q=1, block_k=64, storage="compact",
                             kv_seq_len=1024, has_pos=True)
    assert torch.equal(FA.decode_cuda(q, k, v, comp, pos), outs[0])
    assert FA.launch_counts()["flash_attention_decode"] == len(LOWERINGS) + 1
    assert FA.launch_counts()["flash_attention"] == 0


def test_decode_launches_are_bit_equal_and_leave_the_counters_zero(dev):
    # gemma3-12b's decode shape: 7 splits per (slot, kv head) merged by the
    # last CTA to arrive; every launch gives the same bits and resets the
    # counters; a misaligned copy of the caches (element loads) too
    q = _randn((4, 16, 1, 256), 63, dev, torch.bfloat16)
    k = _randn((4, 8, 1664, 256), 64, dev, torch.bfloat16)
    v = _randn((4, 8, 1664, 256), 65, dev, torch.bfloat16)
    pos = torch.tensor([1536, 1539, 1543, 1551], dtype=torch.int32,
                       device=dev)
    sched = FA.flash_schedule(q.shape, k.shape, kind="full", block_q=1,
                              block_k=128, has_pos=True)
    first = FA.decode_cuda(q, k, v, sched, pos)
    for _ in range(5):
        assert torch.equal(FA.decode_cuda(q, k, v, sched, pos), first)
    torch.cuda.synchronize()
    cnt = FA._DECODE_COUNTERS[(q.device, torch.cuda.current_stream(
        q.device).cuda_stream)]
    assert not cnt.any()
    n = k.numel()
    base = torch.empty(2 * n + 1, dtype=k.dtype, device=dev)
    km, vm = base[1:n + 1].view(k.shape), base[n + 1:].view(v.shape)
    km.copy_(k)
    vm.copy_(v)
    assert km.data_ptr() % 16 == 2
    assert torch.equal(FA.decode_cuda(q, km, vm, sched, pos), first)
    FA.check_flash_against_plain(q, k, v, sched, pos)


def test_paged_bit_equal_to_contiguous_at_the_gemma_width(dev):
    # page 16, d 256, bf16, GQA 16/8 at gemma3-12b's serving positions, a
    # page table wider than the slots need
    from repro_torch.core import paged as P
    b, h, hkv, d, ps, smax = 4, 16, 8, 256, 16, 1664
    q = _randn((b, h, 1, d), 66, dev, torch.bfloat16)
    k = _randn((b, hkv, smax, d), 67, dev, torch.bfloat16)
    v = _randn((b, hkv, smax, d), 68, dev, torch.bfloat16)
    npg = smax // ps
    perm = torch.randperm(b * npg, generator=torch.Generator().manual_seed(4))
    pool = P.init_pool(b * npg + 1, hkv, ps, d, torch.bfloat16, dev)
    table = torch.zeros((b, npg + 7), dtype=torch.int32)
    for i in range(b):
        table[i, :npg] = perm[i * npg:(i + 1) * npg] + 1
        P.write_prefill_pages(pool, table[i, :npg].to(dev), k[i], v[i])
    table = table.to(dev)
    pos = torch.tensor([1536, 1539, 1543, 1551], dtype=torch.int32,
                       device=dev)
    for window in (1024, 0):
        psched = FA.paged_schedule(q.shape, pool.shape, table.shape,
                                   window=window)
        _, paged = FA.check_paged_against_plain(q, pool, table, pos, psched)
        sched = FA.flash_schedule(q.shape, k.shape, kind="full",
                                  window=window, block_q=1, block_k=ps,
                                  has_pos=True)
        assert torch.equal(paged, FA.flash_cuda(q, k, v, sched, pos))


def test_attention_entry_points_launch_the_kernels(dev):
    # f32 prefill takes the 3xTF32 tensor-core kernel
    FA.reset_launch_counts()
    q = _randn((1, 2, 128, 32), 13, dev, torch.float32)
    out = ops.flash_attention(q, q, q, kind="causal", block_q=64,
                              block_k=64)
    pool = _randn((3, 2, 16, 32), 14, dev, torch.float32)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    dec = ops.paged_flash_attention(q[:, :, :1], pool, table, 20)
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc_f32": 1,
                                  "paged_flash_attention": 1}
    assert out.shape == q.shape and dec.shape == (1, 2, 1, 32)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_cuda(q.transpose(2, 3), q, q, FA.flash_schedule(
            (1, 2, 32, 128), (1, 2, 32, 128), kind="full", block_q=32,
            block_k=32))


def test_flash_kernels_reject_tiles_past_the_shared_memory_limit(dev):
    # D 254 with 2048-key tiles needs more shared memory per CTA than the
    # card's opt-in limit in the CUDA-core kernel, launched directly (no
    # route takes it); its wrapper raises before launching.  The tile
    # paths stream any block_k in sub-tiles (the f32 one takes this call,
    # its 1016-byte rows in 8-byte pieces), and the decode kernels stage
    # no tile: the paged one takes 2048-key pages
    torch.backends.cuda.matmul.allow_tf32 = False
    FA.reset_launch_counts()
    q = _randn((1, 1, 1, 254), 15, dev, torch.float32)
    k = _randn((1, 1, 2048, 254), 16, dev, torch.float32)
    sched = FA.flash_schedule(q.shape, k.shape, kind="full", block_q=1,
                              block_k=2048)
    with pytest.raises(ValueError, match="shared memory"):
        FA.flash_cuda_core(q, k, k, sched)
    assert FA.flash_route(sched, q.dtype) == "tc_f32"
    FA.check_flash_against_plain(q, k, k, sched)
    q = _randn((1, 1, 1, 256), 15, dev, torch.float32)
    pos = torch.tensor([2047], dtype=torch.int32, device=dev)
    pool = _randn((2, 2, 2048, 256), 17, dev, torch.float32)
    table = torch.tensor([[1]], dtype=torch.int32, device=dev)
    psched = FA.paged_schedule(q.shape, pool.shape, table.shape)
    FA.check_paged_against_plain(q, pool, table, pos, psched)
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc_f32": 1,
                                  "paged_flash_attention": 1}


# ---------------------------------------------------------------------------
# B4's bf16 tile path on the tensor cores (flash_fwd_tc_kernel)
# ---------------------------------------------------------------------------

TC_HEADS = {"MHA": (4, 4), "GQA": (8, 4), "MQA": (8, 1)}


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads", list(TC_HEADS))
@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_flash_tc_kernel_matches_plain(dev, kind, heads, d, block):
    # every lowering within the bf16 tolerance of the plain version and
    # bit-equal to the others, each launch on the tensor cores
    h, hkv = TC_HEADS[heads]
    s = 4 * block if kind == "local" else 2 * block
    q = _randn((2, h, s, d), 21, dev, torch.bfloat16)
    k = _randn((2, hkv, s, d), 22, dev, torch.bfloat16)
    v = _randn((2, hkv, s, d), 23, dev, torch.bfloat16)
    FA.reset_launch_counts()
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind,
                                  window=2 * block if kind == "local" else 0,
                                  block_q=block, block_k=block, grid_mode=gm)
        assert FA.flash_route(sched, q.dtype) == "tc"
        outs.append(FA.check_flash_against_plain(q, k, v, sched)[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert FA.launch_counts()["flash_attention_tc"] == len(LOWERINGS)
    assert FA.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_tc_kernel_compact_kv_and_seq_pos(dev, grid_mode):
    from repro_torch.core.compact import pack_kv
    # rectangular local with compact KV: bit-equal to embedded
    q = _randn((1, 4, 128, 64), 24, dev, torch.bfloat16)
    k = _randn((1, 2, 512, 64), 25, dev, torch.bfloat16)
    v = _randn((1, 2, 512, 64), 26, dev, torch.bfloat16)
    full = FA.flash_schedule(q.shape, k.shape, kind="local", window=128,
                             block_q=64, block_k=64, grid_mode=grid_mode)
    kc = pack_kv(k, full.domain, 64).contiguous()
    vc = pack_kv(v, full.domain, 64).contiguous()
    sched = FA.flash_schedule(q.shape, kc.shape, kind="local", window=128,
                              block_q=64, block_k=64, grid_mode=grid_mode,
                              storage="compact", kv_seq_len=512)
    FA.reset_launch_counts()
    _, emb = FA.check_flash_against_plain(q, k, v, full)
    _, comp = FA.check_flash_against_plain(q, kc, vc, sched)
    assert torch.equal(emb, comp)
    # seq_pos at block_q 64: scalar and per-row, with and without a window
    qs = _randn((3, 4, 64, 64), 27, dev, torch.bfloat16)
    ks = _randn((3, 2, 512, 64), 28, dev, torch.bfloat16)
    vs = _randn((3, 2, 512, 64), 29, dev, torch.bfloat16)
    for pos, win in ((300, 0), ([37, 511, 128], 0), ([37, 511, 200], 100)):
        sp = FA.flash_schedule(qs.shape, ks.shape, kind="full", window=win,
                               block_q=64, block_k=64, grid_mode=grid_mode,
                               has_pos=True)
        FA.check_flash_against_plain(qs, ks, vs, sp,
                                     FA.seq_pos_vector(pos, 3, dev))
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 5,
                                  "flash_attention_tc_f32": 0,
                                  "paged_flash_attention": 0}


def test_flash_tc_routing_on_the_card(dev):
    # bf16 prefill takes the bf16 tensor-core kernel, f32 prefill the
    # 3xTF32 one, decode neither (the split-K decode kernel)
    q = _randn((1, 2, 128, 64), 30, dev, torch.bfloat16)
    FA.reset_launch_counts()
    ops.flash_attention(q, q, q, kind="causal", block_q=64, block_k=64)
    assert FA.launch_counts()["flash_attention_tc"] == 1
    ops.flash_attention(q.float(), q.float(), q.float(), kind="causal",
                        block_q=64, block_k=64)
    qd = q[:, :, :1].contiguous()
    ops.flash_attention(qd, q, q, kind="full", block_q=1, block_k=64,
                        seq_pos=100)
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 1,
                                  "flash_attention_tc": 1,
                                  "flash_attention_tc_f32": 1,
                                  "paged_flash_attention": 0}
    with pytest.raises(ValueError, match="tensor-core"):
        FA.flash_tc_cuda(q.float(), q.float(), q.float(), FA.flash_schedule(
            q.shape, q.shape, block_q=64, block_k=64))


def test_flash_misaligned_bf16_views_take_the_tc_kernel(dev):
    # the tc kernel copies 16-byte pieces: a contiguous bf16 view that
    # starts 2 bytes past a boundary keeps its route, flash_cuda copies it
    # to an aligned buffer first, and the tc entry point refuses it as it
    # is
    shape = (1, 2, 128, 64)
    n = 2 * 128 * 64
    base = _randn((3 * n + 1,), 31, dev, torch.bfloat16)
    q, k, v = (base[1 + i * n:1 + (i + 1) * n].view(shape) for i in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    sched = FA.flash_schedule(shape, shape, kind="causal", block_q=64,
                              block_k=64)
    assert FA.flash_route(sched, q.dtype) == "tc"
    FA.reset_launch_counts()
    _, out = FA.check_flash_against_plain(q, k, v, sched)
    assert torch.equal(out, FA.flash_cuda(q.clone(), k.clone(), v.clone(),
                                          sched))
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 2,
                                  "flash_attention_tc_f32": 0,
                                  "paged_flash_attention": 0}
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_tc_cuda(q, k, v, sched)


# ---------------------------------------------------------------------------
# B4's f32 prefill on the tensor cores (flash_fwd_tf32_kernel, 3xTF32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads", list(TC_HEADS))
@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_flash_tc_f32_kernel_matches_plain(dev, kind, heads, d, block):
    # every lowering within 2e-5 of the plain version (full f32) and
    # bit-equal to the others, each launch on the 3xTF32 kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    h, hkv = TC_HEADS[heads]
    s = 4 * block if kind == "local" else 2 * block
    q = _randn((2, h, s, d), 41, dev, torch.float32)
    k = _randn((2, hkv, s, d), 42, dev, torch.float32)
    v = _randn((2, hkv, s, d), 43, dev, torch.float32)
    FA.reset_launch_counts()
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind,
                                  window=2 * block if kind == "local" else 0,
                                  block_q=block, block_k=block, grid_mode=gm)
        assert FA.flash_route(sched, q.dtype) == "tc_f32"
        outs.append(FA.check_flash_against_plain(q, k, v, sched)[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert FA.launch_counts()["flash_attention_tc_f32"] == len(LOWERINGS)
    assert FA.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("d,block,s", [(8, 16, 64), (40, 48, 96),
                                       (96, 256, 512), (128, 16, 48),
                                       (200, 64, 256), (136, 32, 96),
                                       (256, 48, 96), (256, 256, 512)])
def test_flash_tc_f32_kernel_odd_heads_and_blocks(dev, d, block, s):
    # head dims below the instantiation (k-steps and n-tiles skipped),
    # one-warp and two-pass query blocks, sub-tiles of 16 and 48 keys
    torch.backends.cuda.matmul.allow_tf32 = False
    q = _randn((2, 4, s, d), 44, dev, torch.float32)
    k = _randn((2, 2, s, d), 45, dev, torch.float32)
    for kind in ("causal", "full"):
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind, block_q=block,
                                  block_k=block)
        assert FA.flash_route(sched, q.dtype) == "tc_f32"
        FA.check_flash_against_plain(q, k, k, sched)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_tc_f32_kernel_compact_kv_and_seq_pos(dev, grid_mode):
    from repro_torch.core.compact import pack_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    # rectangular local with compact KV: bit-equal to embedded
    q = _randn((1, 4, 128, 64), 46, dev, torch.float32)
    k = _randn((1, 2, 512, 64), 47, dev, torch.float32)
    v = _randn((1, 2, 512, 64), 48, dev, torch.float32)
    full = FA.flash_schedule(q.shape, k.shape, kind="local", window=128,
                             block_q=64, block_k=64, grid_mode=grid_mode)
    kc = pack_kv(k, full.domain, 64).contiguous()
    vc = pack_kv(v, full.domain, 64).contiguous()
    sched = FA.flash_schedule(q.shape, kc.shape, kind="local", window=128,
                              block_q=64, block_k=64, grid_mode=grid_mode,
                              storage="compact", kv_seq_len=512)
    FA.reset_launch_counts()
    _, emb = FA.check_flash_against_plain(q, k, v, full)
    _, comp = FA.check_flash_against_plain(q, kc, vc, sched)
    assert torch.equal(emb, comp)
    # seq_pos at block_q 64: scalar and per-row, with and without a window
    qs = _randn((3, 4, 64, 128), 49, dev, torch.float32)
    ks = _randn((3, 2, 512, 128), 50, dev, torch.float32)
    vs = _randn((3, 2, 512, 128), 51, dev, torch.float32)
    for pos, win in ((300, 0), ([37, 511, 128], 0), ([37, 511, 200], 100)):
        sp = FA.flash_schedule(qs.shape, ks.shape, kind="full", window=win,
                               block_q=64, block_k=64, grid_mode=grid_mode,
                               has_pos=True)
        FA.check_flash_against_plain(qs, ks, vs, sp,
                                     FA.seq_pos_vector(pos, 3, dev))
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc_f32": 5,
                                  "paged_flash_attention": 0}


def test_flash_tc_f32_routing_on_the_card(dev):
    # f32 prefill up to head dim 256 takes the 3xTF32 kernel, 8-row
    # blocks and head rows of no whole number of 16-byte pieces included;
    # decode takes the split-K decode kernel, and the tf32 entry point
    # refuses bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    q = _randn((1, 2, 128, 128), 52, dev, torch.float32)
    FA.reset_launch_counts()
    ops.flash_attention(q, q, q, kind="causal", block_q=64, block_k=64)
    wide = _randn((1, 2, 128, 256), 53, dev, torch.float32)
    ops.flash_attention(wide, wide, wide, kind="causal", block_q=64,
                        block_k=64)
    ops.flash_attention(wide, wide, wide, kind="causal", block_q=8,
                        block_k=8)
    odd = _randn((1, 2, 128, 62), 55, dev, torch.float32)
    ops.flash_attention(odd, odd, odd, kind="causal", block_q=64,
                        block_k=64)
    ops.flash_attention(q[:, :, :1].contiguous(), q, q, kind="full",
                        block_q=1, block_k=64, seq_pos=100)
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 1,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc_f32": 4,
                                  "paged_flash_attention": 0}
    t = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="f32 tensor-core"):
        FA.flash_tc_f32_cuda(t, t, t, FA.flash_schedule(
            t.shape, t.shape, block_q=64, block_k=64))


def test_flash_misaligned_f32_views_take_the_tc_f32_kernel(dev):
    # a contiguous f32 view that starts 4 bytes past a 16-byte boundary
    # keeps its route, flash_cuda copies it to an aligned buffer first,
    # and the tf32 entry point refuses it as it is
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1, 2, 128, 64)
    n = 2 * 128 * 64
    base = _randn((3 * n + 1,), 54, dev, torch.float32)
    q, k, v = (base[1 + i * n:1 + (i + 1) * n].view(shape) for i in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    sched = FA.flash_schedule(shape, shape, kind="causal", block_q=64,
                              block_k=64)
    assert FA.flash_route(sched, q.dtype) == "tc_f32"
    FA.reset_launch_counts()
    _, out = FA.check_flash_against_plain(q, k, v, sched)
    assert torch.equal(out, FA.flash_cuda(q.clone(), k.clone(), v.clone(),
                                          sched))
    assert FA.launch_counts() == {"flash_attention": 0,
                                  "flash_attention_decode": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_tc_f32": 2,
                                  "paged_flash_attention": 0}
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_tc_f32_cuda(q, k, v, sched)


# ---------------------------------------------------------------------------
# ragged calls on the tile paths: blocks that are not multiples of 16,
# block_q = 1 without seq_pos, head dims of 8 (bf16) or 4 (f32) mod 16
# ---------------------------------------------------------------------------

#: (kind, block_q, block_k, S, D): the kinds take square blocks but full
RAGGED_CASES = [("causal", 72, 72, 288, 64), ("causal", 72, 72, 216, 256),
                ("causal", 24, 24, 96, 40), ("causal", 8, 8, 64, 128),
                ("causal", 1, 1, 24, 72), ("causal", 100, 100, 300, 64),
                ("local", 40, 40, 240, 64), ("full", 24, 40, 120, 256),
                ("full", 72, 16, 144, 136), ("full", 1, 64, 256, 64),
                ("causal", 64, 64, 128, 200)]


@pytest.mark.parametrize("kind,bq,bk,s,d", RAGGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_tile_paths_match_plain(dev, kind, bq, bk, s, d, dtype):
    # every lowering within tolerance of the plain version (bf16 rows
    # within ROW_RTOL) and bit-equal to the others, on a tile path
    torch.backends.cuda.matmul.allow_tf32 = False
    h, hkv = 4, 2
    sq = 1 if bq == 1 and kind == "full" else s
    q = _randn((2, h, sq, d), 61, dev, dtype)
    k = _randn((2, hkv, s, d), 62, dev, dtype)
    v = _randn((2, hkv, s, d), 63, dev, dtype)
    route = "tc" if dtype == torch.bfloat16 else "tc_f32"
    FA.reset_launch_counts()
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind,
                                  window=2 * bk if kind == "local" else 0,
                                  block_q=bq, block_k=bk, grid_mode=gm)
        assert FA.flash_route(sched, dtype) == route
        outs.append(FA.check_flash_against_plain(q, k, v, sched)[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert FA.launch_counts()[FA.ROUTE_KERNELS[route]] == len(LOWERINGS)
    assert FA.launch_counts()["flash_attention"] == 0


def test_ragged_tile_paths_seq_pos_and_nan_past_the_block(dev):
    # q, k and v end where NaN starts in their buffers: a 120-key run in
    # 40-key blocks ends in a 56-key sub-tile, whose 8 padded rows (and the
    # last query block's) lie past the tensors; they are zero-filled, never
    # read
    torch.backends.cuda.matmul.allow_tf32 = False

    def nan_tailed(shape, seed, dtype):
        t = _randn(shape, seed, dev, dtype)
        buf = torch.full((t.numel() + 4096,), float("nan"), dtype=dtype,
                         device=dev)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(shape)
    for dtype in (torch.float32, torch.bfloat16):
        q = nan_tailed((3, 4, 120, 64), 64, dtype)
        k = nan_tailed((3, 2, 120, 64), 65, dtype)
        v = nan_tailed((3, 2, 120, 64), 66, dtype)
        sc = FA.flash_schedule(q.shape, k.shape, block_q=40, block_k=40)
        assert torch.isfinite(FA.check_flash_against_plain(q, k, v, sc)[1]) \
            .all()
        for pos, win in ((100, 0), ([37, 119, 90], 0), ([37, 119, 90], 50)):
            sp = FA.flash_schedule(q.shape, k.shape, kind="full", window=win,
                                   block_q=40, block_k=40, has_pos=True)
            out = FA.check_flash_against_plain(
                q, k, v, sp, FA.seq_pos_vector(pos, 3, dev))[1]
            assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# head rows that are no whole number of 16-byte pieces on the tile paths
# (8-, 4- and 2-byte pieces), and the CUDA-core kernel no route takes
# ---------------------------------------------------------------------------

#: (dtype, D): f32 D 62 (8-byte pieces), D 37 (4), bf16 D 60 (8), D 250
#: (4), D 37 (2: loaded through registers)
NARROW_CASES = [(torch.float32, 62), (torch.float32, 37),
                (torch.bfloat16, 60), (torch.bfloat16, 250),
                (torch.bfloat16, 37)]


@pytest.mark.parametrize("block", [64, 72])
@pytest.mark.parametrize("dtype,d", NARROW_CASES)
@pytest.mark.parametrize("kind", ["causal", "full"])
def test_narrow_rows_take_the_tile_paths(dev, kind, dtype, d, block):
    # every lowering within tolerance of the plain version (bf16 rows
    # within ROW_RTOL) and bit-equal to the others, on a tile path; the
    # tensors end where NaN starts in their buffers, so a read past a row
    # or a store past the last would show
    torch.backends.cuda.matmul.allow_tf32 = False

    def nan_tailed(shape, seed):
        t = _randn(shape, seed, dev, dtype)
        buf = torch.full((t.numel() + 4096,), float("nan"), dtype=dtype,
                         device=dev)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(shape)
    s = 2 * block
    q, k, v = (nan_tailed(shape, seed) for shape, seed in (
        ((2, 4, s, d), 70), ((2, 2, s, d), 71), ((2, 2, s, d), 72)))
    route = "tc" if dtype == torch.bfloat16 else "tc_f32"
    FA.reset_launch_counts()
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind, block_q=block,
                                  block_k=block, grid_mode=gm)
        assert FA.flash_route(sched, dtype) == route
        outs.append(FA.check_flash_against_plain(q, k, v, sched)[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all()
    assert FA.launch_counts()[FA.ROUTE_KERNELS[route]] == len(LOWERINGS)
    assert FA.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_core_kernel_launched_directly_matches_plain(dev, dtype):
    # no route takes flash_fwd_kernel; launched directly it still holds to
    # the plain version, at a narrow head dim and at quickstart's 64
    torch.backends.cuda.matmul.allow_tf32 = False
    FA.reset_launch_counts()
    for d in (62, 64):
        q = _randn((2, 4, 256, d), 75, dev, dtype)
        k = _randn((2, 2, 256, d), 76, dev, dtype)
        sched = FA.flash_schedule(q.shape, k.shape, block_q=64, block_k=64)
        FA._compare(FA.flash_cuda_core(q, k, k, sched),
                    FA.flash_attention_plain(q, k, k, sched),
                    f"CUDA-core kernel D {d} {dtype}")
    assert FA.launch_counts()["flash_attention"] == 2


#: (fractal, n, block): at least 16 steps a CTA on the persistent grid,
#: so the batched chains resolve whole and short batches
CA_MMA_CASES = [("sierpinski-gasket", 4096, 4), ("sierpinski-carpet", 729, 1),
                ("vicsek-cross", 2187, 1)]


@pytest.mark.parametrize("fractal,n,block", CA_MMA_CASES)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
def test_ca_mma_bit_equal_to_closed_form_at_every_depth(dev, fractal, n,
                                                        block, storage):
    emb, packed = _packed(fractal, n, block, n + 7, dev, binary=True)
    a = packed if storage == "compact" else emb
    for fuse in (1, 3):
        outs = {}
        for gm in ("closed_form", "mma"):
            plan, n_, blk = TC.prepare_run(a, torch.zeros_like(a), block=block,
                                           grid_mode=gm, fractal=fractal,
                                           storage=storage, n=n)
            p = plan.launch_params(n_, blk, dev)
            h = TC.effective_fuse(fuse, fuse, blk, 1)
            for st in (1, 2, 3):
                outs[gm, st] = TC.ca_cuda(a, torch.zeros_like(a), p, h, h,
                                          "parity", 0.2, st)
        assert p.steps > 16 * TC.ring_geometry(p, h, 1)[1]
        for key, got in outs.items():
            assert torch.equal(got, outs["closed_form", 1]), (fuse, key)


@pytest.mark.parametrize("storage", ["compact", "embedded"])
def test_ca_mma_row_chain_bit_equal_to_closed_form(dev, storage):
    from repro_torch.core.domain import TriangularDomain
    dom, block = TriangularDomain(600), 4
    lay = compact_layout(dom)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randint(0, 2, shape, generator=g, device=dev).float()
    outs = {}
    for gm in ("closed_form", "mma"):
        plan, n, blk = TC.prepare_run(a, torch.zeros_like(a), block=block,
                                      grid_mode=gm, storage=storage,
                                      domain=dom)
        p = plan.launch_params(n, blk, dev)
        for st in (1, 2, 3):
            outs[gm, st] = TC.ca_cuda(a, torch.zeros_like(a), p, 2, 2,
                                      "parity", 0.2, st)
    assert p.steps > 16 * TC.ring_geometry(p, 2, 1)[1]
    for key, got in outs.items():
        assert torch.equal(got, outs["closed_form", 1]), key


# ---------------------------------------------------------------------------
# the row-major domains (domain=) and the mma lowering's tensor-core chains
# ---------------------------------------------------------------------------

def _row_domains():
    from repro_torch.core.domain import (BandDomain, BoundingBoxDomain,
                                         TriangularDomain)
    return {"triangular": TriangularDomain(17), "band": BandDomain(24, 5),
            "band-rect": BandDomain(8, 3, 20),
            "bounding-box": BoundingBoxDomain(7, 5),
            "tall-box": BoundingBoxDomain(3, 6),
            "triangular-k": TriangularDomain(200)}


@pytest.mark.parametrize("name", ["triangular", "band", "band-rect",
                                  "bounding-box", "tall-box",
                                  "triangular-k"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("block", [1, 8, 32])
def test_domain_kernels_match_plain(dev, name, grid_mode, storage, block):
    dom = _row_domains()[name]
    lay = compact_layout(dom)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = torch.Generator(device=dev).manual_seed(block)
    m = torch.randint(-8, 9, shape, generator=g, device=dev).float()
    plan, n, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                     storage=storage, domain=dom)
    p = plan.launch_params(n, blk, dev)
    TW.check_write_against_plain(m, 7.3, plan, n, blk, p)
    TW.check_sum_against_plain(m, plan, n, blk, p)


@pytest.mark.parametrize("name", ["triangular", "band", "band-rect",
                                  "bounding-box", "tall-box"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_domain_ca_kernel_matches_plain(dev, name, grid_mode, storage, rule):
    dom = _row_domains()[name]
    block = 8
    lay = compact_layout(dom)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = torch.Generator(device=dev).manual_seed(11)
    a = (torch.randint(0, 2, shape, generator=g, device=dev).float()
         if rule == "parity" else torch.randn(shape, generator=g, device=dev))
    b = torch.zeros_like(a)
    plan, n, blk = TC.prepare_run(a, b, block=block, grid_mode=grid_mode,
                                  storage=storage, domain=dom)
    for h, steps in ((1, 1), (3, 3), (8, 5)):
        TC.check_ca_against_plain(a, b, plan, n, blk, h, steps, rule, 0.2)


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
@pytest.mark.parametrize("storage", ["compact", "embedded"])
def test_mma_bit_equal_to_closed_form(dev, fractal, n, block, s, storage):
    """The tensor-core chains give the closed_form results bit for bit:
    write, sum partials and CA, coarsened or not."""
    emb, packed = _packed(fractal, n, block, 3 * n, dev, binary=True)
    m = packed if storage == "compact" else emb
    for coarsen in (1, s):
        outs, parts, cas = [], [], []
        for gm in ("closed_form", "mma"):
            plan, n_, blk = TW.prepare_launch(m, block=block, grid_mode=gm,
                                              fractal=fractal,
                                              storage=storage, n=n,
                                              coarsen=coarsen)
            p = plan.launch_params(n_, blk, dev)
            outs.append(TW.write_cuda(m.clone(), 7.0, p))
            parts.append(TW.sum_partials_cuda(m, p))
            cas.append(TC.ca_cuda(m, torch.zeros_like(m), p, 1, 1, "parity",
                                  0.2))
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(parts[0], parts[1])
        assert torch.equal(cas[0], cas[1])


def test_mma_raises_past_the_bound_before_any_launch(dev):
    TW.reset_launch_counts()
    m = torch.zeros((4096, 4096), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="2\\^24"):
        ops.sierpinski_write_(m, 1.0, block=1, grid_mode="mma",
                              fractal="sierpinski-carpet", storage="compact",
                              n=6561)
    assert TW.launch_counts()["sierpinski_write"] == 0


# ---------------------------------------------------------------------------
# the write and sum kernels' work split: persistent CTAs taking runs of
# steps, a warp per step walking along the rows, 128-bit chunks
# ---------------------------------------------------------------------------

def _domain_state(dom, block, storage, dtype, seed, dev):
    """An integer-valued state of the domain's storage shape."""
    lay = compact_layout(dom)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g, device=dev).to(dtype)


def _walk_domains():
    """Domains of ~10^6 steps (runs of many steps a warp, so the row walk
    crosses block rows and slot rows) with step counts that are no
    multiple of a run."""
    from repro_torch.core.domain import (BandDomain, BoundingBoxDomain,
                                         TriangularDomain)
    return {"triangular": TriangularDomain(1499),
            "band": BandDomain(4001, 251),
            "band-rect": BandDomain(3001, 331, 3331),
            "bounding-box": BoundingBoxDomain(1001, 997)}


@pytest.mark.parametrize("name", ["triangular", "band", "band-rect",
                                  "bounding-box"])
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("block", [1, 4])
def test_domain_runs_cross_block_rows_and_slot_rows(dev, name, storage,
                                                    grid_mode, block):
    dom = _walk_domains()[name]
    m = _domain_state(dom, block, storage, torch.float32, 7, dev)
    plan, n, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                     storage=storage, domain=dom)
    p = plan.launch_params(n, blk, dev)
    TW.check_write_against_plain(m, 7.3, plan, n, blk, p)
    TW.check_sum_against_plain(m, plan, n, blk, p)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
def test_fewer_steps_than_resident_warps(dev, grid_mode, storage):
    from repro_torch.core.domain import TriangularDomain
    dom = TriangularDomain(2)  # 3 steps (4 bounding): warps 3/4-7 idle
    for block in (1, 8, 32):
        m = _domain_state(dom, block, storage, torch.float32, block, dev)
        plan, n, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                         storage=storage, domain=dom)
        p = plan.launch_params(n, blk, dev)
        assert p.steps == (4 if grid_mode == "bounding" else 3)
        TW.check_write_against_plain(m, 7.3, plan, n, blk, p)
        TW.check_sum_against_plain(m, plan, n, blk, p)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_pad_slots_keep_their_sentinel(dev, grid_mode, dtype):
    from repro_torch.core.domain import TriangularDomain
    dom = TriangularDomain(301)
    lay = compact_layout(dom)
    scols, srows = lay.grid_shape
    assert scols * srows > dom.num_blocks  # the last slot row has pads
    block = 8
    m = torch.full(lay.array_shape(block), -3, dtype=dtype, device=dev)
    plan, n, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                     storage="compact", domain=dom)
    p = plan.launch_params(n, blk, dev)
    TW.check_write_against_plain(m, 5, plan, n, blk, p)
    out = TW.write_cuda(m.clone(), 5, p)
    slot = torch.arange(scols * srows, device=dev).view(srows, scols)
    pad = (slot >= dom.num_blocks).repeat_interleave(block, 0) \
        .repeat_interleave(block, 1)
    assert bool((out[pad] == -3).all()) and bool((out[~pad] == 5).all())


def _misaligned(x):
    """A contiguous copy of ``x`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("domain", ["gasket", "triangular"])
def test_misaligned_view_takes_the_scalar_path(dev, grid_mode, domain):
    """A contiguous state 4 bytes past a 16-byte boundary: the same cells
    through scalar accesses, in the same lane order, so float partials
    are bit-equal to the aligned copy's."""
    from repro_torch.core.domain import TriangularDomain
    kw = dict(block=32, grid_mode=grid_mode)
    if domain == "gasket":
        shape, kw["fractal"] = (1024, 1024), "sierpinski-gasket"
    else:
        dom = TriangularDomain(40)
        shape, kw["domain"] = compact_layout(dom).embedded_shape(32), dom
    g = torch.Generator(device=dev).manual_seed(3)
    even = torch.randn(shape, generator=g, device=dev)
    odd = _misaligned(even)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    assert even.data_ptr() % 16 == 0
    plan, n, blk = TW.prepare_launch(odd, **kw)
    p = plan.launch_params(n, blk, dev)
    got = TW.write_cuda(_misaligned(odd), 7.3, p)
    assert torch.equal(got, TW.sierpinski_write_plain(odd.clone(), 7.3, plan,
                                                      n, blk))
    assert torch.equal(got, TW.write_cuda(even.clone(), 7.3, p))
    TW.check_sum_against_plain(odd, plan, n, blk, p, rtol=1e-5)
    assert torch.equal(TW.sum_partials_cuda(odd, p),
                       TW.sum_partials_cuda(even, p))


@pytest.mark.parametrize("block", [3, 9, 27, 128])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_domain_odd_and_wide_blocks(dev, block, grid_mode, dtype):
    from repro_torch.core.domain import BandDomain, TriangularDomain
    for dom in (TriangularDomain(7), BandDomain(9, 4)):
        for storage in ("embedded", "compact"):
            m = _domain_state(dom, block, storage, dtype, block, dev)
            plan, n, blk = TW.prepare_launch(m, block=block,
                                             grid_mode=grid_mode,
                                             storage=storage, domain=dom)
            p = plan.launch_params(n, blk, dev)
            TW.check_write_against_plain(m, 7.3, plan, n, blk, p)
            TW.check_sum_against_plain(m, plan, n, blk, p)


@pytest.mark.parametrize("name", ["triangular", "band", "band-rect",
                                  "bounding-box", "tall-box"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
def test_domain_kernels_other_dtypes(dev, name, grid_mode, storage, dtype):
    dom = _row_domains()[name]
    for block in (1, 8, 16):
        m = _domain_state(dom, block, storage, dtype, block, dev)
        plan, n, blk = TW.prepare_launch(m, block=block, grid_mode=grid_mode,
                                         storage=storage, domain=dom)
        p = plan.launch_params(n, blk, dev)
        TW.check_write_against_plain(m, 7.3, plan, n, blk, p)
        TW.check_sum_against_plain(m, plan, n, blk, p)


@pytest.mark.parametrize("fractal,n,block,s", COMPACT_CASES)
def test_float_partials_equal_across_lowerings_and_storages(dev, fractal, n,
                                                            block, s):
    """The lane order depends only on a cell's offset in its superblock:
    on a normal f32 state the partials of closed_form, prefetch_lut and
    mma, embedded and compact, coarsened or not, are bit-equal."""
    emb, packed = _packed(fractal, n, block, 5 * n, dev, integer=False)
    for coarsen in (1, s):
        got = []
        for storage, m in (("embedded", emb), ("compact", packed)):
            for gm in ("closed_form", "prefetch_lut", "mma"):
                plan, n_, blk = TW.prepare_launch(
                    m, block=block, grid_mode=gm, fractal=fractal,
                    storage=storage, n=n, coarsen=coarsen)
                got.append(TW.sum_partials_cuda(
                    m, plan.launch_params(n_, blk, dev)))
        assert all(torch.equal(got[0], x) for x in got[1:])


# ---------------------------------------------------------------------------
# the tuner on the card: keys carry the card's name, "auto" is the winner
# ---------------------------------------------------------------------------

@pytest.fixture
def tune_cache(monkeypatch, tmp_path):
    from repro_torch.core import tune
    path = str(tmp_path / "repro-torch-tune.json")
    monkeypatch.setenv(tune.CACHE_ENV, path)
    return path


@pytest.mark.parametrize("storage", ["embedded", "compact"])
def test_autotune_write_on_the_card(dev, tune_cache, storage):
    from repro_torch.core import tune
    n, block = 256, 8
    cfg, us, trials = tune.autotune_write(n=n, block=block, max_coarsen=2,
                                          storages=(storage,), device=dev)
    assert us > 0 and us == min(t for _, t in trials)
    assert len(trials) == len(LOWERINGS) * 2
    entry = next(iter(json.load(open(tune_cache))))
    key = json.loads(entry)
    assert key["backend"] == "cuda"
    assert key["device"] == torch.cuda.get_device_name(dev)
    # the unrestricted key the "auto" lookups read, then "auto" against
    # the winner spelled out and the plain version
    cfg, _, _ = tune.autotune_write(n=n, block=block, max_coarsen=2,
                                    device=dev)
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   block))
    m = _state(n, torch.float32, 5, dev)
    if cfg["storage"] == "compact":
        m = lay.pack(m, block)
    kw = dict(block=block, storage=cfg["storage"], n=n)
    TW.reset_launch_counts()
    got = ops.sierpinski_write(m, 2.0, grid_mode="auto", coarsen="auto",
                               num_stages="auto", **kw)
    assert TW.launch_counts()["sierpinski_write"] == 1
    want = ops.sierpinski_write(m, 2.0, grid_mode=cfg["lowering"],
                                coarsen=cfg["coarsen"], num_stages=1, **kw)
    assert torch.equal(got, want)
    plan, _, _ = TW.prepare_launch(m, grid_mode=cfg["lowering"],
                                   coarsen=cfg["coarsen"], **kw)
    assert torch.equal(got, TW.sierpinski_write_plain(m.clone(), 2.0, plan,
                                                      n, block))
    assert torch.equal(
        ops.sierpinski_sum(m, grid_mode="auto", coarsen="auto", **kw),
        ops.sierpinski_sum(m, grid_mode=cfg["lowering"],
                           coarsen=cfg["coarsen"], **kw))


def test_autotune_ca_on_the_card(dev, tune_cache):
    from repro_torch.core import tune
    n, block = 256, 8
    cfg, us, trials = tune.autotune_ca(n=n, block=block, steps=4,
                                       max_fuse=2, max_coarsen=2,
                                       device=dev)
    assert us == min(t for _, t in trials)
    # the ring depth is an axis on the card
    assert {t["stages"] for t, _ in trials} == {1, 2}
    assert tune.best("ca", {"fractal": "sierpinski-gasket", "n": n,
                            "block": block, "rule": "parity"},
                     device=dev) == cfg
    assert tune.best("ca", {"fractal": "sierpinski-gasket", "n": n,
                            "block": block, "rule": "parity"},
                     device="cpu") is None
    lay = compact_layout(TW.resolve_fractal_domain("sierpinski-gasket", n,
                                                   block))
    a = tune.fractal_state("sierpinski-gasket", n, block, dev, seed=3)
    if cfg["storage"] == "compact":
        a = lay.pack(a, block)
    kw = dict(block=block, storage=cfg["storage"], n=n, donate=False)
    TC.reset_launch_counts()
    got = ops.ca_run(a, torch.zeros_like(a), 5, fuse="auto",
                     grid_mode="auto", coarsen="auto", num_stages="auto",
                     **kw)
    assert TC.launch_counts()["sierpinski_ca_fused"] == \
        len(TC.launch_schedule(5, TC.effective_fuse(
            cfg["fuse"], 5, block, cfg["coarsen"])))
    want = ops.ca_run(a, torch.zeros_like(a), 5, fuse=cfg["fuse"],
                      grid_mode=cfg["lowering"], coarsen=cfg["coarsen"],
                      num_stages=cfg["stages"], **kw)
    assert torch.equal(got, want)
    plain = ops.ca_run(a.cpu(), torch.zeros_like(a.cpu()), 5, fuse=1,
                       block=block, storage=cfg["storage"], n=n)
    assert torch.equal(got.cpu(), plain)


# ---------------------------------------------------------------------------
# the guarded runtime on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,grid_mode,fault", [
    ("nan", "closed_form", "poison_tile"),
    ("bitflip", "prefetch_lut", "poison_tile"),
    ("", "prefetch_lut", "corrupt_table")])
def test_launch_hook_fires_around_write_cuda(dev, mode, grid_mode, fault):
    """The hook runs around the write kernel's launch: the faulted tile
    equals the plain version's under the same fault, the kernel's own
    count still rises, and the guard detects and recovers."""
    from repro_torch.runtime import chaos as RC
    from repro_torch.runtime.guard import (GuardedCall, spot_check,
                                           validate_finite)
    m = _state(64, torch.float32, 3, dev, integer=False)
    kw = dict(block=8, grid_mode=grid_mode, coarsen=1, num_stages=1)
    clean = ops.sierpinski_write(m, 2.0, **kw)
    spec = RC.FaultSpec(fault, "pallas", 0, mode=mode, step=5)
    TW.reset_launch_counts()
    with RC.ChaosInjector(RC.FaultPlan(0, [spec])) as chaos:
        bad = ops.sierpinski_write(m, 2.0, **kw)
    assert TW.launch_counts()["sierpinski_write"] == 1
    assert len(chaos.events) == 1
    with RC.ChaosInjector(RC.FaultPlan(0, [spec])):
        plain = ops.sierpinski_write(m.cpu(), 2.0, **kw)
    assert torch.equal(bad.cpu().isnan(), plain.isnan())
    assert torch.equal(bad.cpu().nan_to_num(), plain.nan_to_num())
    assert not torch.equal(bad, clean)
    validators = [spot_check(clean)] if mode != "nan" else \
        [validate_finite]
    with RC.ChaosInjector(RC.FaultPlan(0, [spec])) as chaos:
        guard = GuardedCall(lambda: ops.sierpinski_write(m, 2.0, **kw),
                            "write", retries=2, validators=validators,
                            before_retry=chaos.refresh)
        assert torch.equal(guard(), clean)
    assert [e.kind for e in guard.events] == ["validation", "retry", "ok"]


def test_real_out_of_memory_is_transient(dev):
    from repro_torch.runtime.guard import classify_error
    total = torch.cuda.get_device_properties(dev).total_memory
    with pytest.raises(torch.OutOfMemoryError) as e:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
    assert classify_error(e.value) == "transient"


def test_server_on_the_card_serves_at_ladder_level_zero(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import model as TM
    from repro_torch.runtime.guard import GuardEvent, ServerState
    cfg = get_config("quickstart", smoke=True).replace(
        attn_decode_kernel="blockspace")
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    FA.reset_launch_counts()
    srv = S.Server(cfg, model, S.ServeConfig(max_len=16,
                                             spot_check_every=2))
    out = srv.generate(prompts.numpy(), 6)
    assert out.shape == (2, 6)
    assert FA.launch_counts()["flash_attention_decode"] == \
        cfg.n_layers * 5
    assert srv.ladder.level == 0 and srv.state == ServerState.HEALTHY
    kinds = {e.kind for e in srv.events if isinstance(e, GuardEvent)}
    assert kinds == {"ok"}
    assert not [e for e in srv.events if not isinstance(e, GuardEvent)]


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_screen_finds_one_bad_value_on_the_card(dev, bad, dtype):
    """The guard's screen (one fused max-|x| a dtype on the card) finds a
    single non-finite value in one of 25 cache-sized leaves."""
    from repro_torch.runtime.guard import ValidationError, validate_finite
    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn(8, 1, 4096, device=dev, generator=g)] + [
        torch.randn(8, 256, 12, 64, device=dev, generator=g).to(dtype)
        for _ in range(24)]
    validate_finite(leaves)
    leaves[17].view(-1)[123457] = bad
    with pytest.raises(ValidationError,
                       match="1 non-finite values in leaf 17 "):
        validate_finite(leaves, "decode")


def test_fatal_decode_error_on_the_card_is_not_degraded(dev):
    """A fatal error on the card's blockspace rung raises; the server
    stays on the kernel's rung."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import model as TM
    from repro_torch.runtime import chaos as RC
    from repro_torch.runtime.guard import GuardExhausted
    cfg = get_config("quickstart", smoke=True).replace(
        attn_decode_kernel="blockspace")
    model = TM.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    plan = RC.FaultPlan(0, [RC.FaultSpec("fatal_error", "serve.decode", 2,
                                         rung=0)])
    srv = S.Server(cfg, model, S.ServeConfig(max_len=16),
                   chaos=RC.ChaosInjector(plan))
    with pytest.raises(GuardExhausted, match="fatal"):
        srv.generate(torch.zeros((2, 8), dtype=torch.int64).numpy(), 6)
    assert srv.ladder.level == 0 and srv.ladder.transitions == []


def test_trainer_takes_two_steps_on_the_card(dev, tmp_path):
    """Two train steps of the quickstart smoke config on the card, the
    flash VJP on (S 32 above a threshold of 16, chunk 8): finite losses,
    a checkpoint that resumes at step 2 with the next batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import train as TT
    cfg = get_config("quickstart", smoke=True).replace(
        flash_threshold=16, attn_chunk=8, remat=True, logit_chunk=8)

    def pipe():
        return SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=32, global_batch=4))
    tcfg = TT.TrainConfig(steps=2, log_every=100, ckpt_dir=str(tmp_path))
    tr = TT.Trainer(cfg, tcfg)
    model, opt, hist = tr.run(pipe())
    assert tr.device.type == "cuda" and model.device.type == "cuda"
    assert len(hist) == 2 and all(torch.isfinite(torch.tensor(h["loss"]))
                                  for h in hist)
    p = pipe()
    step, model2, opt2 = TT.Trainer(cfg, tcfg).restore_or_init(p)
    assert step == 2 and p.state_dict() == {"step": 2}
    assert int(opt2["count"]) == 2
    for (_, a), (_, b) in zip(model.named_parameters(),
                              model2.named_parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the sharded lowering: each rank's launch against its plain version, in
# one process (the plan's rank is explicit: no process group)
# ---------------------------------------------------------------------------

#: (fractal, n, block, coarsen): the gasket at n 32 block 8 (a 3 x 3
#: orthotope) leaves rank 3 of 4 without rows
MESH_CASES = [("sierpinski-gasket", 64, 8, 2), ("sierpinski-carpet", 81, 3, 3),
              ("sierpinski-gasket", 32, 8, 1)]


def _mesh(D):
    import types
    return types.SimpleNamespace(shape={"data": D})


def _rank_views(m, fractal, n, block, storage, grid_mode, coarsen,
                halo=False):
    for D in (2, 3, 4):
        for rank in range(D):
            yield TW.shard_plan(m, block=block, grid_mode=grid_mode,
                                fractal=fractal, storage=storage, n=n,
                                domain=None, coarsen=coarsen, mesh=_mesh(D),
                                shard_axis="data", rank=rank, halo=halo)[0]


@pytest.mark.parametrize("fractal,n,block,coarsen", MESH_CASES)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_sharded_write_and_partials_match_plain(dev, fractal, n, block,
                                                coarsen, storage,
                                                grid_mode):
    m = _state(n, torch.float32, 5, dev)
    if storage == "compact":
        m = compact_layout(TW.resolve_fractal_domain(fractal, n, block)) \
            .pack(m, block)
    for s in sorted({1, coarsen}):
        for view in _rank_views(m, fractal, n, block, storage, grid_mode, s):
            local = view.slab(m, block) if storage == "compact" else m
            TW.check_shard_against_plain(local, 2.5, view, n, block)


@pytest.mark.parametrize("fractal,n,block,coarsen", MESH_CASES)
@pytest.mark.parametrize("storage", ["embedded", "compact"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_sharded_ca_matches_plain(dev, fractal, n, block, coarsen, storage,
                                  grid_mode):
    lay = compact_layout(TW.resolve_fractal_domain(fractal, n, block))
    mask = torch.from_numpy(F.FRACTALS[fractal].membership_grid(n).copy()).to(dev)
    states = {"parity": torch.where(mask, _state(n, torch.float32, 6, dev)
                                    .abs() % 2, 0),
              "diffusion": torch.where(mask, _state(n, torch.float32, 7,
                                                    dev, integer=False), 0)}
    compact = storage == "compact"
    for s in sorted({1, coarsen}):
        for rule, x in states.items():
            x = lay.pack(x, block) if compact else x
            for view in _rank_views(x, fractal, n, block, storage,
                                    grid_mode, s, halo=compact):
                a = view.extended(x, block) if compact else x
                b = torch.zeros_like(a)
                views = [(view, (1, 2))]
                if compact and grid_mode != "bounding" and \
                        view.phase_tables_host() is not None:
                    views += [(view.phase_view(w), (2,))
                              for w in ("interior", "boundary")]
                for fuse in (1, 3):
                    if fuse > s * block:
                        continue
                    for v, depths in views:
                        for stages in depths:
                            TC.check_ca_shard_against_plain(
                                a, b, v, n, block, fuse, fuse, rule, 0.2,
                                stages)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 72)])
@pytest.mark.parametrize("kind,balance", [("causal", "contiguous"),
                                          ("causal", "zigzag"),
                                          ("local", "contiguous"),
                                          ("full", "contiguous")])
def test_sharded_flash_tile_paths_match_plain(dev, dtype, d, kind, balance):
    s, blk = 512, 64
    q, k, v = (_randn(shape, 21 + i, dev, dtype) for i, shape in enumerate(
        [(1, 4, s, d), (1, 2, s, d), (1, 2, s, d)]))
    FA.reset_launch_counts()
    launches = 0
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, kind=kind,
                                  window=128 if kind == "local" else 0,
                                  block_q=blk, block_k=blk, grid_mode=gm)
        for D in (2, 4):
            for rank in range(D):
                band = FA.shard_band(sched, D, rank, balance)
                FA.check_flash_shard_against_plain(
                    FA.band_queries(q, sched, band), k, v, sched, band)
                launches += 1
    assert FA.shard_launch_counts()["flash_attention_sharded"] == launches


# ---------------------------------------------------------------------------
# the access sanitizer's trace builds and verify= on the card
# ---------------------------------------------------------------------------

def _trace_case(kernel, grid_mode, storage, coarsen, domain, dev,
                **extra):
    """(entry call, block) of one launch at a small shape."""
    from repro_torch.core.domain import SierpinskiDomain, TriangularDomain
    block = 4
    dom = SierpinskiDomain(16) if domain == "gasket" else TriangularDomain(8)
    n = dom.bounding_box[1] * block
    lay = compact_layout(dom)
    x = _state(n, torch.float32, 5, dev).abs() % 2
    m = lay.pack(x, block) if storage == "compact" else x
    kw = dict(block=block, grid_mode=grid_mode, storage=storage, n=n,
              domain=dom, coarsen=coarsen, num_stages=1, **extra)
    if kernel == "write":
        return lambda: TW.sierpinski_write(m, 3.0, **kw), block
    if kernel == "sum":
        return lambda: TW.sierpinski_sum(m, **kw), block
    return lambda: TC.ca_run(m, torch.zeros_like(m), 1, fuse=1,
                             donate=False, **kw), block


@pytest.mark.parametrize("kernel", ["write", "sum", "ca"])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
@pytest.mark.parametrize("storage,coarsen,domain", [
    ("embedded", 1, "gasket"), ("compact", 1, "gasket"),
    ("compact", 2, "gasket"), ("embedded", 1, "triangle"),
    ("compact", 1, "triangle")])
def test_trace_kernels_match_plain_rows(dev, kernel, grid_mode, storage,
                                        coarsen, domain):
    """The trace build's output is the untraced kernel's, bit for bit,
    and its rows are the plain version's rows for the same plan."""
    from repro_torch.analysis.sanitizer import AccessTrace, plain_trace
    run, _ = _trace_case(kernel, grid_mode, storage, coarsen, domain, dev)
    untraced = run()
    TW.reset_launch_counts()
    TC.reset_launch_counts()
    with AccessTrace() as tr:
        traced = run()
    assert tr.crosscheck() == []
    assert torch.equal(traced, untraced)
    (launch,) = tr.launches
    assert torch.equal(launch.trace,
                       plain_trace(launch.plan, kernel, dev))
    counts = {**TW.trace_launch_counts(), **TC.trace_launch_counts()}
    name = {"write": "sierpinski_write_trace",
            "sum": "sierpinski_sum_partials_trace",
            "ca": "sierpinski_ca_fused_trace"}[kernel]
    assert counts[name] == 1 and sum(counts.values()) == 1


@pytest.mark.parametrize("kernel", ["write", "sum", "ca"])
def test_verify_flag_refuses_a_corrupt_device_lut(dev, kernel):
    """verify=True reads the LUT the launch would read on the card: two
    swapped rows raise before any launch, and the sanitizer flags the
    same rows from the trace kernel's rows (every address stays valid)."""
    from repro_torch.analysis import PlanVerificationError, verify_launches
    from repro_torch.core import memo
    from repro_torch.core.domain import SierpinskiDomain
    from repro_torch.core.plan import GridPlan
    case = ("prefetch_lut", "compact", 1, "gasket", dev)
    run, block = _trace_case(kernel, *case)
    checked, _ = _trace_case(kernel, *case, verify=True)
    want = run()
    assert torch.equal(checked(), want)
    memo.clear()
    try:
        plan = GridPlan(SierpinskiDomain(16), "prefetch_lut",
                        storage="compact", backend=dev)
        lut = plan.launch_params(64, block, dev).lut
        row9 = lut[9].clone()    # steps 9 and 10 trade their blocks
        lut[9] = lut[10]
        lut[10] = row9
        TW.reset_launch_counts()
        TC.reset_launch_counts()
        with pytest.raises(PlanVerificationError):
            checked()
        assert sum(TW.launch_counts().values()) == 0
        assert sum(TC.launch_counts().values()) == 0
        _, findings = verify_launches(run, strict=False)
        assert any("step 9 decoded block" in f.detail for f in findings)
    finally:
        memo.clear()
    assert torch.equal(run(), want)
