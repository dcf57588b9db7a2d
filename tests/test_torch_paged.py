"""The port's paged KV cache against the JAX package's: the allocator,
the layout helpers (exactly equal), paged decode (within 2e-5 of the
JAX kernel under tpu-interpret; bit-equal to the port's contiguous
seq_pos decode at block_k == page_size), and the page-table verifier."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged as JP
from repro.models import attention as JA
from repro_torch.core import paged as TP
from repro_torch.core.plan import LOWERINGS
from repro_torch.models import attention as TA
from torch_parity import as_f32, assert_attn_close, attn_pair

RNG = np.random.default_rng(11)


def test_pool_allocator_sequences_equal_jax():
    ops = [("alloc", 2), ("alloc", 3), ("alloc", 1), ("free", [1, 2]),
           ("alloc", 1), ("free", [0]), ("alloc", 4), ("free", [3, 5]),
           ("alloc", 2), ("free", [2, 2]), ("free", [9])]
    pools = [JP.PagedKVPool(num_pages=8, page_size=8),
             TP.PagedKVPool(num_pages=8, page_size=8)]
    for op, arg in ops:
        got = []
        for pool in pools:
            try:
                got.append(getattr(pool, op)(arg))
            except ValueError as e:
                got.append(f"ValueError: {e}")
            got.append((pool.free_pages, pool.used_pages, list(pool._free),
                        pool.stats([5, 9])))
        assert got[:2] == got[2:], (op, arg)
    assert [TP.pages_for(n, 8) for n in (0, 1, 8, 9, 16)] == \
        [JP.pages_for(n, 8) for n in (0, 1, 8, 9, 16)] == [0, 1, 1, 2, 2]
    with pytest.raises(ValueError):
        TP.PagedKVPool(1, 8)


def test_layout_helpers_equal_jax():
    hkv, s, d, ps = 2, 20, 8, 8
    jk, tk = attn_pair((hkv, s, d), 1)
    jv, tv = attn_pair((hkv, s, d), 2)
    assert np.array_equal(as_f32(TP.fuse_kv(tk, tv)), as_f32(JP.fuse_kv(jk, jv)))
    kk, vv = TP.split_kv(TP.fuse_kv(tk, tv))
    assert torch.equal(kk, tk) and torch.equal(vv, tv)
    pages = [5, 2, 7]
    jpool = JP.write_prefill_pages(JP.init_pool(9, hkv, ps, d),
                                   jnp.asarray(pages, jnp.int32), jk, jv)
    tpool = TP.write_prefill_pages(TP.init_pool(9, hkv, ps, d, device="cpu"),
                                   torch.tensor(pages), tk, tv)
    assert np.array_equal(as_f32(tpool), as_f32(jpool))
    table = [[5, 2, 7], [7, 0, 5]]
    for a, b in zip(TP.gather_kv(tpool, torch.tensor(table)),
                    JP.gather_kv(jpool, jnp.asarray(table, jnp.int32))):
        assert np.array_equal(as_f32(a), as_f32(b))
    # append: active and inactive slots, a position past the table
    jnew = [attn_pair((3, hkv, 1, d), 3 + i) for i in range(2)]
    table = [[5, 2, 7], [1, 3, 0], [4, 6, 8]]
    pos, act = [9, 3, 30], [True, False, True]
    jout = JP.append_token(jpool, jnp.asarray(table, jnp.int32),
                           jnp.asarray(pos, jnp.int32), jnew[0][0],
                           jnew[1][0], active=jnp.asarray(act))
    tout = TP.append_token(tpool.clone(), torch.tensor(table, dtype=torch.int32),
                           torch.tensor(pos, dtype=torch.int32), jnew[0][1],
                           jnew[1][1], active=torch.tensor(act))
    assert np.array_equal(as_f32(tout), as_f32(jout))
    slot_pages = {0: [3, 1], 2: [4]}
    assert np.array_equal(TP.build_page_table(3, 4, slot_pages),
                          JP.build_page_table(3, 4, slot_pages))
    with pytest.raises(ValueError, match="room"):
        TP.build_page_table(1, 1, {0: [1, 2]})


def _paged_case(b, h, hkv, smax, d, ps, lens, seed=0):
    """Contiguous q/k/v + the same KV scattered into a shuffled pool,
    for both packages."""
    jq, tq = attn_pair((b, h, 1, d), seed)
    jk, tk = attn_pair((b, hkv, smax, d), seed + 1)
    jv, tv = attn_pair((b, hkv, smax, d), seed + 2)
    npg = TP.pages_for(smax, ps)
    perm = np.random.default_rng(3).permutation(b * npg) + 1
    jpool = JP.init_pool(b * npg + 1, hkv, ps, d)
    tpool = TP.init_pool(b * npg + 1, hkv, ps, d, device="cpu")
    table = np.zeros((b, npg), np.int32)
    for i in range(b):
        table[i] = perm[i * npg:(i + 1) * npg]
        jpool = JP.write_prefill_pages(jpool, jnp.asarray(table[i]), jk[i], jv[i])
        TP.write_prefill_pages(tpool, torch.from_numpy(table[i]), tk[i], tv[i])
    pos = np.asarray(lens, np.int32)
    return ((jq, jk, jv, jpool, jnp.asarray(table), jnp.asarray(pos)),
            (tq, tk, tv, tpool, torch.from_numpy(table), torch.from_numpy(pos)))


@pytest.mark.parametrize("gm", LOWERINGS)
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("window", [0, 16])
def test_paged_decode_matches_jax_and_contiguous(gm, ps, window):
    (jq, jk, jv, jpool, jtab, jpos), (tq, tk, tv, tpool, ttab, tpos) = \
        _paged_case(3, 4, 2, 64, 16, ps, lens=[37, 63, 9], seed=ps + window)
    got = TA.decode_attention_paged(tq, tpool, ttab, tpos, window=window,
                                    grid_mode=gm)
    want = JA.decode_attention_paged(jq, jpool, jtab, jpos, window=window,
                                     grid_mode=gm)
    assert_attn_close(got, want)
    # bit-equal to the port's contiguous seq_pos decode at block_k == ps
    kind = "local" if window else "causal"
    contiguous = TA.decode_attention_flash(tq, tk, tv, tpos, kind=kind,
                                           window=window, block_k=ps)
    assert torch.equal(got, contiguous)
    # the gather path reproduces the plain decode bitwise
    xla = TA.decode_attention_paged_xla(tq, tpool, ttab, tpos, window=window)
    assert torch.equal(xla, TA.decode_attention(tq, tk, tv, tpos, kind=kind,
                                                window=window))
    assert_attn_close(xla, JA.decode_attention_paged_xla(
        jq, jpool, jtab, jpos, window=window))


def test_paged_decode_validation():
    from repro_torch.kernels import ops as tops
    _, (tq, _, _, tpool, ttab, tpos) = _paged_case(2, 2, 1, 32, 8, 8,
                                                   lens=[5, 9])
    with pytest.raises(ValueError, match="single-token"):
        tops.paged_flash_attention(tq.expand(2, 2, 2, 8), tpool, ttab, tpos)
    with pytest.raises(ValueError, match="kv_pool"):
        tops.paged_flash_attention(tq, tpool[:, :1], ttab, tpos)
    with pytest.raises(ValueError, match="page_table rows"):
        tops.paged_flash_attention(tq, tpool, ttab[:1], tpos)
    # mma is accepted and, as on the JAX package's gpu structure, does not
    # change the launch: bit-equal to the default lowering
    assert torch.equal(
        tops.paged_flash_attention(tq, tpool, ttab, tpos, grid_mode="mma"),
        tops.paged_flash_attention(tq, tpool, ttab, tpos))
    # as in the JAX package, the paged entry has no tune lookup of its
    # own: "auto" is an unknown lowering
    with pytest.raises(ValueError, match="unknown lowering 'auto'"):
        tops.paged_flash_attention(tq, tpool, ttab, tpos, grid_mode="auto")
    # a scalar position broadcasts to every slot
    assert torch.equal(tops.paged_flash_attention(tq, tpool, ttab, 9),
                       tops.paged_flash_attention(tq, tpool, ttab,
                                                  torch.tensor([9, 9])))


def _healthy_table():
    table = np.zeros((3, 8), np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :2] = [4, 5]
    return table, [20, 13, 0]


@pytest.mark.parametrize("name,mutate,kw", [
    ("healthy", lambda t: None, {}),
    ("bounds", lambda t: t.__setitem__((0, 1), 99), {}),
    ("bounds", lambda t: t.__setitem__((0, 1), -1), {}),
    ("null-in-extent", lambda t: t.__setitem__((1, 0), 0), {}),
    ("double-map", lambda t: t.__setitem__((1, 1), 2), {}),
    ("stale-free", lambda t: None, {"free_pages": [4]}),
    ("tail-null", lambda t: t.__setitem__((2, 0), 7), {}),
])
def test_verify_page_table_findings_equal_jax(name, mutate, kw):
    from repro.analysis import verify_page_table as j_verify
    from repro_torch.analysis import PlanVerificationError, verify_page_table
    table, lens = _healthy_table()
    mutate(table)
    args = dict(page_size=8, num_pages=16, **kw)
    if name == "healthy":
        assert verify_page_table(table, lens, **args).to_json() == \
            j_verify(table, lens, **args).to_json()
        return
    with pytest.raises(ValueError) as jerr:
        j_verify(table, lens, **args)
    with pytest.raises(PlanVerificationError, match=name) as terr:
        verify_page_table(table, lens, **args)
    assert str(terr.value) == str(jerr.value)
