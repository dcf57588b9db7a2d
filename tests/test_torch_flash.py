"""The port's block-space flash attention (plain version on the CPU)
against the JAX package's kernel (tpu-interpret on the CPU) and oracle:
the cases of tests/test_kernels.py and tests/test_attention.py, compact
KV, per-row seq_pos, full + run-time window, and the same ValueErrors.
f32 within 2e-5, bf16 within 2e-2 (ATTN_TOL)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.core.compact import pack_kv as t_pack_kv
from repro_torch.core.plan import LOWERINGS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from torch_parity import (as_f32, assert_attn_close, isolate_tune_caches,
                          qkv_pair)

import importlib

FA = importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.mark.parametrize("b,h,hkv,s,d,bq", [
    (1, 1, 1, 128, 32, 64),
    (2, 4, 2, 256, 32, 64),
    (1, 8, 1, 256, 64, 128),   # MQA
    (2, 2, 2, 128, 128, 64),
])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_causal_matches_jax(b, h, hkv, s, d, bq, grid_mode):
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(b, h, hkv, s, s, d, seed=s + d)
    kw = dict(kind="causal", block_q=bq, block_k=bq, grid_mode=grid_mode)
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert_attn_close(got, jops.flash_attention(jq, jk, jv, **kw))
    assert_attn_close(got, tref.attention_ref(tq, tk, tv, "causal"))


@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_local_matches_jax(window, grid_mode):
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 2, 2, 512, 512, 32, seed=window)
    kw = dict(kind="local", window=window, block_q=64, block_k=64,
              grid_mode=grid_mode)
    assert_attn_close(tops.flash_attention(tq, tk, tv, **kw),
                      jops.flash_attention(jq, jk, jv, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_full_rectangular_and_dtypes(dtype):
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 2, 1, 128, 384, 64, seed=3,
                                          dtype=dtype)
    kw = dict(kind="full", block_q=64, block_k=128, grid_mode="bounding")
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    assert_attn_close(got, jops.flash_attention(jq, jk, jv, **kw), dtype)
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 2, 1, 256, 256, 32, seed=4,
                                          dtype=dtype)
    kw = dict(kind="causal", block_q=64, block_k=64)
    assert_attn_close(tops.flash_attention(tq, tk, tv, **kw),
                      jops.flash_attention(jq, jk, jv, **kw), dtype)


def test_flash_lowerings_bit_identical():
    # closed_form, prefetch_lut and bounding visit the same tiles in the
    # same order: bit-identical (tests/test_kernels.py's invariant)
    _, (tq, tk, tv) = qkv_pair(1, 4, 2, 256, 256, 32, seed=5)
    for kind, window in (("causal", 0), ("local", 64)):
        outs = [tops.flash_attention(tq, tk, tv, kind=kind, window=window,
                                     block_q=64, block_k=64, grid_mode=gm)
                for gm in LOWERINGS]
        for o in outs[1:]:
            assert torch.equal(o, outs[0]), kind


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_flash_compact_kv_matches_jax(grid_mode):
    # rectangular local (queries are the last 128 of 512 positions): the
    # first visited tile of the first rows is wholly masked
    from repro.core.compact import pack_kv as j_pack_kv
    from repro.core.domain import make_attention_domain as j_dom
    from repro_torch.core.domain import make_attention_domain as t_dom
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 4, 2, 128, 512, 32, seed=6)
    kw = dict(kind="local", window=128, block_q=64, block_k=64,
              grid_mode=grid_mode)
    jd, td = j_dom("local", 2, 8, 3), t_dom("local", 2, 8, 3)
    jkc, jvc = j_pack_kv(jk, jd, 64), j_pack_kv(jv, jd, 64)
    tkc, tvc = t_pack_kv(tk, td, 64), t_pack_kv(tv, td, 64)
    assert np.array_equal(as_f32(tkc), as_f32(jkc))
    got = tops.flash_attention(tq, tkc, tvc, storage="compact",
                               kv_seq_len=512, **kw)
    want = jops.flash_attention(jq, jkc, jvc, storage="compact",
                                kv_seq_len=512, **kw)
    assert_attn_close(got, want)
    assert torch.equal(got, tops.flash_attention(tq, tk, tv, **kw))
    assert_attn_close(got, tref.attention_ref(tq, tk, tv, "local",
                                              window=128))


@pytest.mark.parametrize("grid_mode", ["closed_form", "mma"])
@pytest.mark.parametrize("pos,window", [(37, 0), ([41, 63, 13], 0),
                                        ([41, 63, 13], 16), (50, 24)])
def test_flash_decode_seq_pos_matches_jax(pos, window, grid_mode):
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(3, 4, 2, 1, 64, 16, seed=7)
    kw = dict(kind="full", window=window, block_q=1, block_k=16,
              grid_mode=grid_mode)
    got = tops.flash_attention(tq, tk, tv, seq_pos=torch.tensor(pos), **kw)
    want = jops.flash_attention(jq, jk, jv, seq_pos=jnp.asarray(pos), **kw)
    assert_attn_close(got, want)
    # the plain decode of the model stack agrees within the tolerance
    kind = "local" if window else "causal"
    assert_attn_close(got, TA.decode_attention(tq, tk, tv, torch.tensor(pos),
                                               kind=kind, window=window))


def test_flash_decode_vector_seq_pos_matches_per_row():
    _, (tq, tk, tv) = qkv_pair(3, 4, 2, 1, 64, 16, seed=8)
    lens = [41, 63, 13]
    got = TA.decode_attention_flash(tq, tk, tv, torch.tensor(lens))
    for i, n in enumerate(lens):
        row = TA.decode_attention_flash(tq[i:i + 1], tk[i:i + 1],
                                        tv[i:i + 1], n)
        assert torch.equal(got[i:i + 1], row), i
    uni = TA.decode_attention_flash(tq, tk, tv, torch.full((3,), 48))
    assert torch.equal(uni, TA.decode_attention_flash(tq, tk, tv, 48))


BAD_ARGS = [
    ("sq % block", dict(kind="causal", block_q=48, block_k=48), (1, 1, 1, 128, 128, 16)),
    ("causal rect", dict(kind="causal"), (1, 1, 1, 64, 128, 16)),
    ("local window", dict(kind="local", window=40, block_q=32, block_k=32), (1, 1, 1, 128, 128, 16)),
    ("local offset", dict(kind="local", window=32, block_q=32, block_k=32), (1, 1, 1, 64, 112, 16)),
    ("seq_pos kind", dict(kind="causal", seq_pos=3), (1, 1, 1, 64, 64, 16)),
    ("seq_pos shape", dict(kind="full", block_q=1, block_k=16, seq_pos=[1, 2, 3]), (2, 1, 1, 1, 64, 16)),
    ("compact length", dict(kind="local", window=32, block_q=32, block_k=32, storage="compact", kv_seq_len=256), (1, 1, 1, 64, 256, 16)),
    ("lowering", dict(kind="causal", grid_mode="diagonal"), (1, 1, 1, 64, 64, 16)),
    ("storage", dict(kind="causal", storage="packed"), (1, 1, 1, 64, 64, 16)),
]


@pytest.mark.parametrize("what,kw,shape", BAD_ARGS, ids=[c[0] for c in BAD_ARGS])
def test_flash_raises_the_jax_value_errors(what, kw, shape):
    b, h, hkv, sq, sk, d = shape
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(b, h, hkv, sq, sk, d, seed=9)
    with pytest.raises(ValueError) as jerr:
        jops.flash_attention(jq, jk, jv, **kw)
    with pytest.raises(ValueError) as terr:
        tops.flash_attention(tq, tk, tv, **kw)
    assert str(terr.value) == str(jerr.value)


def test_flash_unported_options_name_their_roadmap_item(monkeypatch,
                                                        tmp_path):
    isolate_tune_caches(monkeypatch, tmp_path)  # "auto" misses
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 1, 1, 64, 64, 16, seed=10)
    for kw, item in ((dict(grid_mode="auto"), None),
                     (dict(grid_mode="auto", kind="local", window=16), None),
                     (dict(num_stages=2), None), (dict(block_q="auto"), None),
                     (dict(mesh=object()), AttributeError),
                     (dict(verify=True), None)):
        if isinstance(item, type):
            # an object that is not a mesh: the reference's own error
            with pytest.raises(item):
                jops.flash_attention(jq, jk, jv, backend="tpu-interpret",
                                     **kw)
            with pytest.raises(item):
                tops.flash_attention(tq, tk, tv, **kw)
            continue
        if item is not None:
            with pytest.raises(NotImplementedError, match=item):
                tops.flash_attention(tq, tk, tv, **kw)
            continue
        # what the reference does: the untuned defaults (num_stages is
        # taken and changes nothing); local at the default 128-blocks
        # refuses a 16-token window, with the same error
        try:
            want = jops.flash_attention(jq, jk, jv, backend="tpu-interpret",
                                        **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                tops.flash_attention(tq, tk, tv, **kw)
            assert str(err.value) == str(e)
            continue
        got = tops.flash_attention(tq, tk, tv, **kw)
        base = {key: val for key, val in kw.items()
                if key in ("kind", "window")}
        assert torch.equal(got, tops.flash_attention(tq, tk, tv, **base))
        assert_attn_close(got, want)


# ---------------------------------------------------------------------------
# the model stack's plain attention paths (tests/test_attention.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["dense", "triangular"])
@pytest.mark.parametrize("kind,window,shape", [
    ("causal", 0, (2, 4, 2, 256, 256, 32)),
    ("local", 64, (1, 2, 2, 512, 512, 16)),
    ("causal", 0, (1, 2, 2, 64, 256, 16)),      # q are the last 64
])
def test_flash_xla_matches_jax(schedule, kind, window, shape):
    b, h, hkv, sq, sk, d = shape
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(b, h, hkv, sq, sk, d, seed=sk)
    got = TA.flash_attention_xla(tq, tk, tv, kind=kind, window=window,
                                 chunk=64, schedule=schedule)
    assert_attn_close(got, JA.flash_attention_xla(
        jq, jk, jv, kind=kind, window=window, chunk=64, schedule=schedule))
    assert_attn_close(got, jref.attention_ref(jq, jk, jv, kind,
                                              window=window))


def test_simple_decode_and_dispatcher_match_jax():
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 2, 2, 64, 64, 16, seed=11)
    for kind, window in (("causal", 0), ("local", 16)):
        assert_attn_close(
            TA.simple_attention(tq, tk, tv, kind=kind, window=window),
            JA.simple_attention(jq, jk, jv, kind=kind, window=window))
    assert_attn_close(
        TA.attention(tq, tk, tv, kind="causal", flash_threshold=16,
                     chunk=16),
        JA.attention(jq, jk, jv, kind="causal", flash_threshold=16,
                     chunk=16))
    with pytest.raises(ValueError):
        TA.attention(tq[:, :, :1], tk, tv, kind="causal")
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(2, 4, 2, 1, 64, 16, seed=12)
    for pos, kind, window in ((37, "causal", 0), (50, "local", 16)):
        assert_attn_close(
            TA.decode_attention(tq, tk, tv, pos, kind=kind, window=window),
            JA.decode_attention(jq, jk, jv, jnp.asarray(pos), kind=kind,
                                window=window))
    # a cache length that does not tile block_k runs the plain decode
    _, (tq, tk, tv) = qkv_pair(1, 2, 2, 1, 40, 16, seed=13)
    assert torch.equal(
        TA.decode_attention_flash(tq, tk, tv, 30, block_k=16),
        TA.decode_attention(tq, tk, tv, 30))
