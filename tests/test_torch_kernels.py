"""The port's kernels (plain PyTorch versions, as they run on the CPU) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles.

Inputs come from numpy with a fixed seed and go through both packages.  The
tolerances are the JAX kernel tests' own: 2e-5 for the flash forward and
2e-4 for its backward (tests/test_kernels.py), 1e-4 for gradients through
the autograd op (``test_custom_vjp_matches_autodiff``), ``_TOLS["fp"] =
(2e-5, 1e-5)`` for the paged decode (tests/test_paged_decode.py).  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode_attention as jda
from repro.kernels import flash_attention as jfa
from repro.kernels import paged_decode as jpk
from repro.kernels import ref as jref
from repro_torch.core import decode_attention as tda
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.masking import MaskSpec
from repro_torch.core.tiling import stripe_permutation
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode as tpk
from repro_torch.kernels import ref as tref
from repro_torch.parallel.context import ParallelCtx

INF = jref.BAND_INF
FWD_TOL = 2e-5
BWD_TOL = 2e-4
GRAD_TOL = 1e-4
PAGED_ATOL, PAGED_RTOL = 2e-5, 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


BANDS = {
    # name: (band, stride_q, stride_kv, segments)
    "full": ((0, 0, -INF, INF), 1, 1, False),
    "causal": ((0, 0, 0, INF), 1, 1, False),
    "striped": ((1, 0, 0, INF), 2, 2, False),  # stride-2 stripes, chunk 1 vs 0
    "window": ((0, 0, 0, 7), 1, 1, False),
    "segment": ((0, 0, 0, INF), 1, 1, True),
    "empty_rows": ((0, 8, 0, INF), 1, 1, False),  # rows 0..7 see nothing
}
SHAPES = [
    (1, 32, 32, 2, 2, 16),  # MHA
    (2, 32, 16, 4, 1, 8),  # GQA 4:1, rectangular
]


@pytest.mark.parametrize("shape", SHAPES, ids=["mha", "gqa"])
@pytest.mark.parametrize("name", list(BANDS))
def test_attention_ref_matches_pallas_and_jnp(name, shape):
    B, Sq, Skv, H, Hkv, D = shape
    band, sq, skv, seg = BANDS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    qj, qt = _both(_np(rng, B, Sq, H, D))
    kj, kt = _both(_np(rng, B, Skv, Hkv, D))
    vj, vt = _both(_np(rng, B, Skv, Hkv, D))
    jkw, tkw = {}, {}
    if seg:
        ids_q = np.sort(rng.integers(0, 3, Sq)).astype(np.int32)
        ids_k = np.sort(rng.integers(0, 3, Skv)).astype(np.int32)
        jkw = dict(seg_q=jnp.asarray(ids_q), seg_kv=jnp.asarray(ids_k))
        tkw = dict(seg_q=torch.from_numpy(ids_q), seg_kv=torch.from_numpy(ids_k))
    scale = D**-0.5
    o_t, lse_t = tref.attention_ref(
        qt, kt, vt, scale=scale, band=band, stride_q=sq, stride_kv=skv, **tkw
    )
    o_p, lse_p = jfa.flash_attention_fwd(
        qj, kj, vj, jnp.asarray(band, jnp.int32), scale=scale, stride_q=sq, stride_kv=skv,
        block_q=16, block_kv=16 if Skv >= 16 else Skv, interpret=True, **jkw,
    )
    o_r, lse_r = jref.attention_ref(
        qj, kj, vj, scale=scale, band=band, stride_q=sq, stride_kv=skv, **jkw
    )
    for o_j, lse_j in ((o_p, lse_p), (o_r, lse_r)):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=FWD_TOL, rtol=FWD_TOL)
    if name == "empty_rows":
        assert np.all(lse_t.numpy()[..., :8] == tref.NEG_INF)
        assert np.all(o_t.numpy()[:, :8] == 0)
    # the kernel wrapper takes the plain version for CPU tensors
    o_w, lse_w = tfa.flash_attention_fwd(
        qt, kt, vt, band, scale=scale, stride_q=sq, stride_kv=skv, **tkw
    )
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


def test_per_row_band_matches_rowwise_jnp():
    """A [B, 4] band (the dense decode step's one launch for every slot)
    equals the JAX row-by-row band calls."""
    rng = np.random.default_rng(0)
    B, Skv, H, Hkv, D = 3, 24, 4, 2, 16
    q, k, v = _np(rng, B, 1, H, D), _np(rng, B, Skv, Hkv, D), _np(rng, B, Skv, Hkv, D)
    pos = np.array([0, 9, 23], np.int32)
    band = torch.stack([torch.from_numpy(pos)] + [torch.zeros(B, dtype=torch.int32)] * 2
                       + [torch.full((B,), 5, dtype=torch.int32)], dim=1)
    o_t, lse_t = tops.block_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), band
    )
    for b in range(B):
        o_j, lse_j = jref.attention_ref(
            jnp.asarray(q[b : b + 1]), jnp.asarray(k[b : b + 1]), jnp.asarray(v[b : b + 1]),
            band=(int(pos[b]), 0, 0, 5),
        )
        np.testing.assert_allclose(o_t[b : b + 1].numpy(), np.asarray(o_j), atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(lse_t[b : b + 1].numpy(), np.asarray(lse_j), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 5)])
def test_flash_attention_op_matches_jax(causal, window):
    rng = np.random.default_rng(1)
    qj, qt = _both(_np(rng, 1, 20, 4, 8))
    kj, kt = _both(_np(rng, 1, 20, 2, 8))
    vj, vt = _both(_np(rng, 1, 20, 2, 8))
    from repro.kernels import ops as jops

    o_t = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    o_j = jops.flash_attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=FWD_TOL, rtol=FWD_TOL)


BWD_CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, bq, bk, band, stride_q, stride_kv, segments, delta)
    "causal": (1, 32, 32, 2, 2, 16, 16, 16, (0, 0, 0, INF), 1, 1, False, False),
    "window": (1, 32, 32, 2, 2, 16, 16, 16, (0, 0, 0, 7), 1, 1, False, False),
    "striped": (1, 32, 32, 2, 2, 16, 16, 16, (1, 0, 0, INF), 2, 2, False, False),
    "segment": (1, 32, 32, 2, 2, 16, 16, 16, (0, 0, 0, INF), 1, 1, True, False),
    "gqa_2to1": (1, 64, 32, 4, 2, 8, 32, 16, (0, 0, -INF, INF), 1, 1, False, False),
    "gqa_3to1": (2, 32, 64, 3, 1, 16, 16, 32, (0, 0, 0, INF), 1, 1, False, False),
    "delta_given": (1, 32, 32, 4, 2, 16, 16, 16, (0, 0, 0, INF), 1, 1, False, True),
    "empty_rows": (1, 32, 32, 2, 1, 16, 16, 16, (0, 8, 0, INF), 1, 1, False, False),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_attention_bwd_ref_matches_pallas_and_jnp(name):
    """The plain backward (and the wrapper on CPU tensors) against JAX's
    Pallas backward in interpret mode and its jnp oracle."""
    B, Sq, Skv, H, Hkv, D, bq, bk, band, sq, skv, seg, given = BWD_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrays = [_np(rng, B, Sq, H, D), _np(rng, B, Skv, Hkv, D), _np(rng, B, Skv, Hkv, D),
              _np(rng, B, Sq, H, D)]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_both(x) for x in arrays)
    jkw, tkw = {}, {}
    if seg:
        ids = np.sort(rng.integers(0, 3, Sq)).astype(np.int32)
        jkw = dict(seg_q=jnp.asarray(ids), seg_kv=jnp.asarray(ids))
        tkw = dict(seg_q=torch.from_numpy(ids), seg_kv=torch.from_numpy(ids))
    scale = D**-0.5
    oj, lsej = jref.attention_ref(qj, kj, vj, scale=scale, band=band, stride_q=sq,
                                  stride_kv=skv, **jkw)
    ot, lset = torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lsej))
    deltaj = deltat = None
    if given:
        delta = np.array(jnp.sum(doj * oj, axis=-1))
        deltaj, deltat = jnp.asarray(delta), torch.from_numpy(delta)
    got = tref.attention_bwd_ref(
        qt, kt, vt, None if given else ot, lset, dot, scale=scale, band=band, stride_q=sq,
        stride_kv=skv, delta=deltat, **tkw,
    )
    pallas = jfa.flash_attention_bwd(
        qj, kj, vj, oj, lsej, doj, jnp.asarray(band, jnp.int32), scale=scale, stride_q=sq,
        stride_kv=skv, block_q=bq, block_kv=bk, interpret=True, delta=deltaj, **jkw,
    )
    oracle = jref.attention_bwd_ref(
        qj, kj, vj, oj, lsej, doj, scale=scale, band=band, stride_q=sq, stride_kv=skv,
        delta=deltaj, **jkw,
    )
    for want in (pallas, oracle):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL, rtol=BWD_TOL)
    if name == "empty_rows":
        assert np.all(got[0].numpy()[:, :8] == 0)
    wrapped = tfa.flash_attention_bwd(
        qt, kt, vt, None if given else ot, lset, dot, band, scale=scale, stride_q=sq,
        stride_kv=skv, delta=deltat, **tkw,
    )
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)
    assert tops.block_attention_bwd(
        qt, kt, vt, None if given else ot, lset, dot, band, stride_q=sq, stride_kv=skv,
        delta=deltat, **tkw,
    )[0].shape == qt.shape


def test_flash_attention_bwd_argument_checks():
    q = torch.zeros(2, 8, 2, 8)
    lse = torch.zeros(2, 2, 8)
    with pytest.raises(ValueError, match=r"\[4\]"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, torch.zeros(2, 4, dtype=torch.int32),
                                scale=1.0)
    with pytest.raises(ValueError, match="o or delta"):
        tfa.flash_attention_bwd(q, q, q, None, lse, q, (0, 0, 0, INF), scale=1.0)


# (B, Sq, H, Hkv, D, dtype) -> (body, key splits) at the main path's shapes
FWD_PLANS = {
    # granite-8b packed prefill (1,500 tokens) and a 256-token chunk per slot
    "granite_packed_prefill": ((1, 1500, 32, 8, 128, torch.bfloat16), ("tile", 1)),
    "granite_chunk": ((8, 256, 32, 8, 128, torch.bfloat16), ("tile", 1)),
    # hymba-1.5b window prefill, and its decode tick: 8 slots x 5 kv heads =
    # 40 CTAs would leave most of the 132 SMs idle, so the keys split
    "hymba_prefill": ((1, 1536, 25, 5, 64, torch.bfloat16), ("tile", 1)),
    "hymba_decode": ((8, 1, 25, 5, 64, torch.bfloat16), ("decode", 7)),
    # granite verify (spec_k 4: 16 packed rows) and decode tick (64 CTAs)
    "granite_verify": ((8, 4, 32, 8, 128, torch.bfloat16), ("decode", 5)),
    "granite_decode": ((8, 1, 32, 8, 128, torch.bfloat16), ("decode", 5)),
    # 32 packed rows are the decode body's most; 33 go to the tile body
    "decode_rows_32": ((8, 8, 32, 8, 128, torch.bfloat16), ("decode", 5)),
    "tile_rows_36": ((8, 9, 32, 8, 128, torch.bfloat16), ("tile", 1)),
    # enough kv-head CTAs: no split
    "decode_wide_batch": ((16, 1, 32, 8, 128, torch.bfloat16), ("decode", 1)),
    # fp32 (training, dequantized pools) takes the same bodies by the same
    # shapes, in their two-term instantiations
    "train_fp32": ((1, 4096, 32, 8, 128, torch.float32), ("tile_fp32", 1)),
    "quant_verify_fp32": ((8, 4, 32, 8, 128, torch.float32), ("decode_fp32", 5)),
    "decode_rows_32_fp32": ((8, 8, 32, 8, 128, torch.float32), ("decode_fp32", 5)),
    "tile_rows_36_fp32": ((8, 9, 32, 8, 128, torch.float32), ("tile_fp32", 1)),
    "decode_wide_batch_fp32": ((16, 1, 32, 8, 128, torch.float32), ("decode_fp32", 1)),
    # gemma-7b (16 / 16 heads of 256): bf16 packed prefill on the tile body,
    # an int8 pool's fp32 chunk (256 per slot) on the fp32 tile body, the
    # decode tick of 8 slots (128 CTAs: no split) and a verify (spec_k 4: 5
    # rows) on the decode body
    "gemma_packed_prefill": ((1, 1500, 16, 16, 256, torch.bfloat16), ("tile", 1)),
    "gemma_chunk_fp32": ((8, 256, 16, 16, 256, torch.float32), ("tile_fp32", 1)),
    "gemma_decode": ((8, 1, 16, 16, 256, torch.bfloat16), ("decode", 1)),
    "gemma_decode_fp32": ((8, 1, 16, 16, 256, torch.float32), ("decode_fp32", 1)),
    "gemma_verify_fp32": ((8, 5, 16, 16, 256, torch.float32), ("decode_fp32", 1)),
    # at head dim 256 the decode body takes 16 packed rows, not 32: 17 and
    # GQA 2 x 9 go to the tile body; a slot's tick with few kv heads splits
    "gemma_rows_16": ((2, 16, 16, 16, 256, torch.bfloat16), ("decode", 8)),
    "gemma_rows_17": ((2, 17, 16, 16, 256, torch.bfloat16), ("tile", 1)),
    "gemma_group2_rows_18": ((2, 9, 4, 2, 256, torch.float32), ("tile_fp32", 1)),
    "gemma_one_slot": ((1, 1, 16, 16, 256, torch.bfloat16), ("decode", 8)),
}


@pytest.mark.parametrize("name", list(FWD_PLANS))
def test_fwd_plan_routes_main_path_shapes(name):
    shape, want = FWD_PLANS[name]
    assert tfa._fwd_plan(*shape) == want
    body, splits = want
    assert tfa.FWD_TERMS[body] == (2 if shape[-1] == torch.float32 else 1)
    if body.startswith("decode"):
        B, Sq, H, Hkv = shape[:4]
        assert Sq * (H // Hkv) <= tfa.DECODE_MAX_ROWS and 1 <= splits <= tfa.MAX_SPLITS
        if shape[4] == 256:
            assert Sq * (H // Hkv) <= tfa.DECODE_MAX_ROWS_D256


@pytest.mark.parametrize("D", [16, 48, 80])
def test_fwd_plan_refuses_other_head_dims(D):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims"):
            tfa._fwd_plan(1, 64, 8, 2, D, dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_fwd_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._fwd_plan(1, 64, 8, 2, 64, dtype)


# (B, Sq, Skv, H, Hkv, D, dtype) -> the backward's body: the type alone picks
# it, at every shape the kernels take
BWD_PLANS = {
    # granite-8b training (fp32 params) and its bf16 run, 4096 tokens
    "granite_train_fp32": ((1, 4096, 4096, 32, 8, 128, torch.float32), "tc_fp32"),
    "granite_train_bf16": ((1, 4096, 4096, 32, 8, 128, torch.bfloat16), "tc_bf16"),
    # hymba-1.5b's 25 / 5 heads of 64, ragged
    "hymba_fp32": ((2, 300, 300, 25, 5, 64, torch.float32), "tc_fp32"),
    "hymba_bf16": ((2, 300, 300, 25, 5, 64, torch.bfloat16), "tc_bf16"),
    # a cross-length chunk of keys, D = 32, MHA
    "cross_d32_fp32": ((3, 100, 260, 4, 4, 32, torch.float32), "tc_fp32"),
    "cross_d32_bf16": ((3, 100, 260, 4, 4, 32, torch.bfloat16), "tc_bf16"),
    # a single query row: no decode body in the backward
    "one_row_bf16": ((8, 1, 2048, 32, 8, 128, torch.bfloat16), "tc_bf16"),
    # gemma-7b training (16 / 16 heads of 256) and its bf16 run
    "gemma_train_fp32": ((1, 4096, 4096, 16, 16, 256, torch.float32), "tc_fp32"),
    "gemma_train_bf16": ((1, 4096, 4096, 16, 16, 256, torch.bfloat16), "tc_bf16"),
    # minicpm3-4b training (MLA's expanded 40 / 40 heads of 96) and its bf16 run
    "minicpm_train_fp32": ((1, 4096, 4096, 40, 40, 96, torch.float32), "tc_fp32"),
    "minicpm_train_bf16": ((1, 4096, 4096, 40, 40, 96, torch.bfloat16), "tc_bf16"),
}


@pytest.mark.parametrize("name", list(BWD_PLANS))
def test_bwd_plan_routes_by_type(name):
    shape, want = BWD_PLANS[name]
    assert tfa._bwd_plan(*shape) == want
    assert tfa.BWD_TERMS[want] == (2 if shape[-1] == torch.float32 else 1)


@pytest.mark.parametrize("D", [16, 48, 80])
def test_bwd_plan_refuses_other_head_dims(D):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims"):
            tfa._bwd_plan(1, 64, 64, 8, 2, D, dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_bwd_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._bwd_plan(1, 64, 64, 8, 2, 64, dtype)


@pytest.mark.parametrize("heads", [(8, 3), (6, 4), (0, 2), (4, 0)])
def test_bwd_plan_refuses_uneven_groups(heads):
    with pytest.raises(ValueError, match="divisible"):
        tfa._bwd_plan(1, 64, 64, *heads, 64, torch.float32)


@pytest.mark.parametrize("segments", [False, True], ids=["band", "segments"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 5)])
def test_flash_attention_op_grads_match_jax(causal, window, segments):
    """torch.autograd.grad through the port's op against jax.grad through
    repro.kernels.ops.flash_attention (custom_vjp), fp32."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(11)
    arrays = [_np(rng, 1, 20, 4, 8), _np(rng, 1, 20, 2, 8), _np(rng, 1, 20, 2, 8)]
    w = _np(rng, 1, 20, 4, 8)
    ids = np.repeat(np.arange(3), [6, 9, 5]).astype(np.int32) if segments else None

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                 seg_q=None if ids is None else jnp.asarray(ids))
        return jnp.sum(o * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in arrays))
    xs = [torch.from_numpy(x.copy()).requires_grad_(True) for x in arrays]
    o = tops.flash_attention(*xs, causal=causal, window=window,
                             seg_q=None if ids is None else torch.from_numpy(ids))
    tg = torch.autograd.grad((o * torch.from_numpy(w)).sum(), xs)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("layout", ["striped", "contiguous"])
@pytest.mark.parametrize("pos", [24, 30, 2**20])
def test_dense_scalar_pos_update_past_capacity_matches_jax(pos, layout):
    """A scalar ``pos`` at or past capacity: JAX's dynamic_update_slice clamps
    the slot onto the last one (striped, n = 1: the row owns every position);
    the contiguous layout's owner test fails there and nothing is written.
    The port writes the same bits."""
    rng = np.random.default_rng(12)
    B, m, Hkv, D = 3, 24, 2, 8
    k_cache, v_cache = _np(rng, B, m, Hkv, D), _np(rng, B, m, Hkv, D)
    k_new, v_new = _np(rng, B, 1, Hkv, D), _np(rng, B, 1, Hkv, D)
    kt, vt = tda.sharded_cache_update(
        torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy()),
        torch.from_numpy(k_new), torch.from_numpy(v_new), pos, None, 1, layout=layout,
    )
    kj, vj = jda.sharded_cache_update(
        jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(pos, jnp.int32), None, 1, layout=layout,
    )
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    written = not np.array_equal(kt.numpy(), k_cache)
    assert written == (layout == "striped")


def test_combine_partials_matches_jax():
    rng = np.random.default_rng(2)
    o1, o2 = _np(rng, 2, 4, 3, 8), _np(rng, 2, 4, 3, 8)
    l1, l2 = _np(rng, 2, 3, 4), _np(rng, 2, 3, 4)
    l2[0, 0, :] = tref.NEG_INF  # one empty partial
    ot, lt = tref.combine_partials(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    oj, lj = jref.combine_partials(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6, rtol=1e-6)


def test_combine_split_partials_matches_jax_and_empty_guard():
    rng = np.random.default_rng(3)
    o_parts, lse_parts = _np(rng, 3, 4, 2, 8), _np(rng, 3, 4, 2)
    lse_parts[1, 2] = tref.NEG_INF  # one empty split
    lse_parts[2] = tref.NEG_INF  # an all-empty row
    ot, lt = tpk.combine_split_partials(torch.from_numpy(o_parts), torch.from_numpy(lse_parts))
    oj, lj = jpk.combine_split_partials(jnp.asarray(o_parts), jnp.asarray(lse_parts))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6, rtol=1e-6)
    assert np.all(ot.numpy()[2] == 0) and np.all(lt.numpy()[2] == tref.NEG_INF)


def test_dense_chunk_and_splits_match_jax():
    for m in (1, 6, 16, 48, 96, 128, 2048):
        assert tpk.dense_chunk_for(m) == jpk.dense_chunk_for(m)
    # JAX splits a row's capacity in runs of 4 pages; the card kernel splits
    # each row's visible range in as many shares as fill the card over B x Hkv
    # (row, kv head) pairs, never more than max_pages
    for mp in (1, 3, 4, 5, 128):
        assert jpk.default_num_splits(mp) == -(-mp // 4)
        assert tpk.default_num_splits(8, 8, mp) == min(mp, 5)  # 2 x 132 blocks over 64 pairs
    assert tpk.default_num_splits(1, 8, 128) == 33
    assert tpk.default_num_splits(64, 8, 128) == 1


# (B, H, Hkv, D, max_pages, num_splits, dtype) -> the paged kernel's (body,
# blocks per (row, kv head))
PAGED_PLANS = {
    # granite-8b's serving pool (8 slots, 128 pages of 16) and qwen2.5-32b's
    "granite_bf16": ((8, 32, 8, 128, 128, None, torch.bfloat16), ("mma", 5)),
    "qwen_fp32": ((8, 40, 8, 128, 128, None, torch.float32), ("simt", 5)),
    # gemma-7b (16 / 16 heads of 256): 128 (row, kv head) pairs take 3
    # blocks each; the card-vs-CPU slice's fp32 queries; a split count past
    # the row's pages is cut to them
    "gemma_bf16": ((8, 16, 16, 256, 128, None, torch.bfloat16), ("mma", 3)),
    "gemma_fp32": ((4, 16, 16, 256, 16, None, torch.float32), ("simt", 5)),
    "gemma_capped": ((8, 16, 16, 256, 2, 6, torch.bfloat16), ("mma", 2)),
}


@pytest.mark.parametrize("name", list(PAGED_PLANS))
def test_paged_plan_routes_main_path_shapes(name):
    shape, want = PAGED_PLANS[name]
    assert tpk._plan(*shape) == want


@pytest.mark.parametrize("shape,err", [
    ((8, 16, 16, 192, 128, None, torch.bfloat16), "head dims"),
    ((8, 16, 16, 512, 128, None, torch.float32), "head dims"),
    ((8, 34, 2, 256, 128, None, torch.bfloat16), "GQA group"),
    ((8, 16, 16, 256, 128, None, torch.float16), "float32 or bfloat16"),
])
def test_paged_plan_refuses_what_the_kernel_does_not_take(shape, err):
    with pytest.raises((ValueError, TypeError), match=err):
        tpk._plan(*shape)


def _paged_case(rng, depths, page_size, hkv, d, holes=False):
    """Shuffled pool, -1 past each row's depth; unwritten page tails hold
    large garbage the decode must not see."""
    B = len(depths)
    max_pages = -(-max(depths) // page_size) + 1
    num_pages = B * max_pages + 2
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        for lp in range(-(-depth // page_size)):
            if holes and b == 0 and lp == 1:
                continue
            bt[b, lp] = perm[nxt]
            nxt += 1
    k_pool = _np(rng, num_pages, page_size, hkv, d) * 3
    v_pool = _np(rng, num_pages, page_size, hkv, d)
    return k_pool, v_pool, bt


PAGED = {
    # name: (depths, page_size, stride, shard, window, holes)
    "mixed_depths": ((5, 13, 1, 8), 4, 1, 0, None, False),
    "one_token_pages": ((3, 7), 1, 1, 0, None, False),
    "striped_window": ((9, 12, 4), 2, 4, 1, 6, False),
    "window_partial": ((17, 23), 4, 1, 0, 5, False),
    "empty_row": ((0, 6), 4, 1, 0, None, False),
    "unallocated_page": ((12, 5), 4, 1, 0, None, True),
}


@pytest.mark.parametrize("vector_pos", [True, False], ids=["vec_pos", "scalar_pos"])
@pytest.mark.parametrize("name", list(PAGED))
def test_paged_decode_plain_matches_pallas(name, vector_pos):
    depths, ps, stride, shard, window, holes = PAGED[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    H, Hkv, D = 4, 2, 8
    k_pool, v_pool, bt = _paged_case(rng, depths, ps, Hkv, D, holes)
    q = _np(rng, len(depths), 1, H, D)
    pos = np.array([shard + stride * (d - 1) if d else -1 for d in depths], np.int32)
    if not vector_pos:
        pos = pos.min()  # every row at the same (lowest) depth
    o_t, lse_t = tpk.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(bt), torch.from_numpy(np.asarray(pos)), shard,
        stride_kv=stride, window=window,
    )
    o_j, lse_j = jpk.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(bt),
        jnp.asarray(pos), shard, stride_kv=stride, window=window, interpret=True,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=PAGED_ATOL, rtol=PAGED_RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=PAGED_ATOL, rtol=PAGED_RTOL)
    if name == "empty_row" and vector_pos:
        assert np.all(o_t.numpy()[0] == 0) and np.all(lse_t.numpy()[0] == tref.NEG_INF)


@pytest.mark.parametrize("kernel", ["band", "native"])
@pytest.mark.parametrize("window", [None, 6])
def test_dense_cache_decode_matches_jax(kernel, window):
    """Dense cache: the band path and the split-K kernel through the
    identity block table both equal JAX's dense decode."""
    rng = np.random.default_rng(4)
    B, m, H, Hkv, D = 3, 24, 4, 2, 8
    k_cache, v_cache = _np(rng, B, m, Hkv, D), _np(rng, B, m, Hkv, D)
    q = _np(rng, B, 1, H, D)
    pos = np.array([0, 11, 23], np.int32)
    o_t = tda.sharded_cache_decode(
        torch.from_numpy(q), torch.from_numpy(k_cache), torch.from_numpy(v_cache),
        torch.from_numpy(pos), None, 1, window=window, kernel=kernel,
    )
    o_j = jda.sharded_cache_decode(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(pos),
        None, 1, window=window, kernel=kernel,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=PAGED_ATOL, rtol=PAGED_RTOL)


def test_paged_cache_update_matches_jax_bitwise():
    """Append through the block table; rows past capacity and rows on
    unallocated pages write nothing (JAX drops them, the port filters)."""
    rng = np.random.default_rng(5)
    num_pages, ps, Hkv, D, max_pages = 6, 4, 2, 8, 3
    k_pool, v_pool = _np(rng, num_pages, ps, Hkv, D), _np(rng, num_pages, ps, Hkv, D)
    bt = np.array([[2, 0, -1], [5, -1, -1], [1, 3, 4], [4, 1, 3]], np.int32)
    pos = np.array([6, 4, 11, 2**30], np.int32)  # live, unallocated, live, parked
    k_new, v_new = _np(rng, 4, 1, Hkv, D), _np(rng, 4, 1, Hkv, D)
    kt, vt = tda.paged_cache_update(
        torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy()),
        torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(bt),
        torch.from_numpy(pos), None, 1,
    )
    kj, vj = jda.paged_cache_update(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(bt), jnp.asarray(pos), None, 1,
    )
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not np.array_equal(kt.numpy(), k_pool)  # something was written


@pytest.mark.parametrize("kernel", ["gather", "native"])
def test_paged_cache_decode_matches_jax_gather(kernel):
    rng = np.random.default_rng(6)
    H, Hkv, D = 4, 2, 8
    k_pool, v_pool, bt = _paged_case(rng, (7, 16, 3), 4, Hkv, D)
    q = _np(rng, 3, 1, H, D)
    pos = np.array([6, 15, 2], np.int32)
    o_t = tda.paged_cache_decode(
        torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(bt), torch.from_numpy(pos), None, 1, kernel=kernel,
    )
    o_j = jda.paged_cache_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(bt),
        jnp.asarray(pos), None, 1, kernel="gather",
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=PAGED_ATOL, rtol=PAGED_RTOL)


def test_dispatch_resolution_and_unported_backends():
    assert tdispatch._resolve_decode_kernel("auto", paged=True) == "native"
    assert tdispatch._resolve_decode_kernel("auto", paged=False) == "band"
    assert tdispatch._resolve_decode_kernel("gather", paged=False) == "band"
    assert tdispatch._resolve_decode_kernel("gather", paged=True) == "gather"
    with pytest.raises(ValueError):
        tdispatch._resolve_decode_kernel("nope", paged=True)
    ctx = ParallelCtx(device="cpu")
    plan = tdispatch.plan_from_ctx(ctx, causal=True)
    assert plan.resolved_backend() == "mesh"  # JAX's default attn_impl; n = 1 runs local flash
    q = torch.from_numpy(_np(np.random.default_rng(0), 1, 16, 4, 8))
    want, _ = tref.attention_ref(q, q, q, scale=8**-0.5, band=(0, 0, 0, INF))
    np.testing.assert_allclose(tdispatch.distributed_attention(q, q, q, cfg=plan).numpy(),
                               want.numpy(), atol=FWD_TOL)
    # the ring backends run over a virtual ring of 4 ranks and give the local result
    ctx4 = ParallelCtx(sp_size=4, device="cpu")
    for name in ("mesh", "ring", "ulysses"):
        layout = "contiguous" if name == "ulysses" else "striped"
        cfg = tdispatch.plan_from_ctx(ctx4, causal=True, backend=name, layout=layout)
        perm = stripe_permutation(16, 4) if layout == "striped" else np.arange(16)
        qp = q[:, torch.from_numpy(perm)]
        o = tdispatch.distributed_attention(qp, qp, qp, cfg=cfg, ctx=ctx4)
        np.testing.assert_allclose(o.numpy(), want[:, torch.from_numpy(perm)].numpy(),
                                   atol=FWD_TOL)
    # serving over a ring: the engine and the cache construct at sp_size 2,
    # and the engine serves the tokens it serves on one rank
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    mcfg = get_config("granite-8b").reduced()
    mparams = tfm.init_params(mcfg, device="cpu")
    ring2 = ParallelCtx(sp_size=2, device="cpu")
    prompts = np.random.default_rng(1).integers(0, mcfg.vocab_size, (2, 9), dtype=np.int32)
    assert np.array_equal(ServeEngine(mcfg, mparams, ring2).generate(prompts, 4),
                          ServeEngine(mcfg, mparams, ctx).generate(prompts, 4))
    cache = tfm.init_cache(mcfg, 1, 16, ctx=ring2)
    assert cache["k"].shape == (mcfg.num_layers, 1, 16, mcfg.num_kv_heads, mcfg.hd)
    seg_plan = tdispatch.plan_from_ctx(ctx, mask=MaskSpec.segment())
    with pytest.raises(ValueError, match="segment"):
        tdispatch.distributed_attention(q, q, q, cfg=seg_plan)
    assert "local-flash" in tdispatch.available_backends()
