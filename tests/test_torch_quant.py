"""The port's quantized KV pool against the JAX package, on the CPU: codes and
scales bit-equal to JAX's ``kv_quant``; the plain version of the quantized
paged decode (kernel 4q) against JAX's Pallas kernel in interpret mode; the
quantizing cache writes (decode append, chunk append, one-shot and packed
prefill) bit-equal to JAX's; the allocator's spans, rollback and scale-entry
counts against JAX's ``PageAllocator``; and the fp8 / cache conversions.
Inputs come from numpy with fixed seeds.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import decode_attention as jda
from repro.core import kv_quant as jkq
from repro.kernels import paged_decode as jpk
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve import kv_pool as jpool
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import decode_attention as tda
from repro_torch.core import kv_quant as tkq
from repro_torch.kernels import paged_decode as tpk
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve import kv_pool as tpool

KV_DTYPES = ["int8", "fp8"]
# the plain version and the interpreted kernel both dequantize in fp32 and
# sum in another order
ATOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(t) -> np.ndarray:
    """Codes as raw bytes (fp8 has no numpy dtype on the torch side)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.dtype != torch.int8 else t.numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


QUANT_INPUTS = {
    # name: (shape, magnitude, zero rows)
    "heads": ((3, 4, 2, 8), 1.0, True),
    "tiny": ((5, 16), 1e-3, True),
    "large": ((2, 3, 128), 300.0, False),
    "page": ((4, 16, 8, 128), 2.0, True),
}


@pytest.mark.parametrize("case", list(QUANT_INPUTS))
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantize_bit_equal_to_jax(kv_dtype, case):
    shape, mag, zeros = QUANT_INPUTS[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x = _np(rng, *shape, scale=mag)
    if zeros:
        x.reshape(-1, shape[-1])[::3] = 0.0  # zero rows: scale 0, codes 0
    qt, st = tkq.quantize(torch.from_numpy(x), kv_dtype)
    qj, sj = jkq.quantize(jnp.asarray(x), kv_dtype)
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == tkq.storage_dtype(kv_dtype) and st.dtype == tkq.SCALE_DTYPE
    amax = np.abs(x).max(axis=-1, keepdims=True)
    err = np.abs(tkq.dequantize(qt, st).numpy() - x)
    assert np.all(err <= tkq.REL_ERROR_BOUND[kv_dtype] * amax + 1e-12)
    if zeros:
        assert np.all(st.numpy().reshape(-1)[::3] == 0)
    assert tkq.storage_itemsize(kv_dtype) == jkq.storage_itemsize(kv_dtype) == 1
    assert tkq.REL_ERROR_BOUND == jkq.REL_ERROR_BOUND


def _quant_case(rng, depths, page_size, hkv, d, kv_dtype, holes):
    """A quantized pool from random K/V (codes and scales from JAX's
    quantize), shuffled block table, -1 past each row's depth."""
    B = len(depths)
    max_pages = -(-max(depths) // page_size) + 1
    num_pages = B * max_pages + 2
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        for lp in range(-(-depth // page_size)):
            if holes and b == 0 and lp == 1:
                continue  # an unallocated page inside the visible range
            bt[b, lp] = perm[nxt]
            nxt += 1
    pools = []
    for mag in (3.0, 1.0):
        qj, sj = jkq.quantize(jnp.asarray(_np(rng, num_pages, page_size, hkv, d, scale=mag)),
                              kv_dtype)
        pools.append((qj, sj))
    return pools, bt


@pytest.mark.parametrize("window", [None, 16], ids=["full", "window16"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_paged_decode_ref_quant_matches_pallas(kv_dtype, window):
    """Kernel 4q's plain version against JAX's kernel (quantized branch,
    interpret mode): partial last pages, an unallocated page, an empty row."""
    rng = np.random.default_rng(21)
    depths, ps, H, Hkv, D = (13, 30, 1, 0), 4, 4, 2, 16
    ((kq, ks), (vq, vs)), bt = _quant_case(rng, depths, ps, Hkv, D, kv_dtype, holes=True)
    q = _np(rng, len(depths), 1, H, D)
    pos = np.array([d - 1 for d in depths], np.int32)
    conv = [cache_from_jax({"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos": pos},
                           device="cpu")[key] for key in ("k", "v", "k_scale", "v_scale")]
    o_t, lse_t = tpk.paged_flash_decode(
        torch.from_numpy(q), conv[0], conv[1], torch.from_numpy(bt), torch.from_numpy(pos), 0,
        stride_kv=1, window=window, k_scale=conv[2], v_scale=conv[3],
    )
    o_j, lse_j = jpk.paged_flash_decode(
        jnp.asarray(q), kq, vq, jnp.asarray(bt), jnp.asarray(pos), 0,
        stride_kv=1, window=window, interpret=True, k_scale=ks, v_scale=vs,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=0)
    assert np.all(o_t.numpy()[-1] == 0) and np.all(lse_t.numpy()[-1] == tref.NEG_INF)


def test_paged_decode_scale_arguments_are_checked():
    rng = np.random.default_rng(22)
    ((kq, ks), (vq, vs)), bt = _quant_case(rng, (9,), 4, 2, 16, "int8", holes=False)
    c = cache_from_jax({"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos": np.zeros(1)},
                       device="cpu")
    q, bt_t = torch.from_numpy(_np(rng, 1, 1, 4, 16)), torch.from_numpy(bt)
    with pytest.raises(TypeError):  # codes without scales
        tpk.paged_flash_decode(q, c["k"], c["v"], bt_t, 8, 0, stride_kv=1)
    with pytest.raises(TypeError):  # scales without codes
        tpk.paged_flash_decode(q, c["k"].float(), c["v"].float(), bt_t, 8, 0, stride_kv=1,
                               k_scale=c["k_scale"], v_scale=c["v_scale"])
    with pytest.raises(TypeError):  # one table only
        tpk.paged_flash_decode(q, c["k"], c["v"], bt_t, 8, 0, stride_kv=1,
                               k_scale=c["k_scale"])


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_update_paths_match_jax_bitwise(kv_dtype):
    """Decode append and chunk append into a seeded quantized pool: codes
    and scales bit-equal to JAX's (rows past capacity, on unallocated pages,
    below write_starts and past lens write nothing)."""
    rng = np.random.default_rng(23)
    num_pages, ps, Hkv, D = 7, 4, 2, 8
    (kq, ks), (vq, vs) = (jkq.quantize(jnp.asarray(_np(rng, num_pages, ps, Hkv, D)), kv_dtype)
                          for _ in range(2))
    bt = np.array([[2, 0, -1], [5, -1, -1], [1, 3, 4], [6, 1, 3]], np.int32)
    t = cache_from_jax({"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos": np.zeros(4)},
                       device="cpu")
    pos = np.array([6, 4, 11, 2**30], np.int32)  # live, unallocated, live, parked
    k_new, v_new = _np(rng, 4, 1, Hkv, D), _np(rng, 4, 1, Hkv, D)
    out_t = tda.paged_cache_update(
        t["k"], t["v"], torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(bt), torch.from_numpy(pos), None, 1,
        k_scale=t["k_scale"], v_scale=t["v_scale"],
    )
    out_j = jda.paged_cache_update(
        kq, vq, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(pos),
        None, 1, k_scale=ks, v_scale=vs,
    )
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(_bits(a) if a.dtype != torch.float32 else a.numpy(),
                                      _bits(b) if b.dtype != jnp.float32 else np.asarray(b))
    # a chunk per row on top of that: starts, lens, write_starts
    C = 5
    starts = np.array([3, 0, 6, 1], np.int32)
    lens = np.array([4, 0, 5, 2], np.int32)
    wstarts = np.array([3, 0, 8, 0], np.int32)
    k_c, v_c = _np(rng, 4, C, Hkv, D), _np(rng, 4, C, Hkv, D)
    out_t = tda.paged_cache_chunk_update(
        out_t[0], out_t[1], torch.from_numpy(k_c), torch.from_numpy(v_c),
        torch.from_numpy(bt), torch.from_numpy(starts), torch.from_numpy(lens),
        torch.from_numpy(wstarts), None, 1, k_scale=out_t[2], v_scale=out_t[3],
    )
    out_j = jda.paged_cache_chunk_update(
        out_j[0], out_j[1], jnp.asarray(k_c), jnp.asarray(v_c), jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(wstarts), None, 1,
        k_scale=out_j[2], v_scale=out_j[3],
    )
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(_bits(a) if a.dtype != torch.float32 else a.numpy(),
                                      _bits(b) if b.dtype != jnp.float32 else np.asarray(b))
    assert not np.array_equal(_bits(out_t[0]), _bits(kq))  # something was written


@pytest.fixture(scope="module")
def model():
    cfg = jget_config("granite-8b").reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config("granite-8b").reduced(), tp


QMAX = {"int8": 127.0, "fp8": 448.0}


def dequant_close(tc, jc, kv_dtype):
    """Pools equal once dequantized.  K/V come from projections computed in
    another order, so a code may differ by one step: each side is within
    REL_ERROR_BOUND * amax of nearly the same value, so the two are within
    twice that (for int8 exactly one scale step) plus 1e-5."""
    for key in ("k", "v"):
        a = tkq.dequantize(tc[key], tc[f"{key}_scale"]).numpy()
        b = np.asarray(jkq.dequantize(jc[key], jc[f"{key}_scale"]))
        amax = np.asarray(jc[f"{key}_scale"])[..., None] * QMAX[kv_dtype]
        assert np.all(np.abs(a - b) <= 2 * tkq.REL_ERROR_BOUND[kv_dtype] * amax + 1e-5), key


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_prefill_and_packed_prefill_match_jax(model, kv_dtype):
    """One-shot and packed prefill quantize at write time, as JAX does."""
    jcfg, jp, tcfg, tp = model
    layout = jpool.PagedLayout.for_engine(64, 1, 3, page_size=4)
    tlay = tpool.PagedLayout.for_engine(64, 1, 3, page_size=4)
    jc = jtfm.init_cache(jcfg, 3, 64, dtype=jnp.float32, ctx=JCtx(), paged=layout,
                         kv_dtype=kv_dtype)
    tc = ttfm.init_cache(tcfg, 3, 64, dtype=torch.float32, ctx=TCtx(device="cpu"),
                         paged=tlay, kv_dtype=kv_dtype)
    assert tc["k"].dtype == tkq.storage_dtype(kv_dtype) and tc["k_scale"].shape == tuple(
        jc["k_scale"].shape)
    bt = np.full((3, layout.max_pages), -1, np.int32)
    bt[0, :3], bt[1, :4], bt[2, :2] = [4, 0, 9], [1, 2, 3, 5], [6, 7]
    jc["bt"], tc["bt"] = jnp.asarray(bt), torch.from_numpy(bt)
    rng = np.random.default_rng(24)
    toks = rng.integers(0, jcfg.vocab_size, (1, 16), dtype=np.int32)
    batch = {"tokens": toks, "positions": np.arange(16, dtype=np.int32), "slot": 0,
             "length": np.array([11], np.int32), "shared_len": 0}
    lj, jc = jtfm.prefill(jp, jcfg, JCtx(), {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    lt, tc = ttfm.prefill(tp, tcfg, TCtx(device="cpu"),
                          {k: torch.as_tensor(v) for k, v in batch.items()}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    # two documents packed in one row, into slots 1 and 2
    lens = [9, 6]
    pos = np.concatenate([np.arange(9), np.arange(6), [0]]).astype(np.int32)
    seg = np.array([0] * 9 + [1] * 6 + [2], np.int32)
    pb = {"tokens": rng.integers(0, jcfg.vocab_size, (1, 16), dtype=np.int32),
          "positions": pos, "segments": seg, "doc_lens": np.array(lens, np.int32),
          "slots": np.array([1, 2], np.int32)}
    lj, jc = jtfm.prefill_packed(jp, jcfg, JCtx(), {k: jnp.asarray(v) for k, v in pb.items()},
                                 jc)
    lt, tc = ttfm.prefill_packed(tp, tcfg, TCtx(device="cpu"),
                                 {k: torch.as_tensor(v) for k, v in pb.items()}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    dequant_close(tc, jc, kv_dtype)


def _allocator_script(alloc, rng):
    """A seeded sequence of admissions, appends, speculative spans,
    rollbacks and frees; returns the block tables and stats seen."""
    seen = []
    prompts = {0: rng.integers(0, 50, (9,)), 1: None, 2: rng.integers(0, 50, (3,))}
    prompts[1] = np.concatenate([prompts[0][:8], [7, 7]])  # shares two pages with slot 0
    depth = {}
    for slot, p in prompts.items():
        alloc.alloc_slot(slot, p, 12)
        depth[slot] = len(p)
        seen.append((alloc.device_table(3).copy(), alloc.stats()))
    copies = []
    for step in range(10):
        for slot in sorted(depth):
            if step % 3 == 2:
                n = int(rng.integers(3, 8))
                copies.append(alloc.ensure_span(slot, depth[slot], n))
                keep = depth[slot] + int(rng.integers(1, 3))
                alloc.rollback(slot, keep)
                depth[slot] = keep
            else:
                copies.append(alloc.ensure_append(slot, depth[slot]))
                depth[slot] += 1
        if step == 6:
            alloc.free_slot(0)
            alloc.free_slot(0)  # idempotent
            alloc.rollback(0, 3)  # a retired slot: no-op
            del depth[0]
        assert alloc.check_invariants() == []
        seen.append((alloc.device_table(3).copy(), alloc.stats(), copies[-3:]))
    for slot in list(depth):
        alloc.free_slot(slot)
    seen.append((alloc.device_table(3).copy(), alloc.stats()))
    return seen


def test_allocator_spans_rollback_and_scales_match_jax():
    """The same script through both allocators: identical block tables,
    copy-on-write pairs and stats (the same keys, the oversubscription and
    chaos ones included); scale entries follow referenced pages and
    drain to 0 with them."""
    layout_t = tpool.PagedLayout(num_pages=24, page_size=4, max_pages=8)
    layout_j = jpool.PagedLayout(num_pages=24, page_size=4, max_pages=8)
    got = _allocator_script(tpool.PageAllocator(layout_t, quantized=True),
                            np.random.default_rng(25))
    want = _allocator_script(jpool.PageAllocator(layout_j, quantized=True),
                             np.random.default_rng(25))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
        assert g[1]["scale_entries_in_use"] == g[1]["pages_in_use"]
        if len(g) > 2:
            assert g[2] == w[2]
    final = got[-1][1]
    assert final["pages_in_use"] == final["scale_entries_in_use"] == 0
    assert final["spec_rolled_back_pages"] > 0 and final["cow_copies"] >= 0
    assert final["double_free_noops"] == 2


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cache_from_jax_keeps_codes_bit_for_bit(kv_dtype):
    """``cache_from_jax`` carries a JAX decode cache over: int8 and fp8
    codes (ml_dtypes arrays) bit for bit, scales, block table, positions."""
    cfg = jget_config("granite-8b").reduced()
    layout = jpool.PagedLayout.for_engine(32, 1, 2, page_size=4)
    jc = jtfm.init_cache(cfg, 2, 32, ctx=JCtx(), paged=layout, kv_dtype=kv_dtype)
    rng = np.random.default_rng(26)
    qk, sk = jkq.quantize(jnp.asarray(_np(rng, *jc["k"].shape)),
                          kv_dtype)
    jc = dict(jc, k=qk, k_scale=sk, pos=jnp.asarray([3, 7], jnp.int32))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert set(tc) == set(jc)
    assert tc["k"].dtype == tkq.storage_dtype(kv_dtype) and tc["pos"].dtype == torch.int32
    np.testing.assert_array_equal(_bits(tc["k"]), _bits(jc["k"]))
    np.testing.assert_array_equal(tc["k_scale"].numpy(), np.asarray(jc["k_scale"]))
    np.testing.assert_array_equal(tc["bt"].numpy(), np.asarray(jc["bt"]))
    fp8 = np.asarray(jnp.asarray([0.5, -448.0, 3.25], jnp.float8_e4m3fn))
    t = params_from_jax({"w": fp8}, device="cpu")["w"]
    assert t.dtype == torch.float8_e4m3fn and t.float().tolist() == [0.5, -448.0, 3.25]
    # the encoder's cross-attention K/V carry over (whisper-base); an entry
    # with no counterpart still raises
    carried = cache_from_jax({"cross_k": np.ones((2, 3), np.float32), "pos": np.zeros(1)},
                             device="cpu")
    assert torch.equal(carried["cross_k"], torch.ones(2, 3))
    with pytest.raises(ValueError, match="no port counterpart"):
        cache_from_jax({"latent": np.zeros(1), "pos": np.zeros(1)}, device="cpu")


@pytest.mark.parametrize("arch,dtype", [("mamba2-370m", jnp.bfloat16), ("hymba-1.5b", jnp.float32)])
def test_cache_from_jax_carries_the_ssm_state(arch, dtype):
    """The per-slot SSM entry ``{conv, state}`` crosses bit for bit: the conv
    window in its own dtype, the state in fp32."""
    cfg = jget_config(arch).reduced()
    jc = jtfm.init_cache(cfg, 2, 32, dtype=dtype, ctx=JCtx())
    rng = np.random.default_rng(27)
    ssm = {key: jnp.asarray(_np(rng, *val.shape)).astype(val.dtype)
           for key, val in jc["ssm"].items()}
    jc = dict(jc, ssm=ssm, pos=jnp.asarray([5, 9], jnp.int32))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert set(tc) == set(jc) and set(tc["ssm"]) == {"conv", "state"}
    assert tc["ssm"]["state"].dtype == torch.float32
    assert tc["ssm"]["conv"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    for key in ("conv", "state"):
        got = tc["ssm"][key]
        got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      np.asarray(ssm[key]).view(np.uint8))
    mine = ttfm.init_cache(tget_config(arch).reduced(), 2, 32,
                           dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32,
                           ctx=TCtx(device="cpu"))
    assert {k: tuple(v.shape) for k, v in tc["ssm"].items()} == \
        {k: tuple(v.shape) for k, v in mine["ssm"].items()}
    with pytest.raises(ValueError, match="conv, state"):
        cache_from_jax({"ssm": {"state": np.zeros(1)}, "pos": np.zeros(1)}, device="cpu")
