"""Serving over a sequence-parallel ring in the port: the sequence-sharded
cache functions of ``repro_torch.core.decode_attention`` over a
``VirtualRing`` (every rank folded into one launch, then the lse combine)
against the JAX package's own sharded functions, run rank by rank under
``jax.vmap(..., axis_name="sp")`` on the CPU over the stacked rank slices;
``prefix_chunk_visibility`` against JAX's; and the port's ``ServeEngine`` at
``ParallelCtx(sp_size=4)`` against JAX's single-device engine on converted
weights (reduced granite-8b; the SSM and hybrid archs over the ring:
tests/test_torch_ssm_ring.py).

Inputs come from ``numpy.random.default_rng`` with the seed each case
states.  Caches compare as they stand: the port keeps JAX's global-logical
layout, so its dense ``[B, n*m]`` cache is JAX's n slices ``[B, m]`` side by
side, and its pool ``[P, n*ps]`` JAX's n pools ``[P, ps]``.  Limits: fp32 o
within 1e-5; updated fp caches exactly; quantized pools once dequantized
within one code step (``test_torch_quant.dequant_close``: XLA compiles JAX's
scale division into another rounding of the last bit) and scales within
1e-6; rows of a rank that sees no key come out of the folded launch exactly
o = 0, lse = NEG_INF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import decode_attention as jda
from repro.core.masking import prefix_chunk_visibility as jvisibility
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import _tensor, params_from_jax
from repro_torch.core import decode_attention as tda
from repro_torch.core import dispatch
from repro_torch.core.masking import prefix_chunk_visibility as tvisibility
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.parallel.ring import VirtualRing
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from test_torch_quant import dequant_close

TOL = 1e-5
B, M, HKV, H, D = 3, 8, 2, 4, 16  # rows, local slots per rank, heads, head dim
PS, MAX_PAGES, PAGES = 4, 4, 14  # paged: page size, pages per row, pool pages


def _to_torch(x) -> torch.Tensor:
    return _tensor(np.asarray(x), torch.device("cpu"), None)


def _ranks_to_global(x) -> torch.Tensor:
    """JAX's n rank slices [n, X, c, ...] -> the port's [X, n*c, ...]."""
    x = np.asarray(x)
    return _to_torch(np.moveaxis(x, 0, 1).reshape(x.shape[1], -1, *x.shape[3:]))


def _rng_f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _vmapped(f):
    """JAX's function run rank by rank over the stacked rank slices (one
    compiled program per case)."""
    return jax.jit(jax.vmap(f, axis_name="sp"))


def _visible(pos, n, m, layout, window):
    """[B, n] bool: does rank i hold a key that row b's query sees?"""
    gpos = (np.arange(n)[:, None] + n * np.arange(m)[None] if layout == "striped"
            else np.arange(n)[:, None] * m + np.arange(m)[None])  # [n, m]
    pos = np.broadcast_to(np.asarray(pos), (B,))[:, None, None]
    lo = np.maximum(pos - window + 1, 0) if window else 0
    return ((gpos[None] <= pos) & (gpos[None] >= lo)).any(-1)


def _assert_pools(got, want, kv_dtype):
    """The port's updated pools (k, v[, k_scale, v_scale]) against JAX's
    rank pools."""
    want = [_ranks_to_global(x) for x in want]
    if kv_dtype == "fp":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    keys = ("k", "v", "k_scale", "v_scale")
    dequant_close(dict(zip(keys, got)),
                  {key: jnp.asarray(_global_np(t)) for key, t in zip(keys, want)}, kv_dtype)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-6)


def _global_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _assert_blind_rows(o, lse, vis):
    """Folded partials [B*n, ...]: the rows of the ranks that see no key are
    exactly o = 0, lse = NEG_INF; at least one such row is in the case."""
    blind = torch.from_numpy(~vis.reshape(-1))
    assert blind.any()
    assert torch.all(o[blind] == 0)
    assert torch.all(lse[blind] == NEG_INF)


# --------------------------------------------------------------------------
# the dense cache: update and decode (band, native)
# --------------------------------------------------------------------------

DENSE = [
    (4, pos, window, layout, kernel)
    for pos in ("scalar", "vector")
    for window in (None, 5)
    for layout, kernel in (("striped", "band"), ("striped", "native"), ("contiguous", "band"))
] + [(2, "vector", None, "striped", "band"), (2, "scalar", 5, "contiguous", "native")]


def _positions(kind, n, m, seed):
    if kind == "scalar":
        return np.int32(2)  # ranks past position 2 hold no key yet
    rng = np.random.default_rng(seed)
    return np.array([0, rng.integers(1, n * m - 1), n * m - 1], np.int32)


@pytest.mark.parametrize("n,pos_kind,window,layout,kernel", DENSE)
def test_dense_update_and_decode_match_jax(n, pos_kind, window, layout, kernel):
    rng = np.random.default_rng(100 + n)
    k_r, v_r = _rng_f32(rng, n, B, M, HKV, D), _rng_f32(rng, n, B, M, HKV, D)
    k_new, v_new = _rng_f32(rng, B, 1, HKV, D), _rng_f32(rng, B, 1, HKV, D)
    q = _rng_f32(rng, B, 1, H, D)
    pos = _positions(pos_kind, n, M, seed=n)

    def jstep(kc, vc):
        kc, vc = jda.sharded_cache_update(kc, vc, k_new, v_new, pos, "sp", n, layout=layout)
        o = jda.sharded_cache_decode(q, kc, vc, pos, "sp", n, layout=layout, window=window,
                                     kernel=kernel)
        return o, kc, vc

    o_j, kc_j, vc_j = _vmapped(jstep)(jnp.asarray(k_r), jnp.asarray(v_r))
    ring = VirtualRing(n)
    kc, vc = _ranks_to_global(k_r), _ranks_to_global(v_r)
    tpos = torch.from_numpy(np.asarray(pos))
    tda.sharded_cache_update(kc, vc, _to_torch(k_new), _to_torch(v_new), tpos, ring, n,
                             layout=layout)
    o = tda.sharded_cache_decode(_to_torch(q), kc, vc, tpos, ring, n, layout=layout,
                                 window=window, kernel=kernel)
    assert torch.equal(kc, _ranks_to_global(kc_j)) and torch.equal(vc, _ranks_to_global(vc_j))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j[0]), atol=TOL, rtol=TOL)
    assert ring.stats.hops == {"combine": 1}
    # one rank's partial: o (B x H x D in q's type) and lse (B x H fp32)
    assert ring.stats.bytes["combine"] == B * H * (D + 1) * 4


@pytest.mark.parametrize("layout", ["striped", "contiguous"])
@pytest.mark.parametrize("window", [None, 5])
def test_folded_partials_match_jax_rank_by_rank(layout, window):
    """The folded band and native launches hold every rank's partial: row
    b*n + i against JAX's partial on rank i, and the blind rows exact."""
    n = 4
    rng = np.random.default_rng(7)
    k_r, v_r = _rng_f32(rng, n, B, M, HKV, D), _rng_f32(rng, n, B, M, HKV, D)
    q = _rng_f32(rng, B, 1, H, D)
    pos = np.array([0, 2, 19], np.int32)

    def jpartial(kc, vc):
        i = jax.lax.axis_index("sp")
        return jda._maybe_pruned_partial(q, kc, vc, jnp.asarray(pos), i, n, M, layout, window,
                                         None, False)

    o_j, lse_j = _vmapped(jpartial)(jnp.asarray(k_r), jnp.asarray(v_r))
    want_o = np.moveaxis(np.asarray(o_j), 0, 1).reshape(B * n, 1, H, D)
    want_lse = np.moveaxis(np.asarray(lse_j), 0, 1).reshape(B * n, H, 1)
    kc, vc = _ranks_to_global(k_r), _ranks_to_global(v_r)
    kv_off, stride = tda._rank_offsets(n, M, layout, torch.device("cpu"))
    hi = window - 1 if window else 2**30
    tpos = torch.from_numpy(pos)
    band = tda._banded_partial(_to_torch(q), tda._rank_view(kc, n), tda._rank_view(vc, n), tpos,
                               kv_off, stride, hi, None)
    pool_k, pool_v = kc.reshape(B * n, M, HKV, D), vc.reshape(B * n, M, HKV, D)
    bt = torch.arange(B * n, dtype=torch.int32)[:, None]
    native = tda._native_partial(_to_torch(q), pool_k, pool_v, bt, tpos, kv_off, stride, window,
                                 None)
    vis = _visible(pos, n, M, layout, window)
    live = torch.from_numpy(vis.reshape(-1))
    for o, lse in (band, native):
        _assert_blind_rows(o, lse, vis)
        np.testing.assert_allclose(o[live].numpy(), want_o[live.numpy()], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(lse.reshape(B * n, H, 1)[live].numpy(),
                                   want_lse[live.numpy()], atol=TOL, rtol=TOL)


def test_psum_combine_matches_jax_with_empty_ranks():
    """The combine alone: per-rank partials with some ranks empty and a row
    every rank leaves empty (o = 0 there, as JAX's psum gives)."""
    n, C = 4, 3
    rng = np.random.default_rng(9)
    o_r = _rng_f32(rng, n, B, C, H, D)
    lse_r = _rng_f32(rng, n, B, H, C) * 3
    empty = rng.random((n, B, H, C)) < 0.4
    empty[:, 1] = True  # row 1 sees no key on any rank
    lse_r[empty] = NEG_INF
    o_r[np.moveaxis(empty, 3, 2)] = 0.0
    want = _vmapped(lambda o, lse: jda._psum_combine(o, lse, "sp", jnp.float32))(
        jnp.asarray(o_r), jnp.asarray(lse_r))
    o = torch.from_numpy(np.moveaxis(o_r, 0, 1).reshape(B * n, C, H, D).copy())
    lse = torch.from_numpy(np.moveaxis(lse_r, 0, 1).reshape(B * n, H, C).copy())
    got = tda._psum_combine(o, lse, VirtualRing(n), n, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=TOL, rtol=TOL)
    assert torch.all(got[1] == 0)


# --------------------------------------------------------------------------
# the paged pool: update and decode (gather, native), fp / int8 / fp8
# --------------------------------------------------------------------------


def _block_table(rng):
    """Every row's pages allocated but row 0's last; row 2 shares row 1's
    first page (a shared prefix)."""
    pages = rng.permutation(PAGES)[: B * MAX_PAGES].reshape(B, MAX_PAGES).astype(np.int32)
    pages[0, -1] = -1
    pages[2, 0] = pages[1, 0]
    return pages


def _pool(rng, n, kv_dtype):
    """JAX's n rank pools (codes and scales for a quantized pool)."""
    k, v = _rng_f32(rng, n, PAGES, PS, HKV, D), _rng_f32(rng, n, PAGES, PS, HKV, D)
    if kv_dtype == "fp":
        return jnp.asarray(k), jnp.asarray(v), None, None
    from repro.core import kv_quant as jq

    (kq, ks), (vq, vs) = jq.quantize(jnp.asarray(k), kv_dtype), jq.quantize(jnp.asarray(v), kv_dtype)
    return kq, vq, ks, vs


PAGED = [
    (4, pos, window, kernel, kv)
    for pos, window in (("scalar", None), ("vector", 5))
    for kernel in ("gather", "native")
    for kv in ("fp", "int8")
] + [(4, "vector", None, kernel, "fp8") for kernel in ("gather", "native")] + [
    (2, "vector", None, "native", "fp"), (2, "scalar", 5, "gather", "int8")]


@pytest.mark.parametrize("n,pos_kind,window,kernel,kv_dtype", PAGED)
def test_paged_update_and_decode_match_jax(n, pos_kind, window, kernel, kv_dtype):
    rng = np.random.default_rng(200 + n)
    kp_r, vp_r, ks_r, vs_r = _pool(rng, n, kv_dtype)
    bt = _block_table(rng)
    k_new, v_new = _rng_f32(rng, B, 1, HKV, D), _rng_f32(rng, B, 1, HKV, D)
    q = _rng_f32(rng, B, 1, H, D)
    cap = n * (MAX_PAGES - 1) * PS  # inside row 0's allocated pages
    pos = _positions(pos_kind, n, cap // n, seed=n)
    quant = kv_dtype != "fp"

    def jstep(kp, vp, *scales):
        sc = dict(k_scale=scales[0], v_scale=scales[1]) if quant else {}
        out = jda.paged_cache_update(kp, vp, k_new, v_new, jnp.asarray(bt), pos, "sp", n, **sc)
        sc = dict(k_scale=out[2], v_scale=out[3]) if quant else {}
        o = jda.paged_cache_decode(q, out[0], out[1], jnp.asarray(bt), pos, "sp", n,
                                   window=window, kernel=kernel, **sc)
        return (o,) + tuple(out)

    args = (kp_r, vp_r) + ((ks_r, vs_r) if quant else ())
    want = _vmapped(jstep)(*args)
    ring = VirtualRing(n)
    pools = [_ranks_to_global(x) for x in args]
    sc = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    tbt, tpos = torch.from_numpy(bt), torch.from_numpy(np.asarray(pos))
    tda.paged_cache_update(pools[0], pools[1], _to_torch(k_new), _to_torch(v_new), tbt, tpos,
                           ring, n, **sc)
    o = tda.paged_cache_decode(_to_torch(q), pools[0], pools[1], tbt, tpos, ring, n,
                               window=window, kernel=kernel, **sc)
    _assert_pools(pools, want[1:], kv_dtype)
    np.testing.assert_allclose(o.numpy(), np.asarray(want[0][0]), atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# chunks: continuous prefill and speculative verify
# --------------------------------------------------------------------------

C = 4
STARTS = np.array([0, 5, 9], np.int32)
LENS = np.array([4, 0, 3], np.int32)  # row 1 inactive
WSTARTS = np.array([0, 0, 10], np.int32)  # row 2's first chunk position is resident


@pytest.mark.parametrize("n,window,layout", [
    (4, None, "striped"), (4, 5, "striped"), (4, None, "contiguous"), (4, 5, "contiguous"),
    (2, 5, "striped"), (2, None, "contiguous"),
])
def test_dense_chunk_update_and_decode_match_jax(n, window, layout):
    rng = np.random.default_rng(300 + n)
    k_r, v_r = _rng_f32(rng, n, B, M, HKV, D), _rng_f32(rng, n, B, M, HKV, D)
    k_new, v_new = _rng_f32(rng, B, C, HKV, D), _rng_f32(rng, B, C, HKV, D)
    q = _rng_f32(rng, B, C, H, D)
    st, ln, ws = (jnp.asarray(x) for x in (STARTS, LENS, WSTARTS))

    def jstep(kc, vc):
        kc, vc = jda.sharded_cache_chunk_update(kc, vc, k_new, v_new, st, ln, ws, "sp", n,
                                                layout=layout)
        o = jda.sharded_cache_chunk_decode(q, kc, vc, st, "sp", n, layout=layout, window=window)
        return o, kc, vc

    o_j, kc_j, vc_j = _vmapped(jstep)(jnp.asarray(k_r), jnp.asarray(v_r))
    ring = VirtualRing(n)
    kc, vc = _ranks_to_global(k_r), _ranks_to_global(v_r)
    ts, tl, tw = (torch.from_numpy(x) for x in (STARTS, LENS, WSTARTS))
    tda.sharded_cache_chunk_update(kc, vc, _to_torch(k_new), _to_torch(v_new), ts, tl, tw, ring,
                                   n, layout=layout)
    o = tda.sharded_cache_chunk_decode(_to_torch(q), kc, vc, ts, ring, n, layout=layout,
                                       window=window)
    assert torch.equal(kc, _ranks_to_global(kc_j)) and torch.equal(vc, _ranks_to_global(vc_j))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j[0]), atol=TOL, rtol=TOL)
    assert ring.stats.bytes["combine"] == B * C * H * (D + 1) * 4


@pytest.mark.parametrize("n,window,kv_dtype", [
    (4, None, "fp"), (4, 5, "fp"), (4, None, "int8"), (4, 5, "int8"), (4, None, "fp8"),
    (2, 5, "fp"), (2, None, "int8"),
])
def test_paged_chunk_update_and_decode_match_jax(n, window, kv_dtype):
    rng = np.random.default_rng(400 + n)
    kp_r, vp_r, ks_r, vs_r = _pool(rng, n, kv_dtype)
    bt = _block_table(rng)
    k_new, v_new = _rng_f32(rng, B, C, HKV, D), _rng_f32(rng, B, C, HKV, D)
    q = _rng_f32(rng, B, C, H, D)
    st, ln, ws = (jnp.asarray(x) for x in (STARTS, LENS, WSTARTS))
    quant = kv_dtype != "fp"

    def jstep(kp, vp, *scales):
        sc = dict(k_scale=scales[0], v_scale=scales[1]) if quant else {}
        out = jda.paged_cache_chunk_update(kp, vp, k_new, v_new, jnp.asarray(bt), st, ln, ws,
                                           "sp", n, **sc)
        sc = dict(k_scale=out[2], v_scale=out[3]) if quant else {}
        o = jda.paged_cache_chunk_decode(q, out[0], out[1], jnp.asarray(bt), st, "sp", n,
                                         window=window, **sc)
        return (o,) + tuple(out)

    args = (kp_r, vp_r) + ((ks_r, vs_r) if quant else ())
    want = _vmapped(jstep)(*args)
    ring = VirtualRing(n)
    pools = [_ranks_to_global(x) for x in args]
    sc = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    ts, tl, tw = (torch.from_numpy(x) for x in (STARTS, LENS, WSTARTS))
    tbt = torch.from_numpy(bt)
    tda.paged_cache_chunk_update(pools[0], pools[1], _to_torch(k_new), _to_torch(v_new), tbt, ts,
                                 tl, tw, ring, n, **sc)
    o = tda.paged_cache_chunk_decode(_to_torch(q), pools[0], pools[1], tbt, ts, ring, n,
                                     window=window, **sc)
    _assert_pools(pools, want[1:], kv_dtype)
    np.testing.assert_allclose(o.numpy(), np.asarray(want[0][0]), atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# prefix_chunk_visibility
# --------------------------------------------------------------------------


def test_prefix_chunk_visibility_matches_jax():
    seen = set()
    for q_lo in range(0, 12, 3):
        for q_len in (1, 4):
            for k_lo in range(0, 16, 2):
                for k_len in (1, 3, 8):
                    for window in (None, 1, 3, 6):
                        args = (q_lo, q_lo + q_len - 1, k_lo, k_lo + k_len - 1, window)
                        got = tvisibility(*args)
                        assert got == jvisibility(*args), args
                        seen.add(got)
    assert seen == {"full", "partial", "empty"}
    for bad in ((3, 2, 0, 1), (0, 1, 4, 3)):
        with pytest.raises(ValueError):
            tvisibility(*bad)
    with pytest.raises(ValueError):
        tvisibility(0, 1, 0, 1, window=0)


# --------------------------------------------------------------------------
# the engine over a ring of 4 against JAX's single-device engine
# --------------------------------------------------------------------------

ARCH = "granite-8b"
TCTX4 = TCtx(sp_size=4, device="cpu")


@pytest.fixture(scope="module")
def weights():
    cfg = jget_config(ARCH).reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config(ARCH).reduced(), tp


def _prompts(vocab):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, (16,), dtype=np.int32)
    return [
        np.tile(np.array([7, 11, 13, 7], np.int32), 6),  # repetitive: drafts get accepted
        rng.integers(0, vocab, (21,), dtype=np.int32),
        np.concatenate([prefix, np.full((8,), 5, np.int32)]),  # a shared-prefix pair
        np.concatenate([prefix, np.full((7,), 9, np.int32)]),
    ]


ARRIVALS = [0, 0, 2, 3]
PAGED_KW = dict(paged=True, page_size=4)
CHUNK_KW = dict(prefill_chunk=8, tick_token_budget=16)
MODES = {
    "dense_packed": dict(pack_prefill=True),
    "paged_single_gather": dict(**PAGED_KW, pack_prefill=False, decode_kernel="gather"),
    "dense_chunk_spec": dict(**CHUNK_KW, spec_k=4),
    "paged_chunk_spec": dict(**PAGED_KW, **CHUNK_KW, spec_k=4),
    "int8_paged_chunk_spec": dict(**PAGED_KW, **CHUNK_KW, spec_k=4, kv_dtype="int8"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_ring_engine_streams_match_jax_single_device(weights, mode):
    """The engine over a ring of 4 ranks serves JAX's single-device tokens at
    the same ticks, with the same launch counters, and drains its pages."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(max_seq=64, num_slots=3, **MODES[mode])
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX4, serve=TServe(**kw))
    ring = teng.ctx.ring
    ring.stats.reset()
    out = {}
    for side, eng in (("jax", jeng), ("torch", teng)):
        rids = [eng.submit(p, 10, arrival_tick=t) for p, t in zip(prompts, ARRIVALS)]
        done = eng.run()
        out[side] = [done[r] for r in rids]
    for g, w in zip(out["torch"], out["jax"]):
        assert g.status == w.status == "ok"
        assert g.generated == w.generated and g.token_ticks == w.token_ticks
    for key in ("prefill_launches", "chunk_launches", "verify_launches", "spec_accepted"):
        assert getattr(teng, key) == getattr(jeng, key), key
    # one combine per layer per decode, chunk and verify launch
    launches = teng.decode_launches + teng.chunk_launches + teng.verify_launches
    assert ring.stats.hops["combine"] == tcfg.num_layers * launches
    if kw.get("paged"):
        kv = teng.kv_cache_stats()
        assert kv["pages_in_use"] == kv["scale_entries_in_use"] == 0
        teng.health()


def test_ring_engine_folds_the_ranks_into_one_launch(weights, monkeypatch):
    """Per layer, a decode tick launches the paged decode kernel once and a
    chunk or verify launch the flash forward once, for all 4 ranks: the
    ranks are folded into the kernels' rows, never launched one by one."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pk

    _, _, tcfg, tp = weights
    calls = {"decode": [], "flash": []}
    real_decode, real_flash = pk.paged_flash_decode, fa.flash_attention_fwd

    def decode(q, *args, **kw):
        calls["decode"].append(q.shape[0])
        return real_decode(q, *args, **kw)

    def flash(q, *args, **kw):
        calls["flash"].append(q.shape[:2])
        return real_flash(q, *args, **kw)

    monkeypatch.setattr(pk, "paged_flash_decode", decode)
    monkeypatch.setattr(fa, "flash_attention_fwd", flash)
    eng = TEngine(tcfg, tp, TCTX4, serve=TServe(max_seq=64, num_slots=3, **PAGED_KW, **CHUNK_KW,
                                                spec_k=4))
    for p, t in zip(_prompts(tcfg.vocab_size), ARRIVALS):
        eng.submit(p, 10, arrival_tick=t)
    eng.run()
    L = tcfg.num_layers
    assert len(calls["decode"]) == L * eng.decode_launches > 0
    assert set(calls["decode"]) == {3 * 4}  # 3 slots x 4 ranks in every launch
    assert len(calls["flash"]) == L * (eng.chunk_launches + eng.verify_launches)
    assert {s[0] for s in calls["flash"]} == {3 * 4}
    assert {s[1] for s in calls["flash"]} == {8, 4}  # the chunk and the verify width


def test_ring_prefill_writes_jax_cache_layout(weights):
    """One-shot prefill at sp_size 4 writes the dense cache exactly where
    JAX's prefill over a 4-rank cache puts it (striped prompt, column
    (p % 4) * cap/4 + p // 4), and JAX's decode then agrees with the port's
    over the same cache."""
    jcfg, jp, tcfg, tp = weights
    S, cap, n = 16, 32, 4
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (1, S), dtype=np.int32)
    from repro_torch.core.tiling import stripe_permutation

    perm = np.asarray(stripe_permutation(S, n))
    tc = ttfm.init_cache(tcfg, 1, cap, dtype=torch.float32, ctx=TCTX4)
    batch = {"tokens": torch.from_numpy(tokens[:, perm]), "positions": torch.from_numpy(perm)}
    t_logits, tc = ttfm.prefill(tp, tcfg, TCTX4, batch, tc)
    jc = jtfm.init_cache(jcfg, 1, cap, dtype=jnp.float32)
    j_logits, jc = jtfm.prefill(jp, jcfg, JCtx(), {"tokens": jnp.asarray(tokens),
                                                   "positions": jnp.arange(S)}, jc)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    # JAX's single-device cache holds position p at column p; the ring's at
    # the owner rank's column
    p = np.arange(S)
    cols = torch.from_numpy((p % n) * (cap // n) + p // n)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, :, cols].numpy(), np.asarray(jc[key])[:, :, :S],
                                   atol=1e-5, rtol=1e-5)
    assert int(tc["pos"][0]) == S


# --------------------------------------------------------------------------
# entry points and what stays refused
# --------------------------------------------------------------------------


def test_launch_serve_fake_devices_runs_the_ring(capsys):
    from repro_torch.launch import serve

    assert serve.main([
        "--device", "cpu", "--reduced", "--stream", "--fake-devices", "8", "--paged",
        "--page-size", "4", "--prefill-chunk", "8", "--tick-token-budget", "16", "--spec-k", "4",
        "--check-spec-identical", "--trace", "12:0,20:1", "--new-tokens", "5", "--max-seq", "64",
    ]) == 0
    out = capsys.readouterr().out
    assert '"ring": "VirtualRing(n=4)"' in out and "streams match vanilla greedy" in out


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_and_hybrid_over_a_ring_still_raise(arch):
    """The SSM and hybrid archs, refused over a ring until the sequence-
    sharded SSD scan was ported, now build their cache and serve at sp_size
    4 (their parity with JAX: tests/test_torch_ssm_ring.py).  MoE archs,
    refused until expert parallelism was ported (ROADMAP A.7), now serve
    there too (their parity with JAX: tests/test_torch_moe_ring.py)."""
    cfg = tget_config(arch).reduced()
    params = ttfm.init_params(cfg, device="cpu")
    cache = ttfm.init_cache(cfg, 2, 16, dtype=torch.float32, ctx=TCTX4)
    assert cache["ssm"]["state"].shape[:2] == (cfg.num_layers, 2)
    assert ("k" in cache) == cfg.hybrid
    eng = TEngine(cfg, params, TCTX4, serve=TServe(max_seq=32, num_slots=2))
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), 3, arrival_tick=t)
            for n, t in ((8, 0), (16, 1))]
    done = eng.run()
    assert all(done[r].status == "ok" and len(done[r].generated) == 3 for r in rids)
    with pytest.raises(ValueError, match="multiple of the sequence-parallel size 4"):
        eng.submit(np.zeros(6, np.int32), 2)
    moe = tget_config("qwen2-moe-a2.7b").reduced()
    eng = TEngine(moe, ttfm.init_params(moe, device="cpu", ctx=TCTX4), TCTX4,
                  serve=TServe(max_seq=32, num_slots=2))
    rid = eng.submit(rng.integers(0, moe.vocab_size, (16,), dtype=np.int32), 3)
    assert eng.run()[rid].status == "ok"


def test_ring_engine_checks_divisibility(weights):
    _, _, tcfg, tp = weights
    with pytest.raises(ValueError, match="max_seq"):
        TEngine(tcfg, tp, TCTX4, serve=TServe(max_seq=62))
    with pytest.raises(ValueError, match="multiples"):
        TEngine(tcfg, tp, TCTX4, serve=TServe(max_seq=64, prefill_buckets=(18, 64)))
    with pytest.raises(ValueError, match="ring"):
        dispatch.paged_write_coords(torch.zeros((1, 2), dtype=torch.int32), 0, 4, None, 4)
