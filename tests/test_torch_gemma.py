"""gemma-7b in the port against the JAX package, on the CPU, fp32.

JAX's ``reduced()`` sets head_dim 32 and keeps a GQA group of 2, which would
hide what gemma brings: head dim 256, MHA, tanh-GELU GeGLU and tied
embeddings.  So the model tests build both sides from
``replace(gemma-7b.reduced(), head_dim=256, num_kv_heads=4)`` (2 layers,
d_model 128, 4 / 4 heads of 256), and from the plain reduced config beside
it; the weights are JAX's ``init_params`` converted by ``params_from_jax``.
They reuse the dense family's checks at the dense family's tolerances
(``tests/test_torch_model.py``: logits 1e-4, caches 1e-5;
``tests/test_torch_continuous.py``: chunks and verifies 1e-4, quantized
pools within one code step, a verify over the same codes): forward logits, packed segments, prefill and
greedy decode over the dense and paged caches, packed prefill, an int8
pool's chunks and speculative verify, and the engine over an int8 pool with
chunked prefill and speculation.  The kernels' plain versions at head dim
256 are held to JAX's Pallas kernels in interpret mode at
``tests/test_torch_kernels.py``'s and ``tests/test_torch_quant.py``'s
tolerances: the flash forward (causal, window, segments; group 1 and 2)
and the paged decode over fp, int8 and fp8 pools; the flash backward the
same way.  Training at head dim 256 (``tests/test_torch_train.py``'s
checks and tolerances: loss 1e-5, gradients 1e-4): ``loss_fn`` and its
gradients against ``jax.value_and_grad`` (causal and 3 packed documents,
remat on and off bitwise equal), and three train steps.  Inputs come from
numpy with fixed seeds.
"""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_continuous as tcont
import test_torch_model as tmodel
import test_torch_train as ttrain
from repro.configs import get_config as jget_config
from repro.kernels import flash_attention as jfa
from repro.kernels import paged_decode as jpk
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve import kv_pool as jpool
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_decode as tpk
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from test_torch_quant import _quant_case, dequant_close

ARCH = "gemma-7b"
INF = jref.BAND_INF
# tests/test_torch_kernels.py's flash forward, backward and paged decode
# tolerances, tests/test_torch_quant.py's for the quantized branch
FWD_TOL = 2e-5
BWD_TOL = 2e-4
PAGED_ATOL, PAGED_RTOL = 2e-5, 1e-5
QUANT_ATOL = 1e-5


def _configs(variant):
    """(JAX config, the port's) of one variant: "d256" (head dim 256, 4 / 4
    heads) or "reduced" (JAX's reduced(): head dim 32, 4 / 2 heads)."""
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    if variant == "d256":
        jcfg = dataclasses.replace(jcfg, head_dim=256, num_kv_heads=4)
        tcfg = dataclasses.replace(tcfg, head_dim=256, num_kv_heads=4)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _converted(variant):
    """(jcfg, JAX params, tcfg, the port's params) of one variant."""
    jcfg, tcfg = _configs(variant)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=["d256", "reduced"])
def model(request):
    return _converted(request.param)


@pytest.fixture(scope="module")
def model_d256():
    """The head-dim-256 variant alone, for the slowest checks (the reduced
    config's head dim 32 and GQA 2 run them in tests/test_torch_model.py's
    and test_torch_continuous.py's dense archs)."""
    return _converted("d256")


def test_config_is_jaxs_gemma():
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.hd, tcfg.num_heads, tcfg.num_kv_heads, tcfg.num_layers) == (256, 16, 16, 28)
    assert tcfg.mlp_act == "gelu" and tcfg.tie_embeddings and tcfg.family == "dense"
    d256, reduced = (_configs(v)[1] for v in ("d256", "reduced"))
    assert (d256.hd, d256.num_heads, d256.num_kv_heads, d256.num_layers) == (256, 4, 4, 2)
    assert (reduced.hd, reduced.num_kv_heads) == (32, 2)


def test_forward_logits_match_jax(model):
    tmodel.test_forward_logits_match_jax(model)


def test_forward_packed_segments_match_jax(model):
    tmodel.test_forward_packed_segments_match_jax(model)


def test_prefill_and_decode_match_jax_dense(model_d256):
    tmodel.test_prefill_and_decode_match_jax_dense(model_d256)


def test_prefill_and_decode_match_jax_paged(model_d256):
    tmodel.test_prefill_and_decode_match_jax_paged(model_d256)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_packed_matches_jax(model, paged):
    tmodel.test_prefill_packed_matches_jax(model, paged)


def test_int8_pool_chunks_and_verify_match_jax(model_d256):
    """Two chunk launches (rows at other offsets, a pad-only row, a shared
    prefix skipped by write_starts) and a partly accepted verify over an int8
    pool: chunk logits within 1e-4 and pools within one code step, as
    test_torch_continuous holds them.  Both sides quantize K/V computed in
    another order, and at head dim 256 a code flips (2 of 196,608 K codes
    after the chunks here, one step each), which moves a logit that reads it
    by ~3e-4.  So the verify runs on both sides over the port's pool (JAX's
    cache takes its codes and scales): y, commit and pos equal, and the
    logits within 1e-4 at every draft position that reads no code the
    verify itself wrote differently (the pools stay within one step)."""
    jcfg, jp, tcfg, tp = model_d256
    B, cap = 3, 32
    layout = jpool.PagedLayout.for_engine(cap, 1, B, page_size=4)
    jc = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32, ctx=JCtx(), paged=layout,
                         kv_dtype="int8")
    bt = np.full((B, layout.max_pages), -1, np.int32)
    bt[0, :6], bt[1, :3], bt[2, :2] = [3, 9, 0, 4, 11, 12], [5, 1, 7], [3, 2]
    jc["bt"] = jnp.asarray(bt)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    rng = np.random.default_rng(31)
    toks = rng.integers(0, jcfg.vocab_size, (B, 8), dtype=np.int32)
    chunks = [
        dict(tokens=toks, starts=[0, 0, 0], lens=[8, 5, 0], write_starts=[0, 0, 0],
             pos_set=[-1, 5, -1]),
        dict(tokens=np.roll(toks, 1, axis=1), starts=[8, 0, 0], lens=[6, 0, 7],
             write_starts=[8, 0, 4], pos_set=[14, -1, 7]),
    ]
    for ch in chunks:
        ch = {k: np.asarray(v, np.int32) for k, v in ch.items()}
        lj, jc = jtfm.prefill_chunk(jp, jcfg, JCtx(), tcont._jx(ch), jc)
        lt, tc = ttfm.prefill_chunk(tp, tcfg, tcont.TCTX, tcont._tx(ch), tc)
        live = ch["lens"] > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    dequant_close(tc, jc, "int8")
    jc = dict(jc, **{key: jnp.asarray(tc[key].numpy())
                     for key in ("k", "v", "k_scale", "v_scale")})
    # row 0 drafts JAX's own greedy continuation, row 1 a random draft, row
    # 2 a plain one-token tick
    vt = np.zeros((B, 4), np.int32)
    vt[:, 0] = rng.integers(0, jcfg.vocab_size, (B,))
    vt[1, 1:] = rng.integers(0, jcfg.vocab_size, (3,))
    vb = {"tokens": vt, "starts": np.asarray(jc["pos"]), "lens": np.array([4, 4, 1], np.int32),
          "write_starts": np.asarray(jc["pos"])}
    y0, _, _ = jtfm.verify_step(jp, jcfg, JCtx(), tcont._jx(vb), jc)
    vt[0, 1:] = np.asarray(y0)[0, :3]
    yj, cj, jc, lj = jtfm.verify_step(jp, jcfg, JCtx(), tcont._jx(vb), jc, return_logits=True)
    yt, ct, tc, lt = ttfm.verify_step(tp, tcfg, tcont.TCTX, tcont._tx(vb), tc,
                                      return_logits=True)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(np.asarray(cj)[0]) >= 2 and int(np.asarray(cj)[2]) == 1
    dequant_close(tc, jc, "int8")
    # slot s of row b flipped a code in some layer, kv head or dim (k or v)
    ps = layout.chunk
    flips = sum((tc[key].numpy() != np.asarray(jc[key])).any(axis=(0, 3, 4))
                for key in ("k", "v"))  # [num_pages, page_size]
    checked = 0
    for b in range(B):
        start = int(vb["starts"][b])
        for j in range(int(vb["lens"][b])):
            slots = range(start + j + 1)
            if any(flips[bt[b, s // ps], s % ps] for s in slots if bt[b, s // ps] >= 0):
                continue
            np.testing.assert_allclose(lt.numpy()[b, j], np.asarray(lj)[b, j], atol=1e-4, rtol=0)
            checked += 1
    assert checked >= 3


def test_init_params_mirror_jax_with_a_tied_head(model):
    """No lm_head on either side: the logits read the embedding's transpose."""
    jcfg, jp, tcfg, tp = model
    tmodel.test_init_params_mirrors_jax_pytree(model)
    tmodel.test_params_from_jax_keeps_bf16_and_layout(model)
    assert "lm_head" not in jp and "lm_head" not in tp
    assert "lm_head" not in ttfm.init_params(tcfg, seed=0, device="cpu")
    head = ttfm._head(tp, tcfg)
    assert head.shape == (tcfg.d_model, tcfg.vocab_size)
    assert head.data_ptr() == tp["embed"].data_ptr()  # a view, not a copy
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, tcfg.d_model))
                         .astype(np.float32))
    torch.testing.assert_close(ttfm._logits(x, tp, tcfg),
                               tmodel.tlayers.rms_norm(x, tp["final_ln"]) @ tp["embed"].T)


def test_engine_int8_chunk_spec_streams_match_jax(model):
    """The engine over an int8 pool with chunked prefill (chunk 8, budget
    16) and speculative verify (spec_k 4) against JAX's on one trace, under
    test_torch_continuous's rule: equal streams, or a flip where both
    engines score the two candidates within twice the logit bound."""
    jcfg, jp, tcfg, tp = model
    kw = dict(max_seq=48, num_slots=3, **tcont.MODES["int8_paged_chunk_spec"])
    prompts = tcont._prompts(jcfg.vocab_size)
    want, want_logits = tcont._serve(JEngine(jcfg, jp, JCtx(), serve=JServe(**kw)), prompts)
    teng = TEngine(tcfg, tp, tcont.TCTX, serve=TServe(**kw))
    got, got_logits = tcont._serve(teng, prompts)
    for g, w, gl, wl in zip(got, want, got_logits, want_logits):
        assert g.status == w.status == "ok"
        if g.generated != w.generated:
            i = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
            a, b = w.generated[i], g.generated[i]
            assert wl[i][a] - wl[i][b] <= 2 * tcont.LOGIT_BOUND
            assert gl[i][b] - gl[i][a] <= 2 * tcont.LOGIT_BOUND
        else:
            assert g.token_ticks == w.token_ticks
    assert teng.chunk_launches > 0 and teng.verify_launches > 0
    kv = teng.kv_cache_stats()
    assert kv["pages_in_use"] == kv["scale_entries_in_use"] == kv["dequant_fallbacks"] == 0


# the flash forward at head dim 256: name -> (band, segments, H, Hkv)
FWD_CASES = {
    "causal_mha": ((0, 0, 0, INF), False, 4, 4),
    "causal_gqa2": ((0, 0, 0, INF), False, 4, 2),
    "window_gqa2": ((0, 0, 0, 15), False, 4, 2),
    "segment_mha": ((0, 0, 0, INF), True, 2, 2),
}


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_flash_fwd_plain_d256_matches_pallas(name):
    """The forward's plain version (and the wrapper on CPU tensors) at head
    dim 256 against JAX's Pallas forward in interpret mode."""
    band, seg, H, Hkv = FWD_CASES[name]
    B, S, D = 1, 64, 256
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    jkw, tkw = {}, {}
    if seg:
        ids = np.sort(rng.integers(0, 3, S)).astype(np.int32)
        jkw = dict(seg_q=jnp.asarray(ids), seg_kv=jnp.asarray(ids))
        tkw = dict(seg_q=torch.from_numpy(ids), seg_kv=torch.from_numpy(ids))
    o_t, lse_t = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), band, scale=D**-0.5, **tkw)
    o_p, lse_p = jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(band, jnp.int32),
        scale=D**-0.5, block_q=32, block_kv=32, interpret=True, **jkw,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_p), atol=FWD_TOL, rtol=FWD_TOL)
    assert tfa._fwd_plan(B, S, H, Hkv, D, torch.float32) == ("tile_fp32", 1)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_flash_bwd_plain_d256_matches_pallas(name):
    """The backward's plain version (and the wrapper on CPU tensors) at head
    dim 256 against JAX's Pallas backward in interpret mode (blocks of 32),
    with the body the card would take."""
    band, seg, H, Hkv = FWD_CASES[name]
    B, S, D = 1, 64, 256
    rng = np.random.default_rng(zlib.crc32(f"bwd{name}".encode()))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
    jkw, tkw = {}, {}
    if seg:
        ids = np.sort(rng.integers(0, 3, S)).astype(np.int32)
        jkw = dict(seg_q=jnp.asarray(ids), seg_kv=jnp.asarray(ids))
        tkw = dict(seg_q=torch.from_numpy(ids), seg_kv=torch.from_numpy(ids))
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    oj, lsej = jref.attention_ref(qj, kj, vj, scale=D**-0.5, band=band, **jkw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    ot, lset = torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lsej))
    plain = tref.attention_bwd_ref(qt, kt, vt, ot, lset, dot, scale=D**-0.5, band=band, **tkw)
    wrapped = tfa.flash_attention_bwd(qt, kt, vt, ot, lset, dot, band, scale=D**-0.5, **tkw)
    pallas = jfa.flash_attention_bwd(qj, kj, vj, oj, lsej, doj, jnp.asarray(band, jnp.int32),
                                     scale=D**-0.5, block_q=32, block_kv=32, interpret=True,
                                     **jkw)
    for g, w, p in zip(plain, wrapped, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=BWD_TOL, rtol=BWD_TOL)
        assert torch.equal(g, w)
    assert tfa._bwd_plan(B, S, S, H, Hkv, D, torch.float32) == "tc_fp32"
    assert tfa._bwd_plan(B, S, S, H, Hkv, D, torch.bfloat16) == "tc_bf16"


@pytest.mark.parametrize("docs", [None, 3], ids=["causal", "docs"])
def test_loss_and_grads_match_jax(model, docs):
    """loss_fn and its gradients (GeGLU, the tied embedding, head dim 256
    through the backward's plain version) against jax.value_and_grad;
    remat on and off bitwise equal."""
    ttrain.test_loss_and_grads_match_jax(model[:3], docs)


def test_three_train_steps_match_jax(model_d256):
    jcfg, _, tcfg, _ = model_d256
    ttrain.three_train_steps_match_jax(jcfg, tcfg)


@pytest.mark.parametrize("pool", ["fp", "int8", "fp8"])
def test_paged_decode_plain_d256_matches_pallas(pool):
    """The paged decode's plain version (#4, and 4q over int8 / fp8 codes)
    at head dim 256 against JAX's Pallas kernel in interpret mode: gemma's
    MHA and a group of 2, partial last pages, an unallocated page, an empty
    row."""
    rng = np.random.default_rng(zlib.crc32(pool.encode()))
    depths, ps, H, Hkv, D = (13, 30, 1, 0), 4, 4, 4, 256
    if pool == "fp":
        H, Hkv = 4, 2
        bt = np.full((len(depths), 9), -1, np.int32)
        perm = rng.permutation(40)
        for b, depth in enumerate(depths):
            n = -(-depth // ps)
            bt[b, :n] = perm[9 * b: 9 * b + n]
        bt[0, 1] = -1  # an unallocated page inside the visible range
        kp, vp = (rng.standard_normal((40, ps, Hkv, D)).astype(np.float32) for _ in range(2))
        jkw, tkw = {}, {}
        kj, vj, kt, vt = jnp.asarray(kp), jnp.asarray(vp), torch.from_numpy(kp), torch.from_numpy(vp)
        atol, rtol = PAGED_ATOL, PAGED_RTOL
    else:
        ((kj, ks), (vj, vs)), bt = _quant_case(rng, depths, ps, Hkv, D, pool, holes=True)
        c = cache_from_jax({"k": kj, "v": vj, "k_scale": ks, "v_scale": vs,
                            "pos": np.zeros(len(depths), np.int32)}, device="cpu")
        kt, vt = c["k"], c["v"]
        jkw, tkw = dict(k_scale=ks, v_scale=vs), dict(k_scale=c["k_scale"], v_scale=c["v_scale"])
        atol, rtol = QUANT_ATOL, 0
    q = rng.standard_normal((len(depths), 1, H, D)).astype(np.float32)
    pos = np.array([d - 1 for d in depths], np.int32)
    o_t, lse_t = tpk.paged_flash_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
                                        torch.from_numpy(pos), 0, stride_kv=1, **tkw)
    o_j, lse_j = jpk.paged_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(bt), jnp.asarray(pos),
                                        0, stride_kv=1, interpret=True, **jkw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=atol, rtol=rtol)
    assert np.all(o_t.numpy()[-1] == 0) and np.all(lse_t.numpy()[-1] == tref.NEG_INF)
    assert tpk._plan(len(depths), H, Hkv, D, bt.shape[1], None, torch.float32)[0] == "simt"
