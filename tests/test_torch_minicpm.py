"""minicpm3-4b (Multi-head Latent Attention) in the port against the JAX
package, on the CPU, fp32.

JAX's ``reduced()`` MLA has v_head_dim = qk = 32, so V's padding up to the
qk width and the slice of o back to v_head_dim do nothing there.  So the
model tests run two variants: "reduced" (JAX's reduced config: q_lora 32,
kv_lora 16, nope 16, rope 16, v 32; the latent 32 wide) and "v16", a
hand-made MLA config with v_head_dim < qk (nope 16, rope 8, v 16: V padded
from 16 to 24, a latent of 24); the weights are JAX's ``init_params``
converted by ``params_from_jax``.  The tolerances are the dense family's
(``tests/test_torch_model.py``: logits 1e-4, caches 1e-5;
``tests/test_torch_continuous.py``: chunks and verifies 1e-4, quantized
pools within one code step, greedy flips only under its logit bound) and the
kernels' (``tests/test_torch_kernels.py``, ``tests/test_torch_quant.py``):
the attention block and its expanded K/V; the absorbed decode projections
(q with W^{kv_b}_K, the output through W^{kv_b}_V) at the scale qk^-0.5;
forward logits, packed segments; prefill and decode over the dense cache
and the paged latent pool, JAX's latent cache carried across by
``cache_from_jax``; packed prefill; chunks and speculative verifies over the
dense cache and the fp / int8 pools; the engine's greedy streams in one-shot
(packed and single) and chunked + speculative modes over the dense cache
and the fp / int8 / fp8 pools; the chunked prefill's token against one-shot
(JAX's ``test_chunked_prefill_mla_token_equal``).  The plain versions of the
flash forward at head dims 96 (40 / 40 heads) and 288 (40 heads on one kv
head) and of the paged decode at head dim 288, group 40 (fp, int8, fp8
pools) are held to JAX's Pallas kernels in interpret mode.  MLA trains
(tests/test_torch_minicpm_train.py); MLA serving over a ring and the latent
wire raise, naming ROADMAP A.9.  Inputs come from numpy
with fixed seeds.
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
import test_torch_serve as tserve
from repro.configs import get_config as jget_config
from repro.configs.base import MLAConfig as JMLA
from repro.kernels import flash_attention as jfa
from repro.kernels import paged_decode as jpk
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import MLAConfig as TMLA
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_decode as tpk
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from test_torch_quant import _quant_case

ARCH = "minicpm3-4b"
INF = jref.BAND_INF
TCTX = TCtx(device="cpu")
# tests/test_torch_model.py's: logits 1e-4, caches (and here the block's
# outputs and the absorbed projections, of the same size) 1e-5
LOGIT_TOL = tmodel.LOGIT_TOL
CACHE_TOL = 1e-5
# tests/test_torch_kernels.py's flash forward and paged decode tolerances,
# tests/test_torch_quant.py's for the quantized branch
FWD_TOL = 2e-5
PAGED_ATOL, PAGED_RTOL = 2e-5, 1e-5
QUANT_ATOL = 1e-5
# "v16": v_head_dim 16 < qk 24 (nope 16 + rope 8), so V is padded and o sliced
V16 = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)


def _configs(variant):
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    if variant == "v16":
        jcfg = dataclasses.replace(jcfg, mla=JMLA(**V16))
        tcfg = dataclasses.replace(tcfg, mla=TMLA(**V16))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _converted(variant):
    """(jcfg, JAX params, tcfg, the port's params) of one variant."""
    jcfg, tcfg = _configs(variant)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=["reduced", "v16"])
def model(request):
    return _converted(request.param)


@pytest.fixture(scope="module")
def reduced():
    return _converted("reduced")


def _layer(jp, tp, i=0):
    """Layer i's attention params on both sides."""
    return (jax.tree.map(lambda a: a[i], jp["layers"]["attn"]),
            {k: v[i] for k, v in tp["layers"]["attn"].items()})


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), atol=tol, rtol=0)


def test_config_is_jaxs_minicpm():
    """The port's config is JAX's; 4,261,902,848 parameters (8.52 GB in
    bf16: served whole on one card); the cache is one latent head of 288."""
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == 4_261_902_848
    assert ttfm.attn_cache_dims(tcfg) == (1, 288)
    assert ttfm.attn_cache_dims(_configs("v16")[1]) == (1, 24)
    for variant in ("reduced", "v16"):
        j, t = _configs(variant)
        assert ttfm.attn_cache_dims(t) == jtfm._attn_cache_dims(j)[:2]
    assert 288 in tfa.FWD_HEAD_DIMS and 96 in tfa.FWD_HEAD_DIMS
    assert tpk.KERNEL_MAX_GROUP_D288 >= tcfg.num_heads


def test_init_params_mirror_jax(model):
    """Same pytree keys and shapes (wq_a, q_ln, wq_b, wkv_a, kv_ln, wkv_b,
    wo), and JAX's weights carried across bit for bit."""
    tmodel.test_init_params_mirrors_jax_pytree(model)
    jcfg, jp, tcfg, tp = model
    assert set(tp["layers"]["attn"]) == {"ln", "wq_a", "q_ln", "wq_b", "wkv_a", "kv_ln", "wkv_b",
                                         "wo"}


def test_attention_block_matches_jax(model):
    """The block (q through the bottleneck, the latent expanded per head, V
    padded to qk, o sliced back to v_head_dim), and the expanded q, k, v."""
    jcfg, jp, tcfg, tp = model
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    want = jattn.attention_block(jnp.asarray(x), jl, jcfg, JCtx(), jnp.asarray(pos))
    got = tattn.attention_block(torch.from_numpy(x), tl, tcfg, TCTX, torch.from_numpy(pos))
    _close(got, want, CACHE_TOL)
    jq, jk, jv = jattn._project_qkv(jnp.asarray(x), jl, jcfg, jnp.asarray(pos))
    tq, tk, tv = tattn._project_qkv(torch.from_numpy(x), tl, tcfg, torch.from_numpy(pos))
    m = tcfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert tuple(tv.shape) == (2, 12, tcfg.num_heads, qk)
    assert torch.all(tv[..., m.v_head_dim:] == 0)
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _close(t, j, CACHE_TOL)


@pytest.mark.parametrize("grid", [False, True], ids=["decode", "chunk"])
def test_absorbed_decode_matches_jax(model, grid):
    """``_decode_qkv``'s absorbed q (W^{kv_b}_K folded into q_nope), the
    latent as k_new and v_new, the scale qk^-0.5 (not the latent's width),
    and ``_decode_attn_out``'s o through W^{kv_b}_V and wo: per-slot
    positions (a decode tick) and a [B, S] grid (a chunk)."""
    jcfg, jp, tcfg, tp = model
    jl, tl = _layer(jp, tp)
    rng = np.random.default_rng(6)
    B, S = 3, (4 if grid else 1)
    h = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32)
    if grid:
        pos = pos[:, None] + np.arange(S, dtype=np.int32)[None]
    jq, jk, jv, js = jtfm._decode_qkv(jnp.asarray(h), jl, jcfg, jnp.asarray(pos))
    tq, tk, tv, ts = ttfm._decode_qkv(torch.from_numpy(h), tl, tcfg, torch.from_numpy(pos))
    m = tcfg.mla
    assert ts == js == (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    assert tuple(tq.shape) == (B, S, tcfg.num_heads, m.kv_lora_rank + m.qk_rope_head_dim)
    assert tk is tv and tuple(tk.shape) == (B, S, 1, m.kv_lora_rank + m.qk_rope_head_dim)
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _close(t, j, CACHE_TOL)
    o = rng.standard_normal(tuple(tq.shape)).astype(np.float32)
    want = jtfm._decode_attn_out(jnp.asarray(o), jnp.asarray(h), jl, jcfg)
    got = ttfm._decode_attn_out(torch.from_numpy(o), torch.from_numpy(h), tl, tcfg)
    _close(got, want, CACHE_TOL)


def test_forward_logits_match_jax(model):
    tmodel.test_forward_logits_match_jax(model)


def test_forward_packed_segments_match_jax(model):
    tmodel.test_forward_packed_segments_match_jax(model)


def test_prefill_and_decode_match_jax_dense(model):
    """Bucketed prefill (logits, the latent written as both k and v), then
    greedy decode over the absorbed latent."""
    tmodel.test_prefill_and_decode_match_jax_dense(model)


def test_prefill_and_decode_match_jax_paged(model):
    tmodel.test_prefill_and_decode_match_jax_paged(model)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_packed_matches_jax(model, paged):
    tmodel.test_prefill_packed_matches_jax(model, paged)


def test_latent_cache_from_jax_decodes_like_jax(model):
    """JAX's prefill writes its latent cache; ``cache_from_jax`` carries it
    across, and the port's decode continues it as JAX's does."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(9)
    B, S, cap = 2, 10, 24
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32)
    jl, jc = jtfm.prefill(jp, jcfg, JCtx(), {"tokens": jnp.asarray(tokens),
                                             "positions": jnp.arange(S, dtype=jnp.int32)}, jc)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    hkv, d = ttfm.attn_cache_dims(tcfg)
    assert tuple(tc["k"].shape) == (tcfg.num_layers, B, cap, hkv, d)
    assert torch.equal(tc["k"], tc["v"])  # the latent, written twice
    first = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    toks, jlogits, _ = tmodel._jax_decode(jp, jcfg, jc, first, 3)
    for step in range(3):
        _, tc, tlg = ttfm.decode_step(tp, tc, torch.from_numpy(np.array(toks[step])), tcfg, TCTX)
        _close(tlg, jlogits[step], LOGIT_TOL)


@pytest.mark.parametrize("name", list(tcont.CACHES))
def test_prefill_chunk_and_verify_match_jax(model, name):
    """Chunks and a partly accepted verify over the dense latent cache and
    the fp / int8 latent pools (tests/test_torch_continuous.py's check)."""
    tcont.test_prefill_chunk_and_verify_match_jax(model, name)


def test_chunked_prefill_token_equal_to_one_shot(model):
    """The port's counterpart of JAX's test_chunked_prefill_mla_token_equal:
    chunks of 8 through the absorbed latent against one-shot prefill over
    the expanded heads -- the same next token, logits within 1e-4."""
    _, _, tcfg, tp = model
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (20,), dtype=np.int32)
    S, cap, C = len(prompt), 32, 8
    c1 = ttfm.init_cache(tcfg, 1, cap, dtype=torch.float32, ctx=TCTX)
    l1, _ = ttfm.prefill(tp, tcfg, TCTX, {"tokens": torch.from_numpy(prompt)[None],
                                         "positions": torch.arange(S)}, c1)
    c2 = ttfm.init_cache(tcfg, 1, cap, dtype=torch.float32, ctx=TCTX)
    c2["pos"][0] = 2**30  # parked until the last chunk
    for start in range(0, S, C):
        take = min(C, S - start)
        toks = np.zeros((1, C), np.int32)
        toks[0, :take] = prompt[start:start + take]
        l2, c2 = ttfm.prefill_chunk(tp, tcfg, TCTX, {
            "tokens": torch.from_numpy(toks), "starts": torch.tensor([start]),
            "lens": torch.tensor([take]), "write_starts": torch.tensor([0]),
            "pos_set": torch.tensor([S if start + take >= S else -1])}, c2)
    l1, l2 = l1.reshape(-1), l2.reshape(-1)
    assert int(torch.argmax(l1)) == int(torch.argmax(l2))
    torch.testing.assert_close(l1, l2, atol=1e-4, rtol=1e-4)
    assert int(c2["pos"][0]) == S
    torch.testing.assert_close(c1["k"], c2["k"], atol=CACHE_TOL, rtol=0)


# one-shot prefill (tests/test_torch_serve.py's trace) and chunked prefill +
# speculation (tests/test_torch_continuous.py's) over the dense cache and
# the fp / int8 / fp8 latent pools
ENGINE_MODES = {
    "dense_packed": ("serve", tserve.SERVES["dense_packed"]),
    "paged_single": ("serve", tserve.SERVES["paged_single"]),
    "chunk_paged_shared_prefix": ("cont", tcont.MODES["chunk_paged_shared_prefix"]),
    "spec_dense": ("cont", tcont.MODES["spec_dense"]),
    "int8_paged_chunk_spec": ("cont", tcont.MODES["int8_paged_chunk_spec"]),
    "fp8_paged_chunk_spec": ("cont", tcont.MODES["fp8_paged_chunk_spec"]),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_streams_match_jax(reduced, mode):
    """The port's engine against JAX's on one trace: equal streams and ticks
    (the quantized pools: a flip only where both engines score the two
    candidates within twice test_torch_continuous's logit bound), launch
    counts equal, pages drained."""
    jcfg, jp, tcfg, tp = reduced
    kind, modes = ENGINE_MODES[mode]
    if kind == "serve":
        kw = dict(max_seq=64, num_slots=3, **modes)
        prompts = tserve._prompts(jcfg.vocab_size)
        jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
        teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
        want, got = tserve._replay(jeng, prompts), tserve._replay(teng, prompts)
        for g, w in zip(got, want):
            assert g.status == w.status == "ok"
            assert g.generated == w.generated and g.token_ticks == w.token_ticks
        assert teng.prefill_launches == jeng.prefill_launches
    else:
        kw = dict(max_seq=48, num_slots=3, **modes)
        prompts = tcont._prompts(jcfg.vocab_size)
        jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
        teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
        want, want_logits = tcont._serve(jeng, prompts)
        got, got_logits = tcont._serve(teng, prompts)
        flipped = False
        for g, w, gl, wl in zip(got, want, got_logits, want_logits):
            assert g.status == w.status == "ok"
            if g.generated == w.generated:
                assert g.token_ticks == w.token_ticks
                continue
            assert "kv_dtype" in kw, (mode, g.generated, w.generated)
            i = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
            a, b = w.generated[i], g.generated[i]
            assert wl[i][a] - wl[i][b] <= 2 * tcont.LOGIT_BOUND
            assert gl[i][b] - gl[i][a] <= 2 * tcont.LOGIT_BOUND
            flipped = True
        if not flipped:
            assert tcont._counters(teng) == tcont._counters(jeng)
        if "prefill_chunk" in kw:
            assert teng.chunk_launches > 0
        if "spec_k" in kw:
            assert teng.verify_launches > 0
    if kw.get("paged"):
        kv = teng.kv_cache_stats()
        assert kv["pages_in_use"] == kv["scale_entries_in_use"] == 0
        # the latent pool: one head of kv_lora_rank + rope per token and layer
        assert teng._cache["k"].shape[-2:] == ttfm.attn_cache_dims(tcfg)


# the flash forward's plain version at MLA's widths: name -> (Sq, Skv, H,
# Hkv, D, band); 96: prefill over the expanded heads (40 / 40), 288: a
# chunk and a decode row over the absorbed latent (40 heads on one)
FWD_CASES = {
    "d96_causal": (48, 48, 40, 40, 96, (0, 0, 0, INF)),
    "d288_chunk": (16, 64, 40, 1, 288, (40, 0, 0, INF)),
    "d288_decode": (1, 64, 40, 1, 288, (50, 0, 0, INF)),
}


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_flash_fwd_plain_mla_matches_pallas(name):
    """The forward's plain version (and the wrapper on CPU tensors) against
    JAX's Pallas forward in interpret mode, at MLA's scale qk^-0.5, with the
    body the card would take (the tile body at every row count)."""
    Sq, Skv, H, Hkv, D, band = FWD_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((1, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, Skv, Hkv, D)).astype(np.float32) for _ in range(2))
    scale = 96 ** -0.5
    o_t, lse_t = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), band, scale=scale)
    o_p, lse_p = jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(band, jnp.int32),
        scale=scale, block_q=min(Sq, 16), block_kv=16, interpret=True,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_p), atol=FWD_TOL, rtol=FWD_TOL)
    for dtype in (torch.float32, torch.bfloat16):
        assert tfa._fwd_plan(8, Sq, H, Hkv, D, dtype)[0].startswith("tile")


@pytest.mark.parametrize("pool", ["fp", "int8", "fp8"])
def test_paged_decode_plain_d288_matches_pallas(pool):
    """The paged decode's plain version (#4, and 4q over int8 / fp8 codes)
    at MLA's latent (head dim 288, 40 query heads on one kv head) against
    JAX's Pallas kernel in interpret mode at scale qk^-0.5: partial last
    pages, an unallocated page, an empty row."""
    rng = np.random.default_rng(zlib.crc32(f"d288{pool}".encode()))
    depths, ps, H, Hkv, D = (13, 30, 1, 0), 4, 40, 1, 288
    if pool == "fp":
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
    scale = 96 ** -0.5
    o_t, lse_t = tpk.paged_flash_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
                                        torch.from_numpy(pos), 0, stride_kv=1, scale=scale,
                                        **tkw)
    o_j, lse_j = jpk.paged_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(bt), jnp.asarray(pos),
                                        0, stride_kv=1, scale=scale, interpret=True, **jkw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=atol, rtol=rtol)
    assert np.all(o_t.numpy()[-1] == 0) and np.all(lse_t.numpy()[-1] == tref.NEG_INF)
    for dtype, body in ((torch.float32, "simt"), (torch.bfloat16, "mma")):
        assert tpk._plan(len(depths), H, Hkv, D, bt.shape[1], None, dtype)[0] == body
    with pytest.raises(ValueError, match="GQA group 56 > 48"):
        tpk._plan(1, 56, 1, D, 4, None, torch.bfloat16)


def test_mla_training_and_ring_raise(reduced):
    """MLA trains (the backward at head dim 96): a train step and the CLI
    run on the CPU.  Over a ring nothing of MLA raises any more (ROADMAP
    A.9's MLA bullet is done): the engine serves at sp_size 4 from the
    sharded latent cache, the same streams as at sp_size 1, and a train
    step runs through the latent wire (JAX at sp_size 4 holds both in
    tests/test_torch_mla_ring.py)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as tlaunch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_map
    from repro_torch.train.loop import make_train_step

    _, _, tcfg, tp = reduced
    params = tree_map(torch.clone, tp)  # the step updates params in place
    step = make_train_step(tcfg, TCTX, AdamWConfig())
    _, _, _, metrics = step(params, init_opt_state(params), {},
                            make_batch(tcfg, 16, 1, ctx=TCTX))
    assert np.isfinite(float(metrics["loss"]))
    assert tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                         "--seq", "16", "--batch", "1"]) == 0
    ring = TCtx(sp_size=4, device="cpu")
    ttfm.check_ring_supported(tcfg, ring, "serving")
    prompts = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 12), dtype=np.int32)
    streams = [TEngine(tcfg, tp, ctx, serve=TServe(max_seq=64, num_slots=2)).generate(prompts, 4)
               for ctx in (TCTX, ring)]
    assert np.array_equal(*streams)
    wire = TCtx(sp_size=4, device="cpu", mla_latent_wire=True)
    ttfm.check_ring_supported(tcfg, wire, "training")
    params = tree_map(torch.clone, tp)
    step = make_train_step(tcfg, wire, AdamWConfig())
    _, _, _, metrics = step(params, init_opt_state(params), {},
                            make_batch(tcfg, 16, 1, ctx=wire))
    assert np.isfinite(float(metrics["loss"])) and wire.ring.stats.bytes["recv_kv"] > 0


@pytest.mark.parametrize("arch", ["granite-8b", ARCH])
def test_spec_identical_over_int8_in_bf16_like_jax(arch):
    """ROADMAP C.8 on the CPU: ``launch.serve --check-spec-identical``'s
    check (the speculative run's streams equal a vanilla greedy replay of
    the same trace) in bf16 over an int8 pool with chunked prefill and
    spec_k 4, at the CLI's reduced settings, holds in JAX's engine and in
    the port's (whose plain versions run here) alike."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    trace = [(16, 0), (32, 1), (64, 2), (16, 4)]  # the CLI's default --trace
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32) for n, _ in trace]
    kw = dict(max_seq=128, num_slots=4, paged=True, page_size=4, kv_dtype="int8",
              prefill_chunk=16, tick_token_budget=32)
    streams = {}
    for side, make in (
        ("jax", lambda k: JEngine(jcfg, jp, JCtx(), serve=JServe(
            **kw, spec_k=k, cache_dtype=jnp.bfloat16))),
        ("port", lambda k: TEngine(tcfg, tp, TCTX, serve=TServe(
            **kw, spec_k=k, cache_dtype=torch.bfloat16))),
    ):
        for k in (4, 0):
            eng = make(k)
            rids = [eng.submit(p, 8, arrival_tick=t) for p, (_, t) in zip(prompts, trace)]
            done = eng.run()
            streams[side, k] = [done[r].generated for r in rids]
            if k:
                assert eng.verify_launches > 0
    assert streams["jax", 4] == streams["jax", 0]
    assert streams["port", 4] == streams["port", 0]
