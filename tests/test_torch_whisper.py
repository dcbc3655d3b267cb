"""whisper-base in the port against the JAX package, on the CPU, fp32.

Both sides run JAX's reduced config (2 encoder + 2 decoder layers, d_model
128, 4 / 2 heads of 32, encoder_seq 32, 16-d frames) from JAX's
``init_params`` converted by ``params_from_jax``.  LayerNorm starts at gain
1 and bias 0, so the gains and biases are drawn away from it here (a zero
bias would let a missing one pass).  Per module: ``layer_norm``, the
ungated MLP and ``cross_attention_block``; the kernels' plain versions on
the encoder's non-causal band and the cross-attention's rectangular band
(a ragged Sq among them), forward and backward, against JAX's Pallas
kernels in interpret mode (``tests/test_torch_kernels.py``'s tolerances).
The model: forward logits within 2e-4, ``loss_fn``'s gradients within 5e-5
of each leaf's largest, prefill then teacher-forced ``decode_step`` at
JAX's ``tests/test_archs.py`` tolerances (2e-4 / 3e-4; the cache also
carried over from JAX's prefill by ``cache_from_jax``), the engine's
streams equal to JAX's engine (dense cache: whisper has no paged one),
three ``fit`` steps; and JAX's
refusals: chunked prefill, speculation, packing, the paged pool, a ring.
Inputs come from numpy with fixed seeds.
"""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
from repro.configs import get_config as jget_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import loop as tloop

ARCH = "whisper-base"
JCTX = JCtx()
TCTX = TCtx(device="cpu")
LOGIT_TOL = 2e-4  # forward and prefill logits (test_archs.py's prefill limit)
DECODE_TOL = 3e-4  # teacher-forced decode logits (test_archs.py's)
GRAD_REL = 5e-5  # each gradient leaf, of the leaf's largest |g|
MODULE_TOL = 1e-5  # one module's output
FWD_TOL, BWD_TOL = 2e-5, 2e-4  # tests/test_torch_kernels.py's
INF = jref.BAND_INF


def _perturb_norms(tree, rng):
    """Every LayerNorm gain and bias drawn away from its init (1, 0)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb_norms(val, rng)
        elif key.endswith("ln") or key.endswith("ln_b"):
            out[key] = val + jnp.asarray(0.2 * rng.standard_normal(val.shape), val.dtype)
        else:
            out[key] = val
    return out


@functools.lru_cache(maxsize=None)
def _converted():
    """(jcfg, JAX params, tcfg, the port's params) of the reduced config."""
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = _perturb_norms(jtfm.init_params(jcfg, jax.random.PRNGKey(0)),
                             np.random.default_rng(11))
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _converted()


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


def test_config_is_jaxs_whisper():
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_layers, tcfg.encoder_layers, tcfg.encoder_seq) == (6, 6, 1536)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.hd) == (512, 8, 8, 64)
    assert (tcfg.d_ff, tcfg.vocab_size, tcfg.frontend_dim) == (2048, 51865, 80)
    assert tcfg.norm == "layernorm" and not tcfg.mlp_gated and tcfg.mlp_act == "gelu"
    assert tcfg.tie_embeddings and tcfg.frontend == "audio_stub" and tcfg.family == "audio"


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = (3.0 + rng.standard_normal((2, 6, 64))).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    _close(tlayers.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jlayers.layer_norm(*map(jnp.asarray, (x, w, b))), MODULE_TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tlayers.layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b))
    want = jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_ungated_mlp_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    assert "w3" not in jp["layers"]["mlp"] and "w3" not in tp["layers"]["mlp"]
    x = np.random.default_rng(6).standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    _close(tmlp.mlp_block(torch.from_numpy(x), _layer(tp["layers"]["mlp"]), tcfg),
           jmlp.mlp_block(jnp.asarray(x), _layer(jp["layers"]["mlp"]), jcfg, JCTX), MODULE_TOL)


def test_cross_attention_block_matches_jax(model):
    """Decoder rows (7) against encoder rows (32): a rectangular full band."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    got = tattn.cross_attention_block(torch.from_numpy(x), torch.from_numpy(enc),
                                      _layer(tp["layers"]["xattn"]), tcfg, TCTX)
    want = jattn.cross_attention_block(jnp.asarray(x), jnp.asarray(enc),
                                       _layer(jp["layers"]["xattn"]), jcfg, JCTX)
    _close(got, want, MODULE_TOL)


def test_params_carry_the_encoder_and_frontend(model):
    """params_from_jax carries the encoder, cross-attention and frontend
    subtrees across leaf for leaf; init_params builds the same pytree."""
    jcfg, jp, tcfg, tp = model
    jleaves = {tuple(e.key for e in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {"encoder", "frontend", "final_ln_b"} <= set(tp) and "xattn" in tp["layers"]
    assert len(jleaves) == len(list(tadamw.tree_leaves(tp)))
    for path, leaf in jleaves.items():
        got = tp
        for key in path:
            got = got[key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    mine = ttfm.init_params(tcfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
    assert torch.all(mine["encoder"]["final_ln"] == 1) and torch.all(mine["final_ln_b"] == 0)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "positions": np.arange(S, dtype=np.int32), "frames": _frames(cfg, B, seed + 1)}


def test_forward_logits_match_jax(model):
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 2, 24, 0)
    jl, _ = jtfm.forward(jp, jcfg, JCTX, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = ttfm.forward(tp, tcfg, TCTX, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, LOGIT_TOL)


def test_loss_and_grads_match_jax(model):
    """loss_fn and its gradients (the encoder's, the frontend's and the
    cross-attention's included) against jax.value_and_grad; remat on and off
    bitwise equal."""
    jcfg, jp, tcfg, _ = model
    batch = _batch(jcfg, 2, 24, 3)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCTX, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    results = {}
    for remat in (True, False):
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        ctx = dataclasses.replace(TCTX, remat=remat)
        results[remat] = ttrain._port_loss_and_grads(
            tp, tcfg, ctx, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss, _, grads = results[True]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    jg = ttrain._jax_leaves(jgrads)
    assert sorted(jg) == sorted(grads) and any(n.startswith("encoder/") for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=0, err_msg=name,
                                   atol=GRAD_REL * float(np.abs(jg[name]).max()))
    loss_nr, _, grads_nr = results[False]
    assert torch.equal(loss, loss_nr)
    for name in grads:
        assert torch.equal(grads[name], grads_nr[name]), name


def test_prefill_and_decode_match_jax(model):
    """Prefill half of a row, then teacher-forced decode over four more
    tokens, against JAX's forward over the whole row (test_archs.py's
    check), and from JAX's prefilled cache carried over by cache_from_jax."""
    jcfg, jp, tcfg, tp = model
    B, S, S0, cap = 2, 24, 12, 32
    batch = _batch(jcfg, B, S, 4)
    full, _ = jtfm.forward(jp, jcfg, JCTX, {k: jnp.asarray(v) for k, v in batch.items()})
    full = np.asarray(full)
    pre = {"tokens": batch["tokens"][:, :S0], "positions": batch["positions"][:S0],
           "frames": batch["frames"]}
    jcache = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32)
    jl, jcache = jtfm.prefill(jp, jcfg, JCTX, {k: jnp.asarray(v) for k, v in pre.items()},
                              jcache)
    tcache = ttfm.init_cache(tcfg, B, cap, dtype=torch.float32, ctx=TCTX)
    assert tcache["cross_k"].shape == (2, B, jcfg.encoder_seq, jcfg.num_heads, jcfg.hd)
    tl, tcache = ttfm.prefill(tp, tcfg, TCTX, {k: torch.from_numpy(v) for k, v in pre.items()},
                              tcache)
    _close(tl[:, 0], full[:, S0 - 1], LOGIT_TOL)
    _close(tl, jl, LOGIT_TOL)
    for key in ("k", "v"):
        _close(tcache[key][:, :, :S0], jcache[key][:, :, :S0], MODULE_TOL)
    for key in ("cross_k", "cross_v"):
        _close(tcache[key], jcache[key], MODULE_TOL)
    carried = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    assert sorted(carried) == sorted(tcache)
    for t in range(S0, S0 + 4):
        tok = torch.from_numpy(batch["tokens"][:, t : t + 1])
        _, tcache, lg = ttfm.decode_step(tp, tcache, tok, tcfg, TCTX)
        _, carried, lg_carried = ttfm.decode_step(tp, carried, tok, tcfg, TCTX)
        _close(lg[:, 0], full[:, t], DECODE_TOL)
        _close(lg_carried[:, 0], full[:, t], DECODE_TOL)
    assert tcache["pos"].tolist() == [S0 + 4] * B


# (prompt length, arrival tick) and new tokens of the engine trace
TRACE = [(5, 0), (19, 0), (11, 1), (30, 3)]
NEW_TOKENS = 6


def test_engine_streams_match_jax(model):
    """The engine over the dense cache (zero frames, the encoder once per
    admission, cross-attention decode over the slot's rows) against JAX's:
    identical streams and ticks."""
    jcfg, jp, tcfg, tp = model
    kw = dict(max_seq=64, num_slots=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32) for n, _ in TRACE]

    def replay(eng):
        rids = [eng.submit(p, NEW_TOKENS, arrival_tick=t) for p, (_, t) in zip(prompts, TRACE)]
        done = eng.run()
        return [done[r] for r in rids]

    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    want, got = replay(jeng), replay(teng)
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.generated == w.generated and g.token_ticks == w.token_ticks
    assert teng.prefill_launches == jeng.prefill_launches == len(TRACE)  # nothing packs
    # the encoder's K/V of the last admission in each slot are nonzero
    assert float(teng._cache["cross_k"].abs().sum()) > 0


def test_three_fit_steps():
    """Three steps of the port's fit: its batches carry the pipeline's
    frames, the loss starts near ln(vocab), and the weights move."""
    tcfg = tget_config(ARCH).reduced()
    before = ttfm.init_params(tcfg, seed=0, device="cpu")
    out = tloop.fit(tcfg, TCTX, tloop.TrainConfig(steps=3, seq=16, batch=2))
    losses = out["history"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(tcfg.vocab_size)) < 1.0
    for group in (("frontend", "proj"), ("encoder", "final_ln_b")):
        assert not torch.equal(out["params"][group[0]][group[1]], before[group[0]][group[1]])


def test_refusals_match_jax(model):
    """JAX's refusals: chunked prefill, speculation and the paged pool at
    the engine, packed and chunked prefill in the model, and a ring."""
    jcfg, jp, tcfg, tp = model
    for kw, what in ((dict(prefill_chunk=8), "continuous prefill"),
                     (dict(spec_k=4), "speculative decode"),
                     (dict(paged=True, page_size=4), "paged KV cache")):
        with pytest.raises(ValueError, match=what):
            JEngine(jcfg, jp, JCtx(), serve=JServe(max_seq=64, num_slots=2, **kw))
        with pytest.raises(ValueError, match=what):
            TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2, **kw))
    assert not TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2))._can_pack
    cache = ttfm.init_cache(tcfg, 2, 32, dtype=torch.float32, ctx=TCTX)
    packed = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
              "positions": torch.arange(8), "segments": torch.zeros(8, dtype=torch.int32),
              "doc_lens": torch.tensor([8]), "slots": torch.tensor([0])}
    with pytest.raises(ValueError, match="packed prefill"):
        ttfm.prefill_packed(tp, tcfg, TCTX, packed, cache)
    chunk = {"tokens": torch.zeros((2, 4), dtype=torch.int32), "starts": [0, 0],
             "lens": [4, 0], "write_starts": [0, 0], "pos_set": [4, -1]}
    with pytest.raises(ValueError, match="chunked prefill"):
        ttfm.prefill_chunk(tp, tcfg, TCTX, chunk, cache)
    ring = TCtx(sp_size=4, device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        TEngine(tcfg, tp, ring, serve=TServe(max_seq=64, num_slots=2))
    with pytest.raises(NotImplementedError, match="A.9"):
        tloop.make_train_step(tcfg, ring, tadamw.AdamWConfig())


# the encoder's and the cross-attention's bands: name -> (B, Sq, Skv, H, Hkv)
BAND_CASES = {
    "encoder_square_gqa": (1, 64, 64, 4, 2),
    "encoder_square_mha": (2, 64, 64, 4, 4),
    "cross_rect": (2, 24, 64, 4, 4),
    "cross_rect_ragged": (1, 20, 64, 4, 4),
    "cross_decode_rows": (3, 1, 64, 4, 4),
}


def _band_inputs(name, grad):
    B, Sq, Skv, H, Hkv = BAND_CASES[name]
    D = 32
    rng = np.random.default_rng(zlib.crc32(f"{name}{grad}".encode()))
    shapes = [(B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)] + [(B, Sq, H, D)] * grad
    return D, [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", list(BAND_CASES))
def test_flash_fwd_plain_full_band_matches_pallas(name):
    """The forward's plain version (and the wrapper on CPU tensors) over a
    full band, square and rectangular, against JAX's Pallas forward."""
    D, (q, k, v) = _band_inputs(name, False)
    band = (0, 0, -INF, INF)
    o_t, lse_t = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), band,
                                         scale=D**-0.5)
    o_p, lse_p = jfa.flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                         jnp.asarray(band, jnp.int32), scale=D**-0.5,
                                         block_q=32, block_kv=32, interpret=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_p), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("name", ["encoder_square_gqa", "cross_rect_ragged"])
def test_flash_bwd_plain_full_band_matches_pallas(name):
    """The backward's plain version (and the wrapper on CPU tensors) over a
    full band, square and rectangular (a ragged Sq), against JAX's Pallas
    backward in interpret mode; and through ops.flash_attention's autograd
    (causal=False) against jax.grad of JAX's op."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    D, (q, k, v, do) = _band_inputs(name, True)
    band = (0, 0, -INF, INF)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    oj, lsej = jref.attention_ref(qj, kj, vj, scale=D**-0.5, band=band)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    ot, lset = torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lsej))
    plain = tref.attention_bwd_ref(qt, kt, vt, ot, lset, dot, scale=D**-0.5, band=band)
    wrapped = tfa.flash_attention_bwd(qt, kt, vt, ot, lset, dot, band, scale=D**-0.5)
    pallas = jfa.flash_attention_bwd(qj, kj, vj, oj, lsej, doj, jnp.asarray(band, jnp.int32),
                                     scale=D**-0.5, block_q=32, block_kv=32, interpret=True)
    for g, w, p in zip(plain, wrapped, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=BWD_TOL, rtol=BWD_TOL)
        assert torch.equal(g, w)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jops.flash_attention(a, b, c, causal=False) * doj),
                      argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = tops.flash_attention(*leaves, causal=False)
    tgrads = torch.autograd.grad(out, leaves, dot)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL, rtol=BWD_TOL)
