"""pixtral-12b in the port against the JAX package, on the CPU, fp32.

Both sides run JAX's reduced config (2 layers, d_model 128, 4 / 2 heads of
32, 8 patches of 16 features) from JAX's ``init_params`` converted by
``params_from_jax``.  Positions below ``num_patches`` take the projected
patch embeddings, so every row here runs past them: a prompt no longer
than the patches carries no text at all (the engine feeds zero patches, as
JAX's does).  Checked: ``_merge_patches`` (also in a permuted order),
forward logits within 2e-4, ``loss_fn``'s gradients within 5e-5 of each
leaf's largest (the frontend's projection included), prefill then
teacher-forced ``decode_step`` at JAX's ``tests/test_archs.py`` tolerances
(2e-4 / 3e-4) over the dense cache and over a paged pool, the engine's
streams against JAX's engine over the dense cache, the paged pool and an
int8 pool (``tests/test_torch_continuous.py``'s rule there: a flip only on
a near-tie), three ``fit`` steps, and JAX's refusals: chunked prefill,
speculation, packing and a ring.  Inputs come from numpy with fixed seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_continuous as tcont
import test_torch_train as ttrain
from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kv_pool import PagedLayout as JLayout
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.kv_pool import PagedLayout as TLayout
from repro_torch.train import loop as tloop

ARCH = "pixtral-12b"
JCTX = JCtx()
TCTX = TCtx(device="cpu")
LOGIT_TOL = 2e-4  # forward and prefill logits (test_archs.py's prefill limit)
DECODE_TOL = 3e-4  # teacher-forced decode logits (test_archs.py's)
GRAD_REL = 5e-5  # each gradient leaf, of the leaf's largest |g|


@functools.lru_cache(maxsize=None)
def _converted():
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _converted()


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "positions": np.arange(S, dtype=np.int32),
            "patches": rng.standard_normal((B, cfg.num_patches, cfg.frontend_dim))
            .astype(np.float32)}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_config_is_jaxs_pixtral():
    jcfg, tcfg = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.hd) == (
        40, 5120, 32, 8, 128)
    assert (tcfg.d_ff, tcfg.vocab_size, tcfg.rope_theta) == (14336, 131072, 1e6)
    assert (tcfg.frontend, tcfg.num_patches, tcfg.frontend_dim) == ("vision_stub", 1024, 1024)
    assert tcfg.family == "vlm" and tcfg.mlp_gated and tcfg.norm == "rmsnorm"


def test_merge_patches_matches_jax(model):
    """Positions below num_patches take the patch embedding at their true
    position, in any order (a permuted row too); the rest keep the token's."""
    jcfg, jp, _, tp = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    patches = rng.standard_normal((2, jcfg.num_patches, jcfg.frontend_dim)).astype(np.float32)
    for positions in (np.arange(16), rng.permutation(16)):
        positions = positions.astype(np.int32)
        got = ttfm._merge_patches(torch.from_numpy(x), tp, torch.from_numpy(positions),
                                  torch.from_numpy(patches), jcfg.num_patches)
        want = jtfm._merge_patches(jnp.asarray(x), jp, jnp.asarray(positions),
                                   jnp.asarray(patches), jcfg.num_patches)
        _close(got, want, 1e-5)
        keep = positions >= jcfg.num_patches
        np.testing.assert_array_equal(got.numpy()[:, keep], x[:, keep])


def test_forward_logits_match_jax(model):
    jcfg, jp, tcfg, tp = model
    batch = _batch(jcfg, 2, 24, 0)
    jl, _ = jtfm.forward(jp, jcfg, JCTX, _jx(batch))
    _close(ttfm.forward(tp, tcfg, TCTX, _tx(batch)), jl, LOGIT_TOL)


def test_loss_and_grads_match_jax(model):
    """loss_fn and its gradients against jax.value_and_grad, the frontend's
    projection included; remat on and off bitwise equal."""
    jcfg, jp, tcfg, _ = model
    batch = _batch(jcfg, 2, 24, 3)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCTX, _jx(batch)), has_aux=True)(jp)
    results = {}
    for remat in (True, False):
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        results[remat] = ttrain._port_loss_and_grads(
            tp, tcfg, dataclasses.replace(TCTX, remat=remat), _tx(batch))
    loss, _, grads = results[True]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    jg = ttrain._jax_leaves(jgrads)
    assert sorted(jg) == sorted(grads)
    assert float(np.abs(jg["frontend/proj"]).max()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=0, err_msg=name,
                                   atol=GRAD_REL * float(np.abs(jg[name]).max()))
    loss_nr, _, grads_nr = results[False]
    assert torch.equal(loss, loss_nr)
    for name in grads:
        assert torch.equal(grads[name], grads_nr[name]), name


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_and_decode_match_jax(model, paged):
    """Prefill the first 12 tokens of two rows (past the 8 patches), then
    teacher-forced decode over four more, against JAX's forward over the
    whole rows (test_archs.py's check); the paged pool one row a call
    through a shuffled block table."""
    jcfg, jp, tcfg, tp = model
    B, S, S0, cap = 2, 24, 12, 32
    batch = _batch(jcfg, B, S, 4)
    full = np.asarray(jtfm.forward(jp, jcfg, JCTX, _jx(batch))[0])
    if paged:
        layout = dict(num_pages=20, page_size=4, max_pages=8, n=1)
        bt = np.full((B, 8), -1, np.int32)
        bt[0, :5], bt[1, :5] = [7, 2, 11, 0, 4], [5, 19, 3, 8, 13]
        tcache = ttfm.init_cache(tcfg, B, cap, dtype=torch.float32, ctx=TCTX,
                                 paged=TLayout(**layout))
        tcache["bt"] = torch.from_numpy(bt)
        jcache = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32, paged=JLayout(**layout))
        jcache["bt"] = jnp.asarray(bt)
        for b in range(B):
            pre = {"tokens": batch["tokens"][b : b + 1, :S0],
                   "positions": batch["positions"][:S0],
                   "patches": batch["patches"][b : b + 1], "length": np.array([S0], np.int32)}
            tl, tcache = ttfm.prefill(tp, tcfg, TCTX, {**_tx(pre), "slot": b, "shared_len": 0},
                                      tcache)
            jl, jcache = jtfm.prefill(jp, jcfg, JCTX, {**_jx(pre), "slot": jnp.int32(b),
                                                       "shared_len": jnp.int32(0)}, jcache)
            _close(tl[0, 0], full[b, S0 - 1], LOGIT_TOL)
            _close(tl, jl, LOGIT_TOL)
    else:
        pre = {"tokens": batch["tokens"][:, :S0], "positions": batch["positions"][:S0],
               "patches": batch["patches"]}
        tcache = ttfm.init_cache(tcfg, B, cap, dtype=torch.float32, ctx=TCTX)
        jcache = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32)
        tl, tcache = ttfm.prefill(tp, tcfg, TCTX, _tx(pre), tcache)
        jl, jcache = jtfm.prefill(jp, jcfg, JCTX, _jx(pre), jcache)
        _close(tl[:, 0], full[:, S0 - 1], LOGIT_TOL)
        _close(tl, jl, LOGIT_TOL)
    _close(tcache["k"], jcache["k"], 1e-5)
    for t in range(S0, S0 + 4):
        tok = batch["tokens"][:, t : t + 1]
        _, tcache, lg = ttfm.decode_step(tp, tcache, torch.from_numpy(tok), tcfg, TCTX)
        _, jcache, jlg = jtfm.decode_step(jp, jcache, jnp.asarray(tok), jcfg, JCTX)
        _close(lg[:, 0], full[:, t], DECODE_TOL)
        _close(lg, jlg, DECODE_TOL)


# (prompt length, arrival tick): all but the first run past the 8 patches
TRACE = [(6, 0), (19, 0), (12, 1), (30, 3)]
NEW_TOKENS = 6
ENGINE_CACHES = {
    "dense": dict(paged=False),
    "paged": dict(paged=True, page_size=4),
    "paged_int8": dict(paged=True, page_size=4, kv_dtype="int8"),
}


@pytest.mark.parametrize("cache", list(ENGINE_CACHES))
def test_engine_streams_match_jax(model, cache):
    """The engine (zero patches, each prompt alone in its bucket) against
    JAX's: the fp caches give identical streams and ticks; the int8 pool
    too, or a flip where both engines score the two candidates within
    twice the quantized pool's logit bound."""
    jcfg, jp, tcfg, tp = model
    kw = dict(max_seq=64, num_slots=3, **ENGINE_CACHES[cache])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32) for n, _ in TRACE]

    def replay(eng):
        eng.capture_logits = True
        rids = [eng.submit(p, NEW_TOKENS, arrival_tick=t) for p, (_, t) in zip(prompts, TRACE)]
        done = eng.run()
        return [done[r] for r in rids], [eng.debug_logits[r] for r in rids]

    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    (want, wl), (got, gl) = replay(jeng), replay(teng)
    for g, w, gli, wli in zip(got, want, gl, wl):
        assert g.status == w.status == "ok"
        if g.generated != w.generated and "kv_dtype" in kw:
            i = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
            a, b = w.generated[i], g.generated[i]
            assert wli[i][a] - wli[i][b] <= 2 * tcont.LOGIT_BOUND
            assert gli[i][b] - gli[i][a] <= 2 * tcont.LOGIT_BOUND
        else:
            assert g.generated == w.generated and g.token_ticks == w.token_ticks
    assert teng.prefill_launches == jeng.prefill_launches == len(TRACE)  # nothing packs
    # the first prompt lies inside the patches: it carries no text
    np.testing.assert_allclose(gl[0][0], _text_free_logits(tcfg, tp), atol=1e-5)
    if kw["paged"]:
        kv = teng.kv_cache_stats()
        assert kv["pages_in_use"] == 0 and jeng.kv_cache_stats()["pages_in_use"] == 0


def _text_free_logits(tcfg, tp):
    """First-token logits of a prompt of 6 random tokens that lies inside the
    patches: with zero patches it is the logits of six zero embeddings."""
    rng = np.random.default_rng(9)
    eng = TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=1))
    eng.capture_logits = True
    rid = eng.submit(rng.integers(0, tcfg.vocab_size, (6,), dtype=np.int32), 1)
    eng.run()
    return eng.debug_logits[rid][0]


def test_three_fit_steps():
    """Three steps of the port's fit: its batches carry the pipeline's
    patches, the loss starts near ln(vocab), and the projection moves."""
    tcfg = tget_config(ARCH).reduced()
    before = ttfm.init_params(tcfg, seed=0, device="cpu")["frontend"]["proj"]
    out = tloop.fit(tcfg, TCTX, tloop.TrainConfig(steps=3, seq=16, batch=2))
    losses = out["history"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(tcfg.vocab_size)) < 1.0
    assert not torch.equal(out["params"]["frontend"]["proj"], before)


def test_refusals_match_jax(model):
    """JAX's refusals for a frontend arch: chunked prefill and speculation
    at the engine, packed and chunked prefill in the model, and a ring.
    The paged pool serves it."""
    jcfg, jp, tcfg, tp = model
    for kw, what in ((dict(prefill_chunk=8), "continuous prefill"),
                     (dict(spec_k=4), "speculative decode")):
        with pytest.raises(ValueError, match=what):
            JEngine(jcfg, jp, JCtx(), serve=JServe(max_seq=64, num_slots=2, **kw))
        with pytest.raises(ValueError, match=what):
            TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2, **kw))
    eng = TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2, paged=True,
                                               page_size=4))
    assert not eng._can_pack and eng.paged
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
