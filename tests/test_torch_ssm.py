"""The port's SSM and hybrid serving path against the JAX package, on the CPU
(the SSD kernel's wrapper runs its plain version for CPU tensors), at
reduced sizes only.

  * the SSD chunked scan's plain version against JAX's Pallas kernel
    (``interpret=True``) and the sequential oracle ``ref.ssd_ref``, at the
    shapes and tolerances of ``tests/test_ssd_kernel.py``;
  * the SSM block, its decode step, forward, prefill + decode and the
    serving engine for mamba2-370m and hymba-1.5b reduced, fp32, with the
    JAX weights converted by ``params_from_jax``.

Inputs come from numpy seeds and reach both packages as the same arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_fwd as jssd_kernel
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Scheduler

ARCHS = ["mamba2-370m", "hymba-1.5b"]
JCTX = JCtx()
TCTX = TCtx(device="cpu")
# fp32 sums in another order in XLA and in PyTorch on the CPU
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4


def _ssd_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)  # softplus
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


# the shapes of tests/test_ssd_kernel.py
SSD_SHAPES = [
    (1, 32, 2, 8, 1, 16, 8),
    (2, 64, 4, 16, 2, 8, 16),
    (1, 48, 3, 8, 1, 8, 8),
    (1, 16, 2, 32, 2, 32, 16),
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_jax_kernel_and_oracle(B, S, H, P, G, N, chunk):
    arrays = _ssd_inputs(B * S + H, B, S, H, P, G, N)
    y, st = ssd_scan_fwd(*_t(*arrays), chunk=chunk)
    jy, jst = jssd_kernel(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    ry, rst = jref.ssd_ref(*map(jnp.asarray, arrays))
    for want_y, want_st in ((jy, jst), (ry, rst)):
        _close(y, want_y, 2e-4)
        _close(st, want_st, 2e-4)
    assert st.dtype == torch.float32 and y.dtype == torch.float32
    # the port's own sequential oracle is JAX's
    ty, tst = tref.ssd_ref(*_t(*arrays))
    _close(ty, ry, 2e-4)
    _close(tst, rst, 2e-4)


@pytest.mark.parametrize("chunk", [1, 16], ids=["recurrence", "one_block"])
def test_ssd_chunk_one_and_whole_sequence(chunk):
    """chunk 1 is the pure recurrence, chunk == S one quadratic block."""
    arrays = _ssd_inputs(3, 1, 16, 2, 8, 1, 8)
    y, st = ssd_scan_plain(*_t(*arrays), chunk=chunk)
    jy, jst = jssd_kernel(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    ry, rst = jref.ssd_ref(*map(jnp.asarray, arrays))
    for want_y, want_st in ((jy, jst), (ry, rst)):
        _close(y, want_y, 3e-4)
        _close(st, want_st, 3e-4)


def test_ssd_large_dt_stays_finite():
    """A chunk whose sum of dt*|A| passes ~88 (S=128, chunk 64, dt=3, A=-1).
    The JAX Pallas kernel returns NaN here: it masks the decay by
    multiplying exp(acum_t - acum_s), which is inf for a hidden pair, by 0.
    The port masks by selection, as ``models/ssm.py`` does, and agrees with
    the sequential oracle and with ``models/ssm.py::ssd_scan``."""
    rng = np.random.default_rng(11)
    B, S, H, P, N = 1, 128, 2, 8, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 3.0, np.float32)
    A = np.full((H,), -1.0, np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    y, st = ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    ry, rst = jref.ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    rep = lambda a: jnp.repeat(jnp.asarray(a), H, axis=2)  # noqa: E731
    my, mst = jssm.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), rep(Bm), rep(Cm), 64)
    for want_y, want_st in ((ry, rst), (my, mst)):
        _close(y, want_y, 2e-4)
        _close(st, want_st, 2e-4)
    # differentiable without NaN: no inf meets a zero in the backward either
    xt = torch.from_numpy(x).requires_grad_(True)
    yt, _ = ssd_scan_plain(xt, *_t(dt, A, Bm, Cm), chunk=64)
    yt.sum().backward()
    assert torch.isfinite(xt.grad).all()


def test_ssd_bf16_x_keeps_its_dtype():
    arrays = _ssd_inputs(0, 1, 32, 2, 8, 1, 8)
    x, rest = arrays[0], arrays[1:]
    y, st = ssd_scan_fwd(torch.from_numpy(x).to(torch.bfloat16), *_t(*rest), chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    ry, _ = jref.ssd_ref(*map(jnp.asarray, arrays))
    _close(y, ry, 5e-2)


# --------------------------------------------------------------------------
# the model: mamba2-370m and hymba-1.5b reduced, fp32
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    # nonzero A_log / dt_bias / D_skip, so the block's scalar parameters count
    rng = np.random.default_rng(1)
    jl = dict(jparams["layers"])
    jl["ssm"] = dict(jl["ssm"], **{
        name: jnp.asarray(rng.uniform(-0.5, 0.5, jl["ssm"][name].shape).astype(np.float32))
        for name in ("A_log", "dt_bias", "D_skip")
    })
    jparams = dict(jparams, layers=jl)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


def test_init_params_mirror_jax_pytree(model):
    jcfg, jp, tcfg, tp = model
    mine = ttfm.init_params(tcfg, seed=0, device="cpu")
    shapes = lambda tree: {  # noqa: E731
        k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}
    assert shapes(mine) == shapes(jax.tree.map(np.asarray, jp)) == shapes(tp)
    assert ("mlp" in mine["layers"]) == (tcfg.family == "hybrid")
    assert ("attn" in mine["layers"]) == (tcfg.family == "hybrid")


def test_ssm_block_and_decode_step_match_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    B, S = 2, 24  # 3 chunks of 8
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jlp, tlp = _layer(jp["layers"]["ssm"], 1), _layer(tp["layers"]["ssm"], 1)
    jy, jst = jssm.ssm_block(jnp.asarray(x), jlp, jcfg, JCTX, return_state=True)
    ty, tst = tssm.ssm_block(torch.from_numpy(x), tlp, tcfg, TCTX, return_state=True)
    _close(ty, jy, BLOCK_TOL)
    _close(tst["state"], jst["state"], BLOCK_TOL)
    _close(tst["conv"], jst["conv"], BLOCK_TOL)
    assert tst["state"].dtype == torch.float32
    xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jd, jnew = jssm.ssm_decode_step(jnp.asarray(xd), jlp, jst, jcfg)
    td, tnew = tssm.ssm_decode_step(torch.from_numpy(xd), tlp, tst, tcfg)
    _close(td, jd, BLOCK_TOL)
    _close(tnew["state"], jnew["state"], BLOCK_TOL)
    _close(tnew["conv"], jnew["conv"], BLOCK_TOL)


def test_forward_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    pos = np.arange(32, dtype=np.int32)
    jl, _ = jtfm.forward(jp, jcfg, JCTX,
                         {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)})
    with torch.no_grad():
        tl = ttfm.forward(tp, tcfg, TCTX, {"tokens": torch.from_numpy(tokens),
                                          "positions": torch.from_numpy(pos)})
    _close(tl, jl, LOGIT_TOL)


def _jax_prefill(jp, jcfg, tokens, cap):
    S = tokens.shape[1]
    jcache = jtfm.init_cache(jcfg, tokens.shape[0], cap, dtype=jnp.float32)
    batch = {"tokens": jnp.asarray(tokens), "positions": jnp.arange(S, dtype=jnp.int32)}
    return jtfm.prefill(jp, jcfg, JCTX, batch, jcache)


def test_prefill_and_decode_match_jax(model):
    jcfg, jp, tcfg, tp = model
    B, S, cap = 2, 16, 32
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = _jax_prefill(jp, jcfg, tokens, cap)
    tcache = ttfm.init_cache(tcfg, B, cap, dtype=torch.float32, ctx=TCTX)
    with torch.no_grad():
        tl, tcache = ttfm.prefill(tp, tcfg, TCTX, {"tokens": torch.from_numpy(tokens),
                                                  "positions": torch.arange(S)}, tcache)
    _close(tl, jl, LOGIT_TOL)
    _close(tcache["ssm"]["state"], jcache["ssm"]["state"], BLOCK_TOL)
    _close(tcache["ssm"]["conv"], jcache["ssm"]["conv"], BLOCK_TOL)
    assert ("k" in tcache) == ("k" in jcache)
    toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(4):
        nxt, jcache, jlg = jtfm.decode_step(jp, jcache, jnp.asarray(toks), jcfg, JCTX)
        with torch.no_grad():
            _, tcache, tlg = ttfm.decode_step(tp, tcache, torch.from_numpy(toks), tcfg, TCTX)
        _close(tlg, jlg, LOGIT_TOL)
        toks = np.asarray(nxt)
    _close(tcache["ssm"]["state"], jcache["ssm"]["state"], BLOCK_TOL)
    assert tcache["pos"].tolist() == [S + 4] * B


def test_decode_continues_from_a_jax_prefill(model):
    """Prefill in JAX, ``cache_from_jax``, then decode in the port on the
    same recurrent state (and, for hymba, the same K/V)."""
    jcfg, jp, tcfg, tp = model
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 24)).astype(np.int32)
    jl, jcache = _jax_prefill(jp, jcfg, tokens, 32)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(3):
        nxt, jcache, jlg = jtfm.decode_step(jp, jcache, jnp.asarray(toks), jcfg, JCTX)
        with torch.no_grad():
            tn, tcache, tlg = ttfm.decode_step(tp, tcache, torch.from_numpy(toks), tcfg, TCTX)
        _close(tlg, jlg, LOGIT_TOL)
        assert tn.tolist() == np.asarray(nxt).tolist()
        toks = np.asarray(nxt)


def test_unpadded_paths_refuse_ssm_archs(model):
    """The paged, packed, chunked and verify paths raise for SSM and hybrid
    archs, with JAX's messages."""
    _, _, tcfg, tp = model
    cache = ttfm.init_cache(tcfg, 2, 32, dtype=torch.float32, ctx=TCTX)
    row = {"tokens": torch.zeros((1, 8), dtype=torch.int32), "positions": torch.arange(8)}
    with pytest.raises(ValueError, match="paged cache serves attention-only"):
        ttfm.prefill(tp, tcfg, TCTX, {**row, "slot": 0}, {**cache, "bt": torch.zeros((2, 4))})
    packed = {**row, "segments": torch.zeros(8), "doc_lens": torch.tensor([8]),
              "slots": torch.tensor([0])}
    with pytest.raises(ValueError, match="packed prefill supports attention-only"):
        ttfm.prefill_packed(tp, tcfg, TCTX, packed, cache)
    chunk = {"tokens": torch.zeros((2, 4), dtype=torch.int32), "starts": torch.zeros(2),
             "lens": torch.ones(2), "write_starts": torch.zeros(2), "pos_set": -torch.ones(2)}
    with pytest.raises(ValueError, match="chunked prefill serves attention-only"):
        ttfm.prefill_chunk(tp, tcfg, TCTX, chunk, cache)
    with pytest.raises(ValueError, match="chunked prefill serves attention-only"):
        ttfm.verify_step(tp, tcfg, TCTX, chunk, cache)


# --------------------------------------------------------------------------
# the engine: exact mode
# --------------------------------------------------------------------------


def test_engine_streams_match_jax(model):
    """The trace of ``tests/test_serve.py::test_continuous_matches_sequential_hybrid``
    through both engines: identical greedy streams on the same ticks, and a
    12-token prompt refused at submit (12 > chunk 8, not a multiple)."""
    jcfg, jp, tcfg, tp = model
    kw = dict(max_seq=64, num_slots=2)
    jeng = JEngine(jcfg, jp, JCTX, serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (ln,), dtype=np.int32) for ln in (8, 16)]
    bad = rng.integers(0, jcfg.vocab_size, (12,), dtype=np.int32)
    results = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, max_new_tokens=4, arrival_tick=t) for p, t in zip(prompts, (0, 1))]
        with pytest.raises(ValueError):
            eng.submit(bad, 4)
        done = eng.run()
        results.append([done[r] for r in rids])
    for j, t in zip(*results):
        assert t.status == j.status == "ok"
        assert t.generated == j.generated
        assert t.token_ticks == j.token_ticks
    assert teng.prefill_launches == jeng.prefill_launches == 2
    assert teng.kv_cache_stats()["cache_bytes"] == jeng.kv_cache_stats()["cache_bytes"]


@pytest.mark.parametrize("length", [1, 2])
def test_engine_short_prompt_matches_no_cache_greedy(model, length):
    """A prompt shorter than the conv window (width - 1 = 3 rows): the
    port's greedy stream equals greedy decoding over JAX's own no-cache
    ``forward`` (the whole sequence each step).  The JAX engine keeps only
    the prompt's rows of the window and misplaces them at the front, so it
    departs from this oracle from the second token on and is no oracle here."""
    jcfg, jp, tcfg, tp = model
    new = 5
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (length,), dtype=np.int32)
    toks = prompt.tolist()
    for _ in range(new):
        logits, _ = jtfm.forward(jp, jcfg, JCTX, {
            "tokens": jnp.asarray([toks], jnp.int32),
            "positions": jnp.arange(len(toks), dtype=jnp.int32),
        })
        toks.append(int(jnp.argmax(logits[0, -1])))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2))
    rid = teng.submit(prompt, max_new_tokens=new)
    done = teng.run()
    assert done[rid].status == "ok"
    assert done[rid].generated == toks[length:]


@pytest.mark.parametrize("knob", [
    dict(paged=True, page_size=4), dict(prefill_chunk=8), dict(spec_k=4),
], ids=["paged", "prefill_chunk", "spec_k"])
def test_engine_refuses_unported_knobs_like_jax(model, knob):
    jcfg, jp, tcfg, tp = model
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, JCTX, serve=JServe(max_seq=64, num_slots=2, **knob))
    with pytest.raises(ValueError) as terr:
        TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2, **knob))
    assert str(terr.value) == str(jerr.value)


def test_scheduler_exact_mode():
    sch = Scheduler(2, (16, 32, 64), 64, exact=True, chunk=8)
    assert [sch.bucket_for(n) for n in (3, 8, 16, 40)] == [3, 8, 16, 40]
    with pytest.raises(ValueError, match="chunk"):
        sch.bucket_for(12)
    reqs = [sch.submit(np.zeros(n, np.int32), 2) for n in (8, 16)]
    assert sch.pack_groups(list(enumerate(reqs)), pack_max=4) == [[(0, reqs[0])], [(1, reqs[1])]]
    assert Scheduler(2, (16, 32, 64), 64).bucket_for(12) == 16


def test_launch_serve_cpu_tour_mamba2(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", "mamba2-370m", "--reduced", "--stream",
                       "--trace", "8:0,16:1,24:1,4:3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("status=ok") == 4 and '"prefill_launches": 4' in out
    for flags in (["--paged"], ["--prefill-chunk", "8"], ["--spec-k", "4"]):
        with pytest.raises(ValueError, match="attention-only"):
            serve.main(["--device", "cpu", "--arch", "mamba2-370m", "--reduced", "--stream",
                        *flags])
