"""Continuous prefill, speculative verify and the quantized pool in the port
against the JAX package, on the CPU (the kernels' plain versions): the model
functions ``prefill_chunk`` / ``verify_step``, the draft proposer, the chunk
and draft planners, and whole engine streams.  Weights are JAX's
``init_params`` converted with ``params_from_jax``; inputs come from numpy
with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve import kv_pool as jpool
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.speculative import propose_ngram as jpropose
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Scheduler as TScheduler
from repro_torch.serve.speculative import propose_ngram as tpropose
from test_torch_model import converted_weights
from test_torch_quant import dequant_close

ARCH = "granite-8b"
TCTX = TCtx(device="cpu")
# end-to-end logit ceiling of the quantized pool on the reduced config
# (dist_check quant_kv's): a greedy flip between two engines is allowed only
# where both score the two candidates within twice this
LOGIT_BOUND = 0.25


@pytest.fixture(scope="module")
def model():
    cfg = jget_config(ARCH).reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config(ARCH).reduced(), tp


@pytest.fixture(scope="module")
def qwen_model():
    """qwen2.5-32b reduced, with nonzero QKV biases."""
    return converted_weights("qwen2.5-32b")


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


CACHES = {"dense_fp": (False, "fp"), "paged_fp": (True, "fp"), "paged_int8": (True, "int8")}


@pytest.mark.parametrize("name", list(CACHES))
def test_prefill_chunk_and_verify_match_jax(model, name):
    """Two chunk launches (rows at different offsets, a pad-only row, a
    shared prefix skipped by write_starts) and a verify launch with drafts
    that are partly accepted: logits within 1e-4, y / commit / pos equal,
    pools equal (quantized: once dequantized, within one code step)."""
    paged, kv_dtype = CACHES[name]
    jcfg, jp, tcfg, tp = model
    B, cap = 3, 32
    if paged:
        layout = jpool.PagedLayout.for_engine(cap, 1, B, page_size=4)
        jc = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32, ctx=JCtx(), paged=layout,
                             kv_dtype=kv_dtype)
        bt = np.full((B, layout.max_pages), -1, np.int32)
        # row 2's first page is row 0's: a shared prefix it must not write
        bt[0, :6], bt[1, :3], bt[2, :2] = [3, 9, 0, 4, 11, 12], [5, 1, 7], [3, 2]
        jc["bt"] = jnp.asarray(bt)
    else:
        jc = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    rng = np.random.default_rng(31)
    toks = rng.integers(0, jcfg.vocab_size, (B, 8), dtype=np.int32)
    chunks = [
        dict(tokens=toks, starts=[0, 0, 0], lens=[8, 5, 0], write_starts=[0, 0, 0],
             pos_set=[-1, 5, -1]),
        dict(tokens=np.roll(toks, 1, axis=1), starts=[8, 0, 0], lens=[6, 0, 7],
             write_starts=[8, 0, 4 if paged else 0], pos_set=[14, -1, 7]),
    ]
    for ch in chunks:
        ch = {k: np.asarray(v, np.int32) for k, v in ch.items()}
        lj, jc = jtfm.prefill_chunk(jp, jcfg, JCtx(), _jx(ch), jc)
        lt, tc = ttfm.prefill_chunk(tp, tcfg, TCTX, _tx(ch), tc)
        live = ch["lens"] > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # verify: row 0 drafts JAX's own greedy continuation (accepted), row 1 a
    # random draft, row 2 a plain one-token tick
    vt = np.zeros((B, 4), np.int32)
    vt[:, 0] = rng.integers(0, jcfg.vocab_size, (B,))
    vt[1, 1:] = rng.integers(0, jcfg.vocab_size, (3,))
    vb = {"tokens": vt, "starts": np.asarray(jc["pos"]), "lens": np.array([4, 4, 1], np.int32),
          "write_starts": np.asarray(jc["pos"])}
    y0, _, _ = jtfm.verify_step(jp, jcfg, JCtx(), _jx(vb), jc)
    vt[0, 1:] = np.asarray(y0)[0, :3]
    yj, cj, jc, lj = jtfm.verify_step(jp, jcfg, JCtx(), _jx(vb), jc, return_logits=True)
    yt, ct, tc, lt = ttfm.verify_step(tp, tcfg, TCTX, _tx(vb), tc, return_logits=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(np.asarray(cj)[0]) >= 2 and int(np.asarray(cj)[2]) == 1
    if kv_dtype == "fp":
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5, rtol=0)
    else:
        dequant_close(tc, jc, kv_dtype)


NGRAM_CASES = {
    # name: (prompt, generated, k)
    "looping": ([5, 6, 7, 5, 6, 7, 5], [6], 4),
    "recency": ([1, 2, 3, 9, 1, 2, 4, 8], [1, 2], 3),
    "no_repeat": (list(range(20)), [], 4),
    "truncated": ([4, 4, 4, 2, 9], [4, 4], 6),
    "single_token": ([3], [], 2),
    "period_one": ([8] * 5, [], 3),
}


@pytest.mark.parametrize("case", list(NGRAM_CASES))
def test_propose_ngram_matches_jax(case):
    prompt, generated, k = NGRAM_CASES[case]
    for max_ngram in (1, 2, 3):
        want = jpropose(prompt, generated, k, max_ngram=max_ngram)
        assert tpropose(prompt, generated, k, max_ngram=max_ngram) == want
    assert tpropose(prompt, generated, 0) == []


def test_plan_chunks_and_plan_spec_match_jax():
    """The same queue through both schedulers: chunk plans under the budget
    (head of line always granted) and the granted drafts from the leftover."""
    rng = np.random.default_rng(32)
    lens = [40, 9, 23, 3, 17]
    plans = {}
    for side, S in (("jax", JScheduler), ("torch", TScheduler)):
        sch = S(4, (16, 32, 64), 64, prefill_chunk=8, tick_token_budget=20)
        for i, n in enumerate(lens):
            sch.submit(np.arange(n, dtype=np.int32), 8, arrival_tick=i // 2)
        seen = []
        for tick in range(6):
            sch.admit(tick)
            decodable = [s for s, r in enumerate(sch.slots)
                         if r is not None and r.prefill_pos >= r.ingest_len]
            plan = sch.plan_chunks(len(decodable))
            seen.append([(slot, r.rid, start, take) for slot, r, start, take in plan])
            for _, r, start, take in plan:
                r.prefill_pos = start + take
            chunk_tokens = sum(take for *_, take in plan)
            drafts = {s: [int(x) for x in rng.integers(0, 9, (3,))] for s in decodable}
            seen.append(sch.plan_spec(drafts, len(decodable), chunk_tokens))
        plans[side] = seen
        rng = np.random.default_rng(32)
    assert plans["torch"] == plans["jax"]
    assert any(p for p in plans["jax"][1::2])  # some drafts were granted


def _prompts(vocab):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, (16,), dtype=np.int32)
    return [
        np.tile(np.array([7, 11, 13, 7], np.int32), 6),  # repetitive: drafts get accepted
        rng.integers(0, vocab, (21,), dtype=np.int32),  # random: rejections, rollback
        np.concatenate([prefix, np.full((8,), 5, np.int32)]),  # a shared-prefix pair
        np.concatenate([prefix, np.full((8,), 9, np.int32)]),
    ]


ARRIVALS = [0, 1, 2, 2]
NEW_TOKENS = 12
CHUNK = dict(prefill_chunk=8, tick_token_budget=16)
PAGED = dict(paged=True, page_size=4)
MODES = {
    "chunk_dense": dict(**CHUNK),
    "chunk_paged_shared_prefix": dict(**PAGED, **CHUNK),
    "spec_dense": dict(spec_k=4),
    "spec_paged": dict(**PAGED, spec_k=4),
    "int8_paged_chunk_spec": dict(**PAGED, **CHUNK, spec_k=4, kv_dtype="int8"),
    "fp8_paged_chunk_spec": dict(**PAGED, **CHUNK, spec_k=4, kv_dtype="fp8"),
}


def _serve(engine, prompts):
    engine.capture_logits = True
    rids = [engine.submit(p, NEW_TOKENS, arrival_tick=t) for p, t in zip(prompts, ARRIVALS)]
    done = engine.run()
    return [done[r] for r in rids], [engine.debug_logits[r] for r in rids]


def _counters(eng):
    return (eng.chunk_launches, eng.verify_launches, eng.spec_proposed, eng.spec_accepted)


# qwen2.5-32b (QKV bias): chunked prefill + speculative verify over int8
QWEN_MODES = {"qwen2.5-32b_int8_paged_chunk_spec": MODES["int8_paged_chunk_spec"]}


@pytest.mark.parametrize("mode", list(MODES) + list(QWEN_MODES))
def test_engine_streams_match_jax(request, mode):
    """The port's engine against JAX's on one trace (prefix sharing,
    continuous prefill, speculative verify, quantized pools): generated
    tokens, their ticks and the chunk / verify / draft counters equal, and
    pages and scale entries drain to 0.  For the quantized pools both sides
    quantize K/V computed in another order, so a code may differ by one
    step; a differing token is then allowed only as JAX's dist_check
    quant_kv allows it -- both engines score the two candidates within 2x
    the logit bound -- and the streams are compared no further."""
    jcfg, jp, tcfg, tp = request.getfixturevalue("qwen_model" if mode in QWEN_MODES else "model")
    kw = dict(max_seq=48, num_slots=3, **{**MODES, **QWEN_MODES}[mode])
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    want, want_logits = _serve(jeng, prompts)
    got, got_logits = _serve(teng, prompts)
    flipped = False
    for g, w, gl, wl in zip(got, want, got_logits, want_logits):
        assert g.status == w.status == "ok"
        if g.generated == w.generated:
            assert g.token_ticks == w.token_ticks and g.chunks == w.chunks
            continue
        assert "kv_dtype" in kw, (mode, g.generated, w.generated)
        i = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
        a, b = w.generated[i], g.generated[i]  # JAX's choice, the port's
        assert wl[i][a] - wl[i][b] <= 2 * LOGIT_BOUND and gl[i][b] - gl[i][a] <= 2 * LOGIT_BOUND
        flipped = True
    if not flipped:
        assert _counters(teng) == _counters(jeng)
        assert teng.tick_stats()["decode_tokens"] == jeng.tick_stats()["decode_tokens"]
    if "prefill_chunk" in kw:
        assert teng.chunk_launches > 0
    if "spec_k" in kw:
        assert teng.verify_launches > 0 and teng.spec_accepted > 0
    if kw.get("paged"):
        kv = teng.kv_cache_stats()
        assert kv["pages_in_use"] == kv["scale_entries_in_use"] == 0
        assert jeng.kv_cache_stats()["pages_in_use"] == 0
        teng.health()
        if "prefill_chunk" in kw:
            assert kv["shared_hits"] > 0
        if "kv_dtype" in kw:
            assert kv["quantized_pages"] == 0 and kv["dequant_fallbacks"] == 0
            assert kv["scale_table_bytes"] > 0


@pytest.mark.parametrize("pool", [dict(), dict(**PAGED), dict(**PAGED, kv_dtype="int8")],
                         ids=["dense", "paged", "int8"])
def test_speculation_changes_no_tokens(model, pool):
    """Speculative decode commits exactly the tokens of plain greedy decode
    in the port, token for token, in fewer decode launches."""
    _, _, tcfg, tp = model
    prompts = _prompts(tcfg.vocab_size)
    base = dict(max_seq=48, num_slots=3, **pool)
    vanilla_eng = TEngine(tcfg, tp, TCTX, serve=TServe(**base))
    vanilla, _ = _serve(vanilla_eng, prompts)
    spec_eng = TEngine(tcfg, tp, TCTX, serve=TServe(spec_k=4, spec_max_misses=None, **base))
    spec, _ = _serve(spec_eng, prompts)
    assert [r.generated for r in spec] == [r.generated for r in vanilla]
    assert spec_eng.spec_accepted > 0
    assert spec_eng.decode_launches + spec_eng.verify_launches < vanilla_eng.decode_launches
    if pool:
        assert spec_eng.kv_cache_stats()["spec_rolled_back_pages"] > 0


def test_launch_serve_runs_the_new_flags(capsys):
    """The CLI serves a quantized pool with continuous prefill and
    speculation, and --check-spec-identical holds against a plain replay."""
    from repro_torch.launch import serve

    assert serve.main([
        "--device", "cpu", "--reduced", "--stream", "--paged", "--page-size", "4",
        "--kv-dtype", "int8", "--prefill-chunk", "8", "--tick-token-budget", "16",
        "--spec-k", "4", "--check-spec-identical", "--trace", "12:0,20:1",
        "--new-tokens", "5", "--max-seq", "64",
    ]) == 0
    out = capsys.readouterr().out
    assert "streams match vanilla greedy" in out and '"chunk_launches"' in out
    assert '"scale_entries_in_use": 0.0' in out
