"""The port's ServeEngine (on the CPU, plain versions of the kernels) against
the JAX ServeEngine on the same converted weights: greedy token streams must
be identical, over the dense and the paged cache, with packed and unpacked
prefill, and the paged pool must drain to zero pages.  Plus the engine
surface the port keeps (cancel, deadlines, NaN guard, stats, config checks).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine

ARCH = "granite-8b"
TCTX = TCtx(device="cpu")
# (prompt length, arrival tick): same-tick arrivals pack into one row
TRACE = [(5, 0), (19, 0), (11, 1), (30, 3)]
NEW_TOKENS = 6


@pytest.fixture(scope="module")
def weights():
    cfg = jget_config(ARCH).reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config(ARCH).reduced(), tp


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,), dtype=np.int32) for n, _ in TRACE]


def _replay(engine, prompts):
    rids = [engine.submit(p, NEW_TOKENS, arrival_tick=t) for p, (_, t) in zip(prompts, TRACE)]
    done = engine.run()
    return [done[r] for r in rids]


SERVES = {
    "dense_packed": dict(paged=False, pack_prefill=True),
    "dense_single": dict(paged=False, pack_prefill=False),
    "paged_packed": dict(paged=True, page_size=4, pack_prefill=True),
    "paged_single": dict(paged=True, page_size=4, pack_prefill=False),
}


@pytest.mark.parametrize("mode", list(SERVES))
def test_engine_streams_match_jax(weights, mode):
    jcfg, jp, tcfg, tp = weights
    kw = dict(max_seq=64, num_slots=3, **SERVES[mode])
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    want = _replay(jeng, prompts)
    got = _replay(teng, prompts)
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.generated == w.generated
        assert g.token_ticks == w.token_ticks
    assert teng.prefill_launches == jeng.prefill_launches
    assert teng.tick_stats()["decode_tokens"] == jeng.tick_stats()["decode_tokens"]
    if kw["paged"]:
        assert teng.kv_cache_stats()["pages_in_use"] == 0
        assert jeng.kv_cache_stats()["pages_in_use"] == 0
        teng.health()


@pytest.mark.parametrize("paged,kernel", [(True, "gather"), (False, "native")])
def test_decode_kernel_variants_give_the_same_streams(weights, paged, kernel):
    """The gather path on the paged pool and the split-K kernel on the dense
    cache (identity block table) serve the same tokens as the defaults."""
    _, _, tcfg, tp = weights
    prompts = _prompts(tcfg.vocab_size)
    base = dict(max_seq=64, num_slots=3, paged=paged, page_size=4 if paged else None)
    a = _replay(TEngine(tcfg, tp, TCTX, serve=TServe(**base)), prompts)
    b = _replay(TEngine(tcfg, tp, TCTX, serve=TServe(decode_kernel=kernel, **base)), prompts)
    assert [r.generated for r in a] == [r.generated for r in b]


def test_generate_cancel_deadline_and_stats(weights):
    _, _, tcfg, tp = weights
    eng = TEngine(tcfg, tp, TCTX, serve=TServe(max_seq=64, num_slots=2, paged=True, page_size=4))
    prompts = np.stack(_prompts(tcfg.vocab_size)[:1] * 3)
    out = eng.generate(prompts, max_new_tokens=4)
    assert out.shape == (3, 4) and (out == out[0]).all()  # same prompt, same stream
    now = eng.tick_stats()["ticks"]
    r0 = eng.submit(np.arange(7, dtype=np.int32), 20, arrival_tick=now)
    r1 = eng.submit(np.arange(9, dtype=np.int32), 20, arrival_tick=now, deadline_ticks=3)
    eng.step()
    assert eng.cancel(r0).status == "cancelled"
    res = eng.run()
    assert res[r1].status == "deadline" and 0 < len(res[r1].generated) < 20
    stats = eng.kv_cache_stats()
    assert stats["pages_in_use"] == 0 and stats["cancelled"] == 1 and stats["deadline_expired"] == 1
    ticks = eng.tick_stats()
    assert len(ticks["prefill_s"]) == len(ticks["decode_s"]) == ticks["ticks"]
    assert eng.health()["ok"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nan_guard_retires_only_the_poisoned_slot(weights, paged):
    _, _, tcfg, tp = weights
    serve = TServe(max_seq=64, num_slots=2, paged=paged, page_size=4 if paged else None,
                   pack_prefill=False)
    prompts = _prompts(tcfg.vocab_size)[:2]
    clean = _replay_two(TEngine(tcfg, tp, TCTX, serve=serve), prompts, poison=None)
    dirty_eng = TEngine(tcfg, tp, TCTX, serve=serve)
    dirty = _replay_two(dirty_eng, prompts, poison=0)
    assert dirty[0].status == "numeric_error"
    assert dirty[1].status == "ok" and dirty[1].generated == clean[1].generated
    assert dirty_eng.numeric_errors == 1


def _replay_two(eng, prompts, poison):
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.step()  # both prefilled and decoded once
    if poison is not None:
        if eng.paged:
            page = int(eng.allocator.block_table[poison, 0])
            eng._cache["k"][:, page, 0] = float("nan")
        else:
            eng._cache["k"][:, poison, 0] = float("nan")
    done = eng.run()
    return [done[r] for r in rids]


def test_unported_knobs_raise_and_dtype_is_checked(weights):
    """No serving knob is left unported: oversubscription and the chaos
    injector construct, as continuous prefill, speculation and the quantized
    pool do, and the combination checks are JAX's."""
    from repro_torch.testing.chaos import ChaosConfig, ChaosInjector

    _, _, tcfg, tp = weights
    over = dict(paged=True, prefill_chunk=8, oversubscribe=1.5)
    assert TServe(**over).oversubscribe == JServe(**over).oversubscribe == 1.5
    eng = TEngine(tcfg, tp, TCTX, serve=TServe(**over), chaos=ChaosInjector(ChaosConfig(seed=1)))
    assert eng.allocator.virtual_pages == int(1.5 * eng.allocator.layout.num_pages)
    for kw in (dict(oversubscribe=1.5), dict(paged=True, oversubscribe=1.5),
               dict(prefill_chunk=8, oversubscribe=1.5), dict(oversubscribe=0.5)):
        with pytest.raises(ValueError):
            TServe(**kw)  # as JAX's ServeConfig
        with pytest.raises(ValueError):
            JServe(**kw)
    for kw in (dict(prefill_chunk=8, tick_token_budget=16), dict(spec_k=4),
               dict(paged=True, kv_dtype="int8"), dict(paged=True, kv_dtype="fp8")):
        TServe(**kw)
    for kw in (dict(kv_dtype="int8"), dict(tick_token_budget=16), dict(prefill_chunk=0),
               dict(spec_k=1)):
        with pytest.raises(ValueError):
            TServe(**kw)  # as JAX's ServeConfig
        with pytest.raises(ValueError):
            JServe(**kw)
    with pytest.raises(ValueError, match="paged"):
        ttfm.init_cache(tcfg, 2, 16, ctx=TCTX, kv_dtype="int8")  # dense + quantized
    with pytest.raises(ValueError, match="cache_dtype"):
        TEngine(tcfg, tp, TCTX, serve=TServe(cache_dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        TServe(page_size=4)  # needs paged=True, as in JAX
    bf16 = {k: v for k, v in tp.items()}
    bf16["embed"] = tp["embed"].to(torch.bfloat16)
    TEngine(tcfg, bf16, TCTX, serve=TServe(cache_dtype=torch.bfloat16))
    assert ttfm.param_count(tp) > 0
