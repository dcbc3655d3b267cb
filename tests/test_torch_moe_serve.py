"""The port's ServeEngine on the MoE decoders against JAX's, on the CPU
(plain versions of the kernels), at the reduced qwen2-moe-a2.7b and
mixtral-8x7b (window 16), with JAX's capacity factor 1.25: one-shot over
the dense cache, the paged pool with packed prefill, and chunked prefill
with speculative verify over an int8 pool.  Expert capacity couples the
tokens of a row, so each mode drops its own tokens (counted here: it must
drop some); the port must drop the same ones as JAX's engine.  Streams,
their ticks and the launch counts are exactly equal, and the first-token
logits agree within 1e-4 (fp32 sums in another order).
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine

TCTX = TCtx(device="cpu")
# (prompt length, arrival tick): the two tick-0 prompts share a packed row
TRACE = [(5, 0), (19, 0), (11, 1), (30, 3)]
NEW_TOKENS = 6
LOGIT_TOL = 1e-4
MODES = {
    "oneshot_dense": dict(paged=False, pack_prefill=False),
    "paged_packed": dict(paged=True, page_size=4, pack_prefill=True),
    "chunk_spec_int8": dict(paged=True, page_size=4, prefill_chunk=8, tick_token_budget=16,
                            spec_k=4, kv_dtype="int8"),
}


@pytest.fixture(scope="module", params=["qwen2-moe-a2.7b", "mixtral-8x7b"])
def weights(request):
    cfg = jget_config(request.param).reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config(request.param).reduced(), tp


def _replay(engine, prompts):
    engine.capture_logits = True
    rids = [engine.submit(p, NEW_TOKENS, arrival_tick=t) for p, (_, t) in zip(prompts, TRACE)]
    done = engine.run()
    return [done[r] for r in rids], [engine.debug_logits[r][0] for r in rids]


def _counters(eng):
    return (eng.prefill_launches, eng.chunk_launches, eng.verify_launches, eng.spec_proposed,
            eng.spec_accepted, eng.tick_stats()["decode_tokens"])


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_match_jax(weights, mode, monkeypatch):
    jcfg, jp, tcfg, tp = weights
    kw = dict(max_seq=48, num_slots=3, **MODES[mode])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32) for n, _ in TRACE]
    dropped = []
    dispatch = tmoe._dispatch_indices

    def counting(idx, E, C):
        slot, valid = dispatch(idx, E, C)
        dropped.append(int((~valid).sum()))
        return slot, valid

    monkeypatch.setattr(tmoe, "_dispatch_indices", counting)
    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))
    want, want_first = _replay(jeng, prompts)
    teng = TEngine(tcfg, tp, TCTX, serve=TServe(**kw))
    got, got_first = _replay(teng, prompts)
    assert sum(dropped) > 0  # capacity binds on this trace
    for g, w in zip(got, want):
        assert g.status == w.status == "ok"
        assert g.generated == w.generated
        assert g.token_ticks == w.token_ticks
    for g, w in zip(got_first, want_first):
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0)
    assert _counters(teng) == _counters(jeng)
    if kw["paged"]:
        assert teng.kv_cache_stats()["pages_in_use"] == 0
