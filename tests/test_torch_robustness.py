"""Serving under memory pressure in the port against the JAX package, on the
CPU (the kernels' plain versions): the oversubscribed page allocator
(virtual capacity, ``PoolExhausted``, atomic unwinding, seize / restore,
invariant sweeps), the victim policy ``select_victim``, the chaos injector's
schedule, and whole engine runs -- preempt-and-recompute, a prefix donor
preempted, seeded chaos traces, random churn over dense / paged / int8, the
engine over a ring of 4 ranks, and the ``--check-deterministic`` CLI tour.

Weights are JAX's ``init_params`` (reduced granite-8b) converted with
``params_from_jax``; prompts come from ``numpy.random.default_rng`` with the
seed each case states.  Limits: allocator states, messages, victims and
chaos schedules equal; engine statuses, token streams, per-request
``preemptions`` / ``recompute_tokens`` and chaos events exactly JAX's
(int8 pools: a token may differ only where both engines score the two
candidates within twice ``LOGIT_BOUND``, the rule of
``test_torch_continuous.py``; the streams are then compared no further).
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve import kv_pool as jpool
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import select_victim as jselect
from repro.testing import chaos as jchaos
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ref import NEG_INF
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve import kv_pool as tpool
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import select_victim as tselect
from repro_torch.testing import chaos as tchaos
from test_torch_continuous import LOGIT_BOUND

ARCH = "granite-8b"
TCTX = TCtx(device="cpu")
CAP = 64
NEW = 8
# JAX's tests/test_robustness.py: a 13-page pool that 3 requests of 16 + 12
# tokens (7 pages each) overbook, chunked recompute, the sweep every tick
PRESSURE = dict(paged=True, page_size=4, num_pages=13, prefill_chunk=8, oversubscribe=2.0)
ROOMY = dict(paged=True, page_size=4, num_pages=24, prefill_chunk=8)
CHAOS = dict(seed=6, ticks=16, squeezes=2, squeeze_frac=0.5, squeeze_hold=3, nan_ticks=1,
             drop_ticks=1)


# --------------------------------------------------------------------------
# the allocator under pressure: one call script through both packages
# --------------------------------------------------------------------------


def _pressure_script(pool, oversubscribe, quantized):
    """Admission math, atomic unwinding, seize / restore and the invariant
    sweep; returns every answer, block table, message and stats dict."""
    alloc = pool.PageAllocator(pool.PagedLayout(6, 4, 8, 1), quantized=quantized,
                               oversubscribe=oversubscribe)
    seen = [alloc.virtual_pages, alloc.ADMIT_MARGIN]
    for plen, new in ((8, 8), (8, 12), (16, 0), (20, 0), (8, 28), (8, 60), (24, 0)):
        seen.append((plen, new, alloc.can_admit(plen, new), alloc.never_admittable(plen, new),
                     alloc.can_admit(plen, new, pending=2, pending_prompt=2)))

    def attempt(fn, *args):
        try:
            seen.append(("ok", fn(*args)))
        except tpool.PoolExhausted as e:  # the port's
            seen.append(("exhausted", str(e)))
        except jpool.PoolExhausted as e:  # JAX's
            seen.append(("exhausted", str(e)))
        except (RuntimeError, ValueError) as e:
            seen.append((type(e).__name__, str(e)))
        seen.append((alloc.device_table(4).copy(), alloc.stats(), alloc.check_invariants()))

    attempt(lambda: alloc.alloc_slot(0, np.arange(8, dtype=np.int32), 4).shared_len)
    attempt(lambda: alloc.seize_pages(3))
    attempt(lambda: alloc.alloc_slot(1, np.arange(100, 112, dtype=np.int32), 0).shared_len)
    attempt(lambda: [alloc.ensure_append(0, p) for p in (8, 9, 12)])
    seized = list(alloc._seized)
    attempt(lambda: alloc.restore_pages(seized))
    attempt(lambda: alloc.alloc_slot(1, np.arange(8, dtype=np.int32), 2).shared_len)
    attempt(lambda: alloc.alloc_slot(2, np.arange(200, 216, dtype=np.int32), 0).shared_len)
    attempt(lambda: (alloc.slot_shares_pages(0), alloc.slot_shares_pages(2),
                     alloc.pages_referenced))
    attempt(lambda: (alloc.free_slot(1), alloc.free_slot(1), alloc.rollback(1, 0)))
    attempt(lambda: alloc.seize_pages(99))
    attempt(lambda: alloc.ensure_span(0, 13, 6))
    attempt(lambda: alloc.restore_pages(list(alloc._seized)))
    attempt(lambda: (alloc.free_slot(0), alloc.free_slot(2)))
    alloc.alloc_slot(3, np.arange(300, 306, dtype=np.int32), 2)
    alloc.ref[int(alloc.block_table[3, 0])] += 1  # a refcount leak the sweep reports
    seen.append(alloc.check_invariants())
    return seen


@pytest.mark.parametrize("oversubscribe,quantized", [(1.0, False), (2.0, False), (2.0, True),
                                                     (1.5, True)])
def test_allocator_pressure_script_matches_jax(oversubscribe, quantized):
    """The same call script through both allocators: identical admission
    answers, block tables, stats, invariant reports and exhaustion messages
    (occupancy, seized pages, virtual capacity)."""
    got = _pressure_script(tpool, oversubscribe, quantized)
    want = _pressure_script(jpool, oversubscribe, quantized)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple) and g and isinstance(g[0], np.ndarray):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
        else:
            assert g == w
    kinds = [g[0] for g in got if isinstance(g, tuple) and isinstance(g[0], str)]
    assert "exhausted" in kinds  # the squeeze ran the free list dry
    assert got[-1] and any("refcount" in p for p in got[-1])


def test_pool_exhausted_is_a_runtime_error_and_unwinds():
    alloc = tpool.PageAllocator(tpool.PagedLayout(3, 4, 8, 1), oversubscribe=4.0)
    alloc.alloc_slot(0, np.arange(8, dtype=np.int32), 0)
    with pytest.raises(RuntimeError, match="free list empty"):
        alloc.alloc_slot(1, np.arange(200, 212, dtype=np.int32), 0)  # needs 3 of 1
    assert alloc.slot_pages(1) == 0 and alloc.pages_in_use == 2
    assert (alloc.block_table[1] == tpool.PageAllocator.FREE).all()
    assert alloc.check_invariants() == []
    with pytest.raises(ValueError):
        tpool.PageAllocator(tpool.PagedLayout(3, 4, 8, 1), oversubscribe=0.5)


# --------------------------------------------------------------------------
# the victim policy
# --------------------------------------------------------------------------


class _Req:
    def __init__(self, rid, admit_tick):
        self.rid, self.admit_tick = rid, admit_tick


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_victim_matches_jax(seed):
    """Random slot / allocator states (prefix donors and sharers, private
    slots, page-less slots, free slots) through both policies under every
    protect set of one slot, and none."""
    rng = np.random.default_rng(40 + seed)
    allocs = [pool.PageAllocator(pool.PagedLayout(40, 4, 8, 1)) for pool in (tpool, jpool)]
    prefix = rng.integers(0, 50, (8,)).astype(np.int32)
    slots = []
    for slot in range(6):
        kind = rng.integers(0, 4)
        if kind == 3:
            slots.append(None)
            continue
        req = _Req(int(rng.integers(0, 20)), int(rng.integers(0, 5)))
        slots.append(req)
        if kind == 2:
            continue  # admitted, pages not allocated yet
        prompt = (np.concatenate([prefix, rng.integers(0, 50, (3,))]) if kind == 1
                  else rng.integers(100, 150, (int(rng.integers(3, 12)),))).astype(np.int32)
        for a in allocs:
            a.alloc_slot(slot, prompt, 4)
    for protect in [()] + [{s} for s in range(6)]:
        want = jselect(slots, allocs[1], protect)
        assert tselect(slots, allocs[0], protect) == want
        for s in range(6):
            assert allocs[0].slot_shares_pages(s) == allocs[1].slot_shares_pages(s)


# --------------------------------------------------------------------------
# the chaos injector's schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(seed=6, ticks=16, squeezes=2, squeeze_hold=3),
                                 dict(seed=0), dict(seed=11, ticks=5, squeezes=1, nan_ticks=2,
                                                    drop_ticks=1),
                                 dict(seed=3, ticks=24, squeezes=0, nan_ticks=0, drop_ticks=3)])
def test_chaos_schedule_matches_jax(cfg):
    t = tchaos.ChaosInjector(tchaos.ChaosConfig(**cfg))
    j = jchaos.ChaosInjector(jchaos.ChaosConfig(**cfg))
    assert (t.squeeze_ticks, t.nan_ticks, t.drop_ticks) == (j.squeeze_ticks, j.nan_ticks,
                                                              j.drop_ticks)
    assert t.summary() == j.summary()


@pytest.mark.parametrize("bad", [dict(ticks=1), dict(squeeze_frac=1.5), dict(squeeze_hold=0),
                                 dict(nan_ticks=-1)])
def test_chaos_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        jchaos.ChaosConfig(**bad)
    with pytest.raises(ValueError):
        tchaos.ChaosConfig(**bad)
    with pytest.raises(ValueError, match="do not fit"):
        tchaos.ChaosInjector(tchaos.ChaosConfig(ticks=3, squeezes=2, nan_ticks=1))


# --------------------------------------------------------------------------
# engines: the port against JAX's single-device engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    cfg = jget_config(ARCH).reduced()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tget_config(ARCH).reduced(), tp


def _engines(granite, kw, chaos=None, tctx=TCTX):
    """(JAX's engine, the port's) on the same knobs, each with its own
    injector built from the same chaos config."""
    jcfg, jp, tcfg, tp = granite
    jinj = tinj = None
    if chaos is not None:
        jinj = jchaos.ChaosInjector(jchaos.ChaosConfig(**chaos))
        tinj = tchaos.ChaosInjector(tchaos.ChaosConfig(**chaos))
    jeng = JEngine(jcfg, jp, JCtx(), serve=JServe(max_seq=CAP, num_slots=3, **kw), chaos=jinj)
    teng = TEngine(tcfg, tp, tctx, serve=TServe(max_seq=CAP, num_slots=3, **kw), chaos=tinj)
    return jeng, teng


def _run(eng, prompts, new_tokens=NEW, deadlines=None, cancels=None, base=0, logits=False):
    eng.capture_logits = logits
    rids = [eng.submit(p, new_tokens, arrival_tick=base,
                       deadline_ticks=None if deadlines is None else deadlines[i])
            for i, p in enumerate(prompts)]
    cancels = cancels or {}
    while eng.has_work:
        for idx in cancels.get(eng._tick - base, []):
            eng.cancel(rids[idx])
        eng.step()
    return [eng._finished[r] for r in rids], rids


def _outcome(results):
    return [(r.status, r.generated, r.preemptions, r.recompute_tokens) for r in results]


def _pressure_prompts(vocab, case):
    if case == "token_identity":
        rng = np.random.default_rng(3)
        return [rng.integers(0, vocab, (16,), dtype=np.int32) for _ in range(3)]
    rng = np.random.default_rng(5)  # a prefix donor and its sharer, and one private
    prefix = rng.integers(0, vocab, (12,), dtype=np.int32)
    return [
        np.concatenate([prefix, rng.integers(0, vocab, (4,), dtype=np.int32)]),
        np.concatenate([prefix, rng.integers(0, vocab, (4,), dtype=np.int32)]),
        rng.integers(0, vocab, (16,), dtype=np.int32),
    ]


@pytest.mark.parametrize("case", ["token_identity", "donor"])
def test_preempt_recompute_matches_jax(granite, case):
    """JAX's two pressure cases (tests/test_robustness.py:206, :224): the
    port preempts the same requests as many times, recomputes as many
    tokens, and serves the same streams -- which are those of the roomy,
    pressure-free run; pages drain and the sweep holds every tick."""
    jcfg = granite[0]
    prompts = _pressure_prompts(jcfg.vocab_size, case)
    jeng, teng = _engines(granite, dict(PRESSURE, health_every=1))
    want, _ = _run(jeng, prompts, 12)
    got, _ = _run(teng, prompts, 12)
    assert _outcome(got) == _outcome(want)
    assert [g.token_ticks for g in got] == [w.token_ticks for w in want]
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.recompute_tokens == jeng.recompute_tokens > 0
    assert sum(g.preemptions for g in got) == teng.preemptions
    roomy, _ = _run(_engines(granite, ROOMY)[1], prompts, 12)
    assert [g.generated for g in got] == [r.generated for r in roomy]
    kv = teng.kv_cache_stats()
    assert kv["pages_in_use"] == kv["pages_reserved"] == 0 and kv["preemptions"] > 0
    if case == "donor":
        assert kv["shared_hits"] >= 1
    assert teng.health()["ok"]


def _compare_with_flips(got, want, got_logits, want_logits, quantized):
    """Exact outcomes, or (int8) a near-tie flip: then that request's stream
    is compared no further."""
    for g, w in zip(got, want):
        if g.generated == w.generated or not quantized:
            assert (g.status, g.generated) == (w.status, w.generated)
            continue
        i = next(i for i, (a, b) in enumerate(zip(g.generated, w.generated)) if a != b)
        a, b = w.generated[i], g.generated[i]
        wl, gl = want_logits[w.rid][i], got_logits[g.rid][i]
        assert wl[a] - wl[b] <= 2 * LOGIT_BOUND and gl[b] - gl[a] <= 2 * LOGIT_BOUND


@pytest.mark.parametrize("seed", [6, 11])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_chaos_trace_matches_jax(granite, pool, seed):
    """JAX's seeded chaos case (two squeezes, a NaN tick, a dropped grant
    over a 13-page pool; seed 6 is JAX's, seed 11 lands its drop on a tick
    with chunk grants): the port's events, statuses, streams and
    per-request preemptions are JAX's, event for event; the poisoned slot
    alone retires with numeric_error, and a second port run replays it."""
    jcfg = granite[0]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, (16,), dtype=np.int32) for _ in range(4)]
    kw = dict(PRESSURE, health_every=2, kv_dtype=pool)
    chaos = dict(CHAOS, seed=seed)
    jeng, teng = _engines(granite, kw, chaos=chaos)
    want, _ = _run(jeng, prompts, 10, logits=True)
    got, _ = _run(teng, prompts, 10, logits=True)
    assert teng.chaos.events == jeng.chaos.events
    assert teng.chaos.injected_nans == 1 and teng.chaos.injected_squeezes == 2
    _compare_with_flips(got, want, teng.debug_logits, jeng.debug_logits, pool != "fp")
    assert [g.status for g in got].count("numeric_error") == 1 == teng.numeric_errors
    assert [(g.preemptions, g.recompute_tokens) for g in got] == \
        [(w.preemptions, w.recompute_tokens) for w in want]
    assert teng.chaos_dropped_grants == jeng.chaos_dropped_grants
    assert (teng.chaos_dropped_grants > 0) == (seed == 11)
    kv = teng.kv_cache_stats()
    assert kv["pages_in_use"] == kv["scale_entries_in_use"] == kv["seized_pages"] == 0
    _, replay = _engines(granite, kw, chaos=chaos)
    again, _ = _run(replay, prompts, 10)
    assert replay.chaos.events == teng.chaos.events
    assert _outcome(again) == _outcome(got)


def test_nan_guard_retires_only_the_poisoned_slot(granite):
    """``poison_slot_cache`` on a decoding slot (dense rows and the int8
    pool's scale table): that request alone ends numeric_error, the others
    keep the clean run's tokens, as in JAX."""
    jcfg = granite[0]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, (8,), dtype=np.int32) for _ in range(3)]
    for kw in (dict(prefill_chunk=8), dict(paged=True, page_size=4, prefill_chunk=8,
                                           kv_dtype="int8")):
        outs = []
        for eng in _engines(granite, kw):
            clean, _ = _run(_engines(granite, kw)[1], prompts)
            rids = [eng.submit(p, NEW) for p in prompts]
            poisoned = False
            while eng.has_work:
                if not poisoned and eng.scheduler.slots[1] is not None \
                        and eng.scheduler.slots[1].generated:
                    eng.poison_slot_cache(1)
                    poisoned = True
                eng.step()
            got = [eng._finished[r] for r in rids]
            assert [g.status for g in got].count("numeric_error") == 1 == eng.numeric_errors
            for c, g in zip(clean, got):
                if g.status == "ok":
                    assert g.generated == c.generated
            outs.append([(g.status, g.generated) for g in got])
        assert outs[0] == outs[1]


# --------------------------------------------------------------------------
# churn: random cancels and deadlines under pressure, every pool
# --------------------------------------------------------------------------

MODES = {
    "dense": dict(prefill_chunk=8),
    "paged": dict(PRESSURE),
    "int8": dict(PRESSURE, kv_dtype="int8"),
}
SEEDS = (17, 404, 9001)


def _churn_case(vocab, seed):
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(2, 5))
    prompts = [rng.integers(0, vocab, (int(rng.integers(6, 20)),), dtype=np.int32)
               for _ in range(n_req)]
    deadlines = [int(rng.integers(4, 14)) if rng.random() < 0.3 else None for _ in range(n_req)]
    cancels = {}
    for i in range(n_req):
        if rng.random() < 0.3:
            cancels.setdefault(int(rng.integers(1, 10)), []).append(i)
    return prompts, deadlines, cancels


@pytest.mark.parametrize("mode", list(MODES))
def test_churn_drains_and_ok_streams_match_oracle(granite, mode):
    """JAX's churn property (tests/test_robustness.py:379) on the port: one
    engine serves seeded cases back to back; every path frees its pages and
    scale entries, the sweep holds, and every ok stream is the roomy
    fault-free engine's.  JAX's engine, run on the first case, ends each
    request the same way."""
    jcfg = granite[0]
    kw = dict(MODES[mode], health_every=4)
    roomy_kw = {k: v for k, v in kw.items() if k != "oversubscribe"}
    if roomy_kw.get("paged"):
        roomy_kw["num_pages"] = 32
    jeng, teng = _engines(granite, kw)
    oracle = _engines(granite, roomy_kw)[1]
    for i, seed in enumerate(SEEDS):
        prompts, deadlines, cancels = _churn_case(jcfg.vocab_size, seed)
        got, _ = _run(teng, prompts, deadlines=deadlines, cancels=cancels, base=teng._tick,
                      logits=True)
        assert {g.status for g in got} <= {"ok", "cancelled", "deadline", "numeric_error",
                                           "rejected"}
        if teng.allocator is not None:
            assert teng.allocator.pages_in_use == teng.allocator.pages_reserved == 0
            assert teng.allocator.scale_entries_in_use == 0
        teng.health()
        for g, p in zip(got, prompts):
            if g.status == "ok":
                want, _ = _run(oracle, [p], base=oracle._tick)
                assert g.generated == want[0].generated, (mode, seed)
        if i == 0:
            want, _ = _run(jeng, prompts, deadlines=deadlines, cancels=cancels, logits=True)
            assert [g.status for g in got] == [w.status for w in want]
            _compare_with_flips(got, want, teng.debug_logits, jeng.debug_logits, mode == "int8")


# --------------------------------------------------------------------------
# the engine over a ring of 4 under the same pressure and chaos
# --------------------------------------------------------------------------


def test_ring_pressure_and_chaos_match_one_rank(granite, monkeypatch):
    """At ``sp_size 4`` over a ``VirtualRing`` with page_size 1 a logical
    page covers 4 positions, as page_size 4 does on one rank, so the
    allocator takes the same decisions: the same chaos events, preemptions,
    statuses and streams.  A preempted row parks with an all-FREE block
    table: its folded #4 rows (depth pos - i on rank i) attend nothing on
    any rank, o = 0 and lse = NEG_INF."""
    from repro_torch.kernels import paged_decode as pk

    jcfg, _, tcfg, tp = granite
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, (16,), dtype=np.int32) for _ in range(4)]
    parked = []
    real = pk.paged_flash_decode

    def decode(q, k_pool, v_pool, bt, pos, *args, **kw):
        o, lse = real(q, k_pool, v_pool, bt, pos, *args, **kw)
        rows = ((bt < 0).all(dim=1) & (pos >= 2**29)).nonzero().flatten()
        if len(rows):
            parked.append((o[rows], lse[rows]))
        return o, lse

    monkeypatch.setattr(pk, "paged_flash_decode", decode)
    outs = []
    for n, page_size in ((1, 4), (4, 1)):
        ctx = TCtx(sp_size=n, device="cpu")
        kw = dict(PRESSURE, page_size=page_size, health_every=1)
        eng = TEngine(tcfg, tp, ctx, serve=TServe(max_seq=CAP, num_slots=3, **kw),
                      chaos=tchaos.ChaosInjector(tchaos.ChaosConfig(**CHAOS)))
        got, _ = _run(eng, prompts, 10)
        assert eng.allocator.layout.chunk == 4 and eng.preemptions > 0
        outs.append((eng.chaos.events, _outcome(got), eng.preemptions, eng.recompute_tokens))
    assert outs[1] == outs[0]
    assert parked, "no preempted row rode a decode launch"
    for o, lse in parked:
        assert (o == 0).all() and (lse == NEG_INF).all()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_launch_serve_check_deterministic_with_chaos(capsys):
    """``--check-deterministic --chaos-seed``: run 2 (a fresh engine and
    injector) reproduces run 1's statuses, streams and chaos events, under
    oversubscription with preemptions."""
    import json

    from repro_torch.launch import serve

    assert serve.main([
        "--device", "cpu", "--reduced", "--stream", "--paged", "--page-size", "4",
        "--num-pages", "13", "--prefill-chunk", "8", "--oversubscribe", "2.0",
        "--chaos-seed", "3", "--health-every", "1", "--check-deterministic",
        "--trace", "16:0,16:0,16:1,20:2", "--new-tokens", "12", "--max-seq", "64",
    ]) == 0
    out = capsys.readouterr().out
    assert "reproduced exactly" in out
    summary = json.loads(next(line for line in out.splitlines() if line.startswith("{")))
    rob = summary["robustness"]
    assert rob["preemptions"] > 0 and rob["recompute_tokens"] > 0 and rob["chaos_events"]
    assert summary["kv_cache"]["pages_in_use"] == 0
