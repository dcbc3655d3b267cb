"""The port's planner copies (``repro_torch.core.{tiling,schedule,am,
simulator,autotune,masking}`` and the plan cache of ``core/dispatch.py``)
against the JAX package's modules, on the inputs of tests/test_tiling.py,
test_schedule.py, test_am.py and test_autotune_and_analysis.py: every
factorization of n in {4, 6, 8, 9, 16}, both directions, concurrent rings on
and off, the masks' skip sets.  The copies must give equal outputs, and the
plan-cache keys equal hashes, so a cache written by one package is read by
the other."""

import json

import numpy as np
import pytest

from repro.core import am as jam
from repro.core import autotune as jtune
from repro.core import dispatch as jdispatch
from repro.core import masking as jmask
from repro.core import schedule as jS
from repro.core import simulator as jsim
from repro.core import tiling as jtiling
from repro_torch.core import am as tam
from repro_torch.core import autotune as ttune
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import masking as tmask
from repro_torch.core import schedule as tS
from repro_torch.core import simulator as tsim
from repro_torch.core import tiling as ttiling

NS = (4, 6, 8, 9, 16)
NA = [(n, a) for n in NS for a, _ in jtiling.factorizations(n)]
# profiles of the schedule tests' range (c in [0.1, 8]) plus the default
PROFILES = [
    {},
    dict(c_q=0.1, c_kv=8.0, c_o=0.5, c_odoq=2.5, c_dq=0.3, c_dkv=7.9),
    dict(c_q=3.3, c_kv=0.2, c_o=6.0, c_odoq=0.1, c_dq=4.4, c_dkv=1.1),
]
COMM_HW = dict(peak_flops=989e12, link_bw=2e9, attn_efficiency=0.3)
FAST_HW = dict(peak_flops=50e12, link_bw=400e9, attn_efficiency=0.9)


def _masks(mod, n):
    """The same mask specs in either package (window, documents and a
    bitmap sized to n)."""
    bitmap = [[(i + 2 * j) % 3 != 1 or i == j for j in range(n)] for i in range(n)]
    return {
        "full": mod.MaskSpec.full(),
        "causal": mod.MaskSpec.causal(),
        "window": mod.MaskSpec.causal(window=5),
        "segment": mod.MaskSpec.segment(),
        "document": mod.MaskSpec.document([3 * n, 5 * n, 8 * n]),
        "block_sparse": mod.MaskSpec.block_sparse(bitmap),
    }


@pytest.mark.parametrize("n,a", NA)
def test_tiling_equal(n, a):
    jl, tl = jtiling.TileLayout(n, a), ttiling.TileLayout(n, a)
    assert tl.q_shift_perm() == jl.q_shift_perm()
    assert tl.kv_shift_perm() == jl.kv_shift_perm()
    assert tl.q_ring_perm() == jl.q_ring_perm() and tl.kv_ring_perm() == jl.kv_ring_perm()
    np.testing.assert_array_equal(tl.assignment_matrix(), jl.assignment_matrix())
    for i in range(n):
        assert [tl.q_chunk(i, u) for u in range(a)] == [jl.q_chunk(i, u) for u in range(a)]
        assert [tl.kv_chunk(i, v) for v in range(n // a)] == [
            jl.kv_chunk(i, v) for v in range(n // a)
        ]
    assert ttiling.factorizations(n) == jtiling.factorizations(n)
    assert ttiling.best_square_a(n) == jtiling.best_square_a(n)
    for m in (1, 3, 8):
        np.testing.assert_array_equal(ttiling.stripe_permutation(n * m, n),
                                      jtiling.stripe_permutation(n * m, n))
        np.testing.assert_array_equal(ttiling.unstripe_permutation(n * m, n),
                                      jtiling.unstripe_permutation(n * m, n))


@pytest.mark.parametrize("n,a", NA)
def test_schedules_equal(n, a):
    b = n // a
    for kw in PROFILES:
        for concurrent in (False, True):
            for jgen, tgen in ((jS.greedy_forward_schedule, tS.greedy_forward_schedule),
                               (jS.greedy_backward_schedule, tS.greedy_backward_schedule)):
                js = jgen(a, b, jS.Profile(**kw), allow_concurrent_rings=concurrent)
                ts = tgen(a, b, tS.Profile(**kw), allow_concurrent_rings=concurrent)
                assert tS.schedule_to_json(ts) == jS.schedule_to_json(js)
                tS.validate_schedule(ts, strict_paper=not concurrent)
                assert tS.schedule_to_json(tS.schedule_from_json(jS.schedule_to_json(js))) == \
                    jS.schedule_to_json(js)
    assert tS.schedule_to_json(tS.naive_forward_schedule(a, b)) == \
        jS.schedule_to_json(jS.naive_forward_schedule(a, b))
    assert tS.schedule_to_json(tS.ring_forward_schedule(n)) == \
        jS.schedule_to_json(jS.ring_forward_schedule(n))
    assert tS.COMM_OVERLAP_MODES == jS.COMM_OVERLAP_MODES


@pytest.mark.parametrize("n,a", NA)
def test_mask_skip_sets_and_pruned_schedules_equal(n, a):
    b = n // a
    jm, tm = _masks(jmask, n), _masks(tmask, n)
    seq = 16 * n
    for name in jm:
        assert tm[name].signature() == jm[name].signature()
        assert tm[name].visible_fraction(seq) == jm[name].visible_fraction(seq)
        for layout in ("striped", "contiguous"):
            jv = jm[name].block_visibility(a, b, layout=layout, n=n, seq=seq)
            tv = tm[name].block_visibility(a, b, layout=layout, n=n, seq=seq)
            assert tv == jv, (name, layout)
            skip = tm[name].empty_blocks(a, b, layout=layout, n=n, seq=seq)
            assert skip == jm[name].empty_blocks(a, b, layout=layout, n=n, seq=seq)
            for direction in ("fwd", "bwd"):
                assert tS.comm_requirements(a, b, direction, skip) == \
                    jS.comm_requirements(a, b, direction, skip)
            if (0, 0) in skip:
                continue
            for jgen, tgen in ((jS.greedy_forward_schedule, tS.greedy_forward_schedule),
                               (jS.greedy_backward_schedule, tS.greedy_backward_schedule)):
                assert tS.schedule_to_json(tgen(a, b, skip_blocks=skip)) == \
                    jS.schedule_to_json(jgen(a, b, skip_blocks=skip))
    for name in ("causal", "document", "block_sparse"):
        np.testing.assert_array_equal(tm[name].dense_mask(seq), jm[name].dense_mask(seq))
    np.testing.assert_array_equal(tm["document"].segment_array(seq),
                                  jm["document"].segment_array(seq))


@pytest.mark.parametrize("n", NS)
def test_comm_model_and_simulator_equal(n):
    for kv_hidden in (None, 512):
        jc = jam.CommModel(seq=1 << 16, hidden=4096, n=n, kv_hidden=kv_hidden)
        tc = tam.CommModel(seq=1 << 16, hidden=4096, n=n, kv_hidden=kv_hidden)
        for kind in ("q", "o", "dq", "kv", "dkv", "odoq"):
            assert tc.chunk_bytes(kind) == jc.chunk_bytes(kind)
        assert tc.best_a() == jc.best_a() and tc.best_a(backward=True) == jc.best_a(backward=True)
        assert tc.ring_fwd_bytes() == jc.ring_fwd_bytes()
        assert tc.ring_bwd_bytes() == jc.ring_bwd_bytes()
        for a, _ in jtiling.factorizations(n):
            assert tc.fwd_bytes(a) == jc.fwd_bytes(a) and tc.bwd_bytes(a) == jc.bwd_bytes(a)
            assert tam.mesh_volume(n, a) == jam.mesh_volume(n, a)
            assert tam.commcom_ratio(n, a) == jam.commcom_ratio(n, a)
            for hw in (COMM_HW, FAST_HW):
                for mode in tS.COMM_OVERLAP_MODES:
                    for backward in (False, True):
                        jcost = jsim.make_cost_model(jc, jsim.HardwareModel(**hw), causal=True,
                                                     backward=backward, comm_overlap=mode)
                        tcost = tsim.make_cost_model(tc, tsim.HardwareModel(**hw), causal=True,
                                                     backward=backward, comm_overlap=mode)
                        assert tcost == tsim.CostModel(**jcost.__dict__)
                        sched = (jS.greedy_backward_schedule if backward
                                 else jS.greedy_forward_schedule)(a, n // a, jcost.profile())
                        tsched = tS.schedule_from_json(jS.schedule_to_json(sched))
                        jr = jsim.simulate(sched, jcost, jc, comm_overlap=mode)
                        tr = tsim.simulate(tsched, tcost, tc, comm_overlap=mode)
                        assert tr.__dict__ == jr.__dict__
    assert tam.table2(n) == jam.table2(n)
    for mode in tS.COMM_OVERLAP_MODES:
        assert tam.ppermute_pair_factor(mode) == jam.ppermute_pair_factor(mode)


def _plan_json(plan, mod):
    return (plan.a, plan.b, mod.schedule_to_json(plan.fwd),
            mod.schedule_to_json(plan.bwd) if plan.bwd else None, plan.total, plan.comm_bytes)


@pytest.mark.parametrize("n", NS)
def test_tune_and_plan_for_equal(n):
    cases = [
        (dict(seq=1 << 16, hidden=4096), COMM_HW, dict(causal=True)),
        (dict(seq=1 << 15, hidden=4096, kv_hidden=512), FAST_HW, dict(causal=False)),
    ]
    for comm_kw, hw, kw in cases:
        jc, tc = jam.CommModel(n=n, **comm_kw), tam.CommModel(n=n, **comm_kw)
        jhw, thw = jsim.HardwareModel(**hw), tsim.HardwareModel(**hw)
        for concurrent in (False, True):
            for mode in tS.COMM_OVERLAP_MODES:
                opts = dict(allow_concurrent_rings=concurrent, comm_overlap=mode, **kw)
                assert _plan_json(ttune.tune(tc, thw, **opts), tS) == \
                    _plan_json(jtune.tune(jc, jhw, **opts), jS)
                for a, _ in jtiling.factorizations(n):
                    assert _plan_json(ttune.plan_for(tc, a, thw, **opts), tS) == \
                        _plan_json(jtune.plan_for(jc, a, jhw, **opts), jS)
        mseq = comm_kw["seq"]
        jmk = jmask.MaskSpec.document([mseq // 2, mseq // 4, mseq // 4])
        tmk = tmask.MaskSpec.document([mseq // 2, mseq // 4, mseq // 4])
        assert _plan_json(ttune.tune(tc, thw, mask=tmk), tS) == \
            _plan_json(jtune.tune(jc, jhw, mask=jmk), jS)


PLAN_CASES = [
    dict(n=4, a=None, causal=True),
    dict(n=4, a=2, causal=True, comm_overlap="bidir"),
    dict(n=8, a=None, window=64, causal=True, layout="contiguous"),
    dict(n=8, a=4, allow_concurrent_rings=True, with_backward=False, hw_profile="paper_a100"),
    dict(n=16, a=None, causal=True, comm_overlap="serial", hw_profile="tpu_v5e"),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_plan_keys_equal_and_caches_shared(case, tmp_path):
    """Equal hashes over the same call, and a plan file written by JAX's
    ``plan_schedules`` is read (not re-planned) by the port's."""
    assert sorted(tdispatch.HW_PROFILES) == sorted(jdispatch.HW_PROFILES)
    for name, hw in jdispatch.HW_PROFILES.items():
        assert tdispatch.HW_PROFILES[name].__dict__ == hw.__dict__
    case = dict(case, plan_cache_dir=str(tmp_path))
    jcfg = jdispatch.AttentionPlanConfig(backend="mesh", autotune=True, **case)
    tcfg = tdispatch.AttentionPlanConfig(backend="mesh", autotune=True, **case)
    comm = dict(seq=1024, hidden=8 * 64, n=case["n"], kv_hidden=2 * 64, bytes_per_elem=4, batch=2)
    jc, tc = jam.CommModel(**comm), tam.CommModel(**comm)
    jkey, jdesc = jdispatch._plan_key(jcfg, jc, jdispatch.HW_PROFILES[jcfg.hw_profile])
    tkey, tdesc = tdispatch._plan_key(tcfg, tc, tdispatch.HW_PROFILES[tcfg.hw_profile])
    assert tkey == jkey and tdesc == jdesc
    jdispatch.clear_plan_cache(jcfg)
    tdispatch.clear_plan_cache(tcfg)
    ja, jf, jb = jdispatch.plan_schedules(jcfg, jc)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"{jkey}.json"]
    # tamper with the JAX-written file's a: the port must report what it read
    path = tmp_path / files[0]
    payload = json.loads(path.read_text())
    payload["a"] = -7
    path.write_text(json.dumps(payload))
    ta, tf, tb = tdispatch.plan_schedules(tcfg, tc)
    assert ta == -7
    assert tS.schedule_to_json(tf) == jS.schedule_to_json(jf)
    assert (tb is None) == (jb is None)
    if tb is not None:
        assert tS.schedule_to_json(tb) == jS.schedule_to_json(jb)
    # an un-tampered re-plan by the port gives JAX's plan
    tdispatch.clear_plan_cache(tcfg)
    assert tdispatch.plan_schedules(tcfg, tc)[0] == ja
    jdispatch.clear_plan_cache(jcfg)
    tdispatch.clear_plan_cache(tcfg)
