"""The port's MoE over a sequence-parallel ring (``ParallelCtx(sp_size=4)``, a
``VirtualRing`` on the CPU) against JAX at sp_size 4: JAX's ``moe_block``,
``_moe_ep_manual``, ``loss_fn`` and ``ServeEngine`` over a (2, 4) mesh of
fake CPU devices with Auto axes, run in two subprocesses side by side
(``tests/jax_moe_ep_worker.py``, since the device count is fixed when JAX
starts), fp32, reduced configs, JAX's weights through ``params_from_jax``:

  * the layer: qwen2-moe ("ep": JAX's ``_moe_ep_segmented``, capacity per
    rank's quarter of a row) at cf 1.25 (drops on both sides) and 8, with 6
    experts padded to 8 by the port's ``init_params(ctx=...)``, S 5 (the
    global path), and mixtral ("tp": the global path); y within
    ``BLOCK_TOL``, aux within ``AUX_TOL``, and the "ep" outputs against
    ``_moe_ep_manual`` too (whose aux, a mean of per-rank terms, differs by
    design: ROADMAP C.3);
  * the model: logits (3e-5, JAX's ``check_moe_ep_manual`` limit), loss,
    ce and aux (1e-5) and every gradient leaf (5e-5 of its largest entry)
    on JAX's striped batch;
  * the engine: streams and their ticks equal to JAX's at sp_size 4, one-shot
    over the fp pool (qwen2-moe, mixtral) and chunked + speculative over an
    int8 pool (qwen2-moe), cf 1.25, drops on both sides; one #4 launch per
    layer and decode tick with the ranks folded;
  * the ring's ``moe_dispatch`` / ``moe_return`` counts against their
    reckoning, and two runs bitwise equal.

Inputs come from ``numpy.random.default_rng`` with the seed each case
states.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine

N = 4
B, S = 2, 32
BLOCK_TOL, AUX_TOL = 1e-5, 1e-6  # tests/test_torch_moe.py's
LOGIT_TOL, LOSS_TOL, GRAD_REL = 3e-5, 1e-5, 5e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_moe_ep_worker.py")
TIME_LIMIT_S = 240
QWEN, MIXTRAL = "qwen2-moe-a2.7b", "mixtral-8x7b"
# case -> (arch, capacity factor, expert count or None, S)
BLOCKS = {
    "qwen_cf1.25": (QWEN, 1.25, None, S),
    "qwen_cf8": (QWEN, 8.0, None, S),
    "qwen_padded": (QWEN, 1.25, 6, S),
    "mixtral_tp": (MIXTRAL, 1.25, None, S),
    "qwen_s5": (QWEN, 1.25, None, 5),
}
MODELS = {"qwen": QWEN, "mixtral": MIXTRAL}
# (prompt length, arrival tick); the 16-token prompt loops, so prompt
# lookup drafts and the verify window ([slots, spec_k]) runs
TRACE = [(8, 0), (16, 0), (28, 1)]
NEW_TOKENS = 6
ENGINES = {
    "qwen_oneshot_fp": (QWEN, dict(paged=True, page_size=4)),
    "qwen_chunk_spec_int8": (QWEN, dict(paged=True, page_size=4, prefill_chunk=16,
                                        tick_token_budget=32, spec_k=4, kv_dtype="int8")),
    "mixtral_oneshot_fp": (MIXTRAL, dict(paged=True, page_size=4)),
}
SERVE = dict(max_seq=64, num_slots=3)
# the JAX cases of each worker process, for about equal compile times; the
# second also takes every block case
_WORKER_GROUPS = ({"engine::qwen_oneshot_fp", "engine::qwen_chunk_spec_int8", "model::mixtral"},
                  {"engine::mixtral_oneshot_fp", "model::qwen"})


def _configs(arch, cf, experts=None):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    out = []
    for cfg in (jcfg, tcfg):
        m = dataclasses.replace(cfg.moe, capacity_factor=cf)
        if experts is not None:
            m = dataclasses.replace(m, num_experts=experts)
        out.append(dataclasses.replace(cfg, moe=m))
    return out


def _ctx():
    return TCtx(sp_size=N, device="cpu", block_q=8, block_kv=8)


def _jax_params(jcfg):
    return jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.PRNGKey(0)))


def _block_params(case):
    """One layer's MoE params, with norm gains drawn off their init: JAX's
    layer 1, or (padded) the port's ``init_params`` under a ring of 4."""
    arch, cf, experts, _ = BLOCKS[case]
    jcfg, tcfg = _configs(arch, cf, experts)
    if experts is None:
        p = {k: v[1] for k, v in _jax_params(jcfg)["layers"]["moe"].items()}
    else:
        tp = ttfm.init_params(tcfg, seed=0, device="cpu", ctx=_ctx())
        p = {k: v[0].numpy() for k, v in tp["layers"]["moe"].items()}
    rng = np.random.default_rng(len(case))
    p["ln"] = rng.uniform(-0.5, 0.5, p["ln"].shape).astype(np.float32)
    return p


def _prompts(vocab):
    rng = np.random.default_rng(4)
    out = [rng.integers(0, vocab, (n,), dtype=np.int32) for n, _ in TRACE]
    out[1] = np.tile(out[1][:4], 4)
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every JAX output of the module, from two subprocesses
    (``_WORKER_GROUPS``) started when the first test asks for them, so they
    run side by side and while the port's side does.  -> a function
    that waits for them and returns (inputs, outputs)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = {}
    for i, (case, (arch, cf, experts, length)) in enumerate(BLOCKS.items()):
        key = f"block::{case}"
        jcfg, _ = _configs(arch, cf, experts)
        inputs.update({f"{key}::arch": np.asarray(arch), f"{key}::cf": np.asarray(cf)})
        if experts is not None:
            inputs[f"{key}::experts"] = np.asarray(experts)
        inputs[f"{key}::x"] = np.random.default_rng(20 + i).standard_normal(
            (B, length, jcfg.d_model)).astype(np.float32)
        for name, leaf in _block_params(case).items():
            inputs[f"{key}::p::{name}"] = leaf
    for case, arch in MODELS.items():
        key = f"model::{case}"
        inputs.update({f"{key}::arch": np.asarray(arch), f"{key}::cf": np.asarray(1.25),
                       f"{key}::seq": np.asarray(S), f"{key}::batch": np.asarray(B)})
    for case, (arch, kw) in ENGINES.items():
        key = f"engine::{case}"
        prompts = _prompts(jget_config(arch).reduced().vocab_size)
        padded = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
        for row, p in zip(padded, prompts):
            row[: len(p)] = p
        inputs.update({f"{key}::arch": np.asarray(arch), f"{key}::cf": np.asarray(1.25),
                       f"{key}::serve": np.asarray(json.dumps({**SERVE, **kw})),
                       f"{key}::prompts": padded,
                       f"{key}::lengths": np.asarray([n for n, _ in TRACE]),
                       f"{key}::arrivals": np.asarray([t for _, t in TRACE]),
                       f"{key}::new_tokens": np.asarray(NEW_TOKENS)})
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    procs = []
    for group, cases in enumerate(_WORKER_GROUPS):
        np.savez(tmp / f"inputs{group}.npz", **{
            k: v for k, v in inputs.items()
            if k.split("::")[0] == "block" and group or "::".join(k.split("::")[:2]) in cases})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp / f"inputs{group}.npz"), str(tmp / f"out{group}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    result = {}

    def wait():
        if not result:
            for group, proc in enumerate(procs):
                try:
                    log, _ = proc.communicate(timeout=TIME_LIMIT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    pytest.fail(f"JAX's worker did not finish within {TIME_LIMIT_S} s")
                assert proc.returncode == 0, log
                result.update(dict(np.load(tmp / f"out{group}.npz")))
        return inputs, result

    yield wait
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(autouse=True)
def _start_the_oracle(oracle):
    """Every test of the module starts the JAX subprocess first."""


class _Drops:
    """Counts the entries capacity drops, and the [B, S] of every
    ``moe_block`` call, while the port runs."""

    def __init__(self, monkeypatch):
        self.dropped, self.shapes = 0, []
        dispatch, block = tmoe._dispatch_indices, tmoe.moe_block

        def counting(idx, E, C):
            slot, valid = dispatch(idx, E, C)
            self.dropped += int((~valid).sum())
            return slot, valid

        def recording(x, *args, **kwargs):
            self.shapes.append(tuple(x.shape[:2]))
            return block(x, *args, **kwargs)

        monkeypatch.setattr(tmoe, "_dispatch_indices", counting)
        monkeypatch.setattr(tmoe, "moe_block", recording)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=0)


def _port_block(case, x, monkeypatch=None):
    arch, cf, experts, _ = BLOCKS[case]
    _, tcfg = _configs(arch, cf, experts)
    tp = {k: torch.tensor(v) for k, v in _block_params(case).items()}
    ctx = _ctx()
    drops = _Drops(monkeypatch) if monkeypatch is not None else None
    y, aux = tmoe.moe_block(torch.from_numpy(x), tp, tcfg, ctx)
    return tcfg, ctx, y, aux, drops


def _a2a_bytes(tcfg, shapes, itemsize=4, n=N):
    """The reckoning: per ``moe_block`` call that dispatches over the ring (S
    a multiple of n), one rank's [B, E, C_loc, D] buffer, (n - 1) / n of it
    sent, once each way."""
    m = tcfg.moe
    E = math.ceil(m.num_experts / n) * n
    total = 0
    for b, s in shapes:
        if s % n == 0:
            c = math.ceil(s // n * m.top_k * m.capacity_factor / E)
            total += b * E * c * tcfg.d_model * itemsize * (n - 1) // n
    return total


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax_at_sp4(oracle, case, monkeypatch):
    inputs, out = oracle()
    key = f"block::{case}"
    x = inputs[f"{key}::x"]
    tcfg, ctx, y, aux, drops = _port_block(case, x, monkeypatch)
    _close(y, out[f"{key}::y"], BLOCK_TOL)
    _close(aux, out[f"{key}::aux"], AUX_TOL)
    segmented = tcfg.moe.mode == "ep" and x.shape[1] % N == 0
    assert ("moe_dispatch" in ctx.ring.stats.bytes) == segmented
    if segmented:
        _close(y, out[f"{key}::manual_y"], BLOCK_TOL)
        # the manual form's aux is a mean of per-rank terms (ROADMAP C.3)
        assert abs(float(out[f"{key}::manual_aux"]) - float(aux)) > AUX_TOL
    if case in ("qwen_cf1.25", "qwen_padded", "mixtral_tp"):
        assert drops.dropped > 0 and (int(out[f"{key}::drops"]) > 0) == segmented
    if case == "qwen_cf8":
        assert drops.dropped == int(out[f"{key}::drops"]) == 0


def test_padded_experts_come_from_init_params():
    """6 experts over 4 ranks pad to 8 in the port's ``init_params(ctx=...)``
    as in JAX's, router columns and expert leaves alike; one rank keeps 6,
    and the "tp" arch never pads."""
    _, tcfg = _configs(QWEN, 1.25, 6)
    p = ttfm.init_params(tcfg, seed=0, device="cpu", ctx=_ctx())["layers"]["moe"]
    jcfg, _ = _configs(QWEN, 1.25, 6)

    class _OnAxisOf4:  # JAX's padded_experts reads sp_size alone
        sp_size = N

    assert jmoe.padded_experts(jcfg, _OnAxisOf4) == tmoe.padded_experts(tcfg, _ctx()) == 8
    assert p["router"].shape[-1] == p["we1"].shape[1] == p["we2"].shape[1] == 8
    assert ttfm.init_params(tcfg, device="cpu")["layers"]["moe"]["router"].shape[-1] == 6
    _, mix = _configs(MIXTRAL, 1.25, 6)
    assert ttfm.init_params(mix, device="cpu", ctx=_ctx())["layers"]["moe"]["we1"].shape[1] == 6


def test_unpadded_experts_over_the_ring_raise():
    _, tcfg = _configs(QWEN, 1.25, 6)
    p = {k: v[0] for k, v in ttfm.init_params(tcfg, device="cpu")["layers"]["moe"].items()}
    with pytest.raises(ValueError, match="init_params"):
        tmoe.moe_block(torch.zeros((1, 8, tcfg.d_model)), p, tcfg, _ctx())


# --------------------------------------------------------------------------
# counts and determinism
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["qwen_cf1.25", "qwen_padded"])
def test_block_all_to_all_counts_and_repeat(oracle, case):
    inputs, _ = oracle()
    x = inputs[f"block::{case}::x"]
    tcfg, ctx, y, aux, _ = _port_block(case, x)
    want = _a2a_bytes(tcfg, [x.shape[:2]])
    st = ctx.ring.stats
    assert st.bytes["moe_dispatch"] == st.bytes["moe_return"] == want > 0
    assert st.hops["moe_dispatch"] == st.hops["moe_return"] == 1
    assert st.messages["moe_dispatch"] == st.messages["moe_return"] == 1
    _, _, y2, aux2, _ = _port_block(case, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_a_nan_token_stays_in_its_rows(oracle):
    """A NaN token reaches only its own row's output: dropped entries land
    in the spare row, and the all-to-alls move every rank's buffer whole."""
    inputs, _ = oracle()
    x = inputs["block::qwen_cf1.25::x"].copy()
    x[0, 3] = np.nan
    _, _, y, _, _ = _port_block("qwen_cf1.25", x)
    # router and aux see the NaN (global softmax statistics), the other
    # batch row never does
    assert bool(torch.isfinite(y[1]).all())


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_forward_loss_and_grads_match_jax_at_sp4(oracle, case, monkeypatch):
    inputs, out = oracle()
    key = f"model::{case}"
    jcfg, tcfg = _configs(MODELS[case], 1.25)
    tp = params_from_jax(_jax_params(jcfg), device="cpu")
    batch = {k: torch.from_numpy(out[f"{key}::{k}"]) for k in ("tokens", "positions", "labels")}
    ctx = _ctx()
    with torch.no_grad():
        logits = ttfm.forward(tp, tcfg, ctx, batch)
    _close(logits, out[f"{key}::logits"], LOGIT_TOL)
    named = list(tadamw.tree_leaves(tp))
    leaves = [leaf.requires_grad_(True) for _, leaf in named]
    drops = _Drops(monkeypatch)
    loss, metrics = ttfm.loss_fn(tp, tcfg, ctx, batch)
    grads = torch.autograd.grad(loss, leaves)
    for name in ("loss", "ce", "aux"):
        _close(metrics[name], out[f"{key}::{name}"], LOSS_TOL)
    assert drops.dropped > 0
    for (name, _), g in zip(named, grads):
        want = out[f"{key}::g::{name}"]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        _close(g, want, GRAD_REL * scale)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_streams_match_jax_at_sp4(oracle, case, monkeypatch):
    from repro_torch.kernels import paged_decode as pk

    inputs, out = oracle()
    key = f"engine::{case}"
    arch, kw = ENGINES[case]
    jcfg, tcfg = _configs(arch, 1.25)
    tp = params_from_jax(_jax_params(jcfg), device="cpu")
    decode_rows = []
    real_decode = pk.paged_flash_decode

    def decode(q, *args, **kwargs):
        decode_rows.append(q.shape[0])
        return real_decode(q, *args, **kwargs)

    monkeypatch.setattr(pk, "paged_flash_decode", decode)
    drops = _Drops(monkeypatch)
    eng = TEngine(tcfg, tp, _ctx(), serve=TServe(**SERVE, **kw))
    rids = [eng.submit(p, NEW_TOKENS, arrival_tick=t)
            for p, (_, t) in zip(_prompts(tcfg.vocab_size), TRACE)]
    done = eng.run()
    assert all(done[r].status == "ok" for r in rids)
    assert [done[r].generated for r in rids] == out[f"{key}::streams"].tolist()
    assert [list(done[r].token_ticks) for r in rids] == out[f"{key}::ticks"].tolist()
    assert drops.dropped > 0 and int(out[f"{key}::drops"]) > 0
    assert eng.kv_cache_stats()["pages_in_use"] == 0
    # one #4 / 4q launch per layer and decode tick, the 4 ranks folded
    L = tcfg.num_layers
    assert len(decode_rows) == L * eng.decode_launches > 0
    assert set(decode_rows) == {SERVE["num_slots"] * N}
    ring = eng.tick_stats()["ring_bytes"]
    if tcfg.moe.mode == "ep":
        want = _a2a_bytes(tcfg, drops.shapes)
        assert ring["moe_dispatch"] == ring["moe_return"] == want > 0
        if kw.get("spec_k"):
            # the verify windows ([slots, spec_k]: 4 rows, a multiple of the
            # ranks) dispatch over the ring, as JAX's do; decode rows do not
            assert eng.verify_launches > 0
            assert {(3, 1), (3, 4), (3, 16)} == set(drops.shapes)
    else:
        assert "moe_dispatch" not in ring
