"""minicpm3-4b (MLA) over a sequence-parallel ring in the port
(``ParallelCtx(sp_size=4)``, a ``VirtualRing`` on the CPU) against JAX at
sp_size 4: JAX's ``forward``, ``loss_fn`` and ``ServeEngine`` over a (2, 4)
mesh of fake CPU devices with Auto axes, run in two subprocesses side by
side (``tests/jax_mla_ring_worker.py``, since the device count is fixed
when JAX starts; they take the weights drawn here), fp32, JAX's reduced
config, JAX's weights through ``params_from_jax``:

  * the block op with an autograd rule (``ops.differentiable_block_attention``,
    what the latent wire's blocks run under grad) against autograd through
    the plain attention, under a random cotangent on o AND lse (a rule that
    drops lse's cotangent is wrong only where blocks merge): a causal band,
    a window with segments, and ranks folded into the batch, to
    ``BLOCK_TOL``;
  * ``forward`` at sp_size 4 over the expanded heads and through the latent
    wire (causal, and packed documents with the wire) against JAX's, to
    ``LOGIT_TOL`` (JAX's ``check_mla_wire`` limit);
  * ``loss_fn`` and its gradients through the wire against ``jax.grad``
    through JAX's wire (loss 1e-5, every leaf 5e-5 of its largest entry),
    against the port's expanded heads to the same limit, and bitwise equal
    in the three ``comm_overlap`` modes;
  * ``ServeEngine`` at sp_size 4, wire off and on: streams and their ticks
    equal to JAX's, one-shot over the fp pool and chunked + speculative
    over an int8 pool (where JAX's engine never reaches the wire, so that
    one JAX run holds both); one #4 / 4q launch per layer and decode tick
    with the ranks folded;
  * the bytes: under the wire the KV hops carry (kvr + rope) / (2·H·qk) of
    the expanded heads' bytes, exactly, and the Q and O hops the same.

Under autograd on a ``ProcessGroupRing`` the wire raises, naming ROADMAP
A.9; that case runs in the gloo worker (``tests/torch_ring_worker.py``).
Inputs come from ``numpy.random.default_rng`` with the seed each case
states.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine

ARCH = "minicpm3-4b"
N = 4
B, S = 2, 32
BLOCK_TOL = 1e-5
LOGIT_TOL, LOSS_TOL, GRAD_REL = 3e-5, 1e-5, 5e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_mla_ring_worker.py")
TIME_LIMIT_S = 240
INF = tref.BAND_INF
# case -> (wire, documents a row (0: causal), gradients)
MODELS = {"expanded": (0, 0, 0), "wire": (1, 0, 1), "wire_docs": (1, 3, 0)}
# (prompt length, arrival tick); the 16-token prompt loops, so prompt
# lookup drafts and the verify window ([slots, spec_k]) runs
TRACE = [(8, 0), (16, 0), (28, 1)]
NEW_TOKENS = 6
RUNS = {"oneshot_fp": dict(paged=True, page_size=4),
        "chunk_spec_int8": dict(paged=True, page_size=4, prefill_chunk=8, tick_token_budget=32,
                                spec_k=4, kv_dtype="int8")}
ENGINES = {f"{run}_{'wire' if wire else 'expanded'}": (wire, run)
           for run in RUNS for wire in (0, 1)}
# the JAX engine each port engine is held to.  A chunked engine never
# reaches attention_block -- chunks, verifies and decode run over the cache
# -- so JAX's with the wire on is its run with the wire off: one JAX run
# holds both port runs
JAX_ENGINES = {case: case if "prefill_chunk" not in RUNS[run] else f"{run}_expanded"
               for case, (_, run) in ENGINES.items()}
SERVE = dict(max_seq=64, num_slots=3)
# the JAX cases of each worker process, for about equal compile times
_WORKER_GROUPS = ({f"engine::{case}" for case in set(JAX_ENGINES.values())},
                  {f"model::{case}" for case in MODELS})


def _configs():
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights():
    """JAX's weights (PRNGKey(0)) as numpy leaves by path, and as the
    port's."""
    jcfg, _ = _configs()
    jp = jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    leaves = {"/".join(str(e.key) for e in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return leaves, params_from_jax(jp, device="cpu")


def _params():
    return _weights()[1]


def _ctx(wire=False, mode="overlap"):
    return TCtx(sp_size=N, device="cpu", block_q=8, block_kv=8, mla_latent_wire=bool(wire),
                comm_overlap=mode)


def _prompts(vocab):
    rng = np.random.default_rng(4)
    out = [rng.integers(0, vocab, (n,), dtype=np.int32) for n, _ in TRACE]
    out[1] = np.tile(out[1][:4], 4)
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every JAX output of the module, from two subprocesses
    (``_WORKER_GROUPS``) started when the first test asks for them, so they
    run side by side and while the port's side does.  -> a function that
    waits for them and returns the outputs."""
    tmp = tmp_path_factory.mktemp("mla_ring")
    jcfg, _ = _configs()
    inputs = {}
    for case, (wire, docs, grad) in MODELS.items():
        key = f"model::{case}"
        inputs.update({f"{key}::arch": np.asarray(ARCH), f"{key}::wire": np.asarray(wire),
                       f"{key}::seq": np.asarray(S), f"{key}::batch": np.asarray(B),
                       f"{key}::docs": np.asarray(docs), f"{key}::grad": np.asarray(grad)})
    prompts = _prompts(jcfg.vocab_size)
    padded = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for row, p in zip(padded, prompts):
        row[: len(p)] = p
    for case in set(JAX_ENGINES.values()):
        wire, run = ENGINES[case]
        key = f"engine::{case}"
        inputs.update({f"{key}::arch": np.asarray(ARCH), f"{key}::wire": np.asarray(wire),
                       f"{key}::serve": np.asarray(json.dumps({**SERVE, **RUNS[run]})),
                       f"{key}::prompts": padded,
                       f"{key}::lengths": np.asarray([n for n, _ in TRACE]),
                       f"{key}::arrivals": np.asarray([t for _, t in TRACE]),
                       f"{key}::new_tokens": np.asarray(NEW_TOKENS)})
    weights = {f"params::{path}": leaf for path, leaf in _weights()[0].items()}
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    procs = []
    for group, cases in enumerate(_WORKER_GROUPS):
        np.savez(tmp / f"inputs{group}.npz", **weights, **{
            k: v for k, v in inputs.items() if "::".join(k.split("::")[:2]) in cases})
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
        return result

    yield wait
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(autouse=True)
def _start_the_oracle(oracle):
    """Every test of the module starts the JAX subprocesses first."""


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=0)


def _batch(out, case):
    key = f"model::{case}"
    return {name: torch.from_numpy(out[f"{key}::{name}"])
            for name in ("tokens", "positions", "labels", "segments", "mask")
            if f"{key}::{name}" in out}


_GRADS = {}


def _port_grads(out, wire, mode="overlap"):
    """(loss, metrics, {leaf path: gradient}, the ring's bytes) of the
    port's loss_fn at sp_size 4 on JAX's "wire" batch (each computed once
    per module)."""
    if (wire, mode) not in _GRADS:
        tp = tadamw.tree_map(lambda x: x.detach().clone().requires_grad_(True), _params())
        named = list(tadamw.tree_leaves(tp))
        ctx = _ctx(wire, mode)
        loss, metrics = ttfm.loss_fn(tp, _configs()[1], ctx, _batch(out, "wire"))
        grads = torch.autograd.grad(loss, [leaf for _, leaf in named])
        _GRADS[wire, mode] = (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                              {name: g for (name, _), g in zip(named, grads)},
                              dict(ctx.ring.stats.bytes))
    return _GRADS[wire, mode]


# --------------------------------------------------------------------------
# the block op's autograd rule
# --------------------------------------------------------------------------

# name -> (batch, band (one, or per row), band groups, segments)
BLOCKS = {
    "causal": (2, (0, 0, 0, INF), None, False),
    "window_segments": (1, (0, 0, -5, 0), None, True),
    # 4 ranks x 2 rows folded: one band a rank, as the wire's blocks launch
    "folded_ranks": (8, [(r, (r + 1) % 4, 0, INF) for r in range(4) for _ in range(2)], 4,
                     False),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_rule_matches_autograd_through_the_plain_attention(name):
    batch, band, groups, seg = BLOCKS[name]
    Sq, H, Hkv, D = 12, 4, 2, 16
    rng = np.random.default_rng(len(name))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((batch, Sq, H, D), (batch, Sq, Hkv, D), (batch, Sq, Hkv, D),
                             (batch, Sq, H, D)))
    dlse = torch.from_numpy(rng.standard_normal((batch, H, Sq)).astype(np.float32))
    kw = {}
    if seg:
        ids = torch.from_numpy(np.sort(rng.integers(0, 3, Sq)).astype(np.int32))
        kw = dict(seg_q=ids, seg_kv=ids)
    stride = 4 if groups else 1
    per_row = isinstance(band, list)
    band_t = torch.tensor(band, dtype=torch.int32) if per_row else band
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    o, lse = tops.differentiable_block_attention(q, k, v, band_t, groups=groups,
                                                 stride_q=stride, stride_kv=stride, **kw)
    got = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), (q, k, v),
                              retain_graph=True)
    rows = band if per_row else [band] * batch
    want_o, want_lse = zip(*(tref.attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], band=rows[b],
                                                stride_q=stride, stride_kv=stride, **kw)
                             for b in range(batch)))
    want_o, want_lse = torch.cat(want_o), torch.cat(want_lse)
    want = torch.autograd.grad((want_o * do).sum() + (want_lse * dlse).sum(), (q, k, v))
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for g, w in zip(got, want):
        _close(g, w.detach(), BLOCK_TOL)
    # lse's cotangent matters: without it the gradients part
    bare = torch.autograd.grad((o * do).sum(), (q, k, v))
    assert float((bare[0] - got[0]).abs().max()) > 100 * BLOCK_TOL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


_FORWARDS = {}


def _port_forward(out, case):
    """The port's logits at sp_size 4 on JAX's batch of ``case``, and the
    ring's bytes per comm kind (each case computed once per module)."""
    if case not in _FORWARDS:
        wire, _, _ = MODELS[case]
        ctx = _ctx(wire)
        with torch.no_grad():
            logits = ttfm.forward(_params(), _configs()[1], ctx, _batch(out, case))
        _FORWARDS[case] = logits, dict(ctx.ring.stats.bytes)
    return _FORWARDS[case]


@pytest.mark.parametrize("case", list(MODELS))
def test_forward_matches_jax_at_sp4(oracle, case):
    out = oracle()
    logits, nbytes = _port_forward(out, case)
    _close(logits, out[f"model::{case}::logits"], LOGIT_TOL)
    assert nbytes["recv_kv"] > 0 and nbytes["recv_q"] > 0


def test_wire_loss_and_grads_match_jax_at_sp4(oracle):
    """loss_fn through the wire against jax.value_and_grad through JAX's
    wire, and against the port's expanded heads: the latent's gradient
    reaches wkv_a through every expansion of every slot."""
    out = oracle()
    loss, metrics, grads, _ = _port_grads(out, wire=True)
    _close(loss, out["model::wire::loss"], LOSS_TOL)
    _close(metrics["ce"], out["model::wire::ce"], LOSS_TOL)
    _, _, expanded, _ = _port_grads(out, wire=False)
    assert set(grads) == {k[len("model::wire::g::"):] for k in out
                          if k.startswith("model::wire::g::")}
    for name, g in grads.items():
        want = out[f"model::wire::g::{name}"]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        _close(g, want, GRAD_REL * scale)
        _close(g, expanded[name], GRAD_REL * scale)


def test_wire_grads_are_bitwise_equal_across_comm_overlap_modes(oracle):
    out = oracle()
    _, _, base, base_bytes = _port_grads(out, wire=True)
    for mode in ("serial", "bidir"):
        _, _, grads, nbytes = _port_grads(out, wire=True, mode=mode)
        assert nbytes == base_bytes
        for name, g in grads.items():
            assert torch.equal(g, base[name]), (mode, name)


def test_the_wire_moves_the_latent(oracle):
    """Per KV hop the wire carries the latent, (kvr + rope) / (2·H·qk) of the
    expanded heads' (k, v) bytes, exactly; the Q hops and O sends move the
    same bytes.  Under autograd the wire's counted hops are its forward's
    only (remat runs it twice per layer): the gradients that autograd sends
    back through the hops' index selects are not counted, where the expanded
    heads' count holds the Algorithm-3 backward's hops too.  So a training
    step's ring bytes, wire against expanded, are not like for like."""
    out = oracle()
    _, tcfg = _configs()
    m = tcfg.mla
    ratio = (m.kv_lora_rank + m.qk_rope_head_dim, 2 * tcfg.num_heads * (m.qk_nope_head_dim
                                                                         + m.qk_rope_head_dim))
    _, expanded = _port_forward(out, "expanded")
    _, wire = _port_forward(out, "wire")
    assert wire["recv_kv"] * ratio[1] == expanded["recv_kv"] * ratio[0] > 0
    assert {k: v for k, v in wire.items() if k != "recv_kv"} == \
        {k: v for k, v in expanded.items() if k != "recv_kv"}
    _, _, _, grad_wire = _port_grads(out, wire=True)
    assert grad_wire["recv_kv"] == 2 * wire["recv_kv"]
    assert grad_wire["recv_q"] == 2 * expanded["recv_q"]
    assert set(grad_wire) == {"recv_q", "recv_kv", "send_o"}


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_streams_match_jax_at_sp4(oracle, case, monkeypatch):
    from repro_torch.kernels import paged_decode as pk

    out = oracle()
    wire, run = ENGINES[case]
    _, tcfg = _configs()
    decode_rows = []
    real_decode = pk.paged_flash_decode

    def decode(q, *args, **kwargs):
        decode_rows.append(q.shape[0])
        return real_decode(q, *args, **kwargs)

    monkeypatch.setattr(pk, "paged_flash_decode", decode)
    eng = TEngine(tcfg, _params(), _ctx(wire), serve=TServe(**SERVE, **RUNS[run]))
    rids = [eng.submit(p, NEW_TOKENS, arrival_tick=t)
            for p, (_, t) in zip(_prompts(tcfg.vocab_size), TRACE)]
    done = eng.run()
    key = f"engine::{JAX_ENGINES[case]}"
    assert all(done[r].status == "ok" for r in rids)
    assert [done[r].generated for r in rids] == out[f"{key}::streams"].tolist()
    assert [list(done[r].token_ticks) for r in rids] == out[f"{key}::ticks"].tolist()
    kv = eng.kv_cache_stats()
    assert kv["pages_in_use"] == kv["scale_entries_in_use"] == 0
    # the latent pool: one head of kvr + rope, sharded over the ranks
    assert eng._cache["k"].shape[-2:] == ttfm.attn_cache_dims(tcfg)
    # one #4 / 4q launch per layer and decode tick, the 4 ranks folded
    assert len(decode_rows) == tcfg.num_layers * eng.decode_launches > 0
    assert set(decode_rows) == {SERVE["num_slots"] * N}
    ring = eng.tick_stats()["ring_bytes"]
    if "prefill_chunk" in RUNS[run]:
        assert eng.chunk_launches > 0 and eng.verify_launches > 0
        assert set(ring) == {"combine"}
    else:
        assert ring["recv_kv"] > 0 and eng.prefill_launches > 0
