"""The port's sequence-sharded SSD scan (``repro_torch.models.ssm`` at
``ParallelCtx(sp_size=4)``, a ``VirtualRing`` on the CPU) against the JAX
package, for mamba2-370m and hymba-1.5b reduced, fp32, on JAX's weights
converted by ``params_from_jax``:

  * the SSD block at S 256 against JAX's ``shard_map`` block over a (2, 4)
    fake-device mesh (one subprocess, ``tests/jax_ssm_shard_worker.py``,
    since the device count is fixed when JAX starts) and against JAX's
    one-rank block: y, final state and conv tail within ``BLOCK_TOL``;
  * ranks shorter than the conv halo (S 8 and 4 over 4 ranks) against
    JAX's one-rank block only: JAX's sharded block takes its halo from the
    left neighbour's rows alone and goes wrong there (ROADMAP C.6);
  * the ring's hops, messages and bytes per comm kind against their formula;
  * the engine at sp_size 4 against JAX's single-device engine (streams,
    ticks, statuses), the scheduler's exact-mode refusals at n 4 against
    JAX's, and the serve CLI over the ring.

Inputs come from ``numpy.random.default_rng`` with the seed each case
states.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.config import ServeConfig as JServe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import Scheduler as TScheduler

ARCHS = ["mamba2-370m", "hymba-1.5b"]
N = 4
B, S = 2, 256
BLOCK_TOL = 1e-5  # tests/test_torch_ssm.py's: fp32 sums in another order
LOGIT_TOL = 1e-4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_ssm_shard_worker.py")
TIME_LIMIT_S = 240
# (prompt length, arrival tick): an 8-token prompt has 2 rows a rank, fewer
# than the conv halo's 3
TRACE = [(8, 0), (32, 0), (16, 1), (64, 2)]


def _jax_weights(arch):
    jcfg = jget_config(arch).reduced()
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    # nonzero A_log / dt_bias / D_skip, so the block's scalar parameters count
    rng = np.random.default_rng(1)
    jl = dict(jparams["layers"])
    jl["ssm"] = dict(jl["ssm"], **{
        name: jnp.asarray(rng.uniform(-0.5, 0.5, jl["ssm"][name].shape).astype(np.float32))
        for name in ("A_log", "dt_bias", "D_skip")
    })
    return jcfg, dict(jparams, layers=jl)


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


def _x(seed, S_, d_model):
    return np.random.default_rng(seed).standard_normal((B, S_, d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg, jp = _jax_weights(arch)
        tcfg = tget_config(arch).reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


@pytest.fixture(scope="module")
def shard_map_run(weights, tmp_path_factory):
    """JAX's shard_map block for every arch at S 256, started in its own
    process when the module's first test asks for the weights, so it runs
    while the tests that need no oracle do.  -> a function that waits for
    it and returns its outputs."""
    tmp = tmp_path_factory.mktemp("ssm_shard")
    inputs = {}
    for i, arch in enumerate(ARCHS):
        jcfg, jp, _, _ = weights[arch]
        inputs[f"{arch}::arch"] = np.asarray(arch)
        inputs[f"{arch}::x"] = _x(10 + i, S, jcfg.d_model)
        for name, leaf in _layer(jp["layers"]["ssm"], 1).items():
            inputs[f"{arch}::p::{name}"] = np.asarray(leaf)
    np.savez(tmp / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    proc = subprocess.Popen([sys.executable, WORKER, str(tmp / "inputs.npz"),
                             str(tmp / "out.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    result = {}

    def wait():
        if not result:
            try:
                log, _ = proc.communicate(timeout=TIME_LIMIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                pytest.fail(f"JAX's shard_map block did not finish within {TIME_LIMIT_S} s")
            assert proc.returncode == 0, log
            result.update(dict(np.load(tmp / "out.npz")))
        return inputs, result

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True)
def _start_the_oracle(shard_map_run):
    """Every test of the module starts the shard_map subprocess first."""


def _close(got, want, tol=BLOCK_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _port_block(tcfg, tlp, x):
    ctx = TCtx(sp_size=N, device="cpu")
    y, st = tssm.ssm_block(torch.from_numpy(x), tlp, tcfg, ctx, return_state=True)
    return y, st, ctx.ring.stats


def _one_rank_jax(jcfg, jlp, x):
    return jssm.ssm_block(jnp.asarray(x), jlp, jcfg, JCtx(), return_state=True)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length", [8, 4], ids=["local2", "local1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_short_ranks_match_the_one_rank_block(weights, arch, length):
    """Each rank holds fewer rows than the conv halo (width - 1 = 3): the
    halo comes from further left over repeated hops, and the block is the
    one-rank block.  JAX's sharded block takes only the left neighbour's
    rows here (it gives another y, or raises), so JAX's one-rank block is
    the oracle (ROADMAP C.6)."""
    jcfg, jp, tcfg, tp = weights[arch]
    x = _x(20 + length, length, jcfg.d_model)
    jy, jst = _one_rank_jax(jcfg, _layer(jp["layers"]["ssm"], 1), x)
    ty, tst, _ = _port_block(tcfg, _layer(tp["layers"]["ssm"], 1), x)
    _close(ty, jy)
    _close(tst["state"], jst["state"])
    # JAX keeps a prompt shorter than the window at the window's front
    # (ROADMAP C.2), so the tail is held where both are whole
    if length >= tcfg.ssm.conv_width - 1:
        _close(tst["conv"], jst["conv"])


def _want_counts(cfg, S_, n=N, batch=B, itemsize=4):
    """hops, messages and bytes one rank sends per kind, for one block."""
    d_inner = cfg.ssm.expand * cfg.d_model
    H, P, Nst, G = d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.state_dim, \
        cfg.ssm.n_groups
    conv_dim = d_inner + 2 * G * Nst
    need, m = cfg.ssm.conv_width - 1, S_ // n
    rounds = math.ceil(need / m)
    halo_rows = sum(min(k * m, need) for k in range(1, rounds + 1))
    return {
        "hops": {"ssd_halo": rounds, "ssd_state": 1, "ssd_tail": 1},
        "messages": {"ssd_halo": rounds, "ssd_state": 2, "ssd_tail": 1},
        "bytes": {"ssd_halo": batch * halo_rows * conv_dim * itemsize,
                  "ssd_state": batch * H * (P * Nst + 1) * 4,
                  "ssd_tail": batch * need * conv_dim * itemsize},
    }


@pytest.mark.parametrize("length", [S, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_counts_follow_the_formula(weights, arch, length):
    """Per block: ceil((width-1) / (S/n)) halo hops of the growing halo, one
    gather of (state, total decay) and one of the conv tails, in bytes one
    rank sends."""
    jcfg, _, tcfg, tp = weights[arch]
    _, _, stats = _port_block(tcfg, _layer(tp["layers"]["ssm"], 0), _x(3, length, jcfg.d_model))
    want = _want_counts(tcfg, length)
    assert {k: dict(getattr(stats, k)) for k in want} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_block_matches_jax_shard_map_and_one_rank(weights, shard_map_run, arch):
    jcfg, jp, tcfg, tp = weights[arch]
    inputs, out = shard_map_run()
    x = inputs[f"{arch}::x"]
    ty, tst, stats = _port_block(tcfg, _layer(tp["layers"]["ssm"], 1), x)
    assert stats.hops == {"ssd_halo": 1, "ssd_state": 1, "ssd_tail": 1}
    jy, jst = _one_rank_jax(jcfg, _layer(jp["layers"]["ssm"], 1), x)
    for want_y, want_state, want_conv in ((out[f"{arch}::y"], out[f"{arch}::state"],
                                           out[f"{arch}::conv"]),
                                          (jy, jst["state"], jst["conv"])):
        _close(ty, want_y)
        _close(tst["state"], want_state)
        _close(tst["conv"], want_conv)
    assert tst["state"].dtype == torch.float32


# --------------------------------------------------------------------------
# the engine, the scheduler, the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_sp4_matches_jax_single_device(weights, arch, monkeypatch):
    """The engine over a ring of 4 against JAX's single-device engine on a
    trace with an 8-token prompt: streams, ticks and statuses equal; per
    layer ONE scan launch per prefill with the 4 ranks folded into its
    batch."""
    jcfg, jp, tcfg, tp = weights[arch]
    batches = []
    real = tssd.ssd_scan_fwd

    def scan(x, *args, **kw):
        batches.append(x.shape[0])
        return real(x, *args, **kw)

    monkeypatch.setattr(tssm, "ssd_scan_fwd", scan)
    kw = dict(max_seq=128, num_slots=3)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32) for n, _ in TRACE]
    out = {}
    teng = TEngine(tcfg, tp, TCtx(sp_size=N, device="cpu"), serve=TServe(**kw))
    for side, eng in (("jax", JEngine(jcfg, jp, JCtx(), serve=JServe(**kw))), ("torch", teng)):
        rids = [eng.submit(p, 6, arrival_tick=t) for p, (_, t) in zip(prompts, TRACE)]
        done = eng.run()
        out[side] = [done[r] for r in rids]
    for g, w in zip(out["torch"], out["jax"]):
        assert g.status == w.status == "ok"
        assert g.generated == w.generated and g.token_ticks == w.token_ticks
    assert teng.prefill_launches == len(TRACE)
    assert batches == [N] * (tcfg.num_layers * len(TRACE))
    stats = teng.ctx.ring.stats
    assert stats.hops["ssd_state"] == stats.hops["ssd_tail"] == tcfg.num_layers * len(TRACE)
    if tcfg.hybrid:  # one lse combine per layer and decode tick
        assert stats.hops["combine"] == tcfg.num_layers * teng.decode_launches


def test_scheduler_refuses_at_n4_what_jax_refuses():
    """Exact mode at n = 4: a length that is no multiple of 4, and a
    per-rank length above the chunk that is no multiple of it, raise JAX's
    messages; the rest pass at their own length."""
    kw = dict(exact=True, multiple=N, chunk=8)
    j, t = JScheduler(2, (16, 64), 128, **kw), TScheduler(2, (16, 64), 128, **kw)
    for length in (8, 4, 32, 64, 96):
        assert t.bucket_for(length) == j.bucket_for(length) == length
    for length, match in ((10, "multiple of the sequence-parallel size"),
                          (36, "per-device prompt length")):
        with pytest.raises(ValueError, match=match) as jerr:
            j.bucket_for(length)
        with pytest.raises(ValueError) as terr:
            t.bucket_for(length)
        assert str(terr.value) == str(jerr.value)


def test_launch_serve_mamba2_over_the_ring(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--reduced", "--arch", "mamba2-370m",
                       "--fake-devices", "8", "--stream", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "VirtualRing(n=4)" in out and out.count("status=ok") == 4
