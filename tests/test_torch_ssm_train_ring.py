"""SSM and hybrid training over a sequence-parallel ring (``sp_size = 4`` on a
``VirtualRing``: the sequence-sharded SSD scan of ``models/ssm.py``, hymba's
attention through the mesh executor) against the JAX package at one device,
fp32, on the CPU, and the train CLI's tours, for mamba2-370m and hymba-1.5b
reduced.  JAX's own multi-device checks fail inside the reference (ROADMAP
"Port ground rules"), so its single-device gradients are the oracle.
Limits: tests/test_torch_train.py's, loss 1e-5 and every gradient leaf 1e-4.
"""

import jax
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.parallel.context import ParallelCtx as TCtx
from test_torch_ssm_train import (ARCHS, _assert_model_grads, _port_loss_and_grads,
                                  _to_torch_batch, _train_steps_match_jax,
                                  model)  # noqa: F401 (the fixture)

N_RING = 4


# --------------------------------------------------------------------------
# over a virtual ring of 4
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [32, 8], ids=["rows8", "rows2"])
def test_ring_loss_and_grads_match_jax(model, seq, monkeypatch):
    """At sp_size 4 on a VirtualRing (contiguous layout; hymba's attention
    through the mesh executor, a = 2) against JAX at one device; seq 8 leaves
    each rank 2 rows, fewer than the conv halo's 3 (ROADMAP C.6).  The scan
    runs once per layer and pass with the ranks folded into its batch (its
    backward too), and the final state's gradient reaches #5b."""
    jcfg, jparams, tcfg = model
    jbatch = jpipe.make_batch(jcfg, seq, 2, seed=6, step=3)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCtx(), jbatch), has_aux=True)(jparams)
    batches, dstates = [], []
    real_f, real_b = tssd._forward, tssd.ssd_scan_bwd
    monkeypatch.setattr(tssd, "_forward", lambda *a: batches.append(a[0].shape[0]) or real_f(*a))
    monkeypatch.setattr(tssd, "ssd_scan_bwd", lambda *a, **k: dstates.append(a[6]) or real_b(
        *a, **k))
    ctx = TCtx(sp_size=N_RING, mesh_a=2, device="cpu", block_q=16, block_kv=16, remat=False)
    loss, _, grads = _port_loss_and_grads(jparams, tcfg, ctx, _to_torch_batch(jbatch))
    _assert_model_grads(loss, grads, jloss, jgrads)
    L = tcfg.num_layers
    assert batches == [N_RING * 2] * L and len(dstates) == L
    assert all(d is not None and float(d.abs().max()) > 0 for d in dstates)
    hops = ctx.ring.stats.hops
    assert hops["ssd_state"] == hops["ssd_tail"] == L and hops["ssd_halo"] >= L


def test_train_steps_on_the_virtual_ring_match_jax(model):
    """Three make_train_step steps at sp_size 4 on a VirtualRing against
    JAX's single-device steps: loss and grad norm each step, then params and
    both AdamW moments."""
    ctx = TCtx(sp_size=N_RING, mesh_a=2, device="cpu", block_q=16, block_kv=16)
    _train_steps_match_jax(model, ctx)
    assert ctx.ring.stats.hops["ssd_state"] > 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fake", [0, 8], ids=["one_rank", "ring4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_ssm(arch, fake, capsys):
    from repro_torch.launch import train

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--seq", "16",
            "--batch", "1"]
    assert train.main(argv + (["--fake-devices", str(fake)] if fake else [])) == 0
    out = capsys.readouterr().out
    ring = "VirtualRing(n=4)" if fake else "ring=none"
    assert ring in out and "step 0: loss" in out and "done: step=2 final_loss=" in out
    final = float(out.rsplit("final_loss=", 1)[1].split()[0])
    assert np.isfinite(final)
