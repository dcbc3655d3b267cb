"""The port's training path over a sequence-parallel ring (``sp_size = 4``
on a ``VirtualRing``) against the JAX package at ``sp_size = 1``, fp32, on
the CPU.

Weights come from JAX's ``init_params`` through ``convert.params_from_jax``;
the batch is JAX's ``make_batch`` (unstriped), which the test stripes for
the port as the port's own ``make_batch`` does.  The limits are the
train-parity ones of tests/test_torch_train.py: loss 1e-5, every gradient
leaf 1e-4."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.core.tiling import stripe_permutation
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.parallel.ring import VirtualRing
from repro_torch.train import loop as tloop

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
N = 4
SEQ, BATCH = 32, 2


def _jax_leaves(tree):
    return {
        "/".join(str(e.key) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module", params=["granite-8b", "paper-mha-7b"])
def model(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    assert tcfg.causal_layout == "striped"
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg


_JAX_RING_REFERENCE = {}


def _jax_ring_reference(jcfg, jparams, docs):
    """JAX's batch, loss and gradients at sp_size 1 for the ring tests of
    ``jparams``: the same for the mesh and the ring backend, so computed
    once per weights and documents."""
    key = (id(jparams), docs)
    if key not in _JAX_RING_REFERENCE:
        jbatch = jpipe.make_batch(jcfg, SEQ, BATCH, seed=5, step=2, docs=docs)
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, jcfg, JCtx(), jbatch), has_aux=True)(jparams)
        _JAX_RING_REFERENCE[key] = (jparams, jbatch, jloss, jgrads)
    return _JAX_RING_REFERENCE[key][1:]


@pytest.mark.parametrize("impl", ["mesh", "ring"])
@pytest.mark.parametrize("docs", [None, 2], ids=["causal", "docs"])
def test_ring_loss_and_grads_match_jax(model, impl, docs):
    jcfg, jparams, tcfg = model
    jbatch, jloss, jgrads = _jax_ring_reference(jcfg, jparams, docs)
    perm = stripe_permutation(SEQ, N)
    batch = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[..., perm]))
             for k, v in jbatch.items()}
    ctx = TCtx(sp_size=N, attn_impl=impl, mesh_a=2 if impl == "mesh" else None, device="cpu",
               block_q=16, block_kv=16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = list(tadamw.tree_leaves(tparams))
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    ctx.ring.stats.reset()
    loss, metrics = ttfm.loss_fn(tparams, tcfg, ctx, batch)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=LOSS_TOL, rtol=0)
    jg = _jax_leaves(jgrads)
    for (name, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], atol=GRAD_TOL, rtol=0, err_msg=name)
    # the attention really ran over the ring: KV hops in every layer's
    # forward (twice with remat) and backward
    L = tcfg.num_layers
    kv_hops = ctx.ring.stats.hops["recv_kv"]
    assert kv_hops == L * (2 + 1) * (N // (2 if impl == "mesh" else 1) - 1)


def test_make_batch_stripes_for_a_ring(model):
    _, _, tcfg = model
    one = tpipe.make_batch(tcfg, SEQ, BATCH, seed=1, step=3, ctx=TCtx(device="cpu"), docs=2)
    four = tpipe.make_batch(tcfg, SEQ, BATCH, seed=1, step=3, ctx=TCtx(sp_size=N, device="cpu"),
                            docs=2)
    perm = torch.from_numpy(stripe_permutation(SEQ, N))
    assert sorted(one) == sorted(four) == ["labels", "mask", "positions", "segments", "tokens"]
    for key, t in one.items():
        assert torch.equal(four[key], t[..., perm]), key


def test_fit_on_the_virtual_ring_matches_one_rank(model):
    """3 steps of ``fit`` at sp_size 4 (mesh, a = 2) give the losses of the
    same run at sp_size 1 (the same stream, striped)."""
    _, _, tcfg = model
    tc = tloop.TrainConfig(steps=3, seq=SEQ, batch=BATCH, seed=0)
    one = tloop.fit(tcfg, TCtx(device="cpu"), tc)
    ring = VirtualRing(N)
    four = tloop.fit(tcfg, TCtx(sp_size=N, ring=ring, mesh_a=2, device="cpu"), tc)
    assert len(four["history"]) == 3 and all(np.isfinite(four["history"]))
    np.testing.assert_allclose(four["history"], one["history"], atol=LOSS_TOL, rtol=0)
    assert ring.stats.hops["recv_q"] > 0 and ring.stats.hops["send_dq"] > 0


def test_forward_launch_counts_follow_the_schedules(monkeypatch):
    """One forward launch per computed block (the ranks folded into the
    batch), one backward pair per block per rank; with segment ids the
    forward launches once per rank too."""
    calls = {"fwd": 0, "bwd": 0}
    real_f, real_b = ops.block_attention, ops.block_attention_bwd
    monkeypatch.setattr(ops, "block_attention",
                        lambda *a, **k: calls.__setitem__("fwd", calls["fwd"] + 1) or real_f(*a, **k))
    monkeypatch.setattr(ops, "block_attention_bwd",
                        lambda *a, **k: calls.__setitem__("bwd", calls["bwd"] + 1) or real_b(*a, **k))
    cfg = dataclasses.replace(tget_config("paper-mha-7b").reduced(), num_layers=1)
    params = ttfm.init_params(cfg, device="cpu")
    for docs, fwd_per_block in ((None, 1), (2, N)):
        ctx = TCtx(sp_size=N, mesh_a=2, device="cpu", remat=False)
        batch = tpipe.make_batch(cfg, SEQ, 1, ctx=ctx, docs=docs)
        calls.update(fwd=0, bwd=0)
        leaves = [leaf.requires_grad_(True) for _, leaf in tadamw.tree_leaves(params)]
        loss, _ = ttfm.loss_fn(params, cfg, ctx, batch)
        torch.autograd.grad(loss, leaves)
        # a = b = 2 and nothing pruned: 4 blocks per rank
        assert calls == {"fwd": 4 * fwd_per_block, "bwd": 4 * N}, (docs, calls)


@pytest.mark.parametrize("attn", ["mesh", "ring"])
def test_launch_train_fake_devices(attn, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "paper-mha-7b", "--device", "cpu", "--reduced", "--steps", "2",
            "--seq", "32", "--batch", "1", "--fake-devices", "8", "--attn", attn, "--docs", "2"]
    if attn == "mesh":
        argv += ["--tile-a", "2"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    a = 2 if attn == "mesh" else 1
    assert f"ring=VirtualRing(n=4) attn={attn} a={a}" in out and "done: step=2" in out
