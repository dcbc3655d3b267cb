"""The port's MoE layer (``repro_torch/models/moe.py``) and the MoE decoder
against the JAX package, fp32, on the CPU: the dispatch indices bit for bit
(ties among expert ids), the router (choices exactly, weights and the aux
term 1e-6), ``moe_block`` at three capacity factors (1e-5: one sort, one
gather and a few fp32 products apart) and in bf16 at two (BF16_BLOCK_REL),
and ``forward`` / ``loss_fn`` with their gradients (loss 1e-5, each gradient
leaf within 5e-5 of its largest entry).  Weights are JAX's ``init_params`` carried over by
``params_from_jax``; inputs come from numpy with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.models.layers import rms_norm as jrms_norm
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import rms_norm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
JCTX = JCtx()
TCTX = TCtx(device="cpu")
ROUTE_TOL, BLOCK_TOL, LOSS_TOL, GRAD_REL = 1e-6, 1e-5, 1e-5, 5e-5
# moe_block in bf16 against JAX's in bf16, of the output's largest entry.
# Both sides route identically (the fp32 router over the same bf16 h:
# choices and bf16 weights are compared exactly), but XLA computes
# silu(up) * gate fused in fp32 with its own logistic, so about a third of
# the bf16 roundings of the expert hidden differ by one ulp; through the
# product with we2 these add up to 6.2e-3 - 8.4e-3 of the largest entry
# (readings on a CPU), as much as bf16 itself moves the block (JAX bf16 vs
# fp32: 6.8e-3 - 7.0e-3).  The limit is 4x the readings; a dropped shared
# expert (0.83) or top-k weights left unnormalised (0.26 - 0.30) exceed it
# 8-26x.
BF16_BLOCK_REL = 2.0**-5


def _configs(arch, cf=None):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg


# (T, K, E, C): few experts and small capacities, so equal ids abound and
# capacity drops entries
DISPATCH = [(12, 2, 4, 3), (7, 4, 60, 1), (16, 1, 3, 2), (9, 2, 2, 40)]


@pytest.mark.parametrize("T,K,E,C", DISPATCH)
def test_dispatch_indices_bitwise(T, K, E, C):
    rng = np.random.default_rng(T * 100 + E)
    idx = rng.integers(0, min(E, 3), (3, T, K)).astype(np.int32)
    got_slot, got_valid = tmoe._dispatch_indices(torch.from_numpy(idx), E, C)
    for b in range(3):
        want_slot, want_valid = jmoe._dispatch_indices(jnp.asarray(idx[b]), E, C)
        np.testing.assert_array_equal(got_slot[b].numpy(), np.asarray(want_slot))
        np.testing.assert_array_equal(got_valid[b].numpy(), np.asarray(want_valid))
    # kept entries own their slots: no two valid entries share one
    kept = got_slot[got_valid.reshape(got_slot.shape)].reshape(-1)
    per_row = got_slot.reshape(3, -1)[0][got_valid.reshape(3, -1)[0]]
    assert per_row.unique().numel() == per_row.numel() and kept.numel() > 0
    if T * K > E * C:
        assert not bool(got_valid.all())


@pytest.mark.parametrize("case", ["random", "ties", "padded"])
def test_route_matches_jax(model, case):
    """Choices exactly, weights and aux to 1e-6.  "ties": the router's
    columns come in equal pairs, so probabilities tie exactly and the lower
    expert id must come first on both sides; "random" has no exact tie
    within the top-k + 1 (asserted), so the order is not a tie-break;
    "padded": the router has the columns of expert parallelism's padding
    (``padded_experts`` over a ring of 3: qwen2-moe's 4 experts pad to 6,
    mixtral's "tp" mode pads none), which never win."""
    jcfg, jp, tcfg = model
    E = jcfg.moe.num_experts
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    w = np.array(jp["layers"]["moe"]["router"][0])
    E_pad = E
    if case == "ties":
        w = np.repeat(w[:, : E // 2], 2, axis=1)
    if case == "padded":
        gen = torch.Generator().manual_seed(0)
        ring = TCtx(sp_size=3, device="cpu")
        E_pad = tmoe.padded_experts(tcfg, ring)
        padded = tmoe.init_moe_params(gen, tcfg, 1, torch.float32, "cpu", ctx=ring)
        assert padded["router"].shape[-1] == E_pad == (
            6 if tcfg.moe.mode == "ep" else E)
        w = np.concatenate([w, 10 * rng.standard_normal((w.shape[0], E_pad - E))], 1)
        w = w.astype(np.float32)
    idx_j, w_j, aux_j = jmoe._route(jnp.asarray(h), jnp.asarray(w), jcfg, E_pad)
    idx_t, w_t, aux_t = tmoe._route(torch.from_numpy(h), torch.from_numpy(w), tcfg, E_pad)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ROUTE_TOL, rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=ROUTE_TOL, rtol=0)
    assert int(idx_t.max()) < E
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(w[:, :E]), -1)), -1)
    k = jcfg.moe.top_k
    gaps = np.diff(probs[..., -(k + 1):], axis=-1)
    if case == "ties":
        assert (gaps == 0).any()
    else:
        assert (gaps > 0).all()


@pytest.mark.parametrize("cf,dtype", [
    pytest.param(0.25, "fp32", id="0.25"), pytest.param(1.25, "fp32", id="1.25"),
    pytest.param(8.0, "fp32", id="8.0"), pytest.param(1.25, "bf16", id="bf16-1.25"),
    pytest.param(8.0, "bf16", id="bf16-8.0")])
def test_moe_block_matches_jax(model, cf, dtype):
    """One layer's block on [3, 16] rows, capacity from S = 16: at cf 0.25
    and 1.25 capacity drops entries (asserted), at 8.0 none.  bf16: every
    leaf but the fp32 router and the input in bf16 on both sides, the input
    scaled by 2**-6 (exact in bf16; the norm undoes it) so that the
    residual does not round away the block's own output; the route is
    compared exactly, the output to BF16_BLOCK_REL of its largest entry."""
    jcfg, jp, tcfg = model
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
                  for c in (jcfg, tcfg))
    lp = jax.tree.map(lambda a: a[1], jp["layers"]["moe"])
    x = np.random.default_rng(11).standard_normal((3, 16, jcfg.d_model)).astype(np.float32)
    if dtype == "bf16":
        lp = {k: a if k == "router" else a.astype(jnp.bfloat16) for k, a in lp.items()}
        x = np.array(jnp.asarray(x / 64, jnp.bfloat16).astype(jnp.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, lp), device="cpu")
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    yj, auxj = jmoe.moe_block(xj, lp, jcfg, JCTX)
    yt, auxt = tmoe.moe_block(xt, tp, tcfg, TCTX)
    np.testing.assert_allclose(float(auxt), float(auxj), atol=ROUTE_TOL, rtol=0)
    m = tcfg.moe
    h = rms_norm(xt, tp["ln"])
    idx, w, _ = tmoe._route(h, tp["router"], tcfg, m.num_experts)
    if dtype == "bf16":
        assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
        idx_j, w_j, _ = jmoe._route(jrms_norm(xj, lp["ln"]), lp["router"], jcfg,
                                    m.num_experts)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.float().numpy(), np.asarray(w_j.astype(jnp.float32)))
        want = np.asarray(yj.astype(jnp.float32))
        np.testing.assert_allclose(yt.float().numpy(), want,
                                   atol=BF16_BLOCK_REL * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=BLOCK_TOL, rtol=0)
    C = int(np.ceil(16 * m.top_k * cf / m.num_experts))
    _, valid = tmoe._dispatch_indices(idx, m.num_experts, C)
    assert bool(valid.all()) == (cf == 8.0)


def test_moe_block_keeps_a_nan_row_to_itself(model):
    """A NaN token poisons its own row only: capacity is per row and dropped
    entries are never written."""
    jcfg, jp, tcfg = model
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["moe"]),
                         device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 8, jcfg.d_model))
                         .astype(np.float32))
    clean, _ = tmoe.moe_block(x, tp, tcfg, TCTX)
    x[1, 3] = float("nan")
    dirty, _ = tmoe.moe_block(x, tp, tcfg, TCTX)
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[2], clean[2])
    assert bool(torch.isnan(dirty[1, 3]).all())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_leaves(tree):
    return {
        "/".join(str(e.key) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_init_params_and_conversion_mirror_jax(model):
    """Same pytree and dtypes as JAX's init: the router fp32 under bf16
    weights, expert leaves [L, E, D, F]; bf16 JAX weights keep both through
    ``params_from_jax``."""
    jcfg, _, tcfg = model
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    mine = ttfm.init_params(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    conv = params_from_jax(_np_tree(jp), device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _jax_leaves(jp).items()}
    for tree in (mine, conv):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tadamw.tree_leaves(tree)}
        assert got == want
    moe = conv["layers"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["we1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["we2"].float().numpy(),
                                  np.asarray(jp["layers"]["moe"]["we2"], np.float32))
    m = tcfg.moe
    assert tuple(mine["layers"]["moe"]["we1"].shape) == (
        tcfg.num_layers, m.num_experts, tcfg.d_model, m.d_ff_expert)
    assert torch.count_nonzero(mine["layers"]["moe"]["ln"]) == 0


def test_forward_loss_and_grads_match_jax(model):
    """forward's logits 1e-4; loss_fn = ce + 0.01 aux, its ce and its aux
    within 1e-5, every gradient leaf within 5e-5 of its largest |g|, remat
    on and off bitwise equal."""
    jcfg, jp, tcfg = model
    jbatch = jpipe.make_batch(jcfg, 24, 2, seed=3, step=1)
    jlogits, jaux = jtfm.forward(jp, jcfg, JCTX, jbatch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCTX, jbatch), has_aux=True
    )(jp)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tp = params_from_jax(_np_tree(jp), device="cpu")
    with torch.no_grad():
        logits = ttfm.forward(tp, tcfg, TCTX, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    assert float(jaux) > 0
    results = {}
    for remat in (True, False):
        tp = params_from_jax(_np_tree(jp), device="cpu")
        named = list(tadamw.tree_leaves(tp))
        leaves = [leaf.requires_grad_(True) for _, leaf in named]
        loss, metrics = ttfm.loss_fn(tp, tcfg, dataclasses.replace(TCTX, remat=remat), batch)
        results[remat] = loss, metrics, dict(zip([n for n, _ in named],
                                                 torch.autograd.grad(loss, leaves)))
    loss, metrics, grads = results[True]
    for key, want in (("loss", jloss), ("ce", jmetrics["ce"]), ("aux", jmetrics["aux"])):
        np.testing.assert_allclose(float(metrics[key].detach()), float(want), atol=LOSS_TOL,
                                   rtol=0)
    jg = _jax_leaves(jgrads)
    assert sorted(jg) == sorted(grads)
    for name, g in grads.items():
        scale = float(np.abs(jg[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), jg[name], atol=GRAD_REL * scale, rtol=0,
                                   err_msg=name)
    loss_nr, _, grads_nr = results[False]
    assert torch.equal(loss, loss_nr)
    assert all(torch.equal(grads[n], grads_nr[n]) for n in grads)


def test_moe_over_a_ring_raises(model):
    """Once refused (ROADMAP A.7), the block and the engine now run at
    sp_size 4: qwen2-moe ("ep") through the dispatch all-to-all, mixtral
    ("tp") through the global path, which then equals the one-rank block.
    Their parity with JAX at sp_size 4: tests/test_torch_moe_ring.py."""
    jcfg, jp, tcfg = model
    tp = params_from_jax(_np_tree(jp), device="cpu")
    ring = TCtx(sp_size=4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32))
    lp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    y, aux = tmoe.moe_block(x, lp, tcfg, ring)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))
    assert ("moe_dispatch" in ring.ring.stats.bytes) == (tcfg.moe.mode == "ep")
    if tcfg.moe.mode == "tp":
        y1, aux1 = tmoe.moe_block(x, lp, tcfg, TCTX)
        assert torch.equal(y, y1) and torch.equal(aux, aux1)
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(tcfg, tp, ring, serve=ServeConfig(max_seq=64, num_slots=2))
    out = eng.generate(np.arange(8, dtype=np.int32)[None], max_new_tokens=3)
    assert out.shape == (1, 3)
