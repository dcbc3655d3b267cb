"""SSM and hybrid training in the port against the JAX package, fp32, on the
CPU: the SSD scan's backward (``kernels/ssd_scan.py``: ``ssd_scan_bwd_plain``,
the plain version of kernel #5b, and ``_SSDScan``, the autograd function
``ssd_scan_fwd`` goes through), ``loss_fn`` and its gradients, and train
steps, for mamba2-370m and hymba-1.5b reduced (over a ring of 4 and the CLI:
tests/test_torch_ssm_train_ring.py).

Oracles: ``jax.grad`` of ``repro.models.ssm.ssd_scan`` (the jnp chunked
scan JAX trains with) and of ``repro.kernels.ref.ssd_ref`` (the sequential
recurrence).  At dt 3, A -1 the chunked form's gradient is NaN in JAX
(``jnp.where`` over an inf: ROADMAP C.7), so there the port is held to the
sequential oracle alone.  Limits: the scan's gradients within ``SCAN_TOL``
of each gradient's largest |value| (fp32 sums in another order); the
model's loss 1e-5 and every gradient leaf 1e-4, params after three steps
1e-4, the AdamW moments 1e-6 (tests/test_torch_train.py's).  Inputs come
from ``numpy.random.default_rng`` with the seed each case states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.context import ParallelCtx as JCtx
from repro.train import loop as jloop
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.train import loop as tloop

ARCHS = ["mamba2-370m", "hymba-1.5b"]
SCAN_TOL = 2e-5
LOSS_TOL, GRAD_TOL, PARAM_TOL, OPT_TOL = 1e-5, 1e-4, 1e-4, 1e-6
SSM_LEAVES = ("A_log", "dt_bias", "D_skip", "conv_w", "conv_b", "in_proj", "out_proj", "ln",
              "out_ln")


def _jax_leaves(tree):
    return {
        "/".join(str(e.key) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _to_torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------
# the scan's backward
# --------------------------------------------------------------------------

SCAN_CASES = {
    # name: (B, S, H, P, G, N, chunk, dstate)
    "one_group": (2, 64, 4, 16, 1, 16, 16, False),
    "groups": (2, 48, 6, 8, 3, 8, 16, True),
    "chunk1": (1, 12, 4, 16, 2, 8, 1, True),
    "chunk_is_S": (2, 40, 4, 16, 1, 16, 40, True),
    "dstate": (1, 96, 4, 16, 2, 16, 32, True),
}


def _scan_inputs(B, S, H, P, G, N, seed, dt_value=None):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x, Bm, Cm, dy, ds = f(B, S, H, P), f(B, S, G, N), f(B, S, G, N), f(B, S, H, P), f(B, H, P, N)
    if dt_value is None:
        dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)  # softplus
        A = (-np.exp(0.5 * f(H))).astype(np.float32)
    else:
        dt = np.full((B, S, H), dt_value, np.float32)
        A = -np.ones(H, np.float32)
    return (x, dt, A, Bm, Cm), dy, ds


def _jax_grads(fn, args, dy, ds):
    """jax.grad of <y, dy> + <final state, ds> (ds None: the state unused)."""
    def loss(*a):
        y, st = fn(*a)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(st * ds)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))]


def _chunked_jax(chunk, H, G):
    def fn(x, dt, A, Bm, Cm):
        rep = H // G
        return jssm.ssd_scan(x, dt, A, jnp.repeat(Bm, rep, axis=2), jnp.repeat(Cm, rep, axis=2),
                             chunk)
    return fn


def _port_grads(args, dy, ds, chunk):
    """(ssd_scan_bwd_plain's gradients, the gradients autograd takes through
    ssd_scan_fwd, i.e. _SSDScan's backward)."""
    t = [torch.from_numpy(a) for a in args]
    tdy = torch.from_numpy(dy)
    tds = None if ds is None else torch.from_numpy(ds)
    plain = tssd.ssd_scan_bwd_plain(*t, tdy, tds, chunk)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y, st = tssd.ssd_scan_fwd(*leaves, chunk=chunk)
    loss = (y * tdy).sum() + (0 if tds is None else (st * tds).sum())
    auto = torch.autograd.grad(loss, leaves)
    return [g.numpy() for g in plain], [g.numpy() for g in auto]


def _assert_scan_grads(got, want, what):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert np.isfinite(g).all(), (what, name)
        tol = SCAN_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_backward_matches_jax(case):
    """ssd_scan_bwd_plain and _SSDScan's backward against jax.grad of JAX's
    chunked scan and of the sequential oracle."""
    B, S, H, P, G, N, chunk, with_ds = SCAN_CASES[case]
    args, dy, ds = _scan_inputs(B, S, H, P, G, N, seed=len(case))
    ds = ds if with_ds else None
    plain, auto = _port_grads(args, dy, ds, chunk)
    for np_g, a_g in zip(plain, auto):
        assert np.array_equal(np_g, a_g)  # autograd runs exactly the plain backward
    _assert_scan_grads(plain, _jax_grads(_chunked_jax(chunk, H, G), args, dy, ds), "chunked")
    _assert_scan_grads(plain, _jax_grads(jref.ssd_ref, args, dy, ds), "sequential")


def test_scan_backward_large_dt_is_finite():
    """dt 3, A -1 (S 128, chunk 64): a chunk's sum of dt*|A| passes 88.  The
    port masks by selection and stays finite, held to the sequential
    oracle; JAX's chunked form gives NaN in ddt and dA (ROADMAP C.7)."""
    B, S, H, P, G, N, chunk = 1, 128, 2, 16, 1, 16, 64
    args, dy, ds = _scan_inputs(B, S, H, P, G, N, seed=7, dt_value=3.0)
    plain, auto = _port_grads(args, dy, ds, chunk)
    _assert_scan_grads(plain, _jax_grads(jref.ssd_ref, args, dy, ds), "sequential")
    _assert_scan_grads(auto, _jax_grads(jref.ssd_ref, args, dy, ds), "sequential")
    chunked = _jax_grads(_chunked_jax(chunk, H, G), args, dy, ds)
    assert not np.isfinite(chunked[1]).all() and not np.isfinite(chunked[2]).all()


def test_scan_outside_autograd_is_unchanged(monkeypatch):
    """Without autograd ssd_scan_fwd runs the forward once, with the serving
    term count, and no backward; under autograd it runs the forward once
    with AUTOGRAD_TERMS and, in the backward, #5b once."""
    calls, terms = {"fwd": 0, "bwd": 0}, []
    real_f, real_b = tssd._forward, tssd.ssd_scan_bwd
    monkeypatch.setattr(tssd, "_forward", lambda *a: calls.__setitem__(
        "fwd", calls["fwd"] + 1) or terms.append(a[6]) or real_f(*a))
    monkeypatch.setattr(tssd, "ssd_scan_bwd", lambda *a, **k: calls.__setitem__(
        "bwd", calls["bwd"] + 1) or real_b(*a, **k))
    args, dy, _ = _scan_inputs(1, 32, 2, 16, 1, 16, seed=3)
    t = [torch.from_numpy(a) for a in args]
    y, st = tssd.ssd_scan_fwd(*t, chunk=8)
    assert calls == {"fwd": 1, "bwd": 0} and not y.requires_grad
    leaves = [a.clone().requires_grad_(True) for a in t]
    y2, _ = tssd.ssd_scan_fwd(*leaves, chunk=8)
    assert torch.equal(y2.detach(), y)
    y2.sum().backward()  # the final state's gradient is None
    assert calls == {"fwd": 2, "bwd": 1}
    assert terms == [tssd.TERMS, tssd.AUTOGRAD_TERMS] == [2, 3]
    assert all(torch.isfinite(a.grad).all() for a in leaves)


# --------------------------------------------------------------------------
# the model: loss, gradients, steps
# --------------------------------------------------------------------------


def _jax_weights(arch):
    """JAX's reduced weights with nonzero A_log / dt_bias / D_skip."""
    jcfg = jget_config(arch).reduced()
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jl = dict(jparams["layers"])
    jl["ssm"] = dict(jl["ssm"], **{
        name: jnp.asarray(rng.uniform(-0.5, 0.5, jl["ssm"][name].shape).astype(np.float32))
        for name in ("A_log", "dt_bias", "D_skip")
    })
    return jcfg, dict(jparams, layers=jl)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, jparams = _jax_weights(request.param)
    tcfg = tget_config(request.param).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.causal_layout == "contiguous"
    return jcfg, jparams, tcfg


def _port_loss_and_grads(jparams, tcfg, ctx, batch):
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = list(tadamw.tree_leaves(tparams))
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = ttfm.loss_fn(tparams, tcfg, ctx, batch)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    return loss.detach(), metrics, {name: g for (name, _), g in zip(leaves, grads)}


def _assert_model_grads(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_TOL, rtol=0)
    jg = _jax_leaves(jgrads)
    assert sorted(jg) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("seq", [32, 24])
def test_loss_and_grads_match_jax(model, seq):
    """loss_fn and every gradient leaf against jax.value_and_grad at one
    rank; remat on and off give bitwise-equal losses and gradients."""
    jcfg, jparams, tcfg = model
    jbatch = jpipe.make_batch(jcfg, seq, 2, seed=4, step=1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCtx(), jbatch), has_aux=True)(jparams)
    batch = _to_torch_batch(jbatch)
    runs = {remat: _port_loss_and_grads(jparams, tcfg, TCtx(device="cpu", remat=remat), batch)
            for remat in (True, False)}
    loss, metrics, grads = runs[True]
    _assert_model_grads(loss, grads, jloss, jgrads)
    assert float(metrics["aux"]) == 0.0
    for leaf in SSM_LEAVES:
        assert f"layers/ssm/{leaf}" in grads and float(grads[f"layers/ssm/{leaf}"].abs().max()) > 0
    loss_nr, _, grads_nr = runs[False]
    assert torch.equal(loss, loss_nr)
    for name in grads:
        assert torch.equal(grads[name], grads_nr[name]), name


@pytest.mark.parametrize("remat", [True, False])
def test_remat_reruns_the_scan_forward(model, remat, monkeypatch):
    """Per layer and step: the scan's forward twice with remat (once
    without), each with AUTOGRAD_TERMS (the loss and the gradient come from
    the same arithmetic), its backward once."""
    _, jparams, tcfg = model
    calls, terms = {"fwd": 0, "bwd": 0}, set()
    real_f, real_b = tssd._forward, tssd.ssd_scan_bwd
    monkeypatch.setattr(tssd, "_forward", lambda *a: calls.__setitem__(
        "fwd", calls["fwd"] + 1) or terms.add(a[6]) or real_f(*a))
    monkeypatch.setattr(tssd, "ssd_scan_bwd", lambda *a, **k: calls.__setitem__(
        "bwd", calls["bwd"] + 1) or real_b(*a, **k))
    ctx = TCtx(device="cpu", remat=remat)
    batch = tpipe.make_batch(tcfg, 16, 1, ctx=ctx)
    _port_loss_and_grads(jparams, tcfg, ctx, batch)
    L = tcfg.num_layers
    assert calls == {"fwd": (2 if remat else 1) * L, "bwd": L}
    assert terms == {tssd.AUTOGRAD_TERMS}


def test_three_train_steps_match_jax(model):
    """Three make_train_step steps fed JAX's batches: loss each step, then
    params and both AdamW moments against JAX's."""
    _train_steps_match_jax(model, TCtx(device="cpu"))


def _train_steps_match_jax(model, ctx):
    """Three make_train_step steps on ``ctx`` against JAX's single device."""
    jcfg, jparams, tcfg = model
    jparams = jax.tree.map(jnp.copy, jparams)  # JAX's step donates its inputs
    opt = jadamw.AdamWConfig(total_steps=3, warmup_steps=1)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tstate = tadamw.init_opt_state(tparams)
    jstate = jadamw.init_opt_state(jparams)
    jstep = jloop.make_train_step(jcfg, JCtx(), opt)
    tstep = tloop.make_train_step(tcfg, ctx, tadamw.AdamWConfig(**dataclasses.asdict(opt)))
    jerr, terr = {}, {}
    for step in range(3):
        jbatch = jpipe.make_batch(jcfg, 16, 2, seed=0, step=step)
        tparams, tstate, terr, tm = tstep(tparams, tstate, terr, _to_torch_batch(jbatch))
        jparams, jstate, jerr, jm = jstep(jparams, jstate, jerr, jbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for tree_t, tree_j, tol in ((tparams, jparams, PARAM_TOL), (tstate.m, jstate.m, OPT_TOL),
                                (tstate.v, jstate.v, OPT_TOL)):
        jl = _jax_leaves(tree_j)
        for name, t in tadamw.tree_leaves(tree_t):
            np.testing.assert_allclose(t.detach().numpy(), jl[name], atol=tol, rtol=0,
                                       err_msg=name)


def test_opt_state_from_jax_carries_the_ssm_leaves(model):
    """JAX's AdamW state after one step converts leaf for leaf, the SSD
    block's leaves included."""
    jcfg, jparams, _ = model
    jparams = jax.tree.map(jnp.copy, jparams)  # JAX's step donates its inputs
    jstate = jadamw.init_opt_state(jparams)
    jstep = jloop.make_train_step(jcfg, JCtx(), jadamw.AdamWConfig(total_steps=2))
    _, jstate, _, _ = jstep(jparams, jstate, {}, jpipe.make_batch(jcfg, 16, 1, seed=2, step=0))
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert int(tstate.step) == int(jstate.step) == 1
    for tree_t, tree_j in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
        jl, tl = _jax_leaves(tree_j), dict(tadamw.tree_leaves(tree_t))
        assert sorted(jl) == sorted(tl)
        for leaf in SSM_LEAVES:
            name = f"layers/ssm/{leaf}"
            assert tl[name].dtype == torch.float32 and float(tl[name].abs().max()) > 0
            np.testing.assert_array_equal(tl[name].numpy(), jl[name])
