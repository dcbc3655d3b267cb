"""The port's training path against the JAX package, fp32, on the CPU.

Weights come from JAX's ``init_params`` through ``convert.params_from_jax``;
batches from JAX's ``make_batch`` (the port draws its own tokens, so where
the tokens must agree the test hands JAX's batch to the port).  Tolerances:
loss 1e-5 and every gradient leaf 1e-4 (fp32 sums in another order in XLA
and in PyTorch), AdamW 1e-6, params after three steps 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.context import ParallelCtx as JCtx
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train.monitor import StepMonitor, StragglerPolicy

LOSS_TOL, GRAD_TOL, PARAM_TOL, OPT_TOL = 1e-5, 1e-4, 1e-4, 1e-6
JCTX = JCtx()
TCTX = TCtx(device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(tree):
    return dict(tadamw.tree_leaves(tree))


def _jax_leaves(tree):
    return {
        "/".join(str(e.key) for e in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module", params=["granite-8b", "paper-mha-7b"])
def model(request):
    jcfg = jget_config(request.param).reduced()
    tcfg = tget_config(request.param).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg


def _port_loss_and_grads(tparams, tcfg, ctx, batch):
    leaves = [leaf.requires_grad_(True) for _, leaf in tadamw.tree_leaves(tparams)]
    loss, metrics = ttfm.loss_fn(tparams, tcfg, ctx, batch)
    grads = torch.autograd.grad(loss, leaves)
    names = [name for name, _ in tadamw.tree_leaves(tparams)]
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("docs", [None, 3], ids=["causal", "docs"])
def test_loss_and_grads_match_jax(model, docs):
    """loss_fn and its gradients at the reduced config, with and without
    packed documents (segments + loss mask); remat on and off agree exactly."""
    jcfg, jparams, tcfg = model
    jbatch = jpipe.make_batch(jcfg, 24, 2, seed=3, step=1, docs=docs)
    assert ("segments" in jbatch) == bool(docs)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, JCTX, jbatch), has_aux=True
    )(jparams)
    batch = _to_torch_batch(jbatch)
    results = {}
    for remat in (True, False):
        tparams = params_from_jax(_np_tree(jparams), device="cpu")
        ctx = dataclasses.replace(TCTX, remat=remat)
        results[remat] = _port_loss_and_grads(tparams, tcfg, ctx, batch)
    loss, metrics, grads = results[True]
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), atol=LOSS_TOL, rtol=0)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    jg = _jax_leaves(jgrads)
    assert sorted(jg) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], atol=GRAD_TOL, rtol=0, err_msg=name)
    loss_nr, _, grads_nr = results[False]
    assert torch.equal(loss, loss_nr)
    for name in grads:
        assert torch.equal(grads[name], grads_nr[name]), name


def test_remat_reruns_the_forward_kernel(monkeypatch):
    """With remat the layer forward (and its attention) runs again in the
    backward, as jax.checkpoint makes it: two attention calls per layer."""
    from repro_torch.kernels import ops

    cfg = tget_config("granite-8b").reduced()
    calls = []
    real = ops.block_attention
    monkeypatch.setattr(ops, "block_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = tpipe.make_batch(cfg, 16, 1, ctx=TCTX)
    for remat, expect in ((True, 2), (False, 1)):
        calls.clear()
        params = ttfm.init_params(cfg, device="cpu")
        _port_loss_and_grads(params, cfg, dataclasses.replace(TCTX, remat=remat), batch)
        assert len(calls) == expect * cfg.num_layers


def test_vocab_cross_entropy_matches_jax():
    from repro.models import layers as jlayers

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.vocab_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m)
        )
        got = tlayers.vocab_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m),
        )
        np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


def _opt_inputs(rng, scale):
    shapes = {"embed": (6, 4), "layers": {"attn": {"wq": (2, 4, 4)}, "mlp": {"w1": (2, 4, 8)}},
              "final_ln": (4,)}

    def draw(shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def nest(fn):
        def go(node):
            return {k: go(v) for k, v in node.items()} if isinstance(node, dict) else fn(node)
        return go(shapes)

    return nest(lambda sh: draw(sh, 1.0)), [nest(lambda sh: draw(sh, scale)) for _ in range(3)]


@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_adamw_update_matches_jax(schedule):
    """Three updates from the same params, grads and state (the state carried
    into the port by opt_state_from_jax), clipping active."""
    rng = np.random.default_rng(1)
    params, grads = _opt_inputs(rng, scale=5.0)
    cfg = jadamw.AdamWConfig(lr=1e-2, schedule=schedule, warmup_steps=2, total_steps=4,
                             clip_norm=1.0)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init_opt_state(jp)
    tp = params_from_jax(params, device="cpu")
    for g in grads:
        tstate = opt_state_from_jax(_np_tree(jstate), device="cpu")
        tp = params_from_jax(_np_tree(jp), device="cpu")
        jp, jstate, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), jstate, cfg)
        tp, tstate, tm = tadamw.adamw_update(tp, params_from_jax(g, device="cpu"), tstate, tcfg)
        assert float(jm["grad_norm"]) > 1.0  # the clip is active
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), atol=OPT_TOL, rtol=1e-6)
        assert int(tstate.step) == int(jstate.step)
        for tree_t, tree_j in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
            jl = _jax_leaves(tree_j)
            for name, t in _leaves(tree_t).items():
                np.testing.assert_allclose(t.numpy(), jl[name], atol=OPT_TOL, rtol=0)


def test_schedules_match_jax():
    for schedule in ("constant", "cosine", "wsd"):
        cfg = jadamw.AdamWConfig(schedule=schedule, warmup_steps=3, total_steps=20)
        js = jadamw.make_schedule(cfg)
        ts = tadamw.make_schedule(tadamw.AdamWConfig(**dataclasses.asdict(cfg)))
        for step in (0, 1, 3, 10, 18, 19, 20, 25):
            np.testing.assert_allclose(
                float(ts(torch.tensor(step, dtype=torch.int32))),
                float(js(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12,
            )


def test_three_train_steps_match_jax():
    """Three make_train_step steps fed JAX's batches, against JAX's steps."""
    three_train_steps_match_jax(jget_config("granite-8b").reduced(),
                                tget_config("granite-8b").reduced())


def three_train_steps_match_jax(jcfg, tcfg):
    """Three steps of the port's make_train_step against JAX's from the same
    weights and batches (the third packs 2 documents a row): the losses and
    the params after them."""
    opt = jadamw.AdamWConfig(total_steps=3, warmup_steps=1)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    tstate = tadamw.init_opt_state(tparams)
    jstate = jadamw.init_opt_state(jparams)
    jstep = jloop.make_train_step(jcfg, JCTX, opt)
    tstep = tloop.make_train_step(tcfg, TCTX, tadamw.AdamWConfig(**dataclasses.asdict(opt)))
    jerr, terr = {}, {}
    for step in range(3):
        jbatch = jpipe.make_batch(jcfg, 16, 2, seed=0, step=step, docs=2 if step == 2 else None)
        tparams, tstate, terr, tm = tstep(tparams, tstate, terr, _to_torch_batch(jbatch))
        jparams, jstate, jerr, jm = jstep(jparams, jstate, jerr, jbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=LOSS_TOL, rtol=0)
    jl = _jax_leaves(jparams)
    for name, t in _leaves(tparams).items():
        np.testing.assert_allclose(t.detach().numpy(), jl[name], atol=PARAM_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("seed,step,docs", [(0, 0, 2), (0, 3, 4), (7, 1, 5), (2, 9, None)])
def test_make_batch_matches_jax(seed, step, docs):
    jcfg = jget_config("granite-8b").reduced()
    tcfg = tget_config("granite-8b").reduced()
    jb = jpipe.make_batch(jcfg, 32, 3, seed=seed, step=step, docs=docs)
    tb = tpipe.make_batch(tcfg, 32, 3, seed=seed, step=step, docs=docs, ctx=TCTX)
    assert sorted(jb) == sorted(tb)
    for key in ("segments", "positions", "mask"):
        if key in jb:
            assert tb[key].dtype == torch.from_numpy(np.asarray(jb[key])).dtype
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    again = tpipe.make_batch(tcfg, 32, 3, seed=seed, step=step, docs=docs, ctx=TCTX)
    assert torch.equal(again["tokens"], tb["tokens"])
    other = tpipe.make_batch(tcfg, 32, 3, seed=seed, step=step + 1, docs=docs, ctx=TCTX)
    assert not torch.equal(other["tokens"], tb["tokens"])
    assert tb["tokens"].dtype == torch.int32 and tb["tokens"].shape == (3, 32)
    assert torch.equal(tb["labels"][:, :-1], tb["tokens"][:, 1:])  # labels are the next tokens
    assert int(tb["tokens"].max()) < tcfg.vocab_size
    np.testing.assert_array_equal(
        tpipe.doc_lengths(64, 5, seed=seed, step=step), jpipe.doc_lengths(64, 5, seed=seed, step=step)
    )
    assert tpipe.batch_spec_shapes(tcfg, 32, 3, docs) == jpipe.batch_spec_shapes(jcfg, 32, 3, docs)


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
                   "b": torch.zeros(3, dtype=torch.bfloat16) + 0.5},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip_keep_k_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    for s in (1, 2, 3, 4):
        tckpt.save(d, s, tree, keep=2)
    assert tckpt.latest_step(d) == 4
    assert sorted(tckpt._list_steps(d)) == [3, 4]
    restored, step = tckpt.restore(d, tree)
    assert step == 4
    for (name, a), (_, b) in zip(tadamw.tree_leaves(tree), tadamw.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_checkpoint_corruption_detected(tmp_path):
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, _tree())
    tckpt.save(d, 2, _tree())
    with open(os.path.join(d, "step_000000002", "arrays.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00garbage\x00")
    assert tckpt.latest_step(d) == 1
    _, step = tckpt.restore(d, _tree())
    assert step == 1
    with pytest.raises(IOError):
        tckpt.restore(d, _tree(), step=2)


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    saver = tckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        saver.save(s, _tree())
    saver.wait()
    assert tckpt.latest_step(d) == 3
    assert sorted(tckpt._list_steps(d)) == [2, 3]


def test_restore_checkpoint_written_by_jax(tmp_path):
    """Same on-disk layout: the port restores what repro.train.checkpoint wrote."""
    d = str(tmp_path / "ck")
    jcfg = jget_config("granite-8b").reduced()
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = jadamw.init_opt_state(jparams)
    jckpt.save(d, 12, {"params": jparams, "m": jstate.m, "v": jstate.v, "step": jstate.step})
    like_params = params_from_jax(_np_tree(jparams), device="cpu")
    like = tadamw.init_opt_state(ttfm.init_params(tget_config("granite-8b").reduced(), device="cpu"))
    restored, step = tckpt.restore(
        d, {"params": like_params, "m": like.m, "v": like.v, "step": like.step}
    )
    assert step == 12 and restored["step"].dtype == torch.int32
    jl = _jax_leaves(jparams)
    for name, t in _leaves(restored["params"]).items():
        np.testing.assert_array_equal(t.numpy(), jl[name])


def test_train_resume_after_injected_failure(tmp_path):
    """Train 6 steps with a crash at step 4; the resumed run continues from the
    checkpoint and ends with the SAME loss as an uninterrupted run."""
    cfg = tget_config("granite-8b").reduced()
    d = str(tmp_path / "ck")
    tcfg = tloop.TrainConfig(steps=6, seq=16, batch=2, ckpt_dir=d, ckpt_every=2, log_every=100)
    with pytest.raises(RuntimeError):
        tloop.fit(cfg, TCTX, tcfg, hooks={"fail_at": 4})
    assert tckpt.latest_step(d) == 4
    out = tloop.fit(cfg, TCTX, tcfg)  # resumes from step 4
    assert out["step"] == 6 and not out["interrupted"] and len(out["history"]) == 2
    ref = tloop.fit(cfg, TCTX, tloop.TrainConfig(steps=6, seq=16, batch=2, ckpt_dir=None))
    np.testing.assert_allclose(out["history"][-1], ref["history"][-1], rtol=1e-5)
    assert len(ref["step_seconds"]) == 6


def test_single_card_limits_raise():
    cfg = tget_config("granite-8b").reduced()
    with pytest.raises(NotImplementedError, match="mesh"):
        tloop.make_train_step(cfg, TCTX, tadamw.AdamWConfig(), compression="int8")
    with pytest.raises(NotImplementedError, match="mesh"):
        tloop.fit(cfg, TCTX, tloop.TrainConfig(steps=1, compression="int8"))


def test_step_monitor_matches_jax():
    from repro.train.monitor import StepMonitor as JMonitor
    from repro.train.monitor import StragglerPolicy as JPolicy

    times = [1.0] * 8 + [1e2, 1e3, 1e4, 1.0, 1.0]
    tm, jm = StepMonitor(StragglerPolicy(action="checkpoint")), JMonitor(JPolicy(action="checkpoint"))
    actions = [tm.record(t) for t in times]
    assert actions == [jm.record(t) for t in times]
    assert "checkpoint" in actions and tm.events == jm.events


def test_launch_train_cpu_and_default_device(monkeypatch, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "granite-8b", "--device", "cpu", "--reduced", "--steps", "3",
                       "--seq", "16", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "done: step=3 final_loss=" in out
    with pytest.raises(NotImplementedError, match="--compress"):
        train.main(["--arch", "granite-8b", "--device", "cpu", "--reduced", "--compress"])
    # --attn alone runs local flash (JAX builds no ring below 8 fake devices);
    # with --fake-devices 8 it runs over a virtual ring of 4 ranks
    small = ["--arch", "granite-8b", "--device", "cpu", "--reduced", "--steps", "1",
             "--seq", "16", "--batch", "2"]
    assert train.main(small + ["--attn", "ring"]) == 0
    assert "ring=none" in capsys.readouterr().out
    assert train.main(small + ["--fake-devices", "8", "--attn", "ring"]) == 0
    out = capsys.readouterr().out
    assert "ring=VirtualRing(n=4) attn=ring a=1" in out and "done: step=1" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "granite-8b", "--reduced", "--steps", "1"])
