"""Training loop (copy of ``repro/train/loop.py``): the train step,
checkpoint/restart, preemption, stragglers.

Fault-tolerance model, as in JAX:
  * every saved state goes through the atomic checkpointer; a restart
    resumes from the newest *valid* checkpoint (corrupt ones are skipped);
  * SIGTERM sets a flag; the loop checkpoints at the next step boundary and
    returns (preemption handling);
  * the data pipeline is a pure function of (seed, step), so a restarted run
    consumes the identical stream.

Sequence parallelism runs in one process: with ``ctx.sp_size > 1`` the
batch comes striped (contiguous for the SSM and hybrid archs, whose SSD
scan is sharded over the ring) and every attention call runs the mesh /
ring / ulysses executor over the context's ring (a ``VirtualRing`` on one
card), while the rest of the model sees the whole sequence; an "ep" MoE arch
dispatches each rank's tokens to the experts' ranks over the same ring
(``models/moe.py``), its experts padded to a multiple of the ranks as JAX's
``init_params(ctx=...)`` pads them.  What needs several processes
raises or is absent: cross-pod gradient compression
(``TrainConfig.compression``), the gradient all-reduce over sequence ranks
of a multi-process ring, and the elastic re-meshing restart
(``elastic_fit``).

The step takes the gradients with ``torch.autograd.grad`` with respect to the
stacked parameter leaves (made leaf tensors with ``requires_grad``), then
runs the in-place AdamW update, after which no graph is left.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_update,
    init_opt_state,
    tree_leaves,
    tree_map,
)
from repro_torch.parallel.context import ParallelCtx
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.monitor import StepMonitor, StragglerPolicy

__all__ = ["TrainConfig", "make_train_step", "fit"]

_MULTI_PROCESS = "it needs a multi-process mesh, which a later slice of the port brings"


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq: int = 128
    batch: int = 8
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    param_dtype: torch.dtype = torch.float32
    compression: Optional[object] = None  # cross-pod gradient compression: not ported
    docs: Optional[int] = None  # pack N documents per row (segment-mask attention)


def _check_one_process(compression) -> None:
    if compression is not None:
        raise NotImplementedError(f"gradient compression is not ported: {_MULTI_PROCESS}")


def make_train_step(cfg: ModelConfig, ctx: ParallelCtx, opt_cfg: AdamWConfig,
                    compression=None):
    """Returns (params, opt_state, err, batch) -> (params, opt_state, err,
    metrics), as JAX's jitted step.  ``params`` and the moments are updated
    in place; ``err`` (the compression error state) passes through.
    Frontend and encoder archs train at sp_size 1 only
    (``check_ring_supported``); MLA archs train over a ring on the expanded
    heads or, with ``ctx.mla_latent_wire``, through the latent wire."""
    _check_one_process(compression)
    tfm.check_ring_supported(cfg, ctx, "training")

    def step_fn(params, opt_state: OptState, err, batch):
        leaves = [leaf for _, leaf in tree_leaves(params)]
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, metrics = tfm.loss_fn(params, cfg, ctx, batch)
            grads = torch.autograd.grad(loss, leaves)
        by_leaf = {id(leaf): g for leaf, g in zip(leaves, grads)}
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        metrics.update(om)
        return params, opt_state, err, metrics

    return step_fn


class _Preempt:
    def __init__(self):
        self.flag = False

    def install(self):
        def handler(signum, frame):
            self.flag = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (tests)
        return self


def fit(
    cfg: ModelConfig,
    ctx: ParallelCtx,
    tcfg: TrainConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    hooks: Optional[Dict[str, Callable]] = None,
) -> Dict:
    """Train on ``ctx.device``; resume from ``tcfg.ckpt_dir`` when a valid
    checkpoint exists.  Returns {interrupted, step, history (losses),
    final_loss, straggler_events, params, step_seconds (the wall time of
    each step, as the straggler monitor sees it)}."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
    hooks = hooks or {}
    _check_one_process(tcfg.compression)
    preempt = _Preempt().install()
    monitor = StepMonitor(StragglerPolicy(action="checkpoint"))

    params = tfm.init_params(cfg, seed=tcfg.seed, dtype=tcfg.param_dtype, device=ctx.device,
                             ctx=ctx)
    opt_state = init_opt_state(params)
    err: Dict = {}
    start_step = 0

    if tcfg.ckpt_dir is not None:
        try:
            state_like = {"params": params, "m": opt_state.m, "v": opt_state.v,
                          "step": opt_state.step}
            restored, ck_step = ckpt.restore(tcfg.ckpt_dir, state_like)
            params = restored["params"]
            opt_state = OptState(step=restored["step"], m=restored["m"], v=restored["v"])
            start_step = ck_step
        except (FileNotFoundError, IOError):
            pass

    step_fn = make_train_step(cfg, ctx, opt_cfg, tcfg.compression)
    saver = ckpt.AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep) if tcfg.ckpt_dir else None
    history, step_seconds = [], []

    def save_now(step):
        if saver is None:
            return
        saver.save(step, {"params": params, "m": opt_state.m, "v": opt_state.v,
                          "step": opt_state.step})
        saver.wait()

    for step in range(start_step, tcfg.steps):
        if preempt.flag:
            save_now(step)
            return {"interrupted": True, "step": step, "history": history}
        batch = make_batch(
            cfg, tcfg.seq, tcfg.batch, seed=tcfg.seed, step=step, ctx=ctx, docs=tcfg.docs
        )
        t0 = time.perf_counter()
        params, opt_state, err, metrics = step_fn(params, opt_state, err, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        dt = time.perf_counter() - t0
        action = monitor.record(dt)
        history.append(loss)
        step_seconds.append(dt)
        if "on_step" in hooks:
            hooks["on_step"](step, metrics)
        if action == "checkpoint" or (
            tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0
        ):
            save_now(step + 1)
        if "fail_at" in hooks and hooks["fail_at"] == step:
            raise RuntimeError(f"injected failure at step {step}")
    save_now(tcfg.steps)
    return {
        "interrupted": False,
        "step": tcfg.steps,
        "history": history,
        "final_loss": history[-1] if history else None,
        "straggler_events": monitor.events,
        "params": params,
        "step_seconds": step_seconds,
    }
