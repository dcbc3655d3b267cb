"""AdamW over the port's parameter dicts (copy of ``repro/optim/adamw.py``):
fp32 moments, global-norm clipping, constant / cosine / wsd schedules.

The arithmetic is JAX's, op for op.  Unlike JAX, ``adamw_update`` updates
the parameters and the moments IN PLACE under ``torch.no_grad()`` and returns
the same tensors: at full width a second copy of the parameters and moments
would not fit beside the first.  Nothing may still hold an autograd graph
over the parameters when it runs (``make_train_step`` takes the gradients
with ``torch.autograd.grad`` first, so no graph survives).  The step count and
the learning rate stay on the parameters' device: the update never syncs the
host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "adamw_update",
    "make_schedule",
    "global_norm",
    "tree_leaves",
    "tree_map",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"  # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Dict  # nest like params (fp32)
    v: Dict  # nest like params (fp32)


def tree_leaves(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level (the
    order JAX flattens a dict pytree in); paths are "/"-joined."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            for path, leaf in tree_leaves(node):
                yield f"{key}/{path}", leaf
        else:
            yield key, node


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of one or more nested dicts of the same shape."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(tree_leaves(params))[1]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    return OptState(step=step, m=tree_map(zeros, params), v=tree_map(zeros, params))


def make_schedule(cfg: AdamWConfig) -> Callable:
    """step (int tensor) -> learning rate (fp32 tensor on the step's device)."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            decay = 1.0
        elif cfg.schedule == "wsd":
            # warmup-stable-decay: linear decay over the last 10%
            tail = 0.9 * cfg.total_steps
            decay = torch.clamp(
                1.0 - (step - tail) / max(0.1 * cfg.total_steps, 1), 0.1, 1.0
            )
        else:  # cosine
            frac = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.lr * warm * decay

    return sched


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the fp32 sum of squares."""
    total = None
    for _, x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step; updates ``params`` and the moments in place and returns
    (params, new OptState, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    step = state.step + 1
    lr = make_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(p, g, mm, vv):
        # JAX's arithmetic op for op, in place: two temporaries a leaf, as
        # the leaves are GB-sized
        g32 = g.float()
        tmp = torch.mul(g32, 1 - b1)
        mm.mul_(b1).add_(tmp)  # b1 * m + (1 - b1) * g
        torch.square(g32, out=tmp).mul_(1 - b2)
        vv.mul_(b2).add_(tmp)  # b2 * v + (1 - b2) * g^2
        torch.div(vv, bc2, out=tmp).sqrt_().add_(cfg.eps)
        u = torch.div(mm, bc1).div_(tmp)  # (m / bc1) / (sqrt(v / bc2) + eps)
        p32 = p.float()
        u.add_(torch.mul(p32, cfg.weight_decay, out=tmp)).mul_(lr)  # lr * (u + wd * p)
        p.copy_(torch.sub(p32, u, out=u))

    tree_map(upd, params, grads, state.m, state.v)
    return params, OptState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
