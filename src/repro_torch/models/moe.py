"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch
(the single-rank path of ``repro/models/moe.py``).

Per batch row, as JAX's ``vmap`` over samples has it, the S·K (token,
expert) choices are sorted by expert id (stably), ranked within their
expert, and those past the capacity C = ceil(S·K·cf / E) are dropped.  S is
the length of the rows this call is given -- a prefill bucket, a packed
row, a chunk, a verify window, 1 for decode -- so capacity couples the
tokens of a row, and each entry point's result is its own.  The capacity
stays per row: rows never share slots.

Masks select, they never multiply by 0/1: a dropped entry's row is not
written (JAX adds ``where(valid, src, 0)``), so a NaN token cannot reach
another token's slot.  Only valid entries land in the expert buffer, each
in a slot of its own, so the dispatch has no colliding writes and two runs
on the card agree bit for bit.

The expert products are plain matrix products (``einsum``), as in JAX,
where no Pallas kernel computes them.  The router product is fp32 x fp32.
The port leaves TF32 off, PyTorch's default (``chip_smoke.py`` sets it off
too): a TF32 router would flip expert choices at near-ties.

**Expert parallelism over the sequence ring** (``_moe_ep``: JAX's
``_moe_ep_segmented`` and ``_moe_ep_manual`` in one).  Where JAX takes it --
mode "ep", sp_size n > 1, the padded expert count and S both multiples of n
-- the router runs over the global h (so aux is the global term, as the
segmented form has it), and each rank's contiguous chunk of the rows as they
arrive (the striped order under the engine's striped prompts) dispatches on
its own at C_loc = ceil(S/n·K·cf / E): capacity per (rank, row), not per
row, so at cf 1.25 the result differs from sp_size 1 by design.  The
``moe_dispatch`` all-to-all sends each rank's [E, C_loc] buffer to the
experts' owners (rank r holds experts r·E/n ... (r+1)·E/n - 1), the expert
products run batched over the ranks, and ``moe_return`` brings the rows
home.  Every other case (mode "tp", a decode row, rows the ranks do not
divide) takes the global path, as in JAX; on one process JAX's "tp"
sharding of the expert d_ff changes no number.  A verify window
[slots, spec_k] at spec_k 4 divides by 4 and dispatches, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.parallel.context import ParallelCtx

__all__ = ["init_moe_params", "moe_block", "padded_experts"]

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def padded_experts(cfg: ModelConfig, ctx: ParallelCtx) -> int:
    e = cfg.moe.num_experts
    if cfg.moe.mode == "ep" and ctx.sp_size > 1:
        return int(math.ceil(e / ctx.sp_size) * ctx.sp_size)
    return e


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype, device,
                    ctx: Optional[ParallelCtx] = None) -> dict:
    """JAX's pytree and init law: an fp32 router whatever ``dtype``, norm
    gains at 0, expert leaves ``[L, E, D, F]`` / ``[L, E, F, D]`` with fan-in
    over their second-to-last axis, and qwen2-moe's shared expert.  E is
    ``padded_experts`` under ``ctx`` (none: the config's count)."""
    m = cfg.moe
    D, Fe = cfg.d_model, m.d_ff_expert
    E = padded_experts(cfg, ctx) if ctx is not None else m.num_experts
    p = {
        "ln": torch.zeros((L, D), dtype=dtype, device=device),
        "router": dense_init(gen, (L, D, E), dtype=torch.float32, device=device),
        "we1": dense_init(gen, (L, E, D, Fe), dtype=dtype, device=device),
        "we3": dense_init(gen, (L, E, D, Fe), dtype=dtype, device=device),
        "we2": dense_init(gen, (L, E, Fe, D), dtype=dtype, device=device),
    }
    if m.num_shared:
        Fs = m.d_ff_shared
        p.update(
            ws1=dense_init(gen, (L, D, Fs), dtype=dtype, device=device),
            ws3=dense_init(gen, (L, D, Fs), dtype=dtype, device=device),
            ws2=dense_init(gen, (L, Fs, D), dtype=dtype, device=device),
            shared_gate=dense_init(gen, (L, D, 1), dtype=dtype, device=device),
        )
    return p


def _dispatch_indices(idx: torch.Tensor, E: int, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx [..., T, K]: each row's expert choice per (token, k) -> (slot,
    valid), both [..., T, K].  slot = expert*C + rank within the expert
    (ranked in (token, k) order), clamped to C - 1; valid = rank < C."""
    *lead, T, K = idx.shape
    flat = idx.reshape(-1, T * K).to(torch.int64)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    # rank of each sorted entry within its expert: position - first occurrence
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(T * K, device=idx.device) - first
    slot_sorted = sorted_e * C + ranks.clamp(max=C - 1)
    # back to (token, k) order
    slot = torch.empty_like(flat).scatter_(1, order, slot_sorted)
    valid = torch.empty_like(flat, dtype=torch.bool).scatter_(1, order, ranks < C)
    return slot.reshape(*lead, T, K), valid.reshape(*lead, T, K)


def _route(h: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, E_pad: int):
    """h [B,S,D] -> (idx [B,S,K] int64, weights [B,S,K] in h's dtype, aux
    fp32 scalar).  Top-k keeps the lower expert id first among equal
    probabilities, as ``jax.lax.top_k`` does (a stable descending sort)."""
    m = cfg.moe
    logits = h.to(torch.float32) @ router_w.to(torch.float32)  # [B,S,E_pad]
    if E_pad > m.num_experts:  # padding experts never win
        logits = torch.cat(
            [logits[..., : m.num_experts], logits[..., m.num_experts :] + -1e30], dim=-1
        )
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., : m.top_k], idx[..., : m.top_k]
    if m.router_norm_topk:
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch-style): E * sum(f_e * p_e)
    T = h.shape[0] * h.shape[1]
    f = F.one_hot(idx[..., 0], E_pad).to(torch.float32).reshape(T, E_pad).mean(0)
    pm = probs.reshape(T, E_pad).mean(0)
    aux = m.num_experts * torch.sum(f * pm)
    return idx, w.to(h.dtype), aux


def _dispatch(h, idx, w, E: int, C: int):
    """Each row of h [N, T, D] (its choices idx / weights w [N, T, K]) into
    its own capacity buffer -> (xe [N, E, C, D], slot [N, T*K], contrib
    [N, T, K]).  Dropped entries go to a spare row past the buffer (never
    read), so no kept slot is written twice."""
    N, T, D = h.shape
    K = idx.shape[-1]
    slot, valid = _dispatch_indices(idx, E, C)  # [N, T, K]
    contrib = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
    # xe[r, e*C + c] = the token routed there
    dest = torch.where(valid, slot, E * C).reshape(N, T * K)
    xe = h.new_zeros((N, E * C + 1, D))
    rows = torch.arange(N, device=h.device)[:, None]
    xe[rows, dest] = h.repeat_interleave(K, dim=1)  # token t*K + k's row
    return xe[:, : E * C].reshape(N, E, C, D), slot.reshape(N, T * K), contrib


def _combine(ye, slot, contrib):
    """ye [N, E, C, D] (each row's expert outputs), slot [N, T*K], contrib
    [N, T, K] -> [N, T, D]: the weighted sum of each token's K outputs."""
    N, T, K = contrib.shape
    rows = torch.arange(N, device=ye.device)[:, None]
    got = ye.reshape(N, -1, ye.shape[-1])[rows, slot].reshape(N, T, K, -1)
    return torch.sum(got * contrib[..., None].to(got.dtype), dim=2)


def _shared(h, p, cfg: ModelConfig):
    """qwen2-moe's shared expert (its sigmoid gate in fp32) on h."""
    act = _ACT[cfg.mlp_act]
    g = torch.sigmoid((h @ p["shared_gate"]).to(torch.float32)).to(h.dtype)
    return g * ((act(h @ p["ws1"]) * (h @ p["ws3"])) @ p["ws2"])


def _moe_ep(x, p, cfg: ModelConfig, ctx: ParallelCtx):
    """Expert parallelism over the ring (the module docstring): x [B, S, D]
    in its global view -> (x + moe(x), aux)."""
    m = cfg.moe
    act = _ACT[cfg.mlp_act]
    ring, n = ctx.ring, ctx.sp_size
    B, S, D = x.shape
    E = p["router"].shape[-1]
    if E % n:
        raise ValueError(f"{cfg.name}: {E} experts do not split over {n} ranks: "
                         "init_params(ctx=...) pads them to a multiple")
    C = int(math.ceil(S // n * m.top_k * m.capacity_factor / E))

    h = rms_norm(x, p["ln"])
    idx, w, aux = _route(h, p["router"], cfg, E)
    # the local ranks' chunks [R, B, S/n, ...], one capacity buffer each
    hs, idxs, ws = (ring.split(t, axis=1) for t in (h, idx, w))
    R = hs.shape[0]
    xe, slot, contrib = _dispatch(hs.flatten(0, 1), idxs.flatten(0, 1), ws.flatten(0, 1), E, C)
    # segment-major -> expert-major: [R, B, E/n, n*C, D]
    xe = ring.all_to_all(xe.unflatten(0, (R, B)), 1, 2, kind="moe_dispatch")
    # the local ranks' experts [R, E/n, ...] of the stacked leaves
    mine = [p[k].unflatten(0, (n, E // n)).narrow(0, ring.ranks[0], R)
            for k in ("we1", "we3", "we2")]
    up = torch.einsum("rbecd,redf->rbecf", xe, mine[0])
    gate = torch.einsum("rbecd,redf->rbecf", xe, mine[1])
    ye = torch.einsum("rbecf,refd->rbecd", act(up) * gate, mine[2])
    # expert-major -> segment-major: [R, B, E, C, D]
    ye = ring.all_to_all(ye, 2, 1, kind="moe_return")
    out = ring.join(_combine(ye.flatten(0, 1), slot, contrib).unflatten(0, (R, B)), axis=1)
    if m.num_shared:
        out = out + _shared(h, p, cfg)
    return x + out.to(x.dtype), aux


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              ctx: ParallelCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (x + moe(x), aux_loss): JAX's ``moe_block``.  Over a
    ring, where JAX takes its segmented expert parallelism, capacity is per
    rank's chunk of each row (``_moe_ep``); else per row, from this call's
    S."""
    m = cfg.moe
    n = ctx.sp_size
    if (m.mode == "ep" and n > 1 and padded_experts(cfg, ctx) % n == 0
            and x.shape[1] % n == 0):
        return _moe_ep(x, p, cfg, ctx)
    act = _ACT[cfg.mlp_act]
    B, S, D = x.shape
    E = p["router"].shape[-1]
    C = int(math.ceil(S * m.top_k * m.capacity_factor / E))

    h = rms_norm(x, p["ln"])
    idx, w, aux = _route(h, p["router"], cfg, E)
    xe, slot, contrib = _dispatch(h, idx, w, E, C)
    up = torch.einsum("becd,edf->becf", xe, p["we1"])
    gate = torch.einsum("becd,edf->becf", xe, p["we3"])
    ye = torch.einsum("becf,efd->becd", act(up) * gate, p["we2"])
    out = _combine(ye, slot, contrib)  # [B, S, D]
    if m.num_shared:
        out = out + _shared(h, p, cfg)
    return x + out.to(x.dtype), aux
