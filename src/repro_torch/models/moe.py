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
Expert parallelism over a sequence ring (JAX's ``_moe_ep_segmented`` and
``_moe_ep_manual``) is not ported: ``moe_block`` raises at sp_size > 1.
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


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              ctx: ParallelCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (x + moe(x), aux_loss), capacity per row from this
    call's S."""
    if ctx.sp_size > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE over a sequence-parallel ring needs expert parallelism "
            "(the dispatch all-to-all over the ranks): ROADMAP A.7"
        )
    m = cfg.moe
    act = _ACT[cfg.mlp_act]
    B, S, D = x.shape
    K = m.top_k
    E = p["router"].shape[-1]
    C = int(math.ceil(S * K * m.capacity_factor / E))

    h = rms_norm(x, p["ln"])
    idx, w, aux = _route(h, p["router"], cfg, E)
    slot, valid = _dispatch_indices(idx, E, C)  # [B, S, K]
    contrib = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
    # xe[b, e*C + c] = the token routed there; dropped entries go to a spare
    # row past the buffer (never read), so no kept slot is written twice
    dest = torch.where(valid, slot, E * C).reshape(B, S * K)
    xe = h.new_zeros((B, E * C + 1, D))
    rows = torch.arange(B, device=x.device)[:, None]
    xe[rows, dest] = h.repeat_interleave(K, dim=1)  # token t*K + k's row
    xe = xe[:, : E * C].reshape(B, E, C, D)
    up = torch.einsum("becd,edf->becf", xe, p["we1"])
    gate = torch.einsum("becd,edf->becf", xe, p["we3"])
    ye = torch.einsum("becf,efd->becd", act(up) * gate, p["we2"]).reshape(B, E * C, D)
    got = ye[rows, slot.reshape(B, S * K)].reshape(B, S, K, D)
    out = torch.sum(got * contrib[..., None].to(got.dtype), dim=2)  # [B, S, D]

    if m.num_shared:
        g = torch.sigmoid((h @ p["shared_gate"]).to(torch.float32)).to(h.dtype)
        shared = (act(h @ p["ws1"]) * (h @ p["ws3"])) @ p["ws2"]
        out = out + g * shared
    return x + out.to(x.dtype), aux
