"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060): the port of
``repro/models/ssm.py``, on one rank or sequence-sharded over a ring.

Prefill runs the chunked scan through ``kernels.ssd_scan.ssd_scan_fwd`` (the
CUDA kernel on the card, the plain chunked dual form on the CPU), where JAX
runs its jnp ``_ssd_chunked``.  Training differentiates the same call: under
autograd it goes through ``_SSDScan``, whose backward is kernel #5b
(``ssd_scan_bwd``), where JAX takes ``jax.grad`` of its jnp scan.  Decode is
the O(1) state recurrence in plain PyTorch, as in JAX, with the states
replicated over the ring.

Sequence parallelism (``ctx.sp_size`` n > 1), JAX's ``_ssm_core(...,
axis_name, n)``: the sequence is sharded contiguously over the n ranks of
``ctx.ring`` and the recurrence crosses ranks through its state:

  1. the causal depthwise conv takes a halo of the ``width - 1`` conv inputs
     before the rank's chunk from its left neighbour (comm kind
     ``ssd_halo``; rank 0 gets zeros, the causal pad).  A rank whose chunk
     is shorter than ``width - 1`` passes on what it received with its own
     rows, one more hop each time, until the halo is whole;
  2. ONE scan launch per layer runs every local rank's chunk from h0 = 0,
     the ranks folded into the batch ``[R*B, S/n, H, P]``;
  3. every rank's final state S_i and total decay T_i are gathered
     (``ssd_state``), and each rank's true incoming state is the closed-form
     prefix h0_i = sum_{j<i} (prod_{j<k<i} T_k) S_j, summed in JAX's order;
  4. the outputs are corrected in fp32: y_t += C_t . (exp(cumsum(dt*A))_t h0_i);
  5. the final state (the prefix over all n ranks) and the conv tail (the
     last ``width - 1`` conv inputs of the whole prompt, gathered from the
     last rank: ``ssd_tail``) are the same on every rank.

The code speaks only to the transport (``split``, ``hop``,
``gather_ranks``, ``join``), so one function runs R = n ranks on a
``VirtualRing`` and R = 1 on a ``ProcessGroupRing``.  At n = 1 the block
is the one-rank code: no split and no exchange.  On a ``VirtualRing`` the
block is differentiable end to end: the hops are index copies (the
``serial`` mode) and the gather a view, so gradients flow back through the
halo and the prefix, and the scan's final states, which feed the prefix,
hand #5b a nonzero gradient of the final state.  Over a
``ProcessGroupRing`` no gradient crosses processes (training with one rank
per process is not ported).

Layouts are JAX's: the fused input projection splits into (z, x, B, C, dt);
x is [B, S, H, P] and B, C are [B, S, G, N], handed to the scan as views
of the conv output (no head repeat, no copy in fp32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.parallel.context import ParallelCtx

__all__ = ["init_ssm_params", "ssm_block", "ssm_dims", "init_ssm_cache", "ssm_decode_step"]


def ssm_dims(cfg: ModelConfig):
    """-> (d_inner, H, G, N, P)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.n_groups, s.state_dim, s.head_dim


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype, device) -> dict:
    """JAX's pytree and init law (not its numbers): A = -exp(A_log) = -1,
    D_skip 1, dt_bias 0 at init."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, G, N, _ = ssm_dims(cfg)
    conv_dim = d_inner + 2 * G * N
    f32 = torch.float32
    return {
        "ln": torch.zeros((L, D), dtype=dtype, device=device),
        # fused input projection -> (z, x, B, C, dt)
        "in_proj": dense_init(gen, (L, D, 2 * d_inner + 2 * G * N + H), dtype=dtype,
                              device=device),
        "conv_w": dense_init(gen, (L, s.conv_width, conv_dim), in_axis=-2, dtype=dtype,
                             device=device),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "A_log": torch.zeros((L, H), dtype=f32, device=device),
        "D_skip": torch.ones((L, H), dtype=f32, device=device),
        "dt_bias": torch.zeros((L, H), dtype=f32, device=device),
        "out_ln": torch.zeros((L, d_inner), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (L, d_inner, D), dtype=dtype, device=device),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, H, G, N, _ = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _conv1d_causal(xin: torch.Tensor, w: torch.Tensor, b: torch.Tensor, halo: torch.Tensor):
    """Depthwise causal conv.  xin [B,S,C], w [width,C], halo [B,width-1,C]."""
    width = w.shape[0]
    S = xin.shape[1]
    xp = torch.cat([halo, xin], dim=1)
    out = sum(xp[:, i : i + S] * w[i][None, None, :] for i in range(width))
    return out + b[None, None, :]


def _halo(conv_in: torch.Tensor, ring, width: int) -> torch.Tensor:
    """conv_in [R, B, m, C], each local rank's chunk -> the ``width - 1``
    conv inputs before each chunk [R, B, width-1, C] (zeros before position
    0), over hops from the left neighbour: a rank with m < width - 1 rows
    forwards what it received with its own, so the halo never takes zeros
    in place of real rows."""
    need = width - 1
    perm = [(i, i + 1) for i in range(ring.n - 1)]
    got = None
    while got is None or got.shape[2] < need:
        ext = conv_in if got is None else torch.cat([got, conv_in], dim=2)
        got = ring.hop([ext[:, :, -need:]], perm, kind="ssd_halo", mode="serial").wait()[0]
    return got


def _prefix_states(S: torch.Tensor, T: torch.Tensor) -> list:
    """Every rank's final state S [n, B, H, P, N] from h0 = 0 and total decay
    T [n, B, H] -> [h0_0, ..., h0_n]: h0_i = sum_{j<i} (prod_{j<k<i} T_k)
    S_j, the terms in JAX's order (j ascending, each product over k
    ascending); h0_n is the state after the whole sequence."""
    n = S.shape[0]
    out = [torch.zeros_like(S[0])]
    for i in range(1, n + 1):
        acc = None
        for j in range(i):
            decay = None
            for k in range(j + 1, i):
                decay = T[k] if decay is None else decay * T[k]
            term = S[j] if decay is None else decay[:, :, None, None] * S[j]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _incoming_states(ring, hT: torch.Tensor, total: torch.Tensor, R: int):
    """The local ranks' final states hT [R*B, H, P, N] from h0 = 0 and total
    decays [R*B, H] -> (each local rank's incoming state [R*B, H, P, N], the
    state after the whole sequence [B, H, P, N]), over one gather of every
    rank's pair."""
    allS, allT = ring.gather_ranks([hT.unflatten(0, (R, -1)), total.unflatten(0, (R, -1))],
                                   kind="ssd_state")
    h0s = _prefix_states(allS, allT)
    return torch.stack([h0s[r] for r in ring.ranks]).flatten(0, 1), h0s[ring.n]


def _apply_initial_state(y: torch.Tensor, Cg: torch.Tensor, acum: torch.Tensor,
                         h0: torch.Tensor) -> torch.Tensor:
    """y [B,S,H,P] of a scan from h0 = 0 -> the scan's y from ``h0`` [B,H,P,N]:
    y_t + exp(acum_t) C_t . h0, in fp32; C is [B,S,G,N] (head h reads group
    h // (H/G)) and acum [B,S,H] the decay exponent from the sequence start."""
    H, G = h0.shape[1], Cg.shape[2]
    corr = torch.einsum("btgn,bghpn->btghp", Cg, h0.unflatten(1, (G, H // G)))
    return y + torch.exp(acum)[..., None] * corr.reshape(y.shape)


def _ssm_core(zxbcdt: torch.Tensor, p: dict, cfg: ModelConfig, ring=None):
    """From the fused projection (the global view [B, S, F]) to the gated
    SSD output (before out_proj).  ``ring``: the sequence-parallel transport
    (None: one rank).

    Returns (y [B,S,d_inner], final state [B,H,P,N] fp32, conv tail
    [B,width-1,conv_dim]): the state and conv window a decode continues
    from, the same on every rank."""
    s = cfg.ssm
    d_inner, H, G, N, Pd = ssm_dims(cfg)
    width = s.conv_width
    Bb = zxbcdt.shape[0]
    n = 1 if ring is None else ring.n
    if n > 1:
        # [R, B, S/n, F]: the local ranks' contiguous chunks, folded into
        # the batch from here on
        zr = ring.split(zxbcdt, axis=1)
        R = zr.shape[0]
        zxbcdt = zr.flatten(0, 1)
    S = zxbcdt.shape[1]
    z, xc, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    if n > 1:
        halo = _halo(conv_in.unflatten(0, (R, Bb)), ring, width).flatten(0, 1)
    else:
        halo = torch.zeros((Bb, width - 1, conv_in.shape[-1]), dtype=conv_in.dtype,
                           device=conv_in.device)
    # the last width-1 conv inputs (a halo in front of a short chunk)
    conv_tail = torch.cat([halo, conv_in], dim=1)[:, -(width - 1):]
    conv_out = F.silu(_conv1d_causal(conv_in, p["conv_w"], p["conv_b"], halo))
    xc, Bc, Cc = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    f32 = torch.float32
    xh = xc.reshape(-1, S, H, Pd).to(f32)
    dtf = F.softplus(dt.to(f32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(f32))
    Cg = Cc.reshape(-1, S, G, N).to(f32)
    y, hT = ssd_scan_fwd(xh, dtf, A, Bc.reshape(-1, S, G, N).to(f32), Cg,
                         chunk=min(s.chunk, S))
    if n > 1:
        acum = torch.cumsum(dtf * A, dim=1)  # [R*B, S/n, H]: decay from the chunk start
        h0, hT = _incoming_states(ring, hT, torch.exp(acum[:, -1]), R)
        y = _apply_initial_state(y, Cg, acum, h0)
        tails = ring.gather_ranks([conv_tail.unflatten(0, (R, Bb))], kind="ssd_tail")[0]
        conv_tail = tails[n - 1]
    y = y + p["D_skip"][None, None, :, None].to(f32) * xh
    y = y.reshape(-1, S, d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"])
    if n > 1:
        y = ring.join(y.unflatten(0, (R, Bb)), axis=1)
    return y, hT, conv_tail


def ssm_block(x: torch.Tensor, p: dict, cfg: ModelConfig, ctx: ParallelCtx, *,
              return_state: bool = False):
    """Pre-norm SSD block with residual: x [B, S, D] -> x + SSD(x) @ out_proj.
    ``return_state`` also returns {"state" [B,H,P,N] fp32, "conv"
    [B,width-1,conv_dim] in x's dtype} for decode to continue from.  With
    ``ctx.sp_size`` > 1 the scan is sharded over ``ctx.ring`` (x and the
    output stay the global view)."""
    h = rms_norm(x, p["ln"])
    ring = ctx.ring if ctx.sp_size > 1 else None
    y, hT, conv_tail = _ssm_core(h @ p["in_proj"], p, cfg, ring)
    out = x + y @ p["out_proj"]
    if return_state:
        return out, {"state": hT, "conv": conv_tail.to(x.dtype)}
    return out


# --------------------------------------------------------------------------
# decode: O(1) per token
# --------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, L: int, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """{"conv": [L, B, width-1, conv_dim] in ``dtype``, "state": [L, B, H, P, N]
    fp32}, zeros."""
    s = cfg.ssm
    d_inner, H, G, N, Pd = ssm_dims(cfg)
    conv_dim = d_inner + 2 * G * N
    return {
        "conv": torch.zeros((L, batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((L, batch, H, Pd, N), dtype=torch.float32, device=device),
    }


def ssm_decode_step(x: torch.Tensor, p: dict, cache_l: dict,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, 1, D]; cache_l = {conv [B,w-1,C], state [B,H,P,N]} (one layer).
    Returns (y [B,1,D] residual-added, the new {conv, state}); the cache is
    not written here."""
    d_inner, H, G, N, Pd = ssm_dims(cfg)
    Bb = x.shape[0]
    h = rms_norm(x, p["ln"])
    z, xc, Bc, Cc, dt = _split_proj(h @ p["in_proj"], cfg)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)  # [B,1,C]
    window = torch.cat([cache_l["conv"].to(conv_in.dtype), conv_in], dim=1)  # [B,w,C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"][None, :])
    new_conv = window[:, 1:, :]
    xc, Bc, Cc = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)
    f32 = torch.float32
    xh = xc.reshape(Bb, H, Pd).to(f32)
    Bh = Bc.reshape(Bb, G, N).repeat_interleave(H // G, dim=1).to(f32)
    Ch = Cc.reshape(Bb, G, N).repeat_interleave(H // G, dim=1).to(f32)
    dtf = F.softplus(dt[:, 0].to(f32) + p["dt_bias"][None, :])  # [B,H]
    A = -torch.exp(p["A_log"].to(f32))
    decay = torch.exp(dtf * A)[..., None, None]
    hstate = decay * cache_l["state"] + torch.einsum("bh,bhp,bhn->bhpn", dtf, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", hstate, Ch) + p["D_skip"][None, :, None] * xh
    y = y.reshape(Bb, 1, d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"])
    return x + y @ p["out_proj"], {"conv": new_conv, "state": hstate}
