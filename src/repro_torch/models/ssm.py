"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060): the port of
``repro/models/ssm.py``; the scan runs over the whole sequence in one
process (JAX's sequence-sharded scan is not ported).

Prefill runs the chunked scan through ``kernels.ssd_scan.ssd_scan_fwd`` (the
CUDA kernel on the card, the plain chunked dual form on the CPU), where JAX
runs its jnp ``_ssd_chunked``.  The causal depthwise conv sees a zero halo
(the sequence-sharded halo exchange and state combine come with the mesh
slice).  Decode is the O(1) state recurrence in plain PyTorch, as in JAX.

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


def _ssm_core(zxbcdt: torch.Tensor, p: dict, cfg: ModelConfig):
    """From the fused projection to the gated SSD output (before out_proj).

    Returns (y [B,S,d_inner], final state [B,H,P,N] fp32, conv tail
    [B,width-1,conv_dim]): the state and conv window a decode continues
    from."""
    s = cfg.ssm
    d_inner, H, G, N, Pd = ssm_dims(cfg)
    Bb, S, _ = zxbcdt.shape
    z, xc, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    width = s.conv_width
    halo = torch.zeros((Bb, width - 1, conv_in.shape[-1]), dtype=conv_in.dtype,
                       device=conv_in.device)
    conv_out = F.silu(_conv1d_causal(conv_in, p["conv_w"], p["conv_b"], halo))
    xc, Bc, Cc = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    f32 = torch.float32
    xh = xc.reshape(Bb, S, H, Pd).to(f32)
    dtf = F.softplus(dt.to(f32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(f32))
    y, hT = ssd_scan_fwd(
        xh, dtf, A, Bc.reshape(Bb, S, G, N).to(f32), Cc.reshape(Bb, S, G, N).to(f32),
        chunk=min(s.chunk, S),
    )
    # the last width-1 conv inputs (zero halo in front of a short prompt)
    conv_tail = torch.cat([halo, conv_in], dim=1)[:, -(width - 1):]
    y = y + p["D_skip"][None, None, :, None].to(f32) * xh
    y = y.reshape(Bb, S, d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z), p["out_ln"])
    return y, hT, conv_tail


def ssm_block(x: torch.Tensor, p: dict, cfg: ModelConfig, ctx: ParallelCtx, *,
              return_state: bool = False):
    """Pre-norm SSD block with residual: x [B, S, D] -> x + SSD(x) @ out_proj.
    ``return_state`` also returns {"state" [B,H,P,N] fp32, "conv"
    [B,width-1,conv_dim] in x's dtype} for decode to continue from.  ``ctx``
    is unused: the block sees the whole (contiguous) sequence, also when
    attention runs over a sequence-parallel ring."""
    del ctx
    h = rms_norm(x, p["ln"])
    y, hT, conv_tail = _ssm_core(h @ p["in_proj"], p, cfg)
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
