"""Public wrappers around the attention kernels.

Counterpart of ``repro/kernels/ops.py``.  There is no backend switch: the
kernel wrappers launch the CUDA kernels for tensors on the card and run the
plain PyTorch versions for tensors on the CPU.

Two API layers, as in JAX:
  * ``flash_attention`` -- static band (causal / window / custom), optional
    segment ids; differentiable: ``differentiable_block_attention``'s o, so
    its forward is the flash forward kernel and its backward the dQ and
    dK/dV kernels.
  * ``block_attention`` / ``block_attention_bwd`` -- one AM block, forward and
    backward, with the band given as host ints, a 4-tuple, or an int32
    tensor (the forward also takes one band per batch row, [B, 4]).
  * ``differentiable_block_attention`` -- one AM block, (o, lse), with an
    autograd rule for both outputs: what ``jax.grad`` does through JAX's
    plain block, for the latent wire's program (``core/mesh_attention.py``),
    which merges blocks by lse outside any ``autograd.Function``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def full_band() -> Tuple[int, int, int, int]:
    return (0, 0, -ref.BAND_INF, ref.BAND_INF)


def block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    band,  # 4 ints / int32 [4] / int32 [B, 4]
    *,
    scale: Optional[float] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    block_q: int = fa.DEFAULT_BLOCK_Q,
    block_kv: int = fa.DEFAULT_BLOCK_KV,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AM-block attention: (o, lse); no autograd rule."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return fa.flash_attention_fwd(
        q, k, v, band, scale=scale, stride_q=stride_q, stride_kv=stride_kv,
        block_q=block_q, block_kv=block_kv, seg_q=seg_q, seg_kv=seg_kv,
    )


def block_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: Optional[torch.Tensor],
    lse: torch.Tensor,
    do: torch.Tensor,
    band,  # 4 ints / int32 [4]
    *,
    scale: Optional[float] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    block_q: int = fa.DEFAULT_BLOCK_Q,
    block_kv: int = fa.DEFAULT_BLOCK_KV,
    delta: Optional[torch.Tensor] = None,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AM-block backward from the saved (o, lse): (dq, dk, dv).

    Either ``o`` or ``delta`` (= rowsum(do*o), [B,Sq,H]) must be given."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return fa.flash_attention_bwd(
        q, k, v, o, lse, do, band, scale=scale, stride_q=stride_q, stride_kv=stride_kv,
        block_q=block_q, block_kv=block_kv, delta=delta, seg_q=seg_q, seg_kv=seg_kv,
    )


class _Block(torch.autograd.Function):
    """One AM block, (o, lse): the flash forward, then the dQ and dK/dV
    kernels once per band group.  lse's cotangent g enters through delta:
    dL/ds_ij = P_ij (dP_ij - delta_i + g_i), the usual backward at
    delta' = rowsum(dO.O) - g.  Without g (``flash_attention``, or an lse
    that reached no loss) the kernels take o and form rowsum(dO.O)
    themselves."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, band, groups, kw):
        ctx.set_materialize_grads(False)
        o, lse = block_attention(q, k, v, band, seg_q=seg_q, seg_kv=seg_kv, **kw)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.band, ctx.groups, ctx.kw = band, groups, kw
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        band = ctx.band
        do = torch.zeros_like(o) if do is None else do.to(q.dtype).contiguous()
        delta = None
        if dlse is not None:
            delta = torch.sum(do.float() * o.float(), dim=-1) - dlse.float().transpose(-1, -2)
        rows = q.shape[0] // ctx.groups
        grads = []
        for g in range(ctx.groups):
            sl = slice(g * rows, (g + 1) * rows)
            band_g = band[g * rows] if isinstance(band, torch.Tensor) and band.dim() == 2 \
                else band
            grads.append(block_attention_bwd(
                q[sl], k[sl], v[sl], o[sl] if delta is None else None, lse[sl], do[sl], band_g,
                delta=None if delta is None else delta[sl].contiguous(),
                seg_q=seg_q, seg_kv=seg_kv, **ctx.kw))
        dq, dk, dv = (g[0] if len(g) == 1 else torch.cat(g) for g in zip(*grads))
        return dq, dk, dv, None, None, None, None, None


def differentiable_block_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    band,  # 4 ints / int32 [4] / int32 [B, 4]
    *,
    groups: Optional[int] = None,
    scale: Optional[float] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    block_q: int = fa.DEFAULT_BLOCK_Q,
    block_kv: int = fa.DEFAULT_BLOCK_KV,
    seg_q: Optional[torch.Tensor] = None,
    seg_kv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block_attention`` with an autograd rule for o and lse.  The forward
    is one launch; the backward takes one band per launch, so a per-row
    band [B, 4] is read as ``groups`` runs of B / groups rows that share
    their first row's band (default: one run per row), each run one dQ and
    one dK/dV launch."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    per_row = isinstance(band, torch.Tensor) and band.dim() == 2
    if groups is None:
        groups = q.shape[0] if per_row else 1
    if q.shape[0] % groups or (groups > 1 and not per_row):
        raise ValueError(f"{groups} band groups need a per-row band over a batch they divide, "
                         f"got batch {q.shape[0]}")
    if not isinstance(band, torch.Tensor):
        band = tuple(int(x) for x in band)
    kw = dict(scale=float(scale), stride_q=stride_q, stride_kv=stride_kv, block_q=block_q,
              block_kv=block_kv)
    return _Block.apply(q, k, v, seg_q, seg_kv, band, groups, kw)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    band: Optional[Tuple[int, int, int, int]] = None,
    scale: Optional[float] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    seg_q: Optional[torch.Tensor] = None,  # [Sq] int32 segment ids
    seg_kv: Optional[torch.Tensor] = None,  # [Skv]
) -> torch.Tensor:
    """Attention with a static band (causal/window/custom), optionally
    composed with runtime segment ids (packed documents)."""
    if band is None:
        if causal:
            band = (0, 0, 0, (window - 1) if window else ref.BAND_INF)
        elif window:
            band = (0, 0, -(window - 1), window - 1)
        else:
            band = full_band()
    if seg_q is not None and seg_kv is None:
        seg_kv = seg_q
    return differentiable_block_attention(q, k, v, band, scale=scale, stride_q=stride_q,
                                          stride_kv=stride_kv, seg_q=seg_q, seg_kv=seg_kv)[0]


combine_partials = ref.combine_partials
