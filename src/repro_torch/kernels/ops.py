"""Public wrappers around the attention kernels.

Counterpart of ``repro/kernels/ops.py``.  There is no backend switch: the
kernel wrappers launch the CUDA kernels for tensors on the card and run the
plain PyTorch versions for tensors on the CPU.

Two API layers, as in JAX:
  * ``flash_attention`` -- static band (causal / window / custom), optional
    segment ids; a ``torch.autograd.Function`` whose forward is the flash
    forward kernel and whose backward is the dQ and dK/dV kernels.
  * ``block_attention`` / ``block_attention_bwd`` -- one AM block, forward and
    backward, with the band given as host ints, a 4-tuple, or an int32
    tensor (the forward also takes one band per batch row, [B, 4]).
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


class _Flash(torch.autograd.Function):
    """Forward through the flash forward kernel; backward through the dQ and
    dK/dV kernels from the saved (q, k, v, o, lse) and segment ids."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, band, scale, stride_q, stride_kv):
        o, lse = block_attention(
            q, k, v, band, scale=scale, stride_q=stride_q, stride_kv=stride_kv,
            seg_q=seg_q, seg_kv=seg_kv,
        )
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.band, ctx.scale, ctx.strides = band, scale, (stride_q, stride_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        stride_q, stride_kv = ctx.strides
        dq, dk, dv = block_attention_bwd(
            q, k, v, o, lse, do.contiguous(), ctx.band, scale=ctx.scale,
            stride_q=stride_q, stride_kv=stride_kv, seg_q=seg_q, seg_kv=seg_kv,
        )
        return dq, dk, dv, None, None, None, None, None, None


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
    if scale is None:
        scale = q.shape[-1] ** -0.5
    band = tuple(int(x) for x in band)
    if seg_q is not None and seg_kv is None:
        seg_kv = seg_q
    return _Flash.apply(q, k, v, seg_q, seg_kv, band, float(scale), stride_q, stride_kv)


combine_partials = ref.combine_partials
