"""Public wrappers around the attention kernels.

Counterpart of ``repro/kernels/ops.py``.  There is no backend switch: the
kernel wrappers launch the CUDA kernel for tensors on the card and run the
plain PyTorch version for tensors on the CPU.

Two API layers, as in JAX:
  * ``flash_attention`` -- static band (causal / window / custom), optional
    segment ids; a ``torch.autograd.Function`` whose backward is not ported
    yet (it raises until the training slice brings the dQ/dKV kernels).
  * ``block_attention`` -- one AM block with a band given as host ints, a
    4-tuple, or an int32 tensor ([4] or one band per batch row [B, 4]).
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


class _Flash(torch.autograd.Function):
    """Forward through the kernel; the backward kernels are not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, band, scale, stride_q, stride_kv):
        o, _ = block_attention(
            q, k, v, band, scale=scale, stride_q=stride_q, stride_kv=stride_kv,
            seg_q=seg_q, seg_kv=seg_kv,
        )
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "training slice: the flash-attention backward kernels (dQ, dK/dV) are not "
            "ported to the GPU yet"
        )


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
