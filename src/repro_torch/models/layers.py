"""Shared building blocks: norms, rotary embedding, initializer, loss (copy
of ``repro/models/layers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["rms_norm", "layer_norm", "pre_norm", "norm_params", "rope", "dense_init",
           "vocab_cross_entropy"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the JAX package's ``(1 + w)`` gain (weights init at 0)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in fp32 (biased variance), gain ``w``
    (init 1) and bias ``b`` (init 0), as whisper's."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(dt)


def pre_norm(x: torch.Tensor, p: dict, norm: str) -> torch.Tensor:
    """A block's input norm from its ``ln`` (and, for LayerNorm, ``ln_b``)."""
    if norm == "layernorm":
        return layer_norm(x, p["ln"], p["ln_b"])
    return rms_norm(x, p["ln"])


def norm_params(norm: str, shape, dtype, device) -> dict:
    """A norm's parameters as JAX inits them: LayerNorm gain 1 and bias 0;
    RMSNorm's ``(1 + w)`` gain at w = 0."""
    if norm == "layernorm":
        return {"ln": torch.ones(shape, dtype=dtype, device=device),
                "ln_b": torch.zeros(shape, dtype=dtype, device=device)}
    return {"ln": torch.zeros(shape, dtype=dtype, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last dim of x [B, S, H, D]: fp32
    angles, pairs split as [first half, second half] (llama convention).
    ``positions``: [S] or [B, S] true token positions."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(device=x.device, dtype=torch.float32) * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(
    generator: torch.Generator,
    shape: Sequence[int],
    in_axis: int = -2,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Truncated-normal fan-in init (std 1/sqrt(fan_in), cut at 2 std) drawn
    from ``generator``.  A stacked [L, ...] leaf is drawn one layer at a time,
    so the fp32 scratch stays one layer's size."""
    shape = tuple(shape)
    std = shape[in_axis] ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    slices = [out] if len(shape) < 3 else list(out)
    for dst in slices:
        tmp = torch.empty(dst.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        dst.copy_(tmp.mul_(std))
    return out


def vocab_cross_entropy(
    logits: torch.Tensor,  # [B, S, V] (any float dtype; reductions in fp32)
    labels: torch.Tensor,  # [B, S] int
    mask: Optional[torch.Tensor] = None,  # [B, S] 0/1
) -> torch.Tensor:
    """Mean token negative log-likelihood, fp32 log-sum-exp; with ``mask``
    the mean over the unmasked tokens (at least one)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.to(device=lf.device, dtype=torch.int64)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(device=lf.device, dtype=torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
