"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain (whisper's GELU
MLP), copy of ``repro/models/mlp.py``.  The projections are plain matrix
products."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, norm_params, pre_norm

__all__ = ["init_mlp_params", "mlp_block"]

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype, device) -> dict:
    """``w1``, ``w2``, and ``w3`` only when the MLP is gated; the norm's
    ``ln`` (and ``ln_b`` for LayerNorm)."""
    D, Fd = cfg.d_model, cfg.d_ff
    p = {
        "w1": dense_init(gen, (L, D, Fd), dtype=dtype, device=device),
        "w2": dense_init(gen, (L, Fd, D), dtype=dtype, device=device),
    }
    if cfg.mlp_gated:
        p["w3"] = dense_init(gen, (L, D, Fd), dtype=dtype, device=device)
    p.update(norm_params(cfg.norm, (L, D), dtype, device))
    return p


def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm MLP with residual: x + (act(h W1) * (h W3)) W2 when gated,
    x + act(h W1) W2 when not."""
    h = pre_norm(x, p, cfg.norm)
    up = _ACT[cfg.mlp_act](h @ p["w1"])
    if cfg.mlp_gated:
        up = up * (h @ p["w3"])
    return x + up @ p["w2"]
