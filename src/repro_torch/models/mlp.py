"""Gated feed-forward block (SwiGLU / GeGLU), copy of ``repro/models/mlp.py``
for the dense decoder.  The projections are plain matrix products."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm

__all__ = ["init_mlp_params", "mlp_block"]

_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype, device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w1": dense_init(gen, (L, D, Fd), dtype=dtype, device=device),
        "w2": dense_init(gen, (L, Fd, D), dtype=dtype, device=device),
        "w3": dense_init(gen, (L, D, Fd), dtype=dtype, device=device),
        "ln": torch.zeros((L, D), dtype=dtype, device=device),
    }


def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm gated MLP with residual: x + (act(h W1) * (h W3)) W2."""
    h = rms_norm(x, p["ln"])
    up = _ACT[cfg.mlp_act](h @ p["w1"]) * (h @ p["w3"])
    return x + up @ p["w2"]
