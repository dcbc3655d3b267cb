"""Weights and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX ``init_params`` pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's parameter dict.
The layouts are the same (``x @ W`` with ``W: [D_in, D_out]``, stacked
``[L, ...]`` layer leaves, same key names), so conversion is a copy with no
transposes.  ``opt_state_from_jax`` does the same for JAX's AdamW
``OptState(step, m, v)``, so a JAX run can continue in the port, and
``cache_from_jax`` for a decode cache (pools, scale tables, block table,
positions; the per-slot SSM conv window and state; the encoder's per-slot
cross-attention K/V), so both can continue from one pool, one recurrent
state or one encoding.  ml_dtypes' bfloat16 and
float8_e4m3fn arrays carry over bit for bit.  This module takes numpy only:
it never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState

__all__ = ["params_from_jax", "opt_state_from_jax", "cache_from_jax"]


def _tensor(arr: np.ndarray, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    # ml_dtypes' bfloat16 and float8_e4m3fn have no numpy counterpart in
    # torch: carry the bits over and reinterpret them
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None) -> Dict:
    """Nested dict of numpy arrays -> the same nest of torch tensors on
    ``device`` (default: the card), optionally cast to ``dtype``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return _tensor(np.asarray(node), dev, dtype)

    return conv(tree)


def opt_state_from_jax(opt_state, device=None) -> OptState:
    """JAX's ``OptState(step, m, v)`` with numpy leaves (``jax.tree.map(
    np.asarray, opt_state)``) -> the port's ``OptState`` on ``device``
    (default: the card): an int32 step and fp32 moments."""
    step, m, v = opt_state
    dev = resolve_device(device)
    return OptState(
        step=_tensor(np.asarray(step, np.int32), dev, torch.int32),
        m=params_from_jax(m, device=dev, dtype=torch.float32),
        v=params_from_jax(v, device=dev, dtype=torch.float32),
    )


def cache_from_jax(cache: Dict[str, Any], device=None) -> Dict[str, Any]:
    """JAX's decode cache with numpy leaves (``jax.tree.map(np.asarray,
    cache)``: ``k``/``v``, optional ``k_scale``/``v_scale`` and ``bt``, ``pos``,
    for SSM / hybrid archs ``ssm: {conv, state}``, for encoder archs
    ``cross_k``/``cross_v``) -> the port's cache
    dict on ``device`` (default: the card), the element types kept (int8 and
    fp8 codes bit for bit; the SSM state in fp32)."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, val in cache.items():
        if key == "ssm":
            if not isinstance(val, dict) or set(val) != {"conv", "state"}:
                raise ValueError("cache_from_jax: the 'ssm' entry must be {conv, state}")
            out[key] = {"conv": _tensor(np.asarray(val["conv"]), dev, None),
                        "state": _tensor(np.asarray(val["state"]), dev, torch.float32)}
            continue
        if key not in ("k", "v", "k_scale", "v_scale", "bt", "pos", "cross_k", "cross_v"):
            raise ValueError(f"cache_from_jax: no port counterpart for cache entry {key!r}")
        out[key] = _tensor(np.asarray(val), dev, None)
    out["pos"] = out["pos"].to(torch.int32)
    return out
