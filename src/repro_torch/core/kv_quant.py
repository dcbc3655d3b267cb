"""Quantized KV-pool storage: int8 / fp8-e4m3 pages with fp32 scale tables
(copy of ``repro/core/kv_quant.py``).

The paged pool stores K/V pages in a narrow dtype and keeps symmetric scales
in a side table that shares the pool's physical-page indexing (``[L,
num_pages, chunk, Hkv]`` next to pages ``[L, num_pages, chunk, Hkv, D]``).
Scales are per token per kv-head within a page -- amax over the head dim only
-- so incremental appends (decode, chunked prefill, speculative verify) never
re-quantize previously written positions: each position's ``(q, scale)``
pair is written exactly once.  The scale table rides the block table's page
indexing, so copy-on-write, rollback and prefix sharing move scales in
lockstep with pages.

Error model (elementwise, against the per-(token, head) amax):

- ``int8``: ``scale = amax / 127``, round half to even (``torch.round``, as
  ``jnp.round``) -> ``|x - deq(q)| <= amax / 254``.
- ``fp8`` (``torch.float8_e4m3fn``, 3 mantissa bits): ``scale = amax / 448``
  maps amax to the format's largest normal -> relative error ``<= 2**-4``.

Codes are bit-equal to the JAX module's.  PyTorch's cast to fp8 saturates
above 448 where ml_dtypes gives NaN; ``x / scale`` never leaves [-448, 448],
so neither behaviour is reached and no clamp is added.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "KV_DTYPES",
    "QUANT_KV_DTYPES",
    "REL_ERROR_BOUND",
    "SCALE_DTYPE",
    "fp8_dtype",
    "fp8_supported",
    "pool_kv_dtype",
    "storage_dtype",
    "storage_itemsize",
    "quantize",
    "dequantize",
    "store",
]

KV_DTYPES = ("fp", "int8", "fp8")
QUANT_KV_DTYPES = ("int8", "fp8")

# max representable magnitude the amax is mapped onto
_QMAX = {"int8": 127.0, "fp8": 448.0}

# elementwise |x - dequantize(quantize(x))| <= REL_ERROR_BOUND * amax(token, head)
REL_ERROR_BOUND = {"fp": 0.0, "int8": 1.0 / 254.0, "fp8": 2.0**-4}

SCALE_DTYPE = torch.float32


def fp8_dtype() -> Optional[torch.dtype]:
    """The fp8-e4m3 storage dtype, or None when this torch lacks it."""
    return getattr(torch, "float8_e4m3fn", None)


def fp8_supported() -> bool:
    return fp8_dtype() is not None


def storage_dtype(kv_dtype: str, fp_dtype: torch.dtype = torch.float32) -> torch.dtype:
    """Pool element dtype for a ``kv_dtype`` knob value."""
    if kv_dtype == "fp":
        return fp_dtype
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        dt = fp8_dtype()
        if dt is None:
            raise ValueError("kv_dtype='fp8' requires torch.float8_e4m3fn")
        return dt
    raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")


def storage_itemsize(kv_dtype: str, fp_dtype: torch.dtype = torch.float32) -> int:
    return torch.empty((), dtype=storage_dtype(kv_dtype, fp_dtype)).element_size()


def pool_kv_dtype(pool: torch.Tensor) -> str:
    """Storage mode of a pool tensor, from its dtype."""
    if pool.dtype == torch.int8:
        return "int8"
    if pool.dtype == fp8_dtype():
        return "fp8"
    return "fp"


def quantize(x: torch.Tensor, kv_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization over the last (head-dim) axis -> ``(q, scale)``
    with ``q.shape == x.shape`` in the storage dtype and ``scale.shape ==
    x.shape[:-1]`` in fp32.  Zero rows get scale 0 and codes 0, so
    zero-initialized pool positions and scale entries agree."""
    if kv_dtype not in QUANT_KV_DTYPES:
        raise ValueError(f"quantize expects one of {QUANT_KV_DTYPES}, got {kv_dtype!r}")
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = (amax / _QMAX[kv_dtype]).to(SCALE_DTYPE)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(xf / safe), -127.0, 127.0).to(torch.int8)
    else:
        q = (xf / safe).to(storage_dtype("fp8"))
    return q, scale


def dequantize(q: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`quantize`; ``scale`` broadcasts over the head dim.
    ``scale=None`` is the fp passthrough (a cast to fp32)."""
    if scale is None:
        return q.float()
    return q.float() * scale[..., None].float()


def store(pool: torch.Tensor, scales: Optional[torch.Tensor], index, x: torch.Tensor) -> None:
    """Write ``x`` at ``pool[index]`` in place.  A quantized pool (``scales``
    given) gets the codes, and ``scales[index]`` the scales: every write path
    quantizes here, at write time."""
    if scales is None:
        pool[index] = x.to(pool.dtype)
        return
    codes, sc = quantize(x, pool_kv_dtype(pool))
    pool[index] = codes
    scales[index] = sc
