"""Runtime context threaded through the model code (minimal copy of
``repro/parallel/context.py``).

This slice runs on one card, so there is no mesh: ``sp_size`` must be 1.
``device`` is where the engine puts its cache and where ``init_cache``
allocates; it defaults to the card (see ``repro_torch.device``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = ["ParallelCtx"]

_DECODE_KERNELS = ("auto", "native", "gather")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    sp_size: int = 1  # sequence-parallel width; > 1 arrives with the mesh slice
    block_q: int = 128
    block_kv: int = 128
    decode_kernel: str = "auto"  # auto (paged -> native split-K kernel,
    # dense -> the band kernel per row) | native | gather
    device: Union[str, torch.device] = "cuda"
    remat: bool = True  # recompute each layer's activations in the backward

    def __post_init__(self):
        if self.sp_size != 1:
            raise NotImplementedError(
                "sp_size > 1 (sequence-sharded attention over a mesh) is not ported yet; "
                "it comes with the mesh/ring executor slice"
            )
        if self.decode_kernel not in _DECODE_KERNELS:
            raise ValueError(
                f"unknown decode_kernel {self.decode_kernel!r}; expected "
                + " | ".join(_DECODE_KERNELS)
            )
