"""Runtime context threaded through the model code (copy of
``repro/parallel/context.py`` without the mesh handle).

``sp_size`` is the width of the sequence-parallel ring and ``ring`` its
transport (``parallel/ring.py``): JAX's mesh axis.  ``sp_size > 1`` on one
process defaults to a ``VirtualRing(sp_size)`` -- all ranks on one device,
the one-card stand-in for JAX's fake-device mesh; a ``ProcessGroupRing``
puts one rank on each process.  The attention knobs are JAX's: which
backend (``attn_impl``), the tile height (``mesh_a``), the backward wire,
the ring-transport mode and the autotuner with its plan cache.  ``device``
is where the engine puts its cache and where ``init_cache`` allocates; it
defaults to the card (see ``repro_torch.device``).  Training and serving
both run over the ring, for the dense (MLA included), MoE, SSM and
hybrid families: the engine shards its KV cache over the ranks and folds
them into one launch per decode, chunk or verify step
(``core/decode_attention.py``), SSM and hybrid archs shard their SSD scan
over the same ring (``models/ssm.py``), "ep" MoE archs send each rank's
tokens to the experts' ranks by all-to-all (``models/moe.py``), and MLA
archs may put their latent on the KV ring (``mla_latent_wire``); serving
needs every rank in the process (a ``VirtualRing``).  Frontend and encoder
archs run at sp_size 1 only (ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.schedule import validate_comm_overlap
from repro_torch.core.tiling import best_square_a
from repro_torch.parallel.ring import VirtualRing

__all__ = ["ParallelCtx"]

_DECODE_KERNELS = ("auto", "native", "gather")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    sp_size: int = 1  # sequence-parallel width (ranks of the ring)
    ring: Optional[object] = None  # the transport; None -> VirtualRing(sp_size) if > 1
    # --- Mesh-Attention configuration (the paper's knobs) ---
    attn_impl: str = "mesh"  # any registered dispatch backend (mesh | ring | ulysses | ...)
    mesh_a: Optional[int] = None  # tile height; None -> divisor closest to sqrt(n)
    allow_concurrent_rings: bool = False
    bwd_wire: str = "qdod"
    comm_overlap: str = "overlap"  # ring transport: serial | overlap | bidir
    block_q: int = 128
    block_kv: int = 128
    attn_autotune: bool = False  # pick (a, b) + schedules via the simulator
    plan_cache_dir: Optional[str] = None  # None -> dispatch's default cache dir
    decode_kernel: str = "auto"  # auto (paged -> native split-K kernel,
    # dense -> the band kernel per row) | native | gather
    device: Union[str, torch.device] = "cuda"
    remat: bool = True  # recompute each layer's activations in the backward
    mla_latent_wire: bool = False  # MLA at sp_size > 1: circulate the latent on
    # the KV ring and expand it per head at first use (latent_wire_attention)

    def __post_init__(self):
        if self.sp_size < 1:
            raise ValueError(f"sp_size must be >= 1, got {self.sp_size}")
        if self.ring is None and self.sp_size > 1:
            object.__setattr__(self, "ring", VirtualRing(self.sp_size))
        if self.ring is not None and self.ring.n != self.sp_size:
            raise ValueError(f"the ring has {self.ring.n} ranks but sp_size={self.sp_size}")
        validate_comm_overlap(self.comm_overlap)
        if self.bwd_wire not in ("odoq", "qdod"):
            raise ValueError(f"unknown bwd_wire {self.bwd_wire!r}; expected odoq | qdod")
        if self.decode_kernel not in _DECODE_KERNELS:
            raise ValueError(
                f"unknown decode_kernel {self.decode_kernel!r}; expected "
                + " | ".join(_DECODE_KERNELS)
            )

    def tile_a(self) -> int:
        if self.mesh_a is not None:
            return self.mesh_a
        return best_square_a(self.sp_size)
