"""The attention seam: "which attention" is a config (single-card copy of
``repro/core/dispatch.py``).

Every attention call goes through ``distributed_attention`` (batched
prefill / forward), ``decode_attention_step`` (one cached token) or
``chunk_attention_step`` (a chunk of cached tokens: continuous prefill and
speculative verify).  An ``AttentionPlanConfig`` names a backend from the
registry.  On one card the
``local-flash`` backend serves the batched path and the ``decode`` backend
the cached path; ``mesh``, ``ring`` and ``ulysses`` are registered so a plan
naming them fails loudly -- they need a sequence-sharded mesh (n > 1), which
arrives with the mesh/ring executor slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.decode_attention import (
    chunk_write_coords,
    paged_cache_chunk_decode,
    paged_cache_chunk_update,
    paged_cache_decode,
    paged_cache_update,
    paged_write_coords,
    sharded_cache_chunk_decode,
    sharded_cache_chunk_update,
    sharded_cache_decode,
    sharded_cache_update,
)
from repro_torch.core.masking import MaskSpec
from repro_torch.kernels import ops

__all__ = [
    "AttentionPlanConfig",
    "Backend",
    "register_backend",
    "get_backend",
    "available_backends",
    "resolve_backend_name",
    "distributed_attention",
    "decode_attention_step",
    "chunk_attention_step",
    "chunk_write_coords",
    "paged_write_coords",
    "plan_from_ctx",
]

_DECODE_KERNELS = ("auto", "native", "gather")


@dataclasses.dataclass(frozen=True)
class AttentionPlanConfig:
    """Declarative selection of an attention backend.  ``backend="auto"``
    resolves to ``local-flash`` for n <= 1."""

    backend: str = "auto"
    n: int = 1
    causal: bool = False
    window: Optional[int] = None
    layout: str = "striped"  # striped | contiguous (the decode cache geometry)
    scale: Optional[float] = None
    block_q: int = 128
    block_kv: int = 128
    mask: Optional[MaskSpec] = None  # first-class mask; supersedes causal/window
    paged: bool = False  # decode reads/writes a page pool through a block table
    # "auto" -> "native" (the split-K kernel reading the block table) for the
    # paged cache, the band kernel per row for the dense cache
    decode_kernel: str = "auto"

    def __post_init__(self):
        if self.mask is not None and (self.causal or self.window is not None):
            raise ValueError("pass either mask= or the legacy causal/window flags, not both")
        if self.decode_kernel not in _DECODE_KERNELS:
            raise ValueError(
                f"unknown decode_kernel {self.decode_kernel!r}; expected auto | native | gather"
            )

    def resolved_backend(self) -> str:
        return resolve_backend_name(self)

    def mask_spec(self) -> MaskSpec:
        if self.mask is not None:
            return self.mask
        return MaskSpec.from_flags(self.causal, self.window)


def _resolve_decode_kernel(kernel: Optional[str], paged: bool) -> str:
    """"auto" -> the split-K native kernel for the paged cache and the band
    kernel (flash forward, one band per row) for the dense cache; "gather"
    on the dense cache is the band path; "native" forces the split-K kernel
    on either (the dense cache through an identity block table).  Unlike
    JAX there is no backend policy to consult: kernels launch on the card and
    their plain versions run on the CPU."""
    if kernel in (None, "auto"):
        return "native" if paged else "band"
    if kernel not in ("native", "gather"):
        raise ValueError(f"unknown decode_kernel {kernel!r}; expected auto | native | gather")
    return "band" if (kernel == "gather" and not paged) else kernel


def plan_from_ctx(
    ctx,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    backend: Optional[str] = None,
    mask: Optional[MaskSpec] = None,
) -> AttentionPlanConfig:
    """The attention plan a ``ParallelCtx`` implies.  ``mask`` supersedes the
    legacy causal/window pair."""
    return AttentionPlanConfig(
        backend=backend or "auto",
        n=ctx.sp_size,
        causal=causal if mask is None else False,
        window=window if mask is None else None,
        mask=mask,
        layout=layout,
        scale=scale,
        block_q=ctx.block_q,
        block_kv=ctx.block_kv,
        decode_kernel=ctx.decode_kernel,
    )


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered attention implementation: ``apply`` is the batched
    entry, ``step`` the incremental-decode entry (None when unsupported)."""

    name: str
    apply: Optional[Callable] = None  # (q, k, v, cfg, seg=None) -> o
    step: Optional[Callable] = None  # decode step, see decode_attention_step
    description: str = ""


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown attention backend {name!r}; registered backends: "
            f"{', '.join(available_backends())}"
        ) from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def resolve_backend_name(cfg: AttentionPlanConfig) -> str:
    if cfg.backend == "auto":
        return "local-flash" if cfg.n <= 1 else "mesh"
    get_backend(cfg.backend)  # raise early on unknown names
    return cfg.backend


def _needs_mesh(name: str) -> Callable:
    def apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
        raise NotImplementedError(
            f"the {name!r} backend needs a sequence-sharded mesh (n > 1); it comes with "
            "the mesh/ring executor slice of the port"
        )

    return apply


def _local_flash_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    spec = cfg.mask_spec()
    if spec.needs_segments and seg is None:
        raise ValueError(f"mask kind {spec.kind!r} needs a segment-id operand")
    return ops.flash_attention(
        q, k, v, causal=spec.is_causal, window=spec.window, scale=cfg.scale,
        seg_q=seg, seg_kv=seg,
    )


def _decode_step_local(
    q, k_new, v_new, k_cache, v_cache, pos, cfg: AttentionPlanConfig, bt=None, write_coords=None,
    ks=None, vs=None,
):
    """One decode tick over the local cache: update in place, then decode.
    With ``cfg.paged`` the caches are the page pool, ``bt`` the block table
    and ``write_coords`` (optional) the append's ``paged_write_coords``;
    ``ks``/``vs`` are a quantized pool's scale tables (updated in place)."""
    if cfg.paged:
        paged_cache_update(
            k_cache, v_cache, k_new, v_new, bt, pos, None, cfg.n, layout=cfg.layout,
            coords=write_coords, k_scale=ks, v_scale=vs,
        )
        o = paged_cache_decode(
            q, k_cache, v_cache, bt, pos, None, cfg.n,
            layout=cfg.layout, window=cfg.window, scale=cfg.scale,
            kernel=_resolve_decode_kernel(cfg.decode_kernel, paged=True),
            k_scale=ks, v_scale=vs,
        )
        return o, k_cache, v_cache
    k_cache, v_cache = sharded_cache_update(
        k_cache, v_cache, k_new, v_new, pos, None, cfg.n, layout=cfg.layout
    )
    o = sharded_cache_decode(
        q, k_cache, v_cache, pos, None, cfg.n,
        layout=cfg.layout, window=cfg.window, scale=cfg.scale,
        kernel=_resolve_decode_kernel(cfg.decode_kernel, paged=False),
    )
    return o, k_cache, v_cache


def _chunk_step_local(
    q, k_new, v_new, k_cache, v_cache, starts, lens, wstarts, cfg: AttentionPlanConfig,
    bt=None, ks=None, vs=None, write_coords=None,
):
    """One chunk over the local cache: scatter the chunk's K/V by absolute
    position (in place; quantized with ``ks``/``vs``; at ``write_coords``
    when given), then prefix-causal chunk attention over everything
    resident."""
    if cfg.paged:
        paged_cache_chunk_update(
            k_cache, v_cache, k_new, v_new, bt, starts, lens, wstarts, None, cfg.n,
            layout=cfg.layout, k_scale=ks, v_scale=vs, coords=write_coords,
        )
        o = paged_cache_chunk_decode(
            q, k_cache, v_cache, bt, starts, None, cfg.n,
            layout=cfg.layout, window=cfg.window, scale=cfg.scale, k_scale=ks, v_scale=vs,
        )
        return o, k_cache, v_cache
    sharded_cache_chunk_update(
        k_cache, v_cache, k_new, v_new, starts, lens, wstarts, None, cfg.n, layout=cfg.layout,
        coords=write_coords,
    )
    o = sharded_cache_chunk_decode(
        q, k_cache, v_cache, starts, None, cfg.n,
        layout=cfg.layout, window=cfg.window, scale=cfg.scale,
    )
    return o, k_cache, v_cache


def _decode_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    raise ValueError(
        "the 'decode' backend is step-wise (KV cache); call "
        "repro_torch.core.dispatch.decode_attention_step instead of distributed_attention"
    )


for _name, _desc in (
    ("mesh", "Mesh-Attention (a x b tile) -- mesh slice"),
    ("ring", "Ring-Attention = mesh with a=1 -- mesh slice"),
    ("ulysses", "DeepSpeed-Ulysses head-parallel -- mesh slice"),
):
    register_backend(Backend(_name, apply=_needs_mesh(_name), description=_desc))
register_backend(Backend(
    "local-flash", apply=_local_flash_apply,
    description="single-card flash attention (CUDA kernel; plain version on the CPU)",
))
register_backend(Backend(
    "decode", apply=_decode_apply, step=_decode_step_local,
    description="KV-cache flash-decode (dense band kernel or paged split-K kernel)",
))


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def distributed_attention(q, k, v, *, cfg: AttentionPlanConfig, ctx=None, segments=None):
    """THE attention seam for batched attention.  q: [B, S, H, D]; k, v:
    [B, S, Hkv, D].  ``segments``: int32 [S] segment ids for segment masks,
    in the same order as q/k/v."""
    if segments is not None:
        segments = torch.as_tensor(segments, device=q.device).to(torch.int32)
    name = resolve_backend_name(cfg)
    if cfg.n > 1 or name != "local-flash":
        return get_backend(name).apply(q, k, v, cfg, seg=segments)
    return _local_flash_apply(q, k, v, cfg, seg=segments)


def decode_attention_step(
    q,  # [B, 1, H, D]
    k_new,  # [B, 1, Hkv, D]
    v_new,
    k_cache,  # [B, cap, Hkv, D] -- or, paged: the pool [num_pages, page_size, Hkv, D]
    v_cache,
    pos,  # scalar or [B] per-slot positions
    ctx,
    *,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    block_table=None,  # int32 [B, max_pages]: switches to the paged cache
    decode_kernel: Optional[str] = None,  # None -> ctx.decode_kernel
    write_coords=None,  # paged: paged_write_coords(block_table, pos, ...), shared by layers
    k_scale=None,  # [num_pages, page_size, Hkv] f32: quantized pool (paged only)
    v_scale=None,
):
    """One token of cache-based decode through the 'decode' backend.
    Returns (o, k_cache, v_cache); the caches are updated in place.  Vector
    ``pos`` serves mixed-depth slots in one step (continuous batching).
    ``k_scale``/``v_scale`` mark a quantized pool: writes quantize, reads
    dequantize (in the kernel on the native path), and the return extends to
    ``(o, k_cache, v_cache, k_scale, v_scale)`` as in JAX."""
    n = ctx.sp_size
    if n != 1:
        raise NotImplementedError("sequence-sharded decode (n > 1) comes with the mesh slice")
    if decode_kernel is None:
        decode_kernel = ctx.decode_kernel
    if k_scale is not None and block_table is None:
        raise ValueError("k_scale/v_scale (quantized pool) require block_table")
    if block_table is not None:
        out = _decode_attention_step_paged(
            q, k_new, v_new, k_cache, v_cache, pos, block_table, ctx,
            window=window, layout=layout, scale=scale, decode_kernel=decode_kernel,
            write_coords=write_coords, k_scale=k_scale, v_scale=v_scale,
        )
        return out + (k_scale, v_scale) if k_scale is not None else out
    cfg = AttentionPlanConfig(
        backend="decode", n=n, window=window, layout=layout, scale=scale,
        decode_kernel=decode_kernel,
    )
    return get_backend("decode").step(q, k_new, v_new, k_cache, v_cache, pos, cfg)


def _decode_attention_step_paged(
    q, k_new, v_new, k_pool, v_pool, pos, block_table, ctx,
    *, window, layout, scale, decode_kernel="auto", write_coords=None, k_scale=None,
    v_scale=None,
):
    """Paged decode step on one card: the pool update and the split-K (or
    gather) decode over the whole pool."""
    cfg = AttentionPlanConfig(
        backend="decode", n=ctx.sp_size, window=window, layout=layout, scale=scale,
        paged=True, decode_kernel=decode_kernel,
    )
    bt = torch.as_tensor(block_table, device=q.device).to(torch.int32)
    return get_backend("decode").step(
        q, k_new, v_new, k_pool, v_pool, pos, cfg, bt=bt, write_coords=write_coords,
        ks=k_scale, vs=v_scale,
    )


def chunk_attention_step(
    q,  # [B, C, H, D] chunk queries (pad rows beyond lens compute garbage)
    k_new,  # [B, C, Hkv, D]
    v_new,
    k_cache,  # [B, cap, Hkv, D] -- or, paged: the pool
    v_cache,
    starts,  # [B]: global position of each row's chunk base
    lens,  # [B]: valid tokens per row (0 = inactive row, nothing written)
    write_starts,  # [B]: skip K/V writes below this position (shared prefix)
    ctx,
    *,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    block_table=None,  # int32 [B, max_pages]: switches to the paged cache
    k_scale=None,  # f32 scale tables: quantized pool (paged only)
    v_scale=None,
    write_coords=None,  # chunk_write_coords(...) of this chunk, shared by layers
):
    """One continuous-prefill chunk (or speculative verify): row b's C tokens
    land at ``starts[b] .. starts[b]+lens[b]-1`` and attend prefix-causally
    to every resident position.  Returns (o, k_cache, v_cache), updated in
    place, plus the scale tables for a quantized pool, like
    ``decode_attention_step``.  Chunks always run the gather/band path
    through the flash forward; the split-K kernel stays single-token."""
    n = ctx.sp_size
    if n != 1:
        raise NotImplementedError("sequence-sharded chunks (n > 1) come with the mesh slice")
    if k_scale is not None and block_table is None:
        raise ValueError("k_scale/v_scale (quantized pool) require block_table")
    paged = block_table is not None
    cfg = AttentionPlanConfig(
        backend="decode", n=n, window=window, layout=layout, scale=scale, paged=paged,
    )
    bt = torch.as_tensor(block_table, device=q.device).to(torch.int32) if paged else None
    out = _chunk_step_local(
        q, k_new, v_new, k_cache, v_cache, starts, lens, write_starts, cfg,
        bt=bt, ks=k_scale, vs=v_scale, write_coords=write_coords,
    )
    return out + (k_scale, v_scale) if k_scale is not None else out
