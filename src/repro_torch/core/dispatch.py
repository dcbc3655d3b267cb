"""The attention seam: "which attention" is a config (copy of
``repro/core/dispatch.py``).

Every attention call goes through ``distributed_attention`` (batched
prefill / forward / training), ``decode_attention_step`` (one cached token)
or ``chunk_attention_step`` (a chunk of cached tokens: continuous prefill
and speculative verify); MLA's latent wire through
``latent_wire_attention`` (the Mesh-Attention executor with the latent on
its KV ring).  An ``AttentionPlanConfig`` names a backend from
the registry: ``mesh`` (the paper's a x b tile), ``ring`` (a = 1 with the
ring schedule) and ``ulysses`` run the batched path over a sequence-parallel
ring of n ranks (the plan's ``transport``, JAX's ``axis_name``: a
``VirtualRing`` or a ``ProcessGroupRing`` of ``parallel/ring.py``);
``local-flash`` serves n = 1 and ``decode`` the cached path: decode and
chunks over the sequence-sharded cache, every rank of a ``VirtualRing``
folded into one kernel launch, then the lse combine across the ranks.

When ``autotune=True`` the (a, b) tile and the greedy comm/compute schedules
come from the Figure-6 flow (``autotune.plan_for`` / ``autotune.tune`` over
the event simulator), with an in-process and on-disk **plan cache** keyed as
in JAX: the key hashes are equal, so a plan written by one package is read
by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core import schedule as S
from repro_torch.core.am import CommModel
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
from repro_torch.core.mesh_attention import (
    MeshAttentionConfig,
    mesh_attention,
    mesh_attention_wire,
)
from repro_torch.core.simulator import HardwareModel
from repro_torch.core.tiling import best_square_a, stripe_permutation
from repro_torch.core.ulysses import ulysses_attention
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
    "latent_wire_attention",
    "chunk_write_coords",
    "paged_write_coords",
    "plan_from_ctx",
    "plan_schedules",
    "plan_cache_dir",
    "clear_plan_cache",
    "HW_PROFILES",
]

_DECODE_KERNELS = ("auto", "native", "gather")


@dataclasses.dataclass(frozen=True)
class AttentionPlanConfig:
    """Declarative selection + configuration of an attention call.

    ``backend="auto"`` resolves to ``local-flash`` when the sequence is not
    split (n <= 1) and to ``mesh`` otherwise.  ``a=None`` on the mesh
    backend means: autotune via the simulator when ``autotune`` is set,
    otherwise the sqrt-n heuristic (``best_square_a``).  ``transport`` is
    the ring the n ranks run on (JAX's ``axis_name``); None takes the
    ``ParallelCtx``'s."""

    backend: str = "auto"
    transport: Optional[object] = None
    n: int = 1
    a: Optional[int] = None
    causal: bool = False
    window: Optional[int] = None
    layout: str = "striped"  # striped (§3.7) | contiguous (SSM/hybrid, Ulysses)
    scale: Optional[float] = None
    block_q: int = 128
    block_kv: int = 128
    bwd_wire: str = "qdod"
    allow_concurrent_rings: bool = False
    mask: Optional[MaskSpec] = None  # first-class mask; supersedes causal/window
    # ring-transport mode (schedule.COMM_OVERLAP_MODES): serial | overlap |
    # bidir.  Bitwise-equal; changes the simulated step cost, so it is part
    # of the plan-cache key.
    comm_overlap: str = "overlap"
    paged: bool = False  # decode reads/writes a page pool through a block table
    # "auto" -> "native" (the split-K kernel reading the block table) for the
    # paged cache, the band kernel per row for the dense cache
    decode_kernel: str = "auto"
    # --- Figure-6 autotuning (simulator-planned tile + schedules) ---
    autotune: bool = False
    with_backward: bool = True
    hw_profile: str = "default"
    plan_cache_dir: Optional[str] = None  # None -> $REPRO_PLAN_CACHE_DIR or ~/.cache

    def __post_init__(self):
        S.validate_comm_overlap(self.comm_overlap)
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
    """The attention plan a ``ParallelCtx`` implies (JAX's mapping: ``ring``
    sets a = 1).  ``mask`` supersedes the legacy causal/window pair."""
    impl = backend or ctx.attn_impl
    return AttentionPlanConfig(
        backend=impl,
        transport=ctx.ring,
        n=ctx.sp_size,
        a=1 if impl == "ring" else ctx.mesh_a,
        causal=causal if mask is None else False,
        window=window if mask is None else None,
        mask=mask,
        layout=layout,
        scale=scale,
        block_q=ctx.block_q,
        block_kv=ctx.block_kv,
        bwd_wire=ctx.bwd_wire,
        allow_concurrent_rings=ctx.allow_concurrent_rings,
        comm_overlap=ctx.comm_overlap,
        decode_kernel=ctx.decode_kernel,
        autotune=ctx.attn_autotune,
        plan_cache_dir=ctx.plan_cache_dir,
    )


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered attention implementation: ``apply`` is the batched
    entry over the local ranks' chunks ([R, B, S/n, H, D], as
    ``mesh_attention`` takes them), ``step`` the incremental-decode entry
    (None when unsupported)."""

    name: str
    apply: Optional[Callable] = None  # (q, k, v, cfg, seg=None) -> o, local chunks
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


# --------------------------------------------------------------------------
# simulator-planned schedules + on-disk plan cache
# --------------------------------------------------------------------------

# the JAX package's three profiles, unchanged: their constants enter the
# plan-cache key, and describe no measurement of the port's card
HW_PROFILES: Dict[str, HardwareModel] = {
    "default": HardwareModel(),
    "tpu_v5e": HardwareModel(),
    "paper_a100": HardwareModel(
        peak_flops=312e12, hbm_bw=2039e9, link_bw=25e9, attn_efficiency=0.45
    ),
}

_MEM_CACHE: Dict[str, Tuple[int, S.Schedule, Optional[S.Schedule]]] = {}


def plan_cache_dir(cfg: Optional[AttentionPlanConfig] = None) -> str:
    if cfg is not None and cfg.plan_cache_dir:
        return cfg.plan_cache_dir
    env = os.environ.get("REPRO_PLAN_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro", "attention-plans")


def clear_plan_cache(cfg: Optional[AttentionPlanConfig] = None) -> None:
    _MEM_CACHE.clear()
    d = plan_cache_dir(cfg)
    if os.path.isdir(d):
        for fn in os.listdir(d):
            if fn.endswith(".json"):
                os.unlink(os.path.join(d, fn))


def _plan_key(cfg: AttentionPlanConfig, comm: CommModel, hw: HardwareModel) -> Tuple[str, dict]:
    """Cache key over everything the simulated plan depends on; the same
    fields and values as JAX's, so the hashes agree."""
    desc = {
        "v": 5,
        "n": comm.n,
        "a": cfg.a,
        "seq": comm.seq,
        "hidden": comm.hidden,
        "kv_hidden": comm.kvh,
        "bytes_per_elem": comm.bytes_per_elem,
        "batch": comm.batch,
        "mask": cfg.mask_spec().signature(),
        "layout": cfg.layout,
        "paged": cfg.paged,
        "decode_kernel": _resolve_decode_kernel(cfg.decode_kernel, cfg.paged),
        # JAX's plan config names the pool's precision; the port plans only
        # the batched path, which reads no quantized pool
        "kv_dtype": "fp",
        "with_backward": cfg.with_backward,
        "allow_concurrent_rings": cfg.allow_concurrent_rings,
        "comm_overlap": cfg.comm_overlap,
        "hw_profile": cfg.hw_profile,
        "hw": dataclasses.asdict(hw),
    }
    blob = json.dumps(desc, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest(), desc


def plan_schedules(
    cfg: AttentionPlanConfig, comm: CommModel
) -> Tuple[int, S.Schedule, Optional[S.Schedule]]:
    """Figure-6 planning through the cache: returns (a, fwd, bwd).

    ``cfg.a`` fixed -> ``autotune.plan_for``; ``cfg.a`` None ->
    ``autotune.tune`` argmin over every factorization of n.  Results are
    memoized in-process and persisted as JSON under :func:`plan_cache_dir`
    so later launches skip the simulator."""
    hw = HW_PROFILES.get(cfg.hw_profile)
    if hw is None:
        raise ValueError(
            f"unknown hw_profile {cfg.hw_profile!r}; known: {sorted(HW_PROFILES)}"
        )
    key, desc = _plan_key(cfg, comm, hw)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]

    cache_dir = plan_cache_dir(cfg)
    path = os.path.join(cache_dir, f"{key}.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
            fwd = S.schedule_from_json(payload["fwd"])
            bwd = S.schedule_from_json(payload["bwd"]) if payload.get("bwd") else None
            out = (int(payload["a"]), fwd, bwd)
            _MEM_CACHE[key] = out
            return out
        except (KeyError, TypeError, ValueError, json.JSONDecodeError):
            pass  # corrupt entry: fall through and re-plan

    kw = dict(
        mask=cfg.mask_spec(),
        layout=cfg.layout,
        with_backward=cfg.with_backward,
        allow_concurrent_rings=cfg.allow_concurrent_rings,
        comm_overlap=cfg.comm_overlap,
    )
    if cfg.a is not None:
        plan = autotune.plan_for(comm, cfg.a, hw, **kw)
    else:
        plan = autotune.tune(comm, hw, **kw)

    payload = {
        "key": desc,
        "a": plan.a,
        "b": plan.b,
        "fwd": S.schedule_to_json(plan.fwd),
        "bwd": S.schedule_to_json(plan.bwd) if plan.bwd else None,
        "sim": {"total_s": plan.total, "comm_bytes": plan.comm_bytes},
    }
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)  # atomic: concurrent launchers race benignly

    out = (plan.a, plan.fwd, plan.bwd)
    _MEM_CACHE[key] = out
    return out


def _comm_model_for(cfg: AttentionPlanConfig, q, k) -> CommModel:
    """CommModel from the call's global shapes (q: [B, S, H, D])."""
    return CommModel(
        seq=int(q.shape[1]),
        hidden=int(q.shape[2] * q.shape[3]),
        n=cfg.n,
        kv_hidden=int(k.shape[2] * k.shape[3]),
        bytes_per_elem=int(q.element_size()),
        batch=int(q.shape[0]),
    )


# --------------------------------------------------------------------------
# backend implementations (over the local ranks' chunks)
# --------------------------------------------------------------------------


def _mesh_cfg(
    cfg: AttentionPlanConfig,
    *,
    a: int,
    fwd: Optional[S.Schedule] = None,
    bwd: Optional[S.Schedule] = None,
) -> MeshAttentionConfig:
    return MeshAttentionConfig(
        transport=cfg.transport,
        n=cfg.n,
        a=a,
        causal=cfg.causal if cfg.mask is None else False,
        window=cfg.window if cfg.mask is None else None,
        mask=cfg.mask,
        layout=cfg.layout,
        scale=cfg.scale,
        fwd_schedule=fwd,
        bwd_schedule=bwd,
        bwd_wire=cfg.bwd_wire,
        block_q=cfg.block_q,
        block_kv=cfg.block_kv,
        allow_concurrent_rings=cfg.allow_concurrent_rings,
        comm_overlap=cfg.comm_overlap,
    )


def _mesh_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    if cfg.autotune and cfg.n > 1:
        # q is the LOCAL chunk here, so the CommModel geometry would be
        # wrong by a factor of n; distributed_attention plans from the
        # global view
        raise ValueError(
            "autotuned mesh plans are resolved from the global view "
            "(use distributed_attention, or bake schedules via plan_schedules)"
        )
    a = cfg.a if cfg.a is not None else best_square_a(cfg.n)
    return mesh_attention(q, k, v, _mesh_cfg(cfg, a=a), seg=seg)


def _ring_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    """Ring-Attention as the (a=1, b=n) special case -- one-block-per-step
    ring schedule, identical kernels and ring machinery (paper §2.2)."""
    fwd = S.ring_forward_schedule(cfg.n) if cfg.n > 1 else None
    return mesh_attention(q, k, v, _mesh_cfg(cfg, a=1, fwd=fwd), seg=seg)


def _ulysses_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    if cfg.layout != "contiguous":
        raise ValueError("Ulysses requires the contiguous layout")
    spec = cfg.mask_spec()
    if spec.kind == "block_sparse":
        raise ValueError("Ulysses does not support block-sparse masks")
    if spec.needs_segments and seg is None:
        raise ValueError(f"mask kind {spec.kind!r} needs a segment-id operand")
    return ulysses_attention(
        q, k, v, cfg.transport, cfg.n,
        causal=spec.is_causal, window=spec.window, scale=cfg.scale, seg=seg,
    )


def _local_flash_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    spec = cfg.mask_spec()
    if spec.kind == "block_sparse":
        raise ValueError("block-sparse masks route through the mesh backend")
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
    """One decode tick over the sequence-sharded cache: update in place,
    then decode.  With ``cfg.paged`` the caches are the page pool, ``bt`` the
    block table and ``write_coords`` (optional) the append's
    ``paged_write_coords``; ``ks``/``vs`` are a quantized pool's scale tables
    (updated in place)."""
    ring = cfg.transport
    if cfg.paged:
        paged_cache_update(
            k_cache, v_cache, k_new, v_new, bt, pos, ring, cfg.n, layout=cfg.layout,
            coords=write_coords, k_scale=ks, v_scale=vs,
        )
        o = paged_cache_decode(
            q, k_cache, v_cache, bt, pos, ring, cfg.n,
            layout=cfg.layout, window=cfg.window, scale=cfg.scale,
            kernel=_resolve_decode_kernel(cfg.decode_kernel, paged=True),
            k_scale=ks, v_scale=vs,
        )
        return o, k_cache, v_cache
    k_cache, v_cache = sharded_cache_update(
        k_cache, v_cache, k_new, v_new, pos, ring, cfg.n, layout=cfg.layout
    )
    o = sharded_cache_decode(
        q, k_cache, v_cache, pos, ring, cfg.n,
        layout=cfg.layout, window=cfg.window, scale=cfg.scale,
        kernel=_resolve_decode_kernel(cfg.decode_kernel, paged=False),
    )
    return o, k_cache, v_cache


def _chunk_step_local(
    q, k_new, v_new, k_cache, v_cache, starts, lens, wstarts, cfg: AttentionPlanConfig,
    bt=None, ks=None, vs=None, write_coords=None,
):
    """One chunk over the sequence-sharded cache: scatter the chunk's K/V by
    absolute position (in place; quantized with ``ks``/``vs``; at
    ``write_coords`` when given), then prefix-causal chunk attention over
    everything resident."""
    ring = cfg.transport
    if cfg.paged:
        paged_cache_chunk_update(
            k_cache, v_cache, k_new, v_new, bt, starts, lens, wstarts, ring, cfg.n,
            layout=cfg.layout, k_scale=ks, v_scale=vs, coords=write_coords,
        )
        o = paged_cache_chunk_decode(
            q, k_cache, v_cache, bt, starts, ring, cfg.n,
            layout=cfg.layout, window=cfg.window, scale=cfg.scale, k_scale=ks, v_scale=vs,
        )
        return o, k_cache, v_cache
    sharded_cache_chunk_update(
        k_cache, v_cache, k_new, v_new, starts, lens, wstarts, ring, cfg.n, layout=cfg.layout,
        coords=write_coords,
    )
    o = sharded_cache_chunk_decode(
        q, k_cache, v_cache, starts, ring, cfg.n,
        layout=cfg.layout, window=cfg.window, scale=cfg.scale,
    )
    return o, k_cache, v_cache


def _decode_apply(q, k, v, cfg: AttentionPlanConfig, seg=None):
    raise ValueError(
        "the 'decode' backend is step-wise (KV cache); call "
        "repro_torch.core.dispatch.decode_attention_step instead of distributed_attention"
    )


register_backend(Backend(
    "mesh", apply=_mesh_apply,
    description="Mesh-Attention (a x b tile; autotunable via the simulator)",
))
register_backend(Backend(
    "ring", apply=_ring_apply,
    description="Ring-Attention baseline = mesh with a=1 and the ring schedule",
))
register_backend(Backend(
    "ulysses", apply=_ulysses_apply,
    description="DeepSpeed-Ulysses head-parallel (capped at the KV-head count)",
))
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
    """THE attention seam for batched attention.

    q: [B, S, H, D]; k, v: [B, S, Hkv, D] -- the global view (on every
    process, for a ``ProcessGroupRing``).  Causal striped-layout inputs must
    already be in stripe order (§3.7; the data pipeline does it).  For
    n > 1 the view is split into the ring's chunks (the transport's
    ``split``), the backend runs over them, and the chunks are joined back.
    ``segments``: int32 [S] segment ids for document/segment masks, in the
    SAME order as q/k/v; for a static ``MaskSpec.document`` mask it is
    synthesized (and striped) here when omitted."""
    mask_spec = cfg.mask_spec()
    if segments is None and mask_spec.kind == "document":
        seg_np = mask_spec.segment_array(int(q.shape[1]))
        if cfg.layout == "striped" and cfg.n > 1:
            seg_np = seg_np[stripe_permutation(int(q.shape[1]), cfg.n)]
        segments = torch.from_numpy(seg_np)
    if segments is not None:
        segments = torch.as_tensor(segments, device=q.device).to(torch.int32)

    name = resolve_backend_name(cfg)
    if name == "local-flash" or cfg.n <= 1:
        return _local_flash_apply(q, k, v, cfg, seg=segments)
    backend = get_backend(name)
    if backend.apply is None:
        raise ValueError(f"backend {name!r} does not support the batched-attention mode")
    if cfg.transport is None:
        ring = getattr(ctx, "ring", None)
        if ring is None:
            raise ValueError(
                f"backend {name!r} with n={cfg.n} needs a ring: pass a plan with a "
                "transport, or a ParallelCtx with sp_size > 1"
            )
        cfg = dataclasses.replace(cfg, transport=ring)
    T = cfg.transport
    if T.n != cfg.n:
        raise ValueError(f"the plan has n={cfg.n} but its transport {T!r} has {T.n} ranks")

    if name == "mesh" and cfg.autotune:
        # plan from the global view (pure python), then run the baked schedules
        a, fwd, bwd = plan_schedules(cfg, _comm_model_for(cfg, q, k))
        macfg = _mesh_cfg(cfg, a=a, fwd=fwd, bwd=bwd)
        local = lambda q, k, v, seg=None: mesh_attention(q, k, v, macfg, seg=seg)  # noqa: E731
    else:
        local = lambda q, k, v, seg=None: backend.apply(q, k, v, cfg, seg=seg)  # noqa: E731
    seg = None if segments is None else T.split(segments, axis=0)
    return T.join(local(T.split(q), T.split(k), T.split(v), seg=seg))


def latent_wire_attention(
    q, wire, wire_params, kv_transform, *, cfg: AttentionPlanConfig, ctx=None, segments=None
):
    """Mesh-Attention with a compressed KV wire (JAX's beyond-paper path):
    the opaque ``wire`` (q's global view's [B, S, ...]) circulates on the
    KV ring in the ranks' chunks, and ``kv_transform(chunk, wire_params) ->
    (k, v)`` expands each chunk per head at its first use (MLA's latent).
    ``a`` is the plan's or ``best_square_a(n)``, never autotuned;
    ``segments`` (int32 [S], q's order) ride the rings.  Differentiable on
    a ``VirtualRing`` (``core.mesh_attention.mesh_attention_wire``)."""
    T = cfg.transport if cfg.transport is not None else getattr(ctx, "ring", None)
    if T is None or cfg.n <= 1:
        raise ValueError(
            f"the latent wire runs over a ring of n > 1 ranks (n={cfg.n}): pass a plan with a "
            "transport, or a ParallelCtx with sp_size > 1"
        )
    if T.n != cfg.n:
        raise ValueError(f"the plan has n={cfg.n} but its transport {T!r} has {T.n} ranks")
    a = cfg.a if cfg.a is not None else best_square_a(cfg.n)
    macfg = _mesh_cfg(dataclasses.replace(cfg, transport=T), a=a)
    seg = None
    if segments is not None:
        seg = T.split(torch.as_tensor(segments, device=q.device).to(torch.int32), axis=0)
    o = mesh_attention_wire(T.split(q), T.split(wire), macfg,
                            lambda chunk: kv_transform(chunk, wire_params), seg=seg)
    return T.join(o)


def decode_attention_step(
    q,  # [B, 1, H, D]
    k_new,  # [B, 1, Hkv, D]
    v_new,
    k_cache,  # [B, cap, Hkv, D] -- or, paged: the pool [num_pages, n*page_size, Hkv, D]
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
    k_scale=None,  # [num_pages, n*page_size, Hkv] f32: quantized pool (paged only)
    v_scale=None,
):
    """One token of cache-based decode through the 'decode' backend.
    Returns (o, k_cache, v_cache); the caches are updated in place.  Vector
    ``pos`` serves mixed-depth slots in one step (continuous batching).
    With ``ctx.sp_size`` n > 1 the cache is sharded over the ring's n ranks
    (JAX's global-logical layout: rank i owns the i-th n-th of the dense
    cap axis, or of each page's columns), every rank's partial comes out of
    one launch, and the partials meet in the lse combine.
    ``k_scale``/``v_scale`` mark a quantized pool: writes quantize, reads
    dequantize (in the kernel on the native path), and the return extends to
    ``(o, k_cache, v_cache, k_scale, v_scale)`` as in JAX."""
    n = ctx.sp_size
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
        backend="decode", transport=ctx.ring, n=n, window=window, layout=layout, scale=scale,
        decode_kernel=decode_kernel,
    )
    return get_backend("decode").step(q, k_new, v_new, k_cache, v_cache, pos, cfg)


def _decode_attention_step_paged(
    q, k_new, v_new, k_pool, v_pool, pos, block_table, ctx,
    *, window, layout, scale, decode_kernel="auto", write_coords=None, k_scale=None,
    v_scale=None,
):
    """Paged decode step: the pool update and the split-K (or gather) decode
    over the whole pool, every rank's columns of it at once."""
    cfg = AttentionPlanConfig(
        backend="decode", transport=ctx.ring, n=ctx.sp_size, window=window, layout=layout,
        scale=scale, paged=True, decode_kernel=decode_kernel,
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
    through the flash forward (one launch for every row and rank); the
    split-K kernel stays single-token."""
    n = ctx.sp_size
    if k_scale is not None and block_table is None:
        raise ValueError("k_scale/v_scale (quantized pool) require block_table")
    paged = block_table is not None
    cfg = AttentionPlanConfig(
        backend="decode", transport=ctx.ring, n=n, window=window, layout=layout, scale=scale,
        paged=paged,
    )
    bt = torch.as_tensor(block_table, device=q.device).to(torch.int32) if paged else None
    out = _chunk_step_local(
        q, k_new, v_new, k_cache, v_cache, starts, lens, write_starts, cfg,
        bt=bt, ks=k_scale, vs=v_scale, write_coords=write_coords,
    )
    return out + (k_scale, v_scale) if k_scale is not None else out
