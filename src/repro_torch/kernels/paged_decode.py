"""Paged split-K flash-decode: the CUDA kernels' wrapper and their plain versions.

Counterpart of ``repro/kernels/paged_decode.py``.  The kernel
(``csrc/paged_decode.cu``) decodes one token per slot row straight off the
page pool: it reads the block table (-1 = unallocated) and each row's
position itself, solves the row's visible local slots (at or before the
row's depth, inside the sliding window), and up to ``num_splits`` blocks
take equal shares of them (a shallow row takes one), masking unallocated
pages and the partial last page by global position.  A second kernel,
launched by the same C call, merges the fp32 partials of the rows several
blocks shared by lse straight into o and lse; ``combine_split_partials`` is
that merge's plain version (plain jnp outside the Pallas call in JAX).
bf16 queries run on the tensor cores (``mma.sync``), fp32 queries on the
CUDA cores.  At head dim 288 (minicpm3-4b's absorbed MLA latent: 40 query
heads on one kv head) the wide bodies take groups up to 48: the block
shares each K / V tile and its warps own (rows, dims) pieces of o.

Geometry matches ``core/decode_attention.py``: local slot ``j`` holds global
position ``kv_offset + stride_kv * j`` and lives at offset ``j % page_size``
of logical page ``j // page_size``.  A dense ``[B, m]`` cache is the
degenerate case (reshape to ``[B * m/chunk, chunk]`` pages with the identity
block table), so the same kernel serves the dense decode path too.

A quantized pool (int8 or fp8-e4m3 codes, ``k_scale``/``v_scale``
``[num_pages, page_size, Hkv]`` fp32 per-(token, kv-head) scales) runs the
same kernels with another load path: codes stay bytes in shared memory and
are widened in registers, the k scale multiplies the score and the v scale
is folded into P (the quantized branch of the TPU kernel,
``repro/kernels/paged_decode.py:161-167``).

The wrapper launches the kernels for CUDA tensors and runs the plain version
(:func:`paged_decode_ref`: gather the row's pages, dequantize, then the band
math) for CPU tensors; after the launch it runs no PyTorch op.
``paged_flash_decode.launches`` counts calls over an fp pool,
``paged_flash_decode.quant_launches`` calls over a quantized pool (each
call launches the main kernel, and the combine with more than one split).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import BAND_INF, NEG_INF

__all__ = [
    "paged_flash_decode",
    "paged_decode_ref",
    "combine_split_partials",
    "split_combine",
    "default_num_splits",
    "dense_chunk_for",
]

# the default split count aims at this many blocks per SM of an H100 over
# B x Hkv (row, kv head) pairs: the deepest rows then spread over the card
BLOCKS_PER_SM = 2
H100_SMS = 132

# candidate chunk sizes (local positions) for viewing a DENSE cache row as an
# implicit page run; the largest divisor of m wins
_DENSE_CHUNKS = (128, 64, 32, 16, 8, 4, 2, 1)

KERNEL_HEAD_DIMS = (32, 64, 128, 256, 288)
# query heads per kv head: one 16-row tile, or at head dim 288 (MLA's
# absorbed latent) the wide bodies' three
KERNEL_MAX_GROUP = 16
KERNEL_MAX_GROUP_D288 = 48
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the pool's element type at the C interface: 0 = q's type, 1 = int8, 2 = fp8
_POOL_CODES = {torch.int8: 1}
if hasattr(torch, "float8_e4m3fn"):
    _POOL_CODES[torch.float8_e4m3fn] = 2

PosArg = Union[int, torch.Tensor]


def default_num_splits(batch: int, hkv: int, max_pages: int) -> int:
    """Blocks per (row, kv head): enough for ``BLOCKS_PER_SM`` blocks per SM
    over ``batch * hkv`` pairs, never more than ``max_pages``.  The depths are
    device data, so the count is chosen from the shapes alone; the kernel
    gives a row only as many of them as get 8 tiles of 16 slots each."""
    want = -(-BLOCKS_PER_SM * H100_SMS // max(1, batch * hkv))
    return max(1, min(want, max_pages))


def _plan(B: int, H: int, hkv: int, D: int, max_pages: int, num_splits: Optional[int],
          dtype) -> Tuple[str, int]:
    """(body, blocks per (row, kv head)) of the CUDA kernel, from the shapes
    and q's type alone: "mma" (tensor cores) for bf16 queries, "simt" (CUDA
    cores) for fp32 ones; the split count is ``num_splits`` (default
    :func:`default_num_splits`) cut to [1, max_pages].  Raises for what the
    kernel does not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_flash_decode kernel takes float32 or bfloat16, not {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_flash_decode kernel takes head dims {KERNEL_HEAD_DIMS}, not {D}")
    if hkv < 1 or H % hkv:
        raise ValueError(f"H={H} not divisible by Hkv={hkv}")
    max_group = KERNEL_MAX_GROUP_D288 if D == 288 else KERNEL_MAX_GROUP
    if H // hkv > max_group:
        raise ValueError(f"GQA group {H // hkv} > {max_group} at head dim {D}")
    if num_splits is None:
        num_splits = default_num_splits(B, hkv, max_pages)
    return ("mma" if dtype == torch.bfloat16 else "simt"), max(1, min(int(num_splits), max_pages))


def dense_chunk_for(m: int) -> int:
    """Page size for the dense-cache-as-one-page-run view of a [B, m] slice:
    the largest candidate dividing m (1 always divides)."""
    return next(c for c in _DENSE_CHUNKS if c <= m and m % c == 0)


def combine_split_partials(
    o_parts: torch.Tensor,  # [B, S, H, D] fp32 per-split partial outputs
    lse_parts: torch.Tensor,  # [B, S, H] fp32 per-split lse (NEG_INF = empty)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numerically-stable LSE reduce over the split axis -> ([B,1,H,D] fp32,
    [B,H,1] fp32).  Empty splits weigh 0 even when every split is empty, so a
    fully-hidden row combines to exactly o = 0, lse = NEG_INF."""
    m = lse_parts.amax(dim=1).clamp_min(NEG_INF)  # [B, H]
    nonempty = lse_parts > NEG_INF / 2
    w = torch.where(nonempty, torch.exp(lse_parts - m[:, None]), torch.zeros_like(lse_parts))
    den = w.sum(dim=1)  # [B, H]
    num = (w[..., None] * o_parts).sum(dim=1)  # [B, H, D], exact fp32 (no TF32)
    den_safe = torch.where(den > 0, den, torch.ones_like(den))
    o = num / den_safe[..., None]
    lse = torch.where(den > 0, m + torch.log(den_safe), torch.full_like(den, NEG_INF))
    return o[:, None], lse[..., None]


def _pos_vector(pos: PosArg, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).to(torch.int64).expand(batch)


def paged_decode_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pool: torch.Tensor,  # [num_pages, page_size, Hkv, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos: PosArg,  # scalar or [B]: attends to global positions <= pos
    kv_offset: int,
    *,
    stride_kv: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: gather each row's pages into its dense local view and
    run the band math (position <= pos, inside the window, page allocated).
    Returns (o [B,1,H,D] in q.dtype, lse [B,H,1] fp32)."""
    B, _, H, D = q.shape
    num_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    max_pages = block_table.shape[1]
    if scale is None:
        scale = D**-0.5
    hi = (window - 1) if window else BAND_INF
    bt = block_table.to(q.device)
    idx = bt.clamp(0, num_pages - 1).long()
    views = []
    for pool, scales in ((k_pool, k_scale), (v_pool, v_scale)):
        pages = pool[idx]  # [B, max_pages, page_size, Hkv, D]
        if scales is not None:
            pages = pages.float() * scales[idx][..., None].float()
        views.append(pages.reshape(B, max_pages * page_size, *pool.shape[2:]))
    k_loc, v_loc = views
    pos_v = _pos_vector(pos, B, q.device)
    gpos = kv_offset + stride_kv * torch.arange(max_pages * page_size, device=q.device)
    win_lo = (pos_v - hi).clamp_min(0)
    alloc = (bt >= 0).repeat_interleave(page_size, dim=1)  # [B, m]
    mask = (gpos[None] <= pos_v[:, None]) & (gpos[None] >= win_lo[:, None]) & alloc
    return ref.masked_attention(q, k_loc, v_loc, mask[:, None, None, :], scale)


def _device_int32(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` as contiguous int32 on ``device``: itself when it already is."""
    if t.device != device or t.dtype != torch.int32:
        t = t.to(device=device, dtype=torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def paged_flash_decode(
    q: torch.Tensor,  # [B, 1, H, D] the new token's queries
    k_pool: torch.Tensor,  # [num_pages, page_size, Hkv, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos: PosArg,  # int32 scalar or [B]: attends to global positions <= pos
    kv_offset: int,  # global position of local slot 0
    *,
    stride_kv: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    num_splits: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode partial straight off the page pool: (o [B,1,H,D] in q.dtype,
    lse [B,H,1] fp32).  ``num_splits``: how many blocks share each (row, kv
    head)'s visible pages on the card (default :func:`default_num_splits`;
    at most ``max_pages``); the CPU path ignores it."""
    B, _, H, D = q.shape
    num_pages, page_size, hkv, _ = k_pool.shape
    max_pages = block_table.shape[1]
    if H % hkv:
        raise ValueError(f"H={H} not divisible by Hkv={hkv}")
    quantized = k_pool.dtype in _POOL_CODES
    if quantized != (k_scale is not None) or quantized != (v_scale is not None):
        raise TypeError(
            "an int8/fp8 pool needs both scale tables, and scale tables need an int8/fp8 "
            f"pool (pool {k_pool.dtype}, k_scale {k_scale is not None}, "
            f"v_scale {v_scale is not None})"
        )
    if q.device.type == "cpu":
        return paged_decode_ref(
            q, k_pool, v_pool, block_table, pos, kv_offset, stride_kv=stride_kv,
            window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cuda or cpu tensors, not {q.device}")
    if scale is None:
        scale = D**-0.5
    pool_dtype = k_pool.dtype if quantized else q.dtype
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or t.dtype != pool_dtype:
            raise TypeError(
                f"{name} must be on q's device with q's dtype, or int8/fp8 with scale "
                f"tables ({q.device}, {pool_dtype}); got {t.device}, {t.dtype}"
            )
        if t.shape != (num_pages, page_size, hkv, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(num_pages, page_size, hkv, D)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != q.device or t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32 on {q.device}, got {t.dtype} on {t.device}")
            if t.shape != (num_pages, page_size, hkv):
                raise ValueError(f"{name} shape {tuple(t.shape)} != {(num_pages, page_size, hkv)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if D % 16:
            raise ValueError(f"the quantized kernel loads 16 codes at a time: D={D} % 16 != 0")
    if q.shape != (B, 1, H, D):
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    _, num_splits = _plan(B, H, hkv, D, max_pages, num_splits, q.dtype)
    if stride_kv < 1:
        raise ValueError("stride_kv must be >= 1")
    if block_table.shape != (B, max_pages):
        raise ValueError(f"block_table must be [B={B}, max_pages], got {tuple(block_table.shape)}")
    if not q.is_contiguous():
        q = q.contiguous()
    bt = _device_int32(block_table, q.device)
    if isinstance(pos, torch.Tensor):
        pos_d = _device_int32(pos, q.device)
        if pos_d.numel() not in (1, B):
            raise ValueError(f"pos must be a scalar or [B={B}], got {tuple(pos.shape)}")
        pos_ptr, pos_stride, pos_value = pos_d.data_ptr(), int(pos_d.numel() == B and B > 1), 0
    else:
        pos_ptr, pos_stride, pos_value = None, 0, int(pos)
    hi = (window - 1) if window else BAND_INF
    o = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, lse
    o_parts = lse_parts = None
    if num_splits > 1:
        o_parts = torch.empty((B, num_splits, H, D), dtype=torch.float32, device=q.device)
        lse_parts = torch.empty((B, num_splits, H), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_decode")
    err = lib.paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        bt.data_ptr(), pos_ptr, pos_stride, pos_value, o.data_ptr(), lse.data_ptr(),
        o_parts.data_ptr() if o_parts is not None else None,
        lse_parts.data_ptr() if lse_parts is not None else None,
        B, H, hkv, D, page_size, max_pages, num_splits, int(kv_offset), int(stride_kv), int(hi),
        float(scale), _DTYPE_CODES[q.dtype], _POOL_CODES.get(k_pool.dtype, 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode")
    if quantized:
        paged_flash_decode.quant_launches += 1
    else:
        paged_flash_decode.launches += 1
    return o, lse


paged_flash_decode.launches = 0
paged_flash_decode.quant_launches = 0


def split_combine(
    o_parts: torch.Tensor,  # [B, S, H, D] fp32 per-split partial outputs
    lse_parts: torch.Tensor,  # [B, S, H] fp32 per-split lse (NEG_INF = empty)
    dtype: torch.dtype = torch.float32,  # o's type: float32 or bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paged decode's combine kernel alone: the merge that
    ``paged_flash_decode`` launches after its main kernel, and the
    sequence-sharded decode's merge of its ranks' partials
    (``core/decode_attention.py``).  Returns (o [B,1,H,D] in ``dtype``, lse
    [B,H,1] fp32); CPU tensors run :func:`combine_split_partials`, and
    ``split_combine.launches`` counts the kernel's launches."""
    if o_parts.device.type == "cpu":
        o, lse = combine_split_partials(o_parts.float(), lse_parts.float())
        return o.to(dtype), lse
    if o_parts.device.type != "cuda":
        raise ValueError(f"split_combine runs on cuda or cpu tensors, not {o_parts.device}")
    B, S, H, D = o_parts.shape
    for name, t, shape in (("o_parts", o_parts, (B, S, H, D)), ("lse_parts", lse_parts, (B, S, H))):
        if t.dtype != torch.float32 or t.device != o_parts.device or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32 on {o_parts.device}")
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if dtype not in _DTYPE_CODES or S < 1 or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"split_combine writes float32 or bfloat16 from >= 1 split at head dims "
                         f"{KERNEL_HEAD_DIMS}, not {dtype}, {S}, {D}")
    o = torch.empty((B, 1, H, D), dtype=dtype, device=o_parts.device)
    lse = torch.empty((B, H, 1), dtype=torch.float32, device=o_parts.device)
    if B * H == 0:
        return o, lse
    err = _build.load("paged_decode").paged_decode_combine(
        o_parts.data_ptr(), lse_parts.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H, D,
        _DTYPE_CODES[dtype], torch.cuda.current_stream(o_parts.device).cuda_stream,
    )
    _build.check(err, "paged_decode_combine")
    split_combine.launches += 1
    return o, lse


split_combine.launches = 0
