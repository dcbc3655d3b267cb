"""Flash-decode over the KV cache (single-card copy of
``repro/core/decode_attention.py``).

The JAX module shards the cache over a sequence-parallel axis and combines
per-shard partials with an lse-weighted psum.  This slice runs on one card:
``axis_name`` must be None and ``n`` 1, so there is one shard (index 0) and
the combine is a cast.  The owner/stripe math is kept in the same shape so
sequence-sharded decode (the next slice of the port) can widen it.

Two cache layouts share the band math:

  * **dense** (``sharded_cache_*``) -- each batch row owns a ``[m]`` slice.
  * **paged** (``paged_cache_*``) -- rows share one physical page pool
    ``[num_pages, page_size, Hkv, D]`` addressed through an int32 block table
    ``[B, max_pages]`` (-1 = unallocated; ``serve/kv_pool.py`` allocates).

Both decode entries take a ``kernel`` selector: ``"band"`` / ``"gather"``
run the flash-forward kernel with one band per row (paged: after gathering
the row's pages into a dense view), ``"native"`` runs the split-K paged
kernel, which reads the block table itself; the dense cache reaches it
through an identity block table.

A quantized paged pool (int8 / fp8 codes, ``core/kv_quant.py``) carries
``k_scale``/``v_scale`` tables ``[num_pages, page_size, Hkv]`` that share the
pool's page indexing: every update quantizes its new tokens per (token,
head) and writes codes and scales through the same coordinates; the native
decode kernel reads both, the gather path dequantizes.

Continuous prefill and speculative verify append a C-token chunk per row
(``*_chunk_update``) and attend prefix-causally (``*_chunk_decode``): row i of
a chunk sits at global position ``starts[b] + i``, so the band ``(starts[b],
kv_off, 0, hi)`` with ``stride_q=1`` is exactly the decode band of each row.
All rows go through ONE flash-forward launch with a ``[B, 4]`` band tensor
(JAX maps one call over the rows).  Pad rows (``i >= lens[b]``) compute
garbage but never write; softmax is per row, so they cannot reach real rows.

Unlike JAX, the updates write the cache IN PLACE (slice / index assignment)
and return the same tensors.  JAX drops out-of-range scatter rows
(``mode="drop"``); here rows that must not be written are filtered out with a
boolean mask before the write -- a clamped write could land on a live page.
The window-prune ``lax.cond`` of the JAX module only ever skips a shard of a
mesh, so it has no counterpart on one card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import kv_quant
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pk
from repro_torch.kernels.ref import BAND_INF

__all__ = [
    "sharded_cache_update",
    "sharded_cache_decode",
    "paged_write_coords",
    "paged_cache_update",
    "paged_cache_gather",
    "paged_cache_decode",
    "chunk_write_coords",
    "sharded_cache_chunk_update",
    "sharded_cache_chunk_decode",
    "paged_cache_chunk_update",
    "paged_cache_chunk_decode",
]


def _single_shard(axis_name: Optional[str], n: int) -> int:
    """Shard index of this device: always 0 on one card."""
    if axis_name is not None or n != 1:
        raise NotImplementedError(
            "the sequence-sharded cache (axis_name / n > 1) comes with the next slice of the port"
        )
    return 0


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """int64 [B] positions from a scalar or a [B] vector."""
    return torch.as_tensor(pos, device=device).to(torch.int64).expand(batch)


def _owner_slot(pos, i, n: int, m: int, layout: str):
    """(is_owner, slot) for writing global position ``pos``; m = local slots."""
    if layout == "striped":
        return (pos % n) == i, pos // n
    return (pos // m) == i, pos % m


def _shard_geometry(i, n: int, m: int, layout: str) -> Tuple[int, int]:
    """(kv_offset, stride) of local slot s -> global position for the band."""
    if layout == "striped":
        return i, n
    return i * m, 1


def sharded_cache_update(
    k_cache: torch.Tensor,  # [B, m, Hkv, D] (updated in place)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    pos,  # scalar or [B]: global position(s) being written
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
) -> Tuple[torch.Tensor, torch.Tensor]:
    i = _single_shard(axis_name, n)
    B, m = k_cache.shape[0], k_cache.shape[1]
    pos_v = _pos_vector(pos, B, k_cache.device)
    is_owner, slot = _owner_slot(pos_v, i, n, m, layout)
    if torch.as_tensor(pos).dim() == 0:
        # one position for every row: JAX's dynamic_update_slice clamps a
        # slot past capacity onto the last one, and the owner writes there
        write = is_owner
    else:
        # per-row positions: rows past capacity (retired slots still
        # ticking) must not write, as JAX masks them off; each row only ever
        # touches its own slice, so the masked-off rows put back the value
        # they read and no other row's data can be hit
        write = is_owner & (pos_v < n * m)
    slot = slot.clamp(0, m - 1)
    b = torch.arange(B, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[b, slot]  # [B, Hkv, D]
        cache[b, slot] = torch.where(write[:, None, None], new[:, 0].to(cache.dtype), cur)
    return k_cache, v_cache


def _psum_combine(o, lse, axis_name: Optional[str], q_dtype):
    """Combine of per-shard partials; one shard on one card, so a cast."""
    if axis_name is not None:
        raise NotImplementedError("the cross-shard lse combine comes with the next slice of the port")
    return o.to(q_dtype)


def _banded_partial(q, k_loc, v_loc, pos, kv_off: int, stride_kv: int, hi: int, scale):
    """Per-shard partial through the flash kernel: band (pos, kv_off, 0, hi)
    with stride_q=1, one band per row for a vector ``pos`` (one launch covers
    every row; JAX maps the call over rows).  A [B, C] chunk's row i sits at
    ``pos[b] + i``, so the same band serves decode (C=1) and chunks.  A
    dequantized (fp32) view meets q upcast to fp32: the kernel takes one
    input type; the caller casts o back to q's dtype."""
    pos_t = torch.as_tensor(pos, device=q.device).to(torch.int32)
    band = torch.stack([pos_t, torch.full_like(pos_t, kv_off), torch.zeros_like(pos_t),
                        torch.full_like(pos_t, hi)], dim=-1)
    if k_loc.dtype != q.dtype:
        q = q.float()
    return ops.block_attention(q, k_loc, v_loc, band, scale=scale, stride_q=1, stride_kv=stride_kv)


def sharded_cache_decode(
    q: torch.Tensor,  # [B, 1, H, D] new token's query
    k_cache: torch.Tensor,  # [B, m, Hkv, D]
    v_cache: torch.Tensor,
    pos,  # scalar or [B]: attends to <= pos
    axis_name: Optional[str],
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kernel: str = "band",  # band | native (split-K over implicit page runs)
) -> torch.Tensor:
    """One decode step over the dense cache.  ``kernel="native"`` views each
    row's slice as ONE implicit page run (a reshape view + identity block
    table) and runs the split-K paged kernel."""
    i = _single_shard(axis_name, n)
    B, m, hkv, d = k_cache.shape
    kv_off, stride_kv = _shard_geometry(i, n, m, layout)
    if kernel == "native":
        chunk = pk.dense_chunk_for(m)
        chunks = m // chunk
        k_pool = k_cache.reshape(B * chunks, chunk, hkv, d)
        v_pool = v_cache.reshape(B * chunks, chunk, hkv, v_cache.shape[-1])
        bt = torch.arange(B * chunks, dtype=torch.int32, device=q.device).reshape(B, chunks)
        o, _ = pk.paged_flash_decode(
            q, k_pool, v_pool, bt, pos, kv_off,
            stride_kv=stride_kv, window=window, scale=scale,
        )
    elif kernel == "band":
        hi = (window - 1) if window else BAND_INF
        o, _ = _banded_partial(q, k_cache, v_cache, pos, kv_off, stride_kv, hi, scale)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r}; expected band | native")
    return _psum_combine(o, None, axis_name, q.dtype)


# --------------------------------------------------------------------------
# paged cache: physical page pool + block table (serve/kv_pool.py allocator)
# --------------------------------------------------------------------------


def _page_coords(pos, i, n: int, page_size: int, max_pages: int, layout: str):
    """Owner shard -> (write?, logical page, offset) for global position
    ``pos``: the dense local slot j splits into (j // page_size, j % page_size)."""
    m = max_pages * page_size  # virtual local capacity
    is_owner, j = _owner_slot(pos, i, n, m, layout)
    return is_owner & (pos < n * m), j // page_size, j % page_size


def paged_write_coords(
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos,  # scalar or [B]
    page_size: int,
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each row's decode append lands: ``(rows, pages, offsets)`` of
    the rows that write.  Rows past virtual capacity or pointing at
    unallocated pages are filtered out (JAX drops them with an out-of-range
    page index).  The filter reads a data-dependent count back to the host,
    so ``decode_step`` computes the coordinates once per tick and every
    layer's update reuses them."""
    i = _single_shard(axis_name, n)
    max_pages = block_table.shape[1]
    B = block_table.shape[0]
    pos_v = _pos_vector(pos, B, block_table.device)
    write, lp, off = _page_coords(pos_v, i, n, page_size, max_pages, layout)
    b = torch.arange(B, device=block_table.device)
    phys = block_table[b, lp.clamp(0, max_pages - 1)].to(torch.int64)
    rows = torch.nonzero(write & (phys >= 0)).squeeze(1)
    return rows, phys[rows], off[rows]


def paged_cache_update(
    k_pool: torch.Tensor,  # [num_pages, page_size, Hkv, D] (updated in place)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos,  # scalar or [B]
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
    coords: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
):
    """Append through the block table: owner shard -> (page, offset).
    ``coords`` are ``paged_write_coords`` of this ``block_table`` and
    ``pos``, computed here when not given.  With scale tables the new token
    is quantized and its scales written through the same coordinates; the
    return is then ``(k_pool, v_pool, k_scale, v_scale)``."""
    if coords is None:
        coords = paged_write_coords(block_table, pos, k_pool.shape[1], axis_name, n, layout)
    rows, pages, offs = coords
    for pool, scales, new in ((k_pool, k_scale, k_new), (v_pool, v_scale, v_new)):
        kv_quant.store(pool, scales, (pages, offs), new[rows, 0])
    if k_scale is not None:
        return k_pool, v_pool, k_scale, v_scale
    return k_pool, v_pool


def paged_cache_gather(k_pool, v_pool, block_table, k_scale=None, v_scale=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each row's dense local view from its pages: [B, m, Hkv, D]
    with m = max_pages * page_size, in the same local-position order as the
    dense cache slice.  Unallocated pages clamp to page 0 -- whatever is there
    sits behind the band.  A quantized pool gathers its scales through the
    same index and dequantizes to fp32.  The plain path, used by tests,
    ``kernel="gather"`` and the chunk attention."""
    num_pages = k_pool.shape[0]
    idx = block_table.clamp(0, num_pages - 1).to(torch.int64)  # [B, max_pages]
    out = []
    for pool, scales in ((k_pool, k_scale), (v_pool, v_scale)):
        pages = pool[idx]  # [B, max_pages, page_size, Hkv, D]
        if scales is not None:
            pages = kv_quant.dequantize(pages, scales[idx])
        out.append(pages.reshape(idx.shape[0], -1, *pool.shape[2:]))
    return out[0], out[1]


def paged_cache_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pool: torch.Tensor,  # [num_pages, page_size, Hkv, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    pos,  # scalar or [B]
    axis_name: Optional[str],
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kernel: str = "gather",  # gather | native (block table read in-kernel)
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode.  ``kernel="gather"`` materializes each row's dense view
    and runs the banded partial of the dense path; ``"native"`` hands the
    pool and the block table straight to the split-K kernel -- no gathered
    intermediate, reads follow allocated depth.  A quantized pool hands its
    scale tables along: the kernel folds them in, the gather dequantizes."""
    i = _single_shard(axis_name, n)
    page_size, max_pages = k_pool.shape[1], block_table.shape[1]
    m = max_pages * page_size
    kv_off, stride_kv = _shard_geometry(i, n, m, layout)
    if kernel == "native":
        o, _ = pk.paged_flash_decode(
            q, k_pool, v_pool, block_table, pos, kv_off,
            stride_kv=stride_kv, window=window, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    elif kernel == "gather":
        hi = (window - 1) if window else BAND_INF
        k_loc, v_loc = paged_cache_gather(k_pool, v_pool, block_table, k_scale, v_scale)
        o, _ = _banded_partial(q, k_loc, v_loc, pos, kv_off, stride_kv, hi, scale)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r}; expected gather | native")
    return _psum_combine(o, None, axis_name, q.dtype)


# --------------------------------------------------------------------------
# chunks: multi-token append + prefix-causal chunk attention (continuous
# prefill and speculative verify)
# --------------------------------------------------------------------------


ChunkCoords = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_write_coords(
    starts,  # [B]
    lens,  # [B]
    write_starts,  # [B]
    C: int,
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
    *,
    m: Optional[int] = None,  # dense cache: local slots per row
    block_table: Optional[torch.Tensor] = None,  # paged: [B, max_pages]
    page_size: Optional[int] = None,
) -> ChunkCoords:
    """Where a [B, C] chunk's tokens land: ``(rows, cols, dst0, dst1)`` of
    the tokens that write -- column ``c`` of row ``b`` writes cache
    ``[dst0, dst1]`` (dense: row and slot; paged: page and offset).
    Positions below ``write_starts``, at/after ``starts + lens``, past
    capacity or on unallocated pages are filtered out (JAX drops them).  The
    filter reads a count back to the host, so the model computes the
    coordinates once per launch and every layer reuses them."""
    i = _single_shard(axis_name, n)
    dev = block_table.device if block_table is not None else torch.as_tensor(starts).device
    c = torch.arange(C, device=dev)
    pos = torch.as_tensor(starts, device=dev).to(torch.int64)[:, None] + c[None, :]
    lens = torch.as_tensor(lens, device=dev).to(torch.int64)
    wst = torch.as_tensor(write_starts, device=dev).to(torch.int64)
    live = (c[None] < lens[:, None]) & (pos >= wst[:, None])
    if block_table is None:
        is_owner, slot = _owner_slot(pos, i, n, m, layout)
        write = live & is_owner & (pos < n * m)
        b_idx, c_idx = torch.nonzero(write, as_tuple=True)
        return b_idx, c_idx, b_idx, slot[b_idx, c_idx]
    max_pages = block_table.shape[1]
    write, lp, off = _page_coords(pos, i, n, page_size, max_pages, layout)
    bt = block_table.to(torch.int64)
    phys = torch.gather(bt, 1, lp.clamp(0, max_pages - 1))
    b_idx, c_idx = torch.nonzero(live & write & (phys >= 0), as_tuple=True)
    return b_idx, c_idx, phys[b_idx, c_idx], off[b_idx, c_idx]


def sharded_cache_chunk_update(
    k_cache: torch.Tensor,  # [B, m, Hkv, D] (updated in place)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, D]
    v_new: torch.Tensor,
    starts,  # [B]: global position of each row's chunk base
    lens,  # [B]: valid tokens per row (0 = inactive row)
    write_starts,  # [B]: skip writes below this position
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
    coords: Optional[ChunkCoords] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a C-token chunk per row into the cache.  Positions below
    ``write_starts`` and at/after ``starts + lens`` are dropped; distinct
    positions of one row map to distinct slots, so no write collides.
    ``coords``: this chunk's ``chunk_write_coords``, computed when not given."""
    if coords is None:
        coords = chunk_write_coords(starts, lens, write_starts, k_new.shape[1], axis_name, n,
                                    layout, m=k_cache.shape[1])
    b_idx, c_idx, rows, slots = coords
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, slots] = new[b_idx, c_idx].to(cache.dtype)
    return k_cache, v_cache


def sharded_cache_chunk_decode(
    q: torch.Tensor,  # [B, C, H, D] chunk queries
    k_cache: torch.Tensor,  # [B, m, Hkv, D] (chunk already written)
    v_cache: torch.Tensor,
    starts,  # [B]
    axis_name: Optional[str],
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefix-causal chunk attention: row i of the chunk attends to global
    positions <= starts + i (within the window), all rows in one launch."""
    i = _single_shard(axis_name, n)
    kv_off, stride_kv = _shard_geometry(i, n, k_cache.shape[1], layout)
    hi = (window - 1) if window else BAND_INF
    o, _ = _banded_partial(q, k_cache, v_cache, starts, kv_off, stride_kv, hi, scale)
    return _psum_combine(o, None, axis_name, q.dtype)


def paged_cache_chunk_update(
    k_pool: torch.Tensor,  # [num_pages, page_size, Hkv, D] (updated in place)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, D]
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    starts,  # [B]
    lens,  # [B] (0 = inactive row)
    write_starts,  # [B]: skip writes below this position
    axis_name: Optional[str],
    n: int,
    layout: str = "striped",
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
    coords: Optional[ChunkCoords] = None,
):
    """Chunk append through the block table.  Shared-prefix positions (below
    ``write_starts``) are skipped, so shared pages are not touched
    mid-prefill.  With scale tables each chunk token is quantized on its own
    (per-(token, head) scales: resident positions are never re-quantized);
    the return is then ``(k_pool, v_pool, k_scale, v_scale)``.  ``coords``:
    this chunk's ``chunk_write_coords``, computed when not given."""
    if coords is None:
        coords = chunk_write_coords(
            starts, lens, write_starts, k_new.shape[1], axis_name, n, layout,
            block_table=block_table.to(k_pool.device), page_size=k_pool.shape[1],
        )
    b_idx, c_idx, pages, offs = coords
    for pool, scales, new in ((k_pool, k_scale, k_new), (v_pool, v_scale, v_new)):
        kv_quant.store(pool, scales, (pages, offs), new[b_idx, c_idx])
    if k_scale is not None:
        return k_pool, v_pool, k_scale, v_scale
    return k_pool, v_pool


def paged_cache_chunk_decode(
    q: torch.Tensor,  # [B, C, H, D]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    starts,  # [B]
    axis_name: Optional[str],
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged chunk attention: gather the rows' pages into the dense view
    (dequantized to fp32 for a quantized pool) and run the banded chunk
    partial, as JAX does (the split-K decode kernel stays single-token).
    The gathered view lives only for this call."""
    i = _single_shard(axis_name, n)
    page_size, max_pages = k_pool.shape[1], block_table.shape[1]
    kv_off, stride_kv = _shard_geometry(i, n, max_pages * page_size, layout)
    hi = (window - 1) if window else BAND_INF
    k_loc, v_loc = paged_cache_gather(k_pool, v_pool, block_table, k_scale, v_scale)
    o, _ = _banded_partial(q, k_loc, v_loc, starts, kv_off, stride_kv, hi, scale)
    return _psum_combine(o, None, axis_name, q.dtype)
