"""Flash-decode over the KV cache (single-card copy of
``repro/core/decode_attention.py``).

The JAX module shards the cache over a sequence-parallel axis and combines
per-shard partials with an lse-weighted psum.  This slice runs on one card:
``axis_name`` must be None and ``n`` 1, so there is one shard (index 0) and
the combine is a cast.  The owner/stripe math is kept in the same shape so
the mesh slice can widen it.

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
]


def _single_shard(axis_name: Optional[str], n: int) -> int:
    """Shard index of this device: always 0 on one card."""
    if axis_name is not None or n != 1:
        raise NotImplementedError(
            "the sequence-sharded cache (axis_name / n > 1) comes with the mesh slice"
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
        raise NotImplementedError("the cross-shard lse combine comes with the mesh slice")
    return o.to(q_dtype)


def _banded_partial(q, k_loc, v_loc, pos, kv_off: int, stride_kv: int, hi: int, scale):
    """Per-shard partial flash-decode through the flash kernel: band
    (pos, kv_off, 0, hi), one band per row for a vector ``pos`` (one launch
    covers every row; JAX maps the call over rows)."""
    pos_t = torch.as_tensor(pos, device=q.device).to(torch.int32)
    band = torch.stack([pos_t, torch.full_like(pos_t, kv_off), torch.zeros_like(pos_t),
                        torch.full_like(pos_t, hi)], dim=-1)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append through the block table: owner shard -> (page, offset).
    ``coords`` are ``paged_write_coords`` of this ``block_table`` and
    ``pos``, computed here when not given."""
    if coords is None:
        coords = paged_write_coords(block_table, pos, k_pool.shape[1], axis_name, n, layout)
    rows, pages, offs = coords
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        pool[pages, offs] = new[rows, 0].to(pool.dtype)
    return k_pool, v_pool


def paged_cache_gather(k_pool, v_pool, block_table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each row's dense local view from its pages: [B, m, Hkv, D]
    with m = max_pages * page_size, in the same local-position order as the
    dense cache slice.  Unallocated pages clamp to page 0 -- whatever is there
    sits behind the band.  The plain path, used by tests and
    ``kernel="gather"``."""
    num_pages = k_pool.shape[0]
    idx = block_table.clamp(0, num_pages - 1).to(torch.int64)  # [B, max_pages]
    out = []
    for pool in (k_pool, v_pool):
        pages = pool[idx]  # [B, max_pages, page_size, Hkv, D]
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
) -> torch.Tensor:
    """Paged decode.  ``kernel="gather"`` materializes each row's dense view
    and runs the banded partial of the dense path; ``"native"`` hands the
    pool and the block table straight to the split-K kernel -- no gathered
    intermediate, reads follow allocated depth."""
    i = _single_shard(axis_name, n)
    page_size, max_pages = k_pool.shape[1], block_table.shape[1]
    m = max_pages * page_size
    kv_off, stride_kv = _shard_geometry(i, n, m, layout)
    if kernel == "native":
        o, _ = pk.paged_flash_decode(
            q, k_pool, v_pool, block_table, pos, kv_off,
            stride_kv=stride_kv, window=window, scale=scale,
        )
    elif kernel == "gather":
        hi = (window - 1) if window else BAND_INF
        k_loc, v_loc = paged_cache_gather(k_pool, v_pool, block_table)
        o, _ = _banded_partial(q, k_loc, v_loc, pos, kv_off, stride_kv, hi, scale)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r}; expected gather | native")
    return _psum_combine(o, None, axis_name, q.dtype)
