"""Flash-decode over a sequence-sharded KV cache (copy of
``repro/core/decode_attention.py``).

The paper's locality idea applied to inference: the cache of a ring of n
ranks is sharded over the sequence -- by *absolute position modulo n*
("striped", the §3.7 layout) or contiguously -- and each decode step runs

  1. the new token's q on every rank (it is tiny),
  2. a partial flash-decode on every rank over its own slice,
  3. JAX's lse-weighted psum of the partials (``_psum_combine``): per-token
     traffic O(B·C·H·D) whatever the context length.

The cache keeps JAX's global-logical layout.  Dense: ``[B, n*m, Hkv, D]``,
rank i owns columns ``[i*m, (i+1)*m)`` and its local slot j holds position
``i + n*j`` (striped) or ``i*m + j``.  Paged: the pool ``[num_pages,
n*page_size, Hkv, D]`` (rank i owns columns ``[i*ps, (i+1)*ps)`` of every
page) addressed through an int32 block table ``[B, max_pages]`` (-1 =
unallocated; ``serve/kv_pool.py`` allocates).  Every rank of the ring runs in
this process (the ``VirtualRing``; ``ring`` is JAX's ``axis_name``), so the
ranks fold into ONE launch, as the mesh executor's forward folds them: the
rank views are reshapes of the cache's own storage -- dense ``[B*n, m]``
(row ``b*n + i`` is rank i's slice of slot b), paged ``[P*n, ps]`` (page p
of rank i is ``p*n + i``, the block table becomes ``bt*n + i``) -- and q is
repeated per rank.  The partials' combine is ``paged_decode.split_combine``
(the decode kernel's own split merge) over the rank axis, behind the
transport's ``gather_ranks`` (counted as comm kind ``combine``).  With n = 1
there is no fold and no combine: a cast.

Both decode entries take a ``kernel`` selector: ``"band"`` / ``"gather"``
run the flash-forward kernel with one band per (row, rank) -- ``(pos, kv_off
= i, 0, hi)`` with ``stride_kv = n`` striped (paged: after gathering the
rows' pages into a dense view) -- and ``"native"`` runs the split-K paged
kernel, which reads the block table itself; the dense cache reaches it
through an identity block table.  The kernel takes one ``kv_offset``, so
rank i's rows carry the shifted depth ``pos - kv_off_i`` with offset 0: the
kernel's bounds ``floor((pos - kv_off) / stride)`` and its window start
``max(pos - hi, 0)`` see the same slots, since every position on rank i is
at least ``kv_off_i``.  A rank that sees no key (``pos < kv_off_i``) gets a
negative depth and comes out exactly o = 0, lse = NEG_INF.

A quantized paged pool (int8 / fp8 codes, ``core/kv_quant.py``) carries
``k_scale``/``v_scale`` tables ``[num_pages, n*page_size, Hkv]`` that share
the pool's page indexing (and fold the same way): every update quantizes its
new tokens per (token, head) and writes codes and scales through the same
coordinates; the native decode kernel reads both, the gather path
dequantizes.

Continuous prefill and speculative verify append a C-token chunk per row
(``*_chunk_update``) and attend prefix-causally (``*_chunk_decode``): row i of
a chunk sits at global position ``starts[b] + i``, so the band ``(starts[b],
kv_off, 0, hi)`` with ``stride_q=1`` is exactly the decode band of each row.
All rows and ranks go through ONE flash-forward launch with a ``[B*n, 4]``
band tensor (JAX maps one call over the rows).  Pad rows (``i >= lens[b]``)
compute garbage but never write; softmax is per row, so they cannot reach
real rows.

Unlike JAX, the updates write the cache IN PLACE (slice / index assignment)
at the global coordinates of each position's owner rank, and return the same
tensors.  JAX drops out-of-range scatter rows (``mode="drop"``); here rows
that must not be written are filtered out with a boolean mask before the
write -- a clamped write could land on a live page.  JAX's window prune (a
``lax.cond`` that skips a rank whose whole slice a sliding window hides, and
returns the empty result) is left out: it is bitwise-neutral, and the
kernels' per-row bounds already make such a rank's rows empty.
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


def _check_ring(ring, n: int) -> None:
    """The ring holds all n ranks in this process (the virtual ring); None
    is the one-rank case."""
    if ring is None:
        if n != 1:
            raise ValueError(f"a sequence-sharded cache over n={n} ranks needs the ring")
        return
    if ring.n != n:
        raise ValueError(f"the ring has {ring.n} ranks but n={n}")
    if tuple(ring.ranks) != tuple(range(n)):
        raise NotImplementedError(
            "sequence-sharded serving runs every rank in one process (VirtualRing); one rank "
            "per process waits for multi-process sequence parallelism (ROADMAP A.9)"
        )


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """int64 [B] positions from a scalar or a [B] vector."""
    return torch.as_tensor(pos, device=device).to(torch.int64).expand(batch)


def _owner_slot(pos, n: int, m: int, layout: str):
    """(owner rank, local slot) of global position ``pos``; m = local slots.
    JAX's ``_owner_slot`` asks each rank i whether it is the owner."""
    if layout == "striped":
        return pos % n, pos // n
    return pos // m, pos % m


def _rank_offsets(n: int, m: int, layout: str, device) -> Tuple[torch.Tensor, int]:
    """(kv_offset of each rank [n], stride): local slot s of rank i holds
    global position ``kv_offset[i] + stride * s``."""
    i = torch.arange(n, device=device)
    if layout == "striped":
        return i, n
    return i * m, 1


def _fold_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ...] -> [B*n, ...]: row b*n + i is rank i's copy of row b."""
    return x if n == 1 else x.repeat_interleave(n, dim=0)


def _rank_view(cache: torch.Tensor, n: int) -> torch.Tensor:
    """[X, n*c, ...] -> [X*n, c, ...]: rank i's columns of row x become row
    x*n + i.  A view of the cache's own storage (dense: the slot rows; paged:
    the pages and their scale tables)."""
    X, cols = cache.shape[0], cache.shape[1]
    return cache.reshape(X * n, cols // n, *cache.shape[2:])


def _rank_block_table(bt: torch.Tensor, n: int) -> torch.Tensor:
    """[B, max_pages] -> [B*n, max_pages]: rank i's pages of row b, in the
    folded pool (page p of rank i is p*n + i); -1 stays unallocated."""
    if n == 1:
        return bt
    i = torch.arange(n, dtype=bt.dtype, device=bt.device)[None, :, None]
    folded = torch.where(bt[:, None] >= 0, bt[:, None] * n + i, torch.full_like(bt[:, None], -1))
    return folded.reshape(bt.shape[0] * n, bt.shape[1])


def sharded_cache_update(
    k_cache: torch.Tensor,  # [B, n*m, Hkv, D] (updated in place)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    pos,  # scalar or [B]: global position(s) being written
    ring,
    n: int,
    layout: str = "striped",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append at the owner rank's slot of each row's position."""
    _check_ring(ring, n)
    B, m = k_cache.shape[0], k_cache.shape[1] // n
    pos_v = _pos_vector(pos, B, k_cache.device)
    owner, slot = _owner_slot(pos_v, n, m, layout)
    if torch.as_tensor(pos).dim() == 0:
        # one position for every row: JAX's dynamic_update_slice clamps a
        # slot past capacity onto the last one, and the owner writes there
        write = owner < n
    else:
        # per-row positions: rows past capacity (retired slots still
        # ticking) must not write, as JAX masks them off; each row only ever
        # touches its own slice, so the masked-off rows put back the value
        # they read and no other row's data can be hit
        write = pos_v < n * m
    col = owner.clamp(0, n - 1) * m + slot.clamp(0, m - 1)
    b = torch.arange(B, device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[b, col]  # [B, Hkv, D]
        cache[b, col] = torch.where(write[:, None, None], new[:, 0].to(cache.dtype), cur)
    return k_cache, v_cache


def _psum_combine(o, lse, ring, n: int, q_dtype):
    """JAX's lse-weighted psum of the ranks' partials (softmax over disjoint
    keys): o [B*n, C, H, D], lse [B*n, H, C] -> [B, C, H, D].  Each rank's
    partial is rounded to q's dtype first, as it leaves JAX's kernel; the
    ranks' partials meet through the transport, and ``split_combine`` (the
    decode kernel's split merge: m = max lse, w = exp(lse - m), sum(w o) /
    sum(w), an empty rank weighs 0) merges them in one launch."""
    if n == 1:
        return o.to(q_dtype)
    B, (C, H, D) = o.shape[0] // n, o.shape[1:]
    o_r, lse_r = ring.gather_ranks(
        [o.to(q_dtype).view(B, n, C, H, D).movedim(1, 0), lse.view(B, n, H, C).movedim(1, 0)],
        kind="combine",
    )
    o_parts = torch.empty((B, C, n, H, D), dtype=torch.float32, device=o.device)
    o_parts.copy_(o_r.permute(1, 2, 0, 3, 4))  # one copy: [B, C, rank, H, D] in fp32
    lse_parts = lse_r.permute(1, 3, 0, 2).contiguous()
    out, _ = pk.split_combine(o_parts.view(B * C, n, H, D), lse_parts.view(B * C, n, H), q_dtype)
    return out.view(B, C, H, D)


def _banded_partial(q, k_loc, v_loc, pos, kv_off: torch.Tensor, stride_kv: int, hi: int, scale):
    """The ranks' partials through ONE flash-kernel launch: q [B, C, H, D]
    repeated per rank against the folded slices k_loc [B*n, m, Hkv, D], one
    band per (row, rank) ``(pos[b], kv_off[i], 0, hi)`` with stride_q=1 (a
    chunk's row c sits at ``pos[b] + c``, so the same band serves decode
    and chunks).  A dequantized (fp32) view meets q upcast to fp32: the
    kernel takes one input type; the combine rounds o back to q's dtype."""
    n = kv_off.shape[0]
    B = q.shape[0]
    pos_r = _fold_rows(_pos_vector(pos, B, q.device), n)
    band = torch.stack([pos_r, kv_off.repeat(B), torch.zeros_like(pos_r),
                        torch.full_like(pos_r, hi)], dim=-1).to(torch.int32)
    if k_loc.dtype != q.dtype:
        q = q.float()
    return ops.block_attention(_fold_rows(q, n), k_loc, v_loc, band, scale=scale, stride_q=1,
                               stride_kv=stride_kv)


def _native_partial(q, k_pool, v_pool, bt, pos, kv_off: torch.Tensor, stride_kv: int, window,
                    scale, k_scale=None, v_scale=None):
    """The ranks' partials through ONE split-K launch over the folded pool:
    rank i's rows carry the depth ``pos - kv_off[i]`` at offset 0 (the same
    visible slots; negative: a rank that sees no key)."""
    n = kv_off.shape[0]
    if n == 1:  # one rank: offset 0 in either layout
        return pk.paged_flash_decode(
            q, k_pool, v_pool, bt, pos, 0, stride_kv=stride_kv, window=window,
            scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    B = q.shape[0]
    pos_r = (_fold_rows(_pos_vector(pos, B, q.device), n) - kv_off.repeat(B)).to(torch.int32)
    return pk.paged_flash_decode(
        _fold_rows(q, n), k_pool, v_pool, bt, pos_r, 0, stride_kv=stride_kv, window=window,
        scale=scale, k_scale=k_scale, v_scale=v_scale,
    )


def sharded_cache_decode(
    q: torch.Tensor,  # [B, 1, H, D] new token's query
    k_cache: torch.Tensor,  # [B, n*m, Hkv, D]
    v_cache: torch.Tensor,
    pos,  # scalar or [B]: attends to <= pos
    ring,
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kernel: str = "band",  # band | native (split-K over implicit page runs)
) -> torch.Tensor:
    """One decode step over the dense cache: the ranks' partials, then the
    combine.  ``kernel="native"`` views each rank's slice of a row as ONE
    implicit page run (a reshape view + identity block table) and runs the
    split-K paged kernel."""
    _check_ring(ring, n)
    B, cap, hkv, d = k_cache.shape
    m = cap // n
    kv_off, stride_kv = _rank_offsets(n, m, layout, q.device)
    if kernel == "native":
        chunk = pk.dense_chunk_for(m)
        chunks = m // chunk
        k_pool = k_cache.reshape(B * n * chunks, chunk, hkv, d)
        v_pool = v_cache.reshape(B * n * chunks, chunk, hkv, v_cache.shape[-1])
        bt = torch.arange(B * n * chunks, dtype=torch.int32, device=q.device).reshape(B * n, chunks)
        o, lse = _native_partial(q, k_pool, v_pool, bt, pos, kv_off, stride_kv, window, scale)
    elif kernel == "band":
        hi = (window - 1) if window else BAND_INF
        o, lse = _banded_partial(q, _rank_view(k_cache, n), _rank_view(v_cache, n), pos, kv_off,
                                 stride_kv, hi, scale)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r}; expected band | native")
    return _psum_combine(o, lse, ring, n, q.dtype)


# --------------------------------------------------------------------------
# paged cache: physical page pool + block table (serve/kv_pool.py allocator)
# --------------------------------------------------------------------------


def _page_coords(pos, n: int, page_size: int, max_pages: int, layout: str):
    """Owner rank -> (write?, logical page, pool column) for global position
    ``pos``: the owner's local slot j splits into (j // page_size, j %
    page_size), and its column of the page is ``owner*page_size + j %
    page_size``."""
    m = max_pages * page_size  # virtual local capacity
    owner, j = _owner_slot(pos, n, m, layout)
    return pos < n * m, j // page_size, owner.clamp(0, n - 1) * page_size + j % page_size


def paged_write_coords(
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos,  # scalar or [B]
    page_size: int,
    ring,
    n: int,
    layout: str = "striped",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each row's decode append lands: ``(rows, pages, columns)`` of
    the rows that write.  Rows past virtual capacity or pointing at
    unallocated pages are filtered out (JAX drops them with an out-of-range
    page index).  The filter reads a data-dependent count back to the host,
    so ``decode_step`` computes the coordinates once per tick and every
    layer's update reuses them."""
    _check_ring(ring, n)
    max_pages = block_table.shape[1]
    B = block_table.shape[0]
    pos_v = _pos_vector(pos, B, block_table.device)
    write, lp, col = _page_coords(pos_v, n, page_size, max_pages, layout)
    b = torch.arange(B, device=block_table.device)
    phys = block_table[b, lp.clamp(0, max_pages - 1)].to(torch.int64)
    rows = torch.nonzero(write & (phys >= 0)).squeeze(1)
    return rows, phys[rows], col[rows]


def paged_cache_update(
    k_pool: torch.Tensor,  # [num_pages, n*page_size, Hkv, D] (updated in place)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    pos,  # scalar or [B]
    ring,
    n: int,
    layout: str = "striped",
    coords: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, n*page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
):
    """Append through the block table: owner rank -> (page, column).
    ``coords`` are ``paged_write_coords`` of this ``block_table`` and
    ``pos``, computed here when not given.  With scale tables the new token
    is quantized and its scales written through the same coordinates; the
    return is then ``(k_pool, v_pool, k_scale, v_scale)``."""
    if coords is None:
        coords = paged_write_coords(block_table, pos, k_pool.shape[1] // n, ring, n, layout)
    rows, pages, cols = coords
    for pool, scales, new in ((k_pool, k_scale, k_new), (v_pool, v_scale, v_new)):
        kv_quant.store(pool, scales, (pages, cols), new[rows, 0])
    if k_scale is not None:
        return k_pool, v_pool, k_scale, v_scale
    return k_pool, v_pool


def paged_cache_gather(k_pool, v_pool, block_table, k_scale=None, v_scale=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each row's dense view from its pages: [B, m, Hkv, D] with
    m = max_pages * page_size, in the same local-position order as the dense
    cache slice.  Unallocated pages clamp to page 0 -- whatever is there sits
    behind the band.  A quantized pool gathers its scales through the same
    index and dequantizes to fp32.  Over a folded pool and block table it
    gives every rank's view of every row.  The plain path, used by tests,
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


def _folded_pool(k_pool, v_pool, block_table, k_scale, v_scale, n: int):
    """The ranks' view of the pool: pages [P*n, ps, ...], the block table
    [B*n, max_pages] and the scale tables folded alike."""
    bt = _rank_block_table(block_table.to(device=k_pool.device, dtype=torch.int32), n)
    scales = [None if s is None else _rank_view(s, n) for s in (k_scale, v_scale)]
    return _rank_view(k_pool, n), _rank_view(v_pool, n), bt, scales[0], scales[1]


def paged_cache_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pool: torch.Tensor,  # [num_pages, n*page_size, Hkv, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    pos,  # scalar or [B]
    ring,
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kernel: str = "gather",  # gather | native (block table read in-kernel)
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, n*page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode.  ``kernel="gather"`` materializes each rank's dense
    view of each row and runs the banded partial of the dense path;
    ``"native"`` hands the folded pool and block table straight to the
    split-K kernel -- no gathered intermediate, reads follow allocated
    depth.  A quantized pool hands its scale tables along: the kernel folds
    them in, the gather dequantizes.  Then the ranks' combine."""
    _check_ring(ring, n)
    kp, vp, bt, ks, vs = _folded_pool(k_pool, v_pool, block_table, k_scale, v_scale, n)
    m = bt.shape[1] * kp.shape[1]
    kv_off, stride_kv = _rank_offsets(n, m, layout, q.device)
    if kernel == "native":
        o, lse = _native_partial(q, kp, vp, bt, pos, kv_off, stride_kv, window, scale, ks, vs)
    elif kernel == "gather":
        hi = (window - 1) if window else BAND_INF
        k_loc, v_loc = paged_cache_gather(kp, vp, bt, ks, vs)
        o, lse = _banded_partial(q, k_loc, v_loc, pos, kv_off, stride_kv, hi, scale)
    else:
        raise ValueError(f"unknown decode kernel {kernel!r}; expected gather | native")
    return _psum_combine(o, lse, ring, n, q.dtype)


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
    ring,
    n: int,
    layout: str = "striped",
    *,
    m: Optional[int] = None,  # dense cache: columns per row (n * local slots)
    block_table: Optional[torch.Tensor] = None,  # paged: [B, max_pages]
    page_size: Optional[int] = None,
) -> ChunkCoords:
    """Where a [B, C] chunk's tokens land: ``(rows, cols, dst0, dst1)`` of
    the tokens that write -- column ``c`` of row ``b`` writes cache
    ``[dst0, dst1]`` (dense: row and column; paged: page and column), at
    each position's owner rank.  Positions below ``write_starts``, at/after
    ``starts + lens``, past capacity or on unallocated pages are filtered
    out (JAX drops them).  The filter reads a count back to the host, so the
    model computes the coordinates once per launch and every layer reuses
    them."""
    _check_ring(ring, n)
    dev = block_table.device if block_table is not None else torch.as_tensor(starts).device
    c = torch.arange(C, device=dev)
    pos = torch.as_tensor(starts, device=dev).to(torch.int64)[:, None] + c[None, :]
    lens = torch.as_tensor(lens, device=dev).to(torch.int64)
    wst = torch.as_tensor(write_starts, device=dev).to(torch.int64)
    live = (c[None] < lens[:, None]) & (pos >= wst[:, None])
    if block_table is None:
        m_loc = m // n
        owner, slot = _owner_slot(pos, n, m_loc, layout)
        write = live & (pos < m)
        b_idx, c_idx = torch.nonzero(write, as_tuple=True)
        return b_idx, c_idx, b_idx, owner[b_idx, c_idx] * m_loc + slot[b_idx, c_idx]
    max_pages = block_table.shape[1]
    write, lp, col = _page_coords(pos, n, page_size, max_pages, layout)
    bt = block_table.to(torch.int64)
    phys = torch.gather(bt, 1, lp.clamp(0, max_pages - 1))
    b_idx, c_idx = torch.nonzero(live & write & (phys >= 0), as_tuple=True)
    return b_idx, c_idx, phys[b_idx, c_idx], col[b_idx, c_idx]


def sharded_cache_chunk_update(
    k_cache: torch.Tensor,  # [B, n*m, Hkv, D] (updated in place)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, D]
    v_new: torch.Tensor,
    starts,  # [B]: global position of each row's chunk base
    lens,  # [B]: valid tokens per row (0 = inactive row)
    write_starts,  # [B]: skip writes below this position
    ring,
    n: int,
    layout: str = "striped",
    coords: Optional[ChunkCoords] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a C-token chunk per row into the cache.  Positions below
    ``write_starts`` and at/after ``starts + lens`` are dropped; distinct
    positions of one row map to distinct slots, so no write collides.
    ``coords``: this chunk's ``chunk_write_coords``, computed when not given."""
    if coords is None:
        coords = chunk_write_coords(starts, lens, write_starts, k_new.shape[1], ring, n,
                                    layout, m=k_cache.shape[1])
    b_idx, c_idx, rows, cols = coords
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, cols] = new[b_idx, c_idx].to(cache.dtype)
    return k_cache, v_cache


def sharded_cache_chunk_decode(
    q: torch.Tensor,  # [B, C, H, D] chunk queries
    k_cache: torch.Tensor,  # [B, n*m, Hkv, D] (chunk already written)
    v_cache: torch.Tensor,
    starts,  # [B]
    ring,
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefix-causal chunk attention: row i of the chunk attends to global
    positions <= starts + i (within the window), all rows and ranks in one
    launch, then the ranks' combine."""
    _check_ring(ring, n)
    kv_off, stride_kv = _rank_offsets(n, k_cache.shape[1] // n, layout, q.device)
    hi = (window - 1) if window else BAND_INF
    o, lse = _banded_partial(q, _rank_view(k_cache, n), _rank_view(v_cache, n), starts, kv_off,
                             stride_kv, hi, scale)
    return _psum_combine(o, lse, ring, n, q.dtype)


def paged_cache_chunk_update(
    k_pool: torch.Tensor,  # [num_pages, n*page_size, Hkv, D] (updated in place)
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, C, Hkv, D]
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32; -1 = unallocated
    starts,  # [B]
    lens,  # [B] (0 = inactive row)
    write_starts,  # [B]: skip writes below this position
    ring,
    n: int,
    layout: str = "striped",
    k_scale: Optional[torch.Tensor] = None,  # [num_pages, n*page_size, Hkv] f32
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
            starts, lens, write_starts, k_new.shape[1], ring, n, layout,
            block_table=block_table.to(k_pool.device), page_size=k_pool.shape[1] // n,
        )
    b_idx, c_idx, pages, cols = coords
    for pool, scales, new in ((k_pool, k_scale, k_new), (v_pool, v_scale, v_new)):
        kv_quant.store(pool, scales, (pages, cols), new[b_idx, c_idx])
    if k_scale is not None:
        return k_pool, v_pool, k_scale, v_scale
    return k_pool, v_pool


def paged_cache_chunk_decode(
    q: torch.Tensor,  # [B, C, H, D]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    starts,  # [B]
    ring,
    n: int,
    *,
    layout: str = "striped",
    window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged chunk attention: gather every rank's view of the rows' pages
    (dequantized to fp32 for a quantized pool) and run the banded chunk
    partial, as JAX does (the split-K decode kernel stays single-token),
    then the ranks' combine.  The gathered view lives only for this call."""
    _check_ring(ring, n)
    kp, vp, bt, ks, vs = _folded_pool(k_pool, v_pool, block_table, k_scale, v_scale, n)
    kv_off, stride_kv = _rank_offsets(n, bt.shape[1] * kp.shape[1], layout, q.device)
    hi = (window - 1) if window else BAND_INF
    k_loc, v_loc = paged_cache_gather(kp, vp, bt, ks, vs)
    o, lse = _banded_partial(q, k_loc, v_loc, starts, kv_off, stride_kv, hi, scale)
    return _psum_combine(o, lse, ring, n, q.dtype)
