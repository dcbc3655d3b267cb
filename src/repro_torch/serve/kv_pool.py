"""Paged KV-cache pool: block tables, refcounted pages, prefix sharing.

The port's own copy of ``repro/serve/kv_pool.py`` (numpy only): conservative
admission, prefix sharing, tail-page allocation and copy-on-write on append,
speculative spans and rollback, the quantized pool's scale-entry count, and
retirement, oversubscribed admission against a virtual capacity
(``PoolExhausted`` when the free list runs dry; the engine answers it by
preempting a victim) and the chaos injector's ``seize_pages`` /
``restore_pages``.

The dense engine stores each slot's KV as a full ``[cap]`` row, so memory is
``num_slots x max_seq`` no matter how deep any request actually is, and two
requests sharing a system prompt materialize it twice.  This module virtualizes
the slot rows over a fixed **physical page pool**:

  * device side -- per layer, ``[num_pages, n*page_size, Hkv, D]``.  One
    *logical* page covers ``n * page_size`` consecutive global positions
    (``n``: the ranks of the sequence-parallel ring; rank i owns columns
    ``[i*page_size, (i+1)*page_size)``), which keeps the striped owner math
    of ``core/decode_attention.py`` intact: owner rank -> (page, column).
  * host side -- this module: an int32 block table ``[num_slots, max_pages]``
    mapping each slot's logical page to a physical page, a refcount per page,
    a free list, and a **prefix registry** (hash of the first ``c`` page-chunks
    of a prompt -> live physical pages) so identical prompt prefixes are
    admitted as shared, refcounted pages instead of fresh copies.

The allocator is pure bookkeeping: the engine uploads the block table to the
device when ``version`` moved and applies the allocator's page-copy
instructions (copy-on-write) before the decode step that writes.

Sharing granularity is one logical page: only whole page-chunks of a prompt
are registered/matched, and a slot's first append position is at or past its
prompt length, so under the engine's flow an append never lands inside a
shared page.  ``ensure_append`` still returns a ``(src, dst)`` physical copy
whenever the target page has refcount > 1, and the engine applies it before
writing.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PagedLayout", "PageAllocator", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """The free list cannot satisfy a page request RIGHT NOW.

    Under conservative admission (``oversubscribe == 1.0``) this is an
    allocator bug or an un-reserved caller; under oversubscription it is an
    expected runtime event the engine answers by preempting a victim slot
    and retrying.  Subclasses ``RuntimeError`` so callers that catch
    ``RuntimeError`` keep working."""


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged KV pool.

    ``page_size`` counts LOCAL positions per shard per page; one logical page
    spans ``chunk = n * page_size`` consecutive global positions.  A slot's
    virtual capacity stays ``max_seq`` (= ``max_pages * chunk``), so all the
    band/owner math of the dense cache carries over unchanged.
    """

    num_pages: int  # physical pages in the pool (shared by all slots)
    page_size: int  # local positions per page (per device)
    max_pages: int  # logical pages per slot (virtual cap = max_pages * chunk)
    n: int = 1  # sequence-parallel size the pool is sharded over

    def __post_init__(self):
        if min(self.num_pages, self.page_size, self.max_pages, self.n) < 1:
            raise ValueError(f"invalid paged layout {self}")

    @property
    def chunk(self) -> int:
        """Global positions covered by one logical page."""
        return self.n * self.page_size

    @property
    def virtual_cap(self) -> int:
        return self.max_pages * self.chunk

    def pages_for(self, length: int) -> int:
        """Logical pages needed to hold ``length`` global positions."""
        return -(-max(int(length), 0) // self.chunk)

    @staticmethod
    def for_engine(
        max_seq: int, n: int, num_slots: int,
        page_size: Optional[int] = None, num_pages: Optional[int] = None,
    ) -> "PagedLayout":
        """Engine default: virtual cap == max_seq; pool sized to the dense
        cache (num_slots * max_pages) unless the caller asks for less."""
        if page_size is None:
            page_size = max(1, min(16, max_seq // max(n, 1)))
        if (max_seq % (n * page_size)) != 0:
            raise ValueError(
                f"max_seq={max_seq} must be divisible by n*page_size={n * page_size}"
            )
        max_pages = max_seq // (n * page_size)
        return PagedLayout(
            num_pages=num_pages if num_pages is not None else num_slots * max_pages,
            page_size=page_size,
            max_pages=max_pages,
            n=n,
        )


def _prefix_key(prompt: np.ndarray, upto: int) -> bytes:
    """Chain hash of the first ``upto`` tokens (position 0 anchored, so RoPE
    phases match by construction)."""
    return hashlib.sha1(np.ascontiguousarray(prompt[:upto], np.int32).tobytes()).digest()


@dataclasses.dataclass
class SlotAlloc:
    """What an admission got: which logical pages are shared (prefill must
    NOT overwrite them -- the owner's K/V is already there, byte-identical by
    causality) and how many tokens they cover."""

    shared_pages: int
    shared_len: int  # = shared_pages * chunk


class PageAllocator:
    """Refcounted page allocator + prefix registry over a ``PagedLayout``.

    All methods mutate host state only; device mutations are communicated as
    return values (block-table rows, copy pairs) for the engine to apply.
    With ``oversubscribe == 1.0`` admission is conservative: a request is
    admitted only when its whole lifetime (prompt + token budget) fits the
    unreserved pool, so the pool can never run dry mid-decode.  Above 1.0
    lifetimes book against ``virtual_pages`` and only the prompt (plus
    ``ADMIT_MARGIN``) must fit physically.
    """

    FREE = -1
    # extra physically-free pages required beyond the prompt at admission
    # under oversubscription: the first append after prefill has somewhere
    # to land without an immediate preemption
    ADMIT_MARGIN = 1

    def __init__(
        self, layout: PagedLayout, quantized: bool = False, oversubscribe: float = 1.0,
    ):
        if oversubscribe < 1.0:
            raise ValueError(f"oversubscribe must be >= 1.0, got {oversubscribe}")
        self.layout = layout
        # admission capacity: lifetime reservations may overbook the physical
        # pool by this factor (1.0 = no admitted request can ever exhaust it)
        self.oversubscribe = float(oversubscribe)
        self.virtual_pages = int(layout.num_pages * self.oversubscribe)
        # a quantized pool carries a scale tile per physical page (side table
        # indexed by the same block table); its liveness is counted apart
        # from the free list, so "scales drain with pages" is a real check
        self.quantized = bool(quantized)
        self.scale_entries_in_use = 0
        self.block_table = np.full((0, layout.max_pages), self.FREE, np.int32)
        self.ref = np.zeros((layout.num_pages,), np.int32)
        self.gen = np.zeros((layout.num_pages,), np.int64)  # bumped on free
        self._free: List[int] = list(range(layout.num_pages - 1, -1, -1))
        # slot -> logical page count currently allocated
        self._slot_pages: Dict[int, int] = {}
        # slot -> pages reserved for its full lifetime (admission guarantee)
        self._reserved: Dict[int, int] = {}
        # prefix registry: chain-hash -> (physical page, generation stamp)
        self._prefix: Dict[bytes, Tuple[int, int]] = {}
        # stats
        self.fresh_allocs = 0  # pages taken off the free list, ever
        self.shared_hits = 0  # pages admitted by prefix match instead
        self.cow_copies = 0
        self.spec_rolled_back = 0  # pages freed by speculative rollback
        self.double_free_noops = 0  # idempotent free/rollback of a retired slot
        self.peak_in_use = 0
        # chaos harness: pages seized OUT of the free list (fault injection);
        # they count as in-use but carry no refs and no scale entries
        self._seized: List[int] = []
        # bumped on every block-table mutation: the engine re-uploads the
        # device table only when this moved since the last sync
        self.version = 0

    # -- introspection ------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.layout.num_pages - len(self._free)

    @property
    def pages_reserved(self) -> int:
        return sum(self._reserved.values())

    @property
    def pages_referenced(self) -> int:
        """Pages with at least one live block-table reference (excludes
        chaos-seized pages, which are in use but own no data)."""
        return int(np.count_nonzero(self.ref > 0))

    def slot_pages(self, slot: int) -> int:
        return self._slot_pages.get(slot, 0)

    def slot_shares_pages(self, slot: int) -> bool:
        """True when any of ``slot``'s pages is mapped by another live slot
        (prefix donor / sharer): preemption takes these as last-resort
        victims."""
        held = self._slot_pages.get(slot, 0)
        if not held:
            return False
        return any(self.ref[int(p)] > 1 for p in self.block_table[slot, :held])

    # -- admission ----------------------------------------------------------

    def reserve_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case lifetime pages for a request (sharing not discounted:
        a shared page may need a private copy at any time)."""
        return self.layout.pages_for(prompt_len + max_new_tokens)

    def can_admit(
        self, prompt_len: int, max_new_tokens: int, pending: int = 0,
        pending_prompt: int = 0,
    ) -> bool:
        """Page-accounted admission.  At ``oversubscribe == 1.0`` every
        admitted request can reach its token budget without the pool running
        dry.  Above 1.0 lifetime reservations book against the virtual
        capacity and only the prompt pages (plus a one-page margin) must fit
        physically right now; running dry mid-decode is then an expected
        event the engine resolves by preempt-and-recompute.  ``pending`` /
        ``pending_prompt`` carry pages already promised to requests admitted
        earlier in the same tick (their ``alloc_slot`` hasn't run yet)."""
        need = self.reserve_for(prompt_len, max_new_tokens)
        if self.pages_reserved + pending + need > self.virtual_pages:
            return False
        if self.oversubscribe > 1.0:
            now = self.pages_in_use + pending_prompt + self.layout.pages_for(prompt_len)
            if now + self.ADMIT_MARGIN > self.layout.num_pages:
                return False
        return True

    def never_admittable(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True when the request could not be admitted even into an EMPTY
        pool -- waiting can never help, so the scheduler rejects it instead
        of blocking the queue head forever."""
        if self.reserve_for(prompt_len, max_new_tokens) > self.virtual_pages:
            return True
        return self.layout.pages_for(prompt_len) > self.layout.num_pages

    # -- lifecycle ----------------------------------------------------------

    def _ensure_rows(self, slot: int):
        if slot >= len(self.block_table):
            grow = np.full(
                (slot + 1 - len(self.block_table), self.layout.max_pages),
                self.FREE, np.int32,
            )
            self.block_table = np.concatenate([self.block_table, grow])

    def _take_page(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"page pool exhausted: {self.pages_in_use}/{self.layout.num_pages} "
                f"pages in use ({self.pages_referenced} referenced, "
                f"{len(self._seized)} seized), {self.pages_reserved} reserved "
                f"against a virtual capacity of {self.virtual_pages} "
                f"(oversubscribe={self.oversubscribe}), free list empty"
            )
        pid = self._free.pop()
        self.ref[pid] = 1
        self.fresh_allocs += 1
        if self.quantized:
            self.scale_entries_in_use += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pid

    def _release_page(self, pid: int):
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self.gen[pid] += 1  # invalidate any prefix-registry entries
            self._free.append(pid)
            if self.quantized:
                self.scale_entries_in_use -= 1
        elif self.ref[pid] < 0:
            raise RuntimeError(f"double free of page {pid}")

    def alloc_slot(self, slot: int, prompt: np.ndarray, max_new_tokens: int) -> SlotAlloc:
        """Admit a prompt into ``slot``: match whole page-chunks of its prefix
        against the registry (share, +ref), allocate fresh pages for the rest
        of the prompt, register its own full chunks, and reserve its lifetime
        page budget.  Returns what prefill may skip writing."""
        if self._slot_pages.get(slot, 0):
            raise ValueError(f"slot {slot} still holds pages; free_slot first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        need = self.reserve_for(len(prompt), max_new_tokens)
        if self.pages_reserved + need > self.virtual_pages:
            raise RuntimeError(
                f"admission without capacity: need {need} pages but only "
                f"{self.virtual_pages - self.pages_reserved} of the virtual "
                f"capacity {self.virtual_pages} is unreserved "
                f"({self.pages_in_use}/{self.layout.num_pages} physical pages "
                f"in use, oversubscribe={self.oversubscribe})"
            )
        self._ensure_rows(slot)
        chunk = self.layout.chunk
        n_pages = self.layout.pages_for(len(prompt))
        full = len(prompt) // chunk  # whole chunks eligible for sharing
        shared = 0
        try:
            for c in range(full):
                key = _prefix_key(prompt, (c + 1) * chunk)
                hit = self._prefix.get(key)
                if hit is None:
                    break
                pid, stamp = hit
                if self.ref[pid] <= 0 or self.gen[pid] != stamp:
                    del self._prefix[key]  # stale: owner retired since
                    break
                self.block_table[slot, c] = pid
                self.ref[pid] += 1
                self.shared_hits += 1
                shared = c + 1
            for c in range(shared, n_pages):
                pid = self._take_page()
                self.block_table[slot, c] = pid
                if c < full:  # register this slot's own full chunks
                    self._prefix[_prefix_key(prompt, (c + 1) * chunk)] = (
                        pid, int(self.gen[pid]),
                    )
        except PoolExhausted:
            # atomic admission: a squeezed or oversubscribed pool may run dry
            # mid-prompt -- unwind every page this call took or shared so the
            # engine can preempt (or defer) and retry cleanly
            done = int(np.count_nonzero(self.block_table[slot, :n_pages] >= 0))
            for c in range(done - 1, -1, -1):
                self._release_page(int(self.block_table[slot, c]))
                self.block_table[slot, c] = self.FREE
            self.version += 1
            raise
        self._slot_pages[slot] = n_pages
        self._reserved[slot] = need
        self.version += 1
        return SlotAlloc(shared_pages=shared, shared_len=shared * chunk)

    def ensure_append(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """Make position ``pos`` writable for ``slot`` before a decode tick:
        allocate the next logical page on a chunk boundary, and copy-on-write
        when the target page is shared.  Returns an optional ``(src, dst)``
        physical page copy the engine must apply to the device pool."""
        lp = pos // self.layout.chunk
        if lp >= self.layout.max_pages:
            return None  # past virtual capacity: the write masks off anyway
        held = self._slot_pages.get(slot, 0)
        if lp >= held:
            if lp != held:
                raise ValueError(f"non-contiguous append: slot {slot} pos {pos}")
            self.block_table[slot, lp] = self._take_page()
            self._slot_pages[slot] = held + 1
            self.version += 1
            return None
        pid = int(self.block_table[slot, lp])
        if self.ref[pid] > 1:  # shared tail: private copy before writing
            dst = self._take_page()
            self.ref[pid] -= 1
            self.block_table[slot, lp] = dst
            self.cow_copies += 1
            self.version += 1
            return (pid, dst)
        return None

    def ensure_span(self, slot: int, start: int, count: int) -> List[Tuple[int, int]]:
        """Make positions ``start .. start + count - 1`` writable for ``slot``
        (speculative verify): walk the span's logical pages in order,
        allocating tail pages and copy-on-writing shared ones.  Returns every
        ``(src, dst)`` physical copy the engine must apply before the write."""
        copies: List[Tuple[int, int]] = []
        if count <= 0:
            return copies
        chunk = self.layout.chunk
        for lp in range(start // chunk, (start + count - 1) // chunk + 1):
            if lp >= self.layout.max_pages:
                break  # past virtual capacity: those writes mask off anyway
            cp = self.ensure_append(slot, max(start, lp * chunk))
            if cp is not None:
                copies.append(cp)
        return copies

    def rollback(self, slot: int, keep_len: int) -> int:
        """Free every page of ``slot`` beyond what ``keep_len`` committed
        positions need: rejected speculative tokens become page frees, not
        cache rewrites.  Stale K/V inside the kept tail page is harmless (the
        band never reads past ``pos``).  Speculative pages are never in the
        prefix registry, so no sharer maps what is freed here.  Rolling back a
        slot that holds no pages is a no-op counted in ``double_free_noops``.
        Returns the number of pages freed."""
        if slot not in self._slot_pages:
            self.double_free_noops += 1
            return 0
        held = self._slot_pages[slot]
        target = self.layout.pages_for(keep_len)
        freed = 0
        for lp in range(held - 1, target - 1, -1):
            self._release_page(int(self.block_table[slot, lp]))
            self.block_table[slot, lp] = self.FREE
            freed += 1
        if freed:
            self._slot_pages[slot] = target
            self.spec_rolled_back += freed
            self.version += 1
        return freed

    def free_slot(self, slot: int) -> List[int]:
        """Retire a slot: drop its references; pages survive while shared.
        Freeing an already-free slot is a no-op counted in
        ``double_free_noops``.  Returns the physical pages whose refcount hit
        zero (the engine scrubs them after a numeric error, and drops pending
        copy-on-write copies into them after a preemption)."""
        if slot not in self._slot_pages:
            self.double_free_noops += 1
            self._reserved.pop(slot, None)
            return []
        held = self._slot_pages.pop(slot)
        self._reserved.pop(slot, None)
        freed: List[int] = []
        for c in range(held):
            pid = int(self.block_table[slot, c])
            self._release_page(pid)
            if self.ref[pid] == 0:
                freed.append(pid)
        if held:
            self.block_table[slot, :held] = self.FREE
            self.version += 1
        return freed

    # -- fault injection (testing/chaos.py) ---------------------------------

    def seize_pages(self, k: int) -> List[int]:
        """Chaos hook: remove up to ``k`` pages from the free list, simulating
        an external squeeze (fragmentation, a co-tenant, a shrunken pool).
        Seized pages own no refs and no scale entries; ``restore_pages``
        returns them.  Returns the seized page ids."""
        taken: List[int] = []
        for _ in range(max(int(k), 0)):
            if not self._free:
                break
            taken.append(self._free.pop())
        self._seized.extend(taken)
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return taken

    def restore_pages(self, pids: List[int]) -> None:
        """Chaos hook: return previously seized pages to the free list."""
        for pid in pids:
            self._seized.remove(pid)
            self._free.append(pid)

    # -- invariants (engine.health()) ---------------------------------------

    def check_invariants(self) -> List[str]:
        """Cross-check every piece of allocator state; returns a list of
        violation descriptions (empty = healthy).  ``engine.health()`` runs
        this every ``ServeConfig.health_every`` ticks and raises on any."""
        lay = self.layout
        problems: List[str] = []
        free = list(self._free)
        if len(set(free)) != len(free):
            problems.append(f"free list has duplicates: {sorted(free)}")
        for pid in free:
            if not (0 <= pid < lay.num_pages):
                problems.append(f"free list page {pid} out of range")
            elif self.ref[pid] != 0:
                problems.append(f"free page {pid} has refcount {int(self.ref[pid])}")
        for pid in self._seized:
            if self.ref[pid] != 0:
                problems.append(f"seized page {pid} has refcount {int(self.ref[pid])}")
            if pid in free:
                problems.append(f"page {pid} both seized and free")
        # refcount per page == live block-table references over held rows
        counted = np.zeros((lay.num_pages,), np.int64)
        for slot, held in self._slot_pages.items():
            row = self.block_table[slot, :held]
            if np.any(row < 0):
                problems.append(f"slot {slot} holds {held} pages but row has FREE entries")
            for pid in row:
                if 0 <= int(pid) < lay.num_pages:
                    counted[int(pid)] += 1
            if np.any(self.block_table[slot, held:] != self.FREE):
                problems.append(f"slot {slot}: block-table entries past held={held}")
        for slot in range(len(self.block_table)):
            if slot not in self._slot_pages and np.any(self.block_table[slot] != self.FREE):
                problems.append(f"orphaned block-table row {slot} (slot holds no pages)")
        for pid in np.nonzero(counted != self.ref)[0][:8]:
            problems.append(
                f"page {int(pid)}: refcount {int(self.ref[pid])} != "
                f"{int(counted[pid])} block-table references"
            )
        if len(free) + self.pages_referenced + len(self._seized) != lay.num_pages:
            problems.append(
                f"page conservation: {len(free)} free + {self.pages_referenced} referenced "
                f"+ {len(self._seized)} seized != {lay.num_pages}"
            )
        if self.quantized and self.scale_entries_in_use != self.pages_referenced:
            problems.append(
                f"scale entries ({self.scale_entries_in_use}) out of lockstep "
                f"with referenced pages ({self.pages_referenced})"
            )
        if self.pages_reserved > self.virtual_pages:
            problems.append(
                f"reserved {self.pages_reserved} exceeds virtual capacity {self.virtual_pages}"
            )
        for slot in self._reserved:
            if slot not in self._slot_pages:
                problems.append(f"slot {slot} reserved but holds no pages")
        return problems

    # -- device view --------------------------------------------------------

    def device_table(self, num_slots: int) -> np.ndarray:
        """Block table padded/clipped to the engine's slot count.  FREE (-1)
        entries mean "unallocated"; the kernels skip them and the plain
        versions clamp them to page 0, whose contents the band hides."""
        self._ensure_rows(num_slots - 1)
        return np.array(self.block_table[:num_slots], np.int32)

    def stats(self) -> Dict[str, int]:
        return {
            "pages_in_use": self.pages_in_use,
            "peak_in_use": self.peak_in_use,
            "fresh_allocs": self.fresh_allocs,
            "shared_hits": self.shared_hits,
            "cow_copies": self.cow_copies,
            "spec_rolled_back_pages": self.spec_rolled_back,
            "quantized_pages": self.pages_in_use if self.quantized else 0,
            "scale_entries_in_use": self.scale_entries_in_use,
            "pages_reserved": self.pages_reserved,
            "virtual_pages": self.virtual_pages,
            "seized_pages": len(self._seized),
            "double_free_noops": self.double_free_noops,
        }
