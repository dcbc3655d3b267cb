"""Continuous-batching serving engine over the KV cache (``repro/serve/
engine.py`` in PyTorch).

The engine owns a fixed pool of ``num_slots`` cache rows -- dense, or a paged
pool with block tables, stored in the cache dtype or quantized to int8 / fp8
with scale tables -- allocated ONCE at construction on the device of
``ctx.device`` (the card by default).  Each ``step()`` is one tick:

  * **admission**: ``serve/scheduler.py`` assigns free slots to arrived
    requests (paged: the allocator books the request's pages first);
  * **prefill**, one-shot: same-tick admissions pack into shared bucket rows
    under a segment mask (``pack_prefill``), or each prompt is prefilled
    alone, right-padded to its bucket; the first token comes off the prefill
    logits.  **Continuous** (``prefill_chunk``): admitted slots are parked
    past capacity and their prompts stream in through ONE [num_slots, chunk]
    chunk launch per tick under ``tick_token_budget``; a slot samples its
    first token off its last chunk and decodes the same tick;
  * **decode**: ONE ``decode_step`` advances every decodable slot at its own
    depth (per-slot ``pos``).  With ``spec_k >= 2`` a tick where some slot
    has a granted prompt-lookup draft runs ONE [num_slots, spec_k] verify
    launch instead and commits the longest accepted prefix per slot (the
    paged pool rolls rejected pages back);
  * **retire**: EOS / max-token checks free the slot, and the per-slot NaN
    guard retires only a slot whose logits are not finite.

Under **oversubscription** (``oversubscribe > 1``, paged, continuous
prefill) admission books lifetimes against a virtual capacity, so the pool
may run dry mid-flight: the engine then preempts a victim (``select_victim``)
-- its pages free, its row parks, and it re-queues to recompute its context
(prompt + generated) through chunks -- and retries.  A ``chaos`` injector
(``testing/chaos.py``) squeezes the pool, poisons a slot's cache with NaN
and drops chunk grants through the same code paths, replayably.

SSM and hybrid archs (``cfg.ssm``) serve in **exact** mode, as in JAX: each
prompt is prefilled alone at its own length (the recurrent state has no pad
correction, so no buckets and no packing) straight into its slot's rows, the
per-slot conv window and SSD state included; the length must be a multiple
of the ring's n, and its n-th at most the SSD chunk or a multiple of it.
The paged pool, continuous prefill and speculative verify raise
``ValueError`` for them.

Frontend archs serve through one-shot bucketed prefill alone, as in JAX:
each prompt prefills alone (no packing) with the stub's side input, zero
``frames`` (whisper: the encoder runs once per admission and its
cross-attention K/V land in the slot's dense ``cross_k``/``cross_v`` rows)
or zero ``patches`` (pixtral: positions below ``num_patches`` embed to the
projection of zero).  Continuous prefill and speculative verify raise
``ValueError`` for both, the paged pool for whisper (its cross K/V have no
page structure); pixtral may use the paged pool, fp or quantized.  At
sp_size > 1 both raise ``NotImplementedError`` (ROADMAP A.9).

MLA archs (minicpm3-4b) serve every mode of the dense family, on one rank
and over the ring: the latent cache (one "head" of kv_lora_rank + rope) is
sharded over the ranks like any one-head cache, one-shot prefill runs the
expanded heads through the Mesh-Attention forward -- or, with
``ctx.mla_latent_wire``, the latent on its KV ring, which ``ring_bytes``
shows as ``recv_kv`` bytes of (kvr + rope) / (2·H·qk) of the expanded
run's (besides the segment ids both carry) -- and decode, chunks and
verifies absorb W^{kv_b} as on one rank.

With ``ctx.sp_size`` n > 1 the engine serves over a sequence-parallel ring
(a ``VirtualRing``: every rank on one device), as JAX's does over its mesh
axis: the cache is sharded over the ranks (``core/decode_attention.py``),
one-shot prefill runs the prompt in the §3.7 stripe order through the
Mesh-Attention forward (``dispatch.distributed_attention``), and decode,
chunks and verify launch once for every rank and combine the ranks' partials
by lse.  Buckets and ``max_seq`` are multiples of n.  SSM and hybrid archs
prefill through the sequence-sharded SSD scan (``models/ssm.py``: one scan
launch per layer for every rank, the conv halo and the states exchanged
over the ring) and decode on replicated states; hymba's attention half
prefills through the Mesh-Attention forward on the contiguous layout and
decodes over the sharded dense cache.

MoE archs serve every mode of the dense family, on one rank and over the
ring.  Expert capacity couples the tokens of a row (``models/moe.py``), so
the engine pads, packs, chunks and verifies exactly as JAX's does: each
entry point then drops the same tokens as its JAX twin, and one-shot and
chunked runs of one trace may part ways, as in JAX.  Over the ring an "ep"
arch's prefill rows and chunks (lengths that are multiples of n) dispatch
each rank's n-th of a row at its own capacity through the ``moe_dispatch``
/ ``moe_return`` all-to-alls, as JAX's segmented expert parallelism does;
decode rows and verify windows take the global path.  ``tick_stats()``
carries the ring's bytes per comm kind (``ring_bytes``).

PyTorch runs eagerly, so there are no traces to count; the cache is updated
in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.tiling import stripe_permutation
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.parallel.context import ParallelCtx
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.kv_pool import PageAllocator, PagedLayout, PoolExhausted
from repro_torch.serve.scheduler import Request, RequestResult, Scheduler, default_buckets
from repro_torch.serve.speculative import propose_ngram

__all__ = ["ServeEngine", "select_victim"]


def select_victim(slots, allocator, protect=()):
    """Preemption policy: the slot to evict when the page pool runs dry
    mid-flight.  Victims rank (1) slots whose pages nobody else maps first --
    evicting a prefix DONOR strands nothing (refcounts keep shared pages for
    the sharers) but frees fewer pages, so donors go last; (2) youngest
    admission first (latest ``admit_tick``, then highest rid): the oldest
    request always makes progress, which bounds recompute work and
    guarantees drain.  ``protect`` slots (the one being grown) are exempt.
    Returns the slot index, or None when nothing is evictable."""
    cands = []
    for slot, req in enumerate(slots):
        if req is None or slot in protect:
            continue
        if allocator.slot_pages(slot) == 0:
            continue  # nothing to reclaim
        cands.append((
            allocator.slot_shares_pages(slot),  # donors last
            -(req.admit_tick if req.admit_tick is not None else -1),
            -req.rid,
            slot,
        ))
    if not cands:
        return None
    return min(cands)[3]

# mid-prefill slots park their cache position past any capacity: the shared
# decode step still ticks their row, but every write guard (pos < n*m) drops
# the append, so a half-ingested prompt cannot be corrupted by decode
_PARKED = 2**30


class ServeEngine:
    """Slot-based continuous-batching engine: ``submit()`` requests,
    ``step()`` ticks, ``run()`` drains; ``generate(prompts, n)`` is the
    static-batch wrapper (greedy, exactly n tokens per row)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        ctx: Optional[ParallelCtx] = None,
        *,
        serve: Optional[ServeConfig] = None,
        chaos=None,
    ):
        tfm.check_supported(cfg)
        serve = serve or ServeConfig()
        self.serve = serve
        self.cfg = cfg
        self.ctx = ctx or ParallelCtx()
        n = self.ctx.sp_size
        tfm.check_ring_supported(cfg, self.ctx, "serving")
        if serve.max_seq % n:
            raise ValueError(f"max_seq={serve.max_seq} must be divisible by sp_size={n}")
        if serve.decode_kernel != "auto":
            # "band" is the dense spelling of the non-native path
            kernel = "gather" if serve.decode_kernel == "band" else serve.decode_kernel
            self.ctx = dataclasses.replace(self.ctx, decode_kernel=kernel)
        self.device = resolve_device(self.ctx.device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(
                f"params live on {embed.device} but the engine runs on {self.device}"
            )
        if embed.dtype != serve.cache_dtype:
            raise ValueError(
                f"cache_dtype {serve.cache_dtype} must match the params' dtype {embed.dtype} "
                "(the attention kernels take one input type)"
            )
        self.params = params
        self.max_seq = serve.max_seq
        self.num_slots = serve.num_slots
        self.eos_id = serve.eos_id
        self.pack_plan = serve.pack_plan
        # continuous prefill (None = one-shot bucketed prefill)
        self.prefill_chunk = serve.prefill_chunk
        side_inputs = cfg.ssm is not None or cfg.encoder_layers or cfg.frontend is not None
        if self.prefill_chunk is not None and side_inputs:
            raise ValueError(
                "continuous prefill serves attention-only decoder archs "
                "(SSM state / encoder / frontend inputs have no chunk-append)"
            )
        # speculative decode: verify spec_k tokens per slot per tick through
        # the chunk path; greedy accept/reject keeps the tokens of plain decode
        self.spec_k = serve.spec_k
        self.spec_max_misses = serve.spec_max_misses
        self._spec_on = serve.spec_k >= 2 and serve.spec_draft != "off"
        if self._spec_on and side_inputs:
            raise ValueError(
                "speculative decode rides the chunk-attention verify path: "
                "attention-only decoder archs (no SSM / encoder / frontend)"
            )
        self.paged = serve.paged
        # quantized pool: int8/fp8 pages + per-(token, kv-head) scale tables
        self._quantized = serve.kv_dtype != "fp"
        self.dequant_fallbacks = 0  # quantized ticks served by the gather path
        self.allocator: Optional[PageAllocator] = None
        if serve.paged:
            if cfg.ssm is not None or cfg.encoder_layers:
                raise ValueError(
                    "the paged KV cache serves attention-only decoder archs "
                    "(SSM state / encoder cross-K/V have no page structure)"
                )
            layout = PagedLayout.for_engine(
                serve.max_seq, n, serve.num_slots,
                page_size=serve.page_size, num_pages=serve.num_pages,
            )
            self.allocator = PageAllocator(
                layout, quantized=self._quantized, oversubscribe=serve.oversubscribe,
            )
        self._native_decode = (
            dispatch._resolve_decode_kernel(self.ctx.decode_kernel, paged=serve.paged) == "native"
        )
        buckets = (
            tuple(serve.prefill_buckets)
            if serve.prefill_buckets
            else default_buckets(serve.max_seq, n)
        )
        # SSD's recurrent state has no pad-correction: prefill exactly
        exact = cfg.ssm is not None
        if any(b % n for b in buckets) and not exact:
            raise ValueError(f"buckets {buckets} must be multiples of sp_size={n}")
        self.scheduler = Scheduler(
            self.num_slots, buckets, self.max_seq, exact=exact, multiple=n,
            chunk=cfg.ssm.chunk if exact else None, allocator=self.allocator,
            prefill_chunk=serve.prefill_chunk, tick_token_budget=serve.tick_token_budget,
        )
        self.pack_max = max(1, serve.pack_max)
        # packed prefill: attention-only decoder archs (the SSD state and
        # the frontend / encoder side inputs do not pack)
        self._can_pack = serve.pack_prefill and not side_inputs
        # THE cache: allocated once, updated in place for the engine's lifetime
        self._cache = tfm.init_cache(
            cfg, self.num_slots, self.max_seq, dtype=serve.cache_dtype, ctx=self.ctx,
            paged=self.allocator.layout if self.allocator else None, kv_dtype=serve.kv_dtype,
        )
        self._cur = np.zeros((self.num_slots, 1), np.int32)  # last token per slot
        self._depth = np.zeros((self.num_slots,), np.int64)  # host view of pos
        # per-slot consecutive missed verify ticks (negative: cooldown left)
        self._spec_misses = np.zeros((self.num_slots,), np.int64)
        self._shared_len = np.zeros((self.num_slots,), np.int64)  # paged prefix
        self._bt_version = -1  # device block table staleness marker
        self.bt_uploads = 0  # version-gated block-table uploads
        self._tick = 0
        self._finished: Dict[int, RequestResult] = {}
        # launch accounting: the pack planner's padded-prefill cost is
        # launches x bucket tokens; chunk launches count their device tokens
        # (pad rows included)
        self.prefill_launches = 0
        self.prefill_launch_tokens = 0
        self.chunk_launches = 0
        self.chunk_launch_tokens = 0
        self.decode_launches = 0  # plain one-token decode launches
        self.verify_launches = 0
        self.verify_tokens = 0  # tokens committed by verify launches
        self.spec_proposed = 0
        self.spec_accepted = 0
        # per-tick series: prompt tokens ingested vs tokens generated, and the
        # host wall time of each tick's prefill and decode phases (each phase
        # ends by reading its tokens back, so the clock covers the device work)
        self.tick_prefill_tokens: List[int] = []
        self.tick_decode_tokens: List[int] = []
        self.tick_prefill_s: List[float] = []
        self.tick_decode_s: List[float] = []
        # debug logit capture (set before the first tick): every generated
        # token's full logits row per rid
        self.capture_logits = False
        self.debug_logits: Dict[int, List[np.ndarray]] = {}
        self.nan_guard = serve.nan_guard
        self.health_every = serve.health_every
        self.chaos = chaos  # testing/chaos.py injector (None in production)
        self.preemptions = 0  # mid-flight evictions (pool pressure)
        self.recompute_tokens = 0  # tokens re-ingested for preempted requests
        self.chaos_dropped_grants = 0
        self.cancelled = 0
        self.deadline_expired = 0
        self.numeric_errors = 0
        self.rejected_requests = 0
        self.health_sweeps = 0

    # -- device helpers -----------------------------------------------------

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    def _stripe(self, bucket: int) -> np.ndarray:
        """The §3.7 order of a bucket row (the data pipeline's permutation):
        index j carries true position perm[j].  Identity on one rank and for
        contiguous-layout archs."""
        n = self.ctx.sp_size
        if n > 1 and self.cfg.causal_layout == "striped":
            return np.asarray(stripe_permutation(bucket, n))
        return np.arange(bucket)

    def _aux_inputs(self, batch_size: int) -> Dict:
        """Frontend stub inputs (audio frames / vision patches): zeros, as
        JAX's engine feeds them."""
        cfg, extra = self.cfg, {}
        if cfg.frontend == "audio_stub":
            extra["frames"] = torch.zeros((batch_size, cfg.encoder_seq, cfg.frontend_dim),
                                          dtype=torch.float32, device=self.device)
        if cfg.frontend == "vision_stub":
            extra["patches"] = torch.zeros((batch_size, cfg.num_patches, cfg.frontend_dim),
                                           dtype=torch.float32, device=self.device)
        return extra

    def _sync_block_table(self):
        """Upload the allocator's block table when it moved since last sync."""
        if self.allocator is None or self.allocator.version == self._bt_version:
            return
        self._cache["bt"] = self._to_device(self.allocator.device_table(self.num_slots))
        self._bt_version = self.allocator.version
        self.bt_uploads += 1

    # -- streaming API ------------------------------------------------------

    def submit(
        self, prompt: np.ndarray, max_new_tokens: int = 16, arrival_tick: int = 0,
        *, deadline_ticks: Optional[int] = None, priority: int = 0,
    ) -> int:
        """Queue one request; returns its rid.  ``arrival_tick`` defers
        admission until the engine clock reaches it (trace replay)."""
        req = self.scheduler.submit(
            prompt, max_new_tokens, arrival_tick,
            deadline_ticks=deadline_ticks, priority=priority,
        )
        return req.rid

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def _finish(self, slot: int, status: str = "ok") -> RequestResult:
        req = self.scheduler.retire(slot, self._tick, status=status)
        freed: List[int] = []
        if self.allocator is not None:
            freed = self.allocator.free_slot(slot)
        if status == "numeric_error":
            self._scrub_numeric(slot, freed)
        result = RequestResult.from_request(req)
        self._finished[req.rid] = result
        return result

    def _scrub_numeric(self, slot: int, freed: List[int]) -> None:
        """Zero a numeric_error slot's K/V before the data can be re-read:
        a masked-out key's score is replaced, but its NaN value would still
        meet a zero weight in P·V, and 0 * NaN is NaN.  Shared pages (still
        referenced) hold live prefix data and are left alone."""
        keys = [key for key in ("k", "v", "k_scale", "v_scale") if key in self._cache]
        if self.allocator is not None:
            if not freed:
                return
            idx = torch.as_tensor(freed, dtype=torch.int64, device=self.device)
            for key in keys:
                self._cache[key][:, idx] = 0
        else:
            for key in keys:
                self._cache[key][:, slot] = 0

    def _finish_queued(self, req: Request) -> RequestResult:
        """Terminal path for a request that holds no slot (cancelled,
        expired or rejected while queued); a preempted request may still
        carry generated tokens, which ride along on the result."""
        req.finish_tick = self._tick
        result = RequestResult.from_request(req)
        self._finished[req.rid] = result
        return result

    def cancel(self, rid: int) -> Optional[RequestResult]:
        """Cancel a live request (queued or mid-flight); frees its slot and
        pages at once, partial tokens kept (status ``"cancelled"``).  None if
        the rid is not in flight."""
        req = self.scheduler.cancel_queued(rid)
        if req is not None:
            self.cancelled += 1
            return self._finish_queued(req)
        req = self.scheduler.find(rid)
        if req is None or req.slot is None:
            return None
        self.cancelled += 1
        return self._finish(req.slot, status="cancelled")

    # -- robustness: preemption, fault injection --------------------------

    def _do_preempt(self, slot: int) -> List[int]:
        """Evict ``slot`` back to the queue under pool pressure: free its
        pages (refcounts keep prefix sharers' pages alive), reset its ingest
        cursor so admission recomputes prompt + generated through continuous
        prefill, and park its row.  Returns the physical pages whose refcount
        hit zero (the caller drops pending copy-on-write copies into them)."""
        freed = self.allocator.free_slot(slot)
        req = self.scheduler.preempt(slot)
        req.preemptions += 1
        req.recompute_tokens += req.context_len
        self.preemptions += 1
        self.recompute_tokens += req.context_len
        self._shared_len[slot] = 0
        # the row's block-table entries are FREE already; parking also drops
        # the position-guarded writes, as for a mid-prefill row
        self._cache["pos"][slot] = _PARKED
        return freed

    def _preempt_for(self, protect) -> Optional[List[int]]:
        """Pick and evict one victim; None when nothing is evictable (the
        caller re-raises the pool exhaustion)."""
        if self.prefill_chunk is None:
            return None  # recompute rides continuous prefill only
        victim = select_victim(self.scheduler.slots, self.allocator, protect)
        if victim is None:
            return None
        return self._do_preempt(victim)

    def _ensure_append_robust(self, slot: int, pos: int, copies) -> None:
        """``ensure_append`` with preempt-and-retry: on pool exhaustion evict
        victims until the append fits (or nothing is left to evict).  Pending
        copy-on-write copies whose destination a preemption freed are
        dropped: the requester is gone, and the page may be reissued within
        this same phase."""
        while True:
            try:
                cp = self.allocator.ensure_append(slot, pos)
                if cp is not None:
                    copies.append(cp)
                return
            except PoolExhausted:
                freed = self._preempt_for(protect={slot})
                if freed is None:
                    raise
                drop = set(freed)
                copies[:] = [(s, d) for (s, d) in copies if d not in drop]

    def _ensure_span_robust(self, slot: int, start: int, count: int, copies) -> None:
        """``ensure_span`` with preempt-and-retry (speculative verify)."""
        chunk = self.allocator.layout.chunk
        if count <= 0:
            return
        for lp in range(start // chunk, (start + count - 1) // chunk + 1):
            if lp >= self.allocator.layout.max_pages:
                break
            self._ensure_append_robust(slot, max(start, lp * chunk), copies)

    def poison_slot_cache(self, slot: int) -> None:
        """Fault injection (testing/chaos.py): overwrite ``slot``'s first
        resident K position with NaN in every layer, so its next attention
        pass gives non-finite logits and the NaN guard must retire it.  A
        quantized pool poisons the fp32 scale table (int8 codes hold no
        NaN)."""
        key = "k_scale" if "k_scale" in self._cache else "k"
        if self.allocator is not None:
            if self.allocator.slot_pages(slot) == 0:
                return
            pid = int(self.allocator.block_table[slot, 0])
            self._cache[key][:, pid, 0] = float("nan")  # [L, num_pages, n*ps, ...]
        else:
            self._cache[key][:, slot, 0] = float("nan")  # [L, B, cap, ...]

    def health(self) -> Dict[str, object]:
        """Invariant sweep (allocator refcounts / free list + slot
        cross-checks); raises on any violation, else returns a summary."""
        self.health_sweeps += 1
        problems: List[str] = []
        if self.allocator is not None:
            problems += self.allocator.check_invariants()
            for slot in self.allocator._slot_pages:
                if not (0 <= slot < self.num_slots):
                    problems.append(f"allocator holds pages for bad slot {slot}")
                elif self.scheduler.slots[slot] is None:
                    problems.append(
                        f"orphaned slot {slot}: holds "
                        f"{self.allocator.slot_pages(slot)} pages but no request"
                    )
            for slot, req in enumerate(self.scheduler.slots):
                if req is not None and self.allocator.slot_pages(slot) == 0:
                    problems.append(f"slot {slot} (rid {req.rid}) active without pages")
        if problems:
            raise RuntimeError(
                "engine.health() invariant sweep failed:\n  " + "\n  ".join(problems)
            )
        out = {
            "ok": True,
            "tick": self._tick,
            "active_slots": len(self.scheduler.active_slots()),
            "queued": self.scheduler.pending,
        }
        if self.allocator is not None:
            out.update(
                pages_in_use=self.allocator.pages_in_use,
                pages_reserved=self.allocator.pages_reserved,
                scale_entries_in_use=self.allocator.scale_entries_in_use,
            )
        return out

    def _req_done(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        return len(req.generated) >= req.max_new_tokens

    def _alloc_pages(self, slot: int, req: Request) -> int:
        """Paged admission: claim (or prefix-share) the slot's pages; returns
        the shared-prefix length the prefill scatter must skip.  A resumed
        (preempted) request allocates for its CONTEXT -- prompt + generated
        -- and only its remaining token budget."""
        return self.allocator.alloc_slot(slot, req.context, req.remaining_new_tokens).shared_len

    def _alloc_pages_robust(self, slot: int, req: Request) -> int:
        """Admission alloc with preempt-and-retry: under oversubscription the
        admission check only guaranteed the prompt pages + margin, so a burst
        of same-tick admissions (or a chaos squeeze) can still find the free
        list short.  ``alloc_slot`` unwinds atomically on failure, so each
        retry starts clean."""
        while True:
            try:
                return self._alloc_pages(slot, req)
            except PoolExhausted:
                if self._preempt_for(protect={slot}) is None:
                    raise

    def _resident_shared_len(self, slot: int, shared: int) -> int:
        """Shared-prefix tokens whose CONTENT is already resident.  Continuous
        prefill may admit a sharer while its prefix donor is still mid-chunk:
        the shared pages are booked but not yet written.  Cap the credit at
        every mid-prefill donor's written watermark (page-aligned); the sharer
        rewrites the rest of the prefix itself -- the same values into the
        same pages."""
        lay = self.allocator.layout
        mine = {int(p) for p in self.allocator.block_table[slot, : lay.pages_for(shared)]}
        for s2, r2 in enumerate(self.scheduler.slots):
            if s2 == slot or r2 is None or r2.prefill_pos >= r2.ingest_len:
                continue
            if self.allocator.slot_pages(s2) == 0:
                continue  # admitted this tick, pages not allocated yet
            theirs = self.allocator.block_table[s2, : lay.pages_for(r2.ingest_len)]
            if mine & {int(p) for p in theirs}:
                shared = min(shared, (r2.prefill_pos // lay.chunk) * lay.chunk)
        return shared

    def _prefill_single(self, slot: int, req: Request) -> int:
        """One request alone in a bucket-padded row; returns its first token."""
        plen = len(req.prompt)
        bucket = self.scheduler.bucket_for(plen)
        self.prefill_launches += 1
        self.prefill_launch_tokens += bucket
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        perm = self._stripe(bucket)
        batch = {
            "tokens": self._to_device(toks[:, perm]),
            "positions": self._to_device(perm.astype(np.int32)),
            "length": torch.tensor([plen]),
            **self._aux_inputs(1),
        }
        if self.paged:
            batch["slot"] = slot
            batch["shared_len"] = self._alloc_pages(slot, req)
            self._sync_block_table()
            logits, self._cache = tfm.prefill(self.params, self.cfg, self.ctx, batch, self._cache)
        else:
            # prefill straight into the slot's rows: views of every cache
            # leaf (K/V, the encoder's cross K/V, the SSM conv window and state)
            row = {
                key: self._cache[key][:, slot : slot + 1]
                for key in ("k", "v", "cross_k", "cross_v") if key in self._cache
            }
            if "ssm" in self._cache:
                row["ssm"] = {key: val[:, slot : slot + 1]
                              for key, val in self._cache["ssm"].items()}
            row["pos"] = torch.zeros((1,), dtype=torch.int32, device=self.device)
            logits, _ = tfm.prefill(self.params, self.cfg, self.ctx, batch, row)
            self._cache["pos"][slot] = plen
        if self.capture_logits:
            self.debug_logits.setdefault(req.rid, []).append(logits[0, 0].float().cpu().numpy())
        self._depth[slot] = plen
        return int(torch.argmax(logits[0, 0]))

    def _prefill_group(self, group) -> List[int]:
        """Packed prefill: the group's prompts concatenate into one bucket
        row under a segment mask; each document's K/V lands in its own slot.
        Returns the first generated token per request."""
        lens = [len(req.prompt) for _, req in group]
        bucket = self.scheduler.bucket_for(sum(lens))
        self.prefill_launches += 1
        self.prefill_launch_tokens += bucket
        k = len(group)
        toks = np.zeros((1, bucket), np.int32)
        off = 0
        for (_, req), ln in zip(group, lens):
            toks[0, off : off + ln] = req.prompt
            off += ln
        shared = [self._alloc_pages(slot, req) if self.paged else 0 for slot, req in group]
        self._sync_block_table()
        # segment id and per-document position of every row index; pads get
        # id k, which matches no document
        j = np.arange(bucket)
        cum = np.cumsum(lens)
        starts = np.concatenate([[0], cum[:-1]])
        seg = np.sum(j[:, None] >= starts[None, :], axis=1) - 1
        seg = np.where(j >= cum[-1], k, seg)
        positions = j - starts[np.clip(seg, 0, k - 1)]
        perm = self._stripe(bucket)
        batch = {
            "tokens": self._to_device(toks[:, perm]),
            "positions": self._to_device(positions[perm].astype(np.int32)),
            "segments": self._to_device(seg[perm].astype(np.int32)),
            "doc_lens": self._to_device(np.asarray(lens, np.int64)),
            "slots": self._to_device(np.asarray([slot for slot, _ in group], np.int64)),
        }
        if self.paged:
            batch["shared_lens"] = self._to_device(np.asarray(shared, np.int64))
        logits, self._cache = tfm.prefill_packed(
            self.params, self.cfg, self.ctx, batch, self._cache
        )
        if self.capture_logits:
            rows = logits.float().cpu().numpy()
            for d, (_, req) in enumerate(group):
                self.debug_logits.setdefault(req.rid, []).append(rows[d])
        for (slot, _), ln in zip(group, lens):
            self._depth[slot] = ln
        return [int(t) for t in torch.argmax(logits, dim=-1).cpu()]

    def _record_first_token(self, slot: int, req: Request, tok: int, finished) -> None:
        req.generated.append(tok)
        req.token_ticks.append(self._tick)
        if req.first_token_tick is None:
            req.first_token_tick = self._tick
        self._cur[slot, 0] = tok
        if self._req_done(req, tok):
            finished.append(self._finish(slot))

    def _run_chunks(self, plan, finished):
        """Launch this tick's chunk plan as ONE [num_slots, C] call; rows
        without work carry lens=0 (nothing written).  Rows whose LAST chunk
        this is get their position un-parked to the prompt length and sample
        their first token off the returned logits, the same tick a one-shot
        prefill would.  Returns (prompt tokens ingested, first tokens)."""
        C, B = self.prefill_chunk, self.num_slots
        tokens = np.zeros((B, C), np.int32)
        starts = np.zeros((B,), np.int64)
        lens = np.zeros((B,), np.int64)
        wstarts = np.zeros((B,), np.int64)
        pos_set = np.full((B,), -1, np.int32)
        finishing = []
        total = 0
        for slot, req, start, take in plan:
            # the context: prompt + generated (a resumed request recomputes)
            tokens[slot, :take] = req.context[start : start + take]
            starts[slot] = start
            lens[slot] = take
            wstarts[slot] = self._shared_len[slot]  # skip the resident shared prefix
            if req.first_chunk_tick is None:
                req.first_chunk_tick = self._tick
            req.prefill_pos = start + take
            req.chunks += 1
            total += take
            if req.prefill_pos >= req.ingest_len:
                pos_set[slot] = req.ingest_len
                finishing.append((slot, req))
        self.chunk_launches += 1
        self.chunk_launch_tokens += B * C  # device tokens (pad rows included)
        self._sync_block_table()  # paged: admission allocated this plan's pages
        batch = {
            "tokens": self._to_device(tokens), "starts": self._to_device(starts),
            "lens": self._to_device(lens), "write_starts": self._to_device(wstarts),
            "pos_set": self._to_device(pos_set),
        }
        logits, self._cache = tfm.prefill_chunk(self.params, self.cfg, self.ctx, batch,
                                                self._cache)
        # first token and finiteness bit per row, read back together
        first_ok = torch.stack(
            [torch.argmax(logits, dim=-1), torch.isfinite(logits).all(dim=1).to(torch.int64)],
            dim=1,
        ).cpu().numpy()
        logits_np = logits.float().cpu().numpy() if self.capture_logits else None
        n_first = 0
        for slot, req in finishing:
            if self.nan_guard and not bool(first_ok[slot, 1]):
                self.numeric_errors += 1
                finished.append(self._finish(slot, status="numeric_error"))
                continue
            self._depth[slot] = req.ingest_len
            if logits_np is not None:
                self.debug_logits.setdefault(req.rid, []).append(logits_np[slot])
            self._record_first_token(slot, req, int(first_ok[slot, 0]), finished)
            n_first += 1
        return total, n_first

    def _apply_copies(self, copies) -> None:
        """Copy-on-write: physical page src -> dst in every layer's pool; a
        quantized pool's scale tables move in lockstep (a copied page with
        stale scales would dequantize garbage)."""
        if not copies:
            return
        src = torch.as_tensor([s for s, _ in copies], dtype=torch.int64, device=self.device)
        dst = torch.as_tensor([d for _, d in copies], dtype=torch.int64, device=self.device)
        for key in ("k", "v", "k_scale", "v_scale"):
            if key in self._cache:
                pool = self._cache[key]  # [L, num_pages, page_size, Hkv(, D)]
                pool[:, dst] = pool[:, src]

    def _vanilla_decode_tick(self, decodable, finished) -> int:
        """One decode launch over every decodable slot; returns tokens
        generated this tick."""
        if self.paged:
            # make every decodable slot's write position appendable:
            # allocate tail pages on page boundaries, CoW shared tails.  Under
            # oversubscription (or a chaos squeeze) the pool may run dry:
            # preempt victims and retry; a preempted slot leaves this tick
            copies = []
            for slot in decodable:
                if self.scheduler.slots[slot] is None:
                    continue  # preempted by an earlier slot's append
                self._ensure_append_robust(slot, int(self._depth[slot]), copies)
            decodable = [s for s in decodable if self.scheduler.slots[s] is not None]
            self._apply_copies(copies)
            self._sync_block_table()
            if not decodable:
                return 0
        if self._quantized and not self._native_decode:
            self.dequant_fallbacks += 1  # gather-path dequant served this tick
        self.decode_launches += 1
        nxt, self._cache, logits = tfm.decode_step(
            self.params, self._cache, self._to_device(self._cur), self.cfg, self.ctx
        )
        ok = torch.isfinite(logits).all(dim=2).all(dim=1)
        nxt_np = nxt.cpu().numpy()
        ok_np = ok.cpu().numpy()
        logits_np = logits.float().cpu().numpy() if self.capture_logits else None
        tokens = 0
        for slot in decodable:
            req = self.scheduler.slots[slot]
            if self.nan_guard and not bool(ok_np[slot]):
                # non-finite logits: retire ONLY this slot; every other row
                # came off the same launch unaffected (rows are independent)
                self.numeric_errors += 1
                finished.append(self._finish(slot, status="numeric_error"))
                continue
            self._depth[slot] += 1
            tok = int(nxt_np[slot, 0])
            if logits_np is not None:
                self.debug_logits.setdefault(req.rid, []).append(logits_np[slot, 0])
            req.generated.append(tok)
            req.token_ticks.append(self._tick)
            tokens += 1
            self._cur[slot, 0] = tok
            if self._req_done(req, tok):
                finished.append(self._finish(slot))
        return tokens

    def _spec_drafts(self, decodable) -> Dict[int, List[int]]:
        """Prompt-lookup drafts of the decodable slots whose drafting is on.
        After ``spec_max_misses`` consecutive missed verify ticks a slot is
        suspended until the next global probe tick (every ``16 *
        spec_max_misses`` ticks, so suspended slots probe in one shared
        launch); the counter counts the cooldown down as a negative number."""
        drafts = {}
        for slot in decodable:
            if self.spec_max_misses is not None:
                m = self._spec_misses[slot]
                period = 16 * self.spec_max_misses
                if m >= self.spec_max_misses:
                    self._spec_misses[slot] = -(period - self._tick % period)
                    continue
                if m < 0:
                    # the cooldown ends at max_misses - 1: one missed probe
                    # re-trips, a fully accepted probe re-enables drafting
                    self._spec_misses[slot] = self.spec_max_misses - 1 if m == -1 else m + 1
                    continue
            req = self.scheduler.slots[slot]
            # the furthest write stays inside the slot's reserved capacity
            k_cap = min(self.spec_k, req.max_new_tokens - len(req.generated))
            if k_cap < 2:
                continue
            d = propose_ngram(req.prompt, req.generated, k_cap - 1)
            if d:
                drafts[slot] = d
        return drafts

    def _spec_decode_tick(self, decodable, finished, prefill_tokens) -> int:
        """Speculative tick: verify every decodable row's current token plus
        its granted draft in ONE [num_slots, spec_k] chunk launch and commit
        the longest accepted prefix.  The token stream is that of plain
        greedy decode; only the commit count per tick changes.  Falls back to
        the plain decode launch when no slot has a granted draft.  Returns
        tokens generated this tick."""
        drafts = self._spec_drafts(decodable)
        # drafts spend only the budget left after decode rows and chunks
        granted = self.scheduler.plan_spec(drafts, len(decodable), prefill_tokens)
        granted = {s: d for s, d in granted.items() if d}
        if not granted:
            return self._vanilla_decode_tick(decodable, finished)
        K, B = self.spec_k, self.num_slots
        tokens = np.zeros((B, K), np.int32)
        starts = np.zeros((B,), np.int64)
        lens = np.zeros((B,), np.int64)
        for slot in decodable:
            d = granted.get(slot, [])
            tokens[slot, 0] = self._cur[slot, 0]
            tokens[slot, 1 : 1 + len(d)] = d
            starts[slot] = self._depth[slot]
            lens[slot] = 1 + len(d)
        if self.paged:
            copies = []
            for slot in decodable:
                if self.scheduler.slots[slot] is None:
                    continue  # preempted by an earlier slot's span
                self._ensure_span_robust(slot, int(self._depth[slot]), int(lens[slot]), copies)
            live = [s for s in decodable if self.scheduler.slots[s] is not None]
            for s in set(decodable) - set(live):
                lens[s] = 0  # a preempted row writes and commits nothing
            decodable = live
            self._apply_copies(copies)
            self._sync_block_table()
            if not decodable:
                return 0
        for slot in decodable:
            d = granted.get(slot, [])
            self.scheduler.slots[slot].spec_proposed += len(d)
            self.spec_proposed += len(d)
        self.verify_launches += 1
        if self._quantized and not self._native_decode:
            self.dequant_fallbacks += 1  # gather-path dequant served this tick
        starts_d, lens_d = self._to_device(starts), self._to_device(lens)
        batch = {"tokens": self._to_device(tokens), "starts": starts_d, "lens": lens_d,
                 # verify appends everything it scores
                 "write_starts": starts_d}
        y, commit, self._cache, logits = tfm.verify_step(
            self.params, self.cfg, self.ctx, batch, self._cache, return_logits=True,
        )
        # finiteness over each row's valid positions only: pad positions
        # (c >= lens) attend stale data and are never committed
        valid = torch.arange(K, device=logits.device)[None, :] < lens_d[:, None]
        ok = (torch.isfinite(logits).all(dim=2) | ~valid).all(dim=1)
        # one read-back per tick: y, commit and the finiteness bit together
        host = torch.cat([y, commit[:, None], ok[:, None].to(torch.int32)], dim=1).cpu().numpy()
        y_np, commit_np, ok_np = host[:, :K], host[:, K], host[:, K + 1]
        logits_np = logits.float().cpu().numpy() if self.capture_logits else None
        generated = 0
        for slot in decodable:
            req = self.scheduler.slots[slot]
            if self.nan_guard and not bool(ok_np[slot]):
                # non-finite verify logits: commit nothing, retire this slot
                self.numeric_errors += 1
                finished.append(self._finish(slot, status="numeric_error"))
                continue
            committed = int(commit_np[slot])
            drafted = int(lens[slot]) - 1
            if drafted:
                accepted = committed - 1
                req.spec_accepted += accepted
                self.spec_accepted += accepted
                # a miss is any verify tick with a rejection
                self._spec_misses[slot] = 0 if accepted == drafted else self._spec_misses[slot] + 1
            self._depth[slot] += committed
            done = False
            for i in range(committed):
                tok = int(y_np[slot, i])
                if logits_np is not None:
                    self.debug_logits.setdefault(req.rid, []).append(logits_np[slot, i])
                req.generated.append(tok)
                req.token_ticks.append(self._tick)  # same tick: all one launch
                generated += 1
                self._cur[slot, 0] = tok
                if self._req_done(req, tok):
                    # EOS (or the cap) mid-commit: later accepted tokens are
                    # dropped; their writes sit past the final depth
                    self._depth[slot] -= committed - (i + 1)
                    done = True
                    finished.append(self._finish(slot))
                    break
            if not done and self.paged and drafted:
                # free pages written past the accepted prefix; every launch
                # re-syncs the block table before it runs
                self.allocator.rollback(slot, int(self._depth[slot]))
        self.verify_tokens += generated
        return generated

    def _decodable(self) -> List[int]:
        return [
            s for s in self.scheduler.active_slots()
            if self.scheduler.slots[s].prefill_pos >= self.scheduler.slots[s].ingest_len
        ]

    def _ingest_chunked(self, assigned, finished) -> Tuple[int, int]:
        """Continuous prefill: allocate and park this tick's admissions, then
        launch the budgeted chunk plan.  Returns (prompt tokens ingested,
        first tokens sampled)."""
        for slot, req in assigned:
            shared = 0
            if self.paged:
                try:
                    shared = self._alloc_pages_robust(slot, req)
                except PoolExhausted:
                    # nothing evictable (a fresh squeeze, a lone giant): hand
                    # the slot back and retry on a later tick
                    self.scheduler.preempt(slot)
                    continue
            if shared:
                shared = self._resident_shared_len(slot, shared)
            self._shared_len[slot] = shared
            # fully shared chunks never launch, but the LAST context token
            # always runs forward: its logits give the first token
            req.prefill_pos = min(shared, req.ingest_len - 1)
        if assigned:
            idx = torch.as_tensor([slot for slot, _ in assigned], device=self.device)
            self._cache["pos"][idx] = _PARKED
        plan = self.scheduler.plan_chunks(len(self._decodable()))
        if plan and self.chaos is not None and self.chaos.drop_grants(self._tick):
            # injected scheduler fault: this tick's chunk grants vanish and
            # progress resumes next tick (a dropped plan only delays)
            self.chaos_dropped_grants += len(plan)
            plan = []
        if not plan:
            return 0, 0
        return self._run_chunks(plan, finished)

    def _ingest_one_shot(self, assigned, finished) -> Tuple[int, int]:
        """One-shot prefill of this tick's admissions (packed or alone)."""
        if self._can_pack:
            groups = self.scheduler.pack_groups(
                assigned, pack_max=self.pack_max, plan=self.pack_plan
            )
        else:
            groups = [[x] for x in assigned]
        prompt_tokens = firsts_n = 0
        for group in groups:
            if self._can_pack:
                firsts = self._prefill_group(group)
            else:
                firsts = [self._prefill_single(slot, req) for slot, req in group]
            for tok, (slot, req) in zip(firsts, group):
                req.prefill_pos = len(req.prompt)
                req.chunks = 1
                req.first_chunk_tick = self._tick
                prompt_tokens += len(req.prompt)
                firsts_n += 1  # first token off the prefill logits
                self._record_first_token(slot, req, tok, finished)
        return prompt_tokens, firsts_n

    @torch.no_grad()
    def step(self) -> List[RequestResult]:
        """One engine tick: lifecycle expiry, admission and prompt ingestion
        (one-shot or chunked), then one decode (or verify) launch over every
        decodable slot.  Returns requests finished this tick."""
        finished: List[RequestResult] = []
        if self.chaos is not None:
            self.chaos.on_tick(self)  # fault injection (testing only)
        for req in self.scheduler.take_expired(self._tick):
            self.deadline_expired += 1
            finished.append(self._finish_queued(req))
        for slot, req in enumerate(self.scheduler.slots):
            if (
                req is not None
                and req.deadline_ticks is not None
                and self._tick - req.arrival_tick >= req.deadline_ticks
            ):
                self.deadline_expired += 1
                finished.append(self._finish(slot, status="deadline"))
        t0 = time.perf_counter()
        assigned = self.scheduler.admit(self._tick)
        for req in self.scheduler.take_rejected():
            self.rejected_requests += 1
            finished.append(self._finish_queued(req))
        for slot, _ in assigned:
            self._spec_misses[slot] = 0  # fresh request: drafting re-enabled
        ingest = self._ingest_chunked if self.prefill_chunk is not None else self._ingest_one_shot
        prefill_tokens, decode_tokens = ingest(assigned, finished)
        t1 = time.perf_counter()
        decodable = self._decodable()
        if decodable:
            if self._spec_on:
                decode_tokens += self._spec_decode_tick(decodable, finished, prefill_tokens)
            else:
                decode_tokens += self._vanilla_decode_tick(decodable, finished)
        t2 = time.perf_counter()
        self.tick_prefill_tokens.append(prefill_tokens)
        self.tick_decode_tokens.append(decode_tokens)
        self.tick_prefill_s.append(t1 - t0)
        self.tick_decode_s.append(t2 - t1 if decodable else 0.0)
        self._tick += 1
        if self.health_every and self._tick % self.health_every == 0:
            self.health()
        return finished

    def run(self) -> Dict[int, RequestResult]:
        """Drain the queue; returns {rid: RequestResult}."""
        while self.has_work:
            self.step()
        return dict(self._finished)

    def tick_stats(self) -> Dict[str, object]:
        """Per-tick series: prompt tokens ingested vs tokens generated, and
        the host wall seconds of each tick's prefill and decode phases; over
        a ring, the bytes one rank sent per comm kind (``ring_bytes``: the
        attention's hops and combines, the SSD scan's exchanges, the MoE
        all-to-alls), summed since the ring's stats were last reset."""
        return {
            "ticks": self._tick,
            "prefill_tokens": list(self.tick_prefill_tokens),
            "decode_tokens": list(self.tick_decode_tokens),
            "prefill_s": list(self.tick_prefill_s),
            "decode_s": list(self.tick_decode_s),
            "ring_bytes": dict(self.ctx.ring.stats.bytes) if self.ctx.ring is not None else {},
        }

    def kv_cache_stats(self) -> Dict[str, float]:
        """Attention-cache memory accounting.  Dense: bytes are fixed at
        ``num_slots x max_seq``.  Paged: the pool reservation plus the
        allocator's peak usage and sharing/CoW counters."""
        cfg = self.cfg
        lifecycle = {
            "spec_proposed": float(self.spec_proposed),
            "spec_accepted": float(self.spec_accepted),
            "spec_accept_rate": (
                self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0
            ),
            "verify_launches": float(self.verify_launches),
            "chunk_launches": float(self.chunk_launches),
            "decode_launches": float(self.decode_launches),
            "preemptions": float(self.preemptions),
            "recompute_tokens": float(self.recompute_tokens),
            "cancelled": float(self.cancelled),
            "deadline_expired": float(self.deadline_expired),
            "numeric_errors": float(self.numeric_errors),
            "rejected_requests": float(self.rejected_requests),
            "health_sweeps": float(self.health_sweeps),
            "chaos_dropped_grants": float(self.chaos_dropped_grants),
        }
        if cfg.family == "ssm":
            return {"cache_bytes": 0.0, **lifecycle}
        k, v = self._cache["k"], self._cache["v"]
        # the pool's storage width: int8/fp8 codes with fp32 scales apart
        per_tok = cfg.num_layers * k.shape[-2] * (k.shape[-1] + v.shape[-1]) * k.element_size()
        scale_per_tok = (
            cfg.num_layers * k.shape[-2] * 2 * self._cache["k_scale"].element_size()
            if "k_scale" in self._cache else 0
        )
        if self.allocator is None:
            return {
                "paged": 0,
                "cache_bytes": float(self.num_slots * self.max_seq * per_tok),
                "spec_rolled_back_pages": 0.0,
                **lifecycle,
            }
        lay = self.allocator.layout
        stats = self.allocator.stats()
        return {
            "paged": 1,
            "page_size": lay.page_size,
            "chunk_tokens": lay.chunk,
            "num_pages": lay.num_pages,
            "cache_bytes": float(lay.num_pages * lay.chunk * per_tok),
            "peak_page_bytes": float(stats["peak_in_use"] * lay.chunk * per_tok),
            "bt_uploads": float(self.bt_uploads),
            "scale_table_bytes": float(lay.num_pages * lay.chunk * scale_per_tok),
            "dequant_fallbacks": float(self.dequant_fallbacks),
            **{key: float(val) for key, val in stats.items()},
            **lifecycle,
        }

    # -- static-batch API ---------------------------------------------------

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16) -> np.ndarray:
        """prompts: [B, S0] int32 -> [B, max_new_tokens] greedy tokens; B
        requests arrive at once and are served by the slot pool (in waves
        when B > num_slots)."""
        prompts = np.asarray(prompts, np.int32)
        rids = [self.submit(prompts[i], max_new_tokens, self._tick) for i in range(len(prompts))]
        self.run()
        out = []
        for rid in rids:
            row = self._finished.pop(rid).generated[:max_new_tokens]
            row = row + [self.eos_id or 0] * (max_new_tokens - len(row))
            out.append(row)
        return np.asarray(out, np.int32)
