"""Continuous-batching scheduler: request queue over a fixed slot pool.

The port's own copy of ``repro/serve/scheduler.py`` (numpy only): admission,
bucketed one-shot prefill, and the continuous-prefill and speculative
planners (``plan_chunks`` / ``plan_spec``) under the tick token budget, the
exact (unpadded) prefill of SSM and hybrid archs, and preemption: an evicted
request re-queues and re-ingests its context (prompt + generated).

Pure-python bookkeeping: the engine owns the device tensors, this module owns
WHO occupies WHICH slot WHEN.  Lifecycle of a request:

    submit() -> queued -> admit() assigns a free slot (FIFO among arrived
    requests) -> prefill fills the slot row -> the slot decodes every tick ->
    retire() on EOS / max_new_tokens -> slot returns to the free pool.

Prompts are right-padded to a **bucket** length for prefill, so prefill
shapes are bounded by ``len(buckets)``, not by the mix of prompt lengths.
In **exact** mode (SSM / hybrid archs: the recurrent state has no pad
correction) a prompt is prefilled at its own length, which the SSD chunked
scan needs to be at most the chunk or a multiple of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Request", "RequestResult", "Scheduler", "default_buckets"]


def default_buckets(max_seq: int, n: int = 1, lo: int = 16) -> Tuple[int, ...]:
    """Power-of-two bucket ladder up to the cache capacity; every bucket is a
    multiple of the sequence-parallel size n (striping requirement)."""
    lo = max(lo, n)
    out = []
    b = 1
    while b < lo:
        b *= 2
    while b < max_seq:
        if b % max(n, 1) == 0:
            out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(dict.fromkeys(out))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S0] int32
    max_new_tokens: int
    arrival_tick: int = 0
    # lifecycle: finish by arrival + deadline_ticks or retire with partial
    # output (status "deadline"); higher priority admits first (FIFO ties)
    deadline_ticks: Optional[int] = None
    priority: int = 0
    # filled in by the engine as the request progresses:
    generated: List[int] = dataclasses.field(default_factory=list)
    token_ticks: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    admit_tick: Optional[int] = None
    first_token_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    # terminal state: ok | cancelled | deadline | numeric_error | rejected
    status: str = "ok"
    # oversubscription: times this request was preempted mid-decode, and
    # tokens re-ingested through continuous prefill to restore its cache
    preemptions: int = 0
    recompute_tokens: int = 0
    # continuous prefill: the ingest target (frozen at admission: unlike
    # ``context_len`` it does not grow as decode appends tokens), how far
    # into it the cache is, and how many chunk launches it took (a one-shot
    # prefill counts as one chunk)
    ingest_len: int = 0
    prefill_pos: int = 0
    chunks: int = 0
    first_chunk_tick: Optional[int] = None
    # speculative decode: draft tokens sent to verify / accepted
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def done(self) -> bool:
        return self.finish_tick is not None

    @property
    def context(self) -> np.ndarray:
        """What the cache must hold for this request to keep decoding:
        prompt + everything generated so far.  A preempted request re-queues
        and prefills its CONTEXT, so the resumed stream continues exactly
        where the uninterrupted one would."""
        if not self.generated:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def remaining_new_tokens(self) -> int:
        return max(self.max_new_tokens - len(self.generated), 0)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """What the engine hands back for a finished request: the tokens with
    the engine tick each landed on, and the request's lifecycle ticks.
    ``generated`` is the list view of ``tokens``."""

    rid: int
    prompt: np.ndarray  # [S0] int32
    tokens: np.ndarray  # [T] int32 generated tokens
    token_ticks: Tuple[int, ...]  # engine tick each token landed on
    arrival_tick: int
    admit_tick: int
    first_token_tick: int
    finish_tick: int
    max_new_tokens: int
    slot: int
    chunks: int = 0  # prefill launches (1 = one-shot)
    first_chunk_tick: int = 0  # tick the first prompt chunk landed
    spec_proposed: int = 0  # draft tokens verified for this request
    spec_accepted: int = 0  # ... of which matched greedy decode
    status: str = "ok"  # ok | cancelled | deadline | numeric_error | rejected
    preemptions: int = 0  # mid-decode evictions this request survived
    recompute_tokens: int = 0  # tokens re-ingested after preemption

    @property
    def generated(self) -> List[int]:
        """Legacy list view of ``tokens``."""
        return self.tokens.tolist()

    @property
    def ttft_ticks(self) -> int:
        """Ticks from arrival to the first generated token (inclusive)."""
        return self.first_token_tick - self.arrival_tick + 1

    @property
    def done(self) -> bool:
        return True

    @classmethod
    def from_request(cls, req: Request) -> "RequestResult":
        return cls(
            rid=req.rid,
            prompt=req.prompt,
            tokens=np.asarray(req.generated, np.int32),
            token_ticks=tuple(req.token_ticks),
            arrival_tick=req.arrival_tick,
            admit_tick=req.admit_tick,
            first_token_tick=req.first_token_tick,
            finish_tick=req.finish_tick,
            max_new_tokens=req.max_new_tokens,
            slot=req.slot,
            chunks=req.chunks,
            first_chunk_tick=(
                req.first_chunk_tick if req.first_chunk_tick is not None else req.admit_tick
            ),
            spec_proposed=req.spec_proposed,
            spec_accepted=req.spec_accepted,
            status=req.status,
            preemptions=req.preemptions,
            recompute_tokens=req.recompute_tokens,
        )


class Scheduler:
    """Admission + slot assignment + retirement over ``num_slots`` slots."""

    def __init__(
        self,
        num_slots: int,
        buckets: Sequence[int],
        max_seq: int,
        *,
        exact: bool = False,
        chunk: Optional[int] = None,
        allocator=None,
        prefill_chunk: Optional[int] = None,
        tick_token_budget: Optional[int] = None,
    ):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = num_slots
        self.chunk = chunk  # SSD scan chunk (exact mode only)
        # continuous prefill: prompts stream into their slot prefill_chunk
        # tokens per launch; tick_token_budget caps decode + chunk tokens per
        # tick (None = unbudgeted: every pending chunk runs every tick)
        self.prefill_chunk = prefill_chunk
        self.tick_token_budget = tick_token_budget
        # paged KV pool: admission accounts PAGES, not slot rows -- a request
        # is only admitted when its whole lifetime (prompt + token budget)
        # fits the unreserved pool, so decode can never exhaust mid-flight
        self.allocator = allocator
        self.buckets = tuple(sorted(set(buckets)))
        if not self.buckets or self.buckets[-1] > max_seq:
            raise ValueError(f"buckets {buckets} must be non-empty and <= max_seq={max_seq}")
        self.max_seq = max_seq
        self.exact = exact
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._queue: List[Request] = []
        self._next_rid = 0
        # requests admission found can NEVER fit the pool (even empty):
        # popped from the queue with status "rejected" for the engine to
        # drain, instead of blocking the line head forever
        self.rejected: List[Request] = []

    # -- submission ---------------------------------------------------------

    def submit(
        self, prompt: np.ndarray, max_new_tokens: int, arrival_tick: int = 0,
        *, deadline_ticks: Optional[int] = None, priority: int = 0,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_ticks is not None and deadline_ticks < 1:
            raise ValueError("deadline_ticks must be >= 1 or None")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) exceeds "
                f"cache capacity {self.max_seq}"
            )
        if self.prefill_chunk is None:
            self.bucket_for(len(prompt))  # raise early on un-bucketable prompts
        req = Request(
            self._next_rid, prompt, max_new_tokens, arrival_tick,
            deadline_ticks=deadline_ticks, priority=priority,
        )
        self._next_rid += 1
        self._queue.append(req)
        return req

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= length (or the exact length in exact mode)."""
        if length < 1 or length > self.max_seq:
            raise ValueError(f"prompt length {length} outside (0, {self.max_seq}]")
        if self.exact:
            # no padding: the SSD chunked scan takes the prompt as it is (one
            # card, so no sequence-parallel divisibility as in JAX)
            if self.chunk is not None and length > self.chunk and length % self.chunk:
                raise ValueError(
                    f"the SSD chunked scan needs the prompt length ({length}) to be "
                    f"<= or a multiple of the chunk ({self.chunk})"
                )
            return length
        for b in self.buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} exceeds largest bucket {self.buckets[-1]}")

    def pack_groups(
        self,
        assigned: List[Tuple[int, "Request"]],
        *,
        pack_max: int = 4,
        plan: str = "binpack",
    ) -> List[List[Tuple[int, "Request"]]]:
        """Group same-tick admissions into packed prefill rows.

        ``plan="binpack"`` (default) sorts by length (descending) and places
        each request where the total padded-bucket cost grows least —
        first-fit-decreasing toward bucket boundaries, so a 16+9+8 burst
        prefers an exactly-full 32 row + a padding-free 8 over one 64-bucket
        row.  The admission-order greedy plan is kept as a candidate and the
        cheaper of the two (total bucketed tokens, then fewer groups) wins,
        so binpack never prefills more padding than ``plan="greedy"`` — the
        old behavior, kept for the serve bench's TTFT comparison.  Groups
        close at ``pack_max`` documents or the largest bucket.  Exact mode
        (SSM/hybrid) never packs -- the recurrent state has no per-document
        reset.
        """
        if self.exact or pack_max <= 1:
            return [[x] for x in assigned]
        if plan not in ("greedy", "binpack"):
            raise ValueError(f"unknown pack plan {plan!r} (greedy | binpack)")
        cap = self.buckets[-1]
        groups: List[List[Tuple[int, Request]]] = []
        cur: List[Tuple[int, Request]] = []
        cur_len = 0
        for slot, req in assigned:
            length = len(req.prompt)
            if cur and (len(cur) >= pack_max or cur_len + length > cap):
                groups.append(cur)
                cur, cur_len = [], 0
            cur.append((slot, req))
            cur_len += length
        if cur:
            groups.append(cur)
        if plan == "greedy":
            return groups

        # first-fit-decreasing by MARGINAL bucket cost: joining a group costs
        # bucket(total+len) - bucket(total) extra padded tokens, a fresh group
        # costs bucket(len); ties join (fewer prefill launches)
        bins: List[Tuple[int, List[Tuple[int, Request]]]] = []  # (sum, members)
        order = sorted(assigned, key=lambda sr: len(sr[1].prompt), reverse=True)
        for slot, req in order:
            length = len(req.prompt)
            best_i, best_c = None, self.bucket_for(length)  # fresh-group cost
            for i, (total, members) in enumerate(bins):
                if len(members) >= pack_max or total + length > cap:
                    continue
                c = self.bucket_for(total + length) - self.bucket_for(total)
                if c <= best_c:
                    best_i, best_c = i, c
            if best_i is None:
                bins.append((length, [(slot, req)]))
            else:
                total, members = bins[best_i]
                bins[best_i] = (total + length, members + [(slot, req)])
        packed = [members for _, members in bins]

        def cost(gs):
            return sum(self.bucket_for(sum(len(r.prompt) for _, r in g)) for g in gs)

        # the greedy plan stays a candidate: dense bursts that fit one bucket
        # row beat any split, and this guarantees cost(binpack) <= cost(greedy)
        return min((packed, groups), key=lambda gs: (cost(gs), len(gs)))

    # -- per-tick operations ------------------------------------------------

    def _next_candidate(self, tick: int) -> Optional[Request]:
        """Highest-priority arrived request (FIFO within a priority level);
        requests that could never fit even an EMPTY pool are moved to
        ``self.rejected`` on sight instead of blocking the line."""
        while True:
            cand = min(
                (r for r in self._queue if r.arrival_tick <= tick),
                key=lambda r: (-r.priority, r.arrival_tick, r.rid),
                default=None,
            )
            if cand is None:
                return None
            if self.allocator is not None and self.allocator.never_admittable(
                cand.context_len, cand.remaining_new_tokens
            ):
                self._queue.remove(cand)
                cand.status = "rejected"
                self.rejected.append(cand)
                continue
            return cand

    def admit(self, tick: int) -> List[Tuple[int, Request]]:
        """Assign arrived queued requests to free slots -- highest priority
        first, FIFO within a level (default priority 0 keeps pure FIFO).
        Returns [(slot, request)] for the engine to prefill.  A preempted
        request re-enters through here with its context (prompt + generated)
        as the ingest payload."""
        assigned = []
        pending_pages = 0  # pages promised to this tick's earlier admissions
        pending_prompt = 0  # ... of which must be physically free NOW
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                continue
            req = self._next_candidate(tick)
            if req is None:
                break
            if self.allocator is not None:
                clen, rem = req.context_len, req.remaining_new_tokens
                if not self.allocator.can_admit(
                    clen, rem, pending=pending_pages, pending_prompt=pending_prompt
                ):
                    break  # pool exhausted: FIFO holds the head until pages free
                pending_pages += self.allocator.reserve_for(clen, rem)
                pending_prompt += self.allocator.layout.pages_for(clen)
            self._queue.remove(req)
            req.slot, req.admit_tick = slot, tick
            # freeze the ingest target NOW: decode appends grow context_len,
            # but the chunk machinery must stop exactly here
            req.ingest_len = req.context_len
            self.slots[slot] = req
            assigned.append((slot, req))
        return assigned

    def take_rejected(self) -> List[Request]:
        """Drain requests admission rejected as never-fitting."""
        out, self.rejected = self.rejected, []
        return out

    def preempt(self, slot: int) -> Request:
        """Evict a mid-flight request back to the queue: its slot frees, its
        prefill position resets so admission re-ingests the full context
        (prompt + generated) through continuous prefill.  The caller (the
        engine) frees the allocator pages and counts the preemption."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        req.slot = None
        req.prefill_pos = 0
        self._queue.append(req)
        return req

    def find(self, rid: int) -> Optional[Request]:
        """Look a live request up by rid (queued or active); None if it is
        not in flight (finished, rejected, or never submitted)."""
        for r in self._queue:
            if r.rid == rid:
                return r
        for r in self.slots:
            if r is not None and r.rid == rid:
                return r
        return None

    def cancel_queued(self, rid: int) -> Optional[Request]:
        """Remove a QUEUED request; returns it (status set) or None if the
        rid is not queued (active requests cancel through the engine, which
        must also free the slot's pages)."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                r.status = "cancelled"
                return r
        return None

    def take_expired(self, tick: int) -> List[Request]:
        """Remove QUEUED requests whose deadline passed before admission."""
        out = [
            r for r in self._queue
            if r.deadline_ticks is not None
            and tick - r.arrival_tick >= r.deadline_ticks
        ]
        for r in out:
            self._queue.remove(r)
            r.status = "deadline"
        return out

    def plan_chunks(self, decode_slots: int) -> List[Tuple[int, Request, int, int]]:
        """Continuous prefill: this tick's chunk work under the token budget,
        ``[(slot, request, start, take)]``; the engine launches exactly this
        plan and advances ``request.prefill_pos``.  Oldest request first
        (admission order).  The budget charges one token per decodable slot
        first, then grants whole chunks until it runs out; the head-of-line
        chunk is always granted, so prefill progresses every tick."""
        if self.prefill_chunk is None:
            return []
        work = sorted(
            (r.admit_tick, r.rid, slot, r)
            for slot, r in enumerate(self.slots)
            if r is not None and r.prefill_pos < r.ingest_len
        )
        budget = None
        if self.tick_token_budget is not None:
            budget = max(self.tick_token_budget - decode_slots, 0)
        plan: List[Tuple[int, Request, int, int]] = []
        spent = 0
        for _, _, slot, r in work:
            take = min(self.prefill_chunk, r.ingest_len - r.prefill_pos)
            if plan and budget is not None and spent + take > budget:
                break
            plan.append((slot, r, r.prefill_pos, take))
            spent += take
        return plan

    def plan_spec(
        self, drafts: Dict[int, List[int]], decode_slots: int, chunk_tokens: int
    ) -> Dict[int, List[int]]:
        """Grant speculative draft tokens from the budget LEFT after one token
        per decodable slot and this tick's chunk tokens, oldest request first;
        a draft may be cut to what is left.  No budget = grant everything."""
        if not drafts:
            return {}
        if self.tick_token_budget is None:
            return dict(drafts)
        left = max(self.tick_token_budget - decode_slots - chunk_tokens, 0)
        granted: Dict[int, List[int]] = {}
        order = sorted((self.slots[s].admit_tick, self.slots[s].rid, s) for s in drafts)
        for _, _, slot in order:
            if left <= 0:
                break
            take = drafts[slot][:left]
            granted[slot] = take
            left -= len(take)
        return granted

    def retire(self, slot: int, tick: int, status: str = "ok") -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        req.finish_tick = tick
        req.status = status
        self.slots[slot] = None
        return req

    # -- introspection ------------------------------------------------------

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self.slots)
