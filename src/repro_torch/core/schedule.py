"""Greedy intra-tile scheduling (paper §3.4–§3.6, Algorithms 2 and 3); a copy
of ``repro/core/schedule.py``, which imports no JAX.

A *schedule* is an explicit list of steps; each step carries at most one
communication operation per ring (paper restriction (2)) plus the set of
compute blocks overlapped with it.  The same schedule object drives

  * the event-driven simulator (``core/simulator.py``) that estimates runtime
    for the Fig.-6 autotuning flow, and
  * the distributed implementation (``core/mesh_attention.py``), which issues
    one ring hop per comm op + a batch of flash-attention block launches per
    step, in exactly this order, so the structure of the comm/compute
    overlap on the card is the paper's schedule.

Blocks are identified by local slot coordinates (u, v): Q slot u in [0, a),
KV slot v in [0, b).  Slot 0 is the device's own chunk (Table 1), so block
(0, 0) is the local Q-KV block — the "local Q-KV property" guarantees it is
computable with zero communication.

Semantics of a step (lock-step across all devices, paper §3.2):
  * a ``recv_*`` issued in step s delivers its chunk at the END of step s:
    compute scheduled in step s may only use chunks received in steps < s;
  * a ``send_*`` issued in step s requires its payload complete in steps < s.

Mask-aware pruning: the generators accept ``skip_blocks`` — slot blocks that
a ``MaskSpec`` proved fully masked on EVERY device (``masking.empty_blocks``).
Skipped blocks are never computed, and communication that only feeds skipped
blocks is dropped under the ring constraints:
  * receives are a forwarding pipeline (chunk u arrives after u hops), so only
    the TRAILING recvs past the highest used slot can be dropped;
  * sends are an accumulation chain (send #t carries contributions of rows
    1..t), so only the LEADING sends whose whole prefix of rows is skipped
    can be dropped.
The schedule records its skip set so the executor and validator agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "COMM_OVERLAP_MODES",
    "validate_comm_overlap",
    "Profile",
    "Step",
    "Schedule",
    "comm_requirements",
    "greedy_forward_schedule",
    "greedy_backward_schedule",
    "naive_forward_schedule",
    "ring_forward_schedule",
    "validate_schedule",
    "schedule_to_json",
    "schedule_from_json",
]

Block = Tuple[int, int]

# How the executor orders each step's ring permutes against its compute
# blocks, threaded from ParallelCtx/AttentionPlanConfig down to the ring
# programs and the simulator's step-cost model:
#   serial  - every permute completes before the step's blocks run (an
#             optimization barrier pins it on the critical path): the naive
#             hop-then-compute baseline, cost = comm + compute per step.
#   overlap - permutes issued at step start stay in flight during the step's
#             blocks and deliver at step end (double-buffered slots), cost =
#             max(comm, compute) + the exposed launch residual.
#   bidir   - overlap, plus every hop's payload is split into a half-payload
#             hop pair so both ring directions of the link carry traffic
#             (TokenRing, PAPERS.md): same bytes, per-direction bandwidth.
# All three modes execute the SAME schedule and are bitwise-equal: only the
# transport routing and the modeled step cost differ.
COMM_OVERLAP_MODES = ("serial", "overlap", "bidir")


def validate_comm_overlap(mode: str) -> str:
    if mode not in COMM_OVERLAP_MODES:
        raise ValueError(
            f"unknown comm_overlap {mode!r}; expected "
            + " | ".join(COMM_OVERLAP_MODES)
        )
    return mode


# communication op kinds
RECV_Q = "recv_q"
RECV_KV = "recv_kv"
SEND_O = "send_o"
RECV_ODOQ = "recv_odoq"
SEND_DQ = "send_dq"
SEND_DKV = "send_dkv"

_Q_RING_OPS = frozenset({RECV_Q, SEND_O, RECV_ODOQ, SEND_DQ})
_KV_RING_OPS = frozenset({RECV_KV, SEND_DKV})


@dataclasses.dataclass(frozen=True)
class Profile:
    """Overlap profile: c_<kind> = least number of compute blocks that fully
    hides one chunk transfer of that kind (paper's profiled constants).

    On real hardware these come from measurement; on this container they are
    derived analytically (see ``core/autotune.py``).  Values are floats so
    the simulator can use fractional ratios; the scheduler ceils them.
    """

    c_q: float = 1.0
    c_kv: float = 2.0
    c_o: float = 1.0
    c_odoq: float = 3.0
    c_dq: float = 1.0
    c_dkv: float = 2.0

    def blocks_to_hide(self, kind: str) -> int:
        val = {
            RECV_Q: self.c_q,
            RECV_KV: self.c_kv,
            SEND_O: self.c_o,
            RECV_ODOQ: self.c_odoq,
            SEND_DQ: self.c_dq,
            SEND_DKV: self.c_dkv,
        }[kind]
        return max(1, int(math.ceil(val)))

    def cost(self, kind: str) -> float:
        """Transfer time of one chunk, in units of one compute block."""
        return {
            RECV_Q: self.c_q,
            RECV_KV: self.c_kv,
            SEND_O: self.c_o,
            RECV_ODOQ: self.c_odoq,
            SEND_DQ: self.c_dq,
            SEND_DKV: self.c_dkv,
        }[kind]


@dataclasses.dataclass(frozen=True)
class Step:
    """One lock-step: the communications issued at step start (at most one
    per ring: paper restriction (2) means ``len(comms) <= 1``; the relaxed
    mode allows one Q-ring op and one KV-ring op concurrently) and the
    compute blocks overlapped with them."""

    comms: Tuple[str, ...]
    compute: Tuple[Block, ...]


@dataclasses.dataclass(frozen=True)
class Schedule:
    a: int
    b: int
    direction: str  # "fwd" | "bwd"
    steps: Tuple[Step, ...]
    skip: Tuple[Block, ...] = ()  # mask-pruned blocks (empty on every device)

    @property
    def n(self) -> int:
        return self.a * self.b

    def comm_ops(self) -> List[str]:
        return [c for s in self.steps for c in s.comms]

    def num_steps(self) -> int:
        return len(self.steps)

    def blocks(self) -> List[Block]:
        return [blk for s in self.steps for blk in s.compute]


def _norm_skip(a: int, b: int, skip_blocks) -> Tuple[Block, ...]:
    skip = tuple(sorted((int(u), int(v)) for u, v in (skip_blocks or ())))
    for (u, v) in skip:
        if not (0 <= u < a and 0 <= v < b):
            raise ValueError(f"skip block {(u, v)} out of range for ({a}, {b})")
    if (0, 0) in skip:
        raise ValueError("block (0, 0) is the local Q-KV block and is never empty")
    return skip


def comm_requirements(a: int, b: int, direction: str, skip: Sequence[Block]) -> Dict[str, int]:
    """Expected comm-op counts for a (possibly pruned) schedule.

    Receives: the ring forwards chunks hop by hop, so the number of recvs is
    the highest used slot index.  Sends: send #t carries the accumulated
    contributions of rows (columns) 1..t, so only a leading run of fully
    skipped rows (columns) removes sends.
    """
    skip = set(skip)
    used = [(u, v) for u in range(a) for v in range(b) if (u, v) not in skip]
    max_u = max((u for u, _ in used), default=0)
    max_v = max((v for _, v in used), default=0)

    def lead_empty(total: int, full) -> int:
        t = 0
        while t + 1 < total and full(t + 1):
            t += 1
        return t

    row_empty = lambda u: all((u, v) in skip for v in range(b))
    col_empty = lambda v: all((u, v) in skip for u in range(a))
    t0_rows = lead_empty(a, row_empty)
    t0_cols = lead_empty(b, col_empty)
    if direction == "fwd":
        return {RECV_Q: max_u, RECV_KV: max_v, SEND_O: max(0, a - 1 - t0_rows)}
    return {
        RECV_ODOQ: max_u,
        RECV_KV: max_v,
        SEND_DQ: max(0, a - 1 - t0_rows),
        SEND_DKV: max(0, b - 1 - t0_cols),
    }


# --------------------------------------------------------------------------
# forward (Algorithm 2)
# --------------------------------------------------------------------------


def _fwd_priority_order(a: int, b: int) -> List[Block]:
    """Row-first order with the local row (slot 0) de-prioritized: rows
    1..a-1 are on the critical path (their O must be sent to peers), row 0
    only feeds the device's own output (paper principle 3)."""
    rows = list(range(1, a)) + [0]
    return [(u, v) for u in rows for v in range(b)]


class _TileState:
    """Mutable tile progress shared by the schedule generators.

    ``skip`` blocks are pre-marked done: never emitted as compute, but they
    count toward row/column completion (their contribution is exactly empty).
    """

    def __init__(self, a: int, b: int, order: Sequence[Block], skip: Sequence[Block] = ()):
        self.a, self.b = a, b
        self.have_q = 1  # local slot 0 is present from the start
        self.have_kv = 1
        self.skip = set(skip)
        self.done: set = set(self.skip)
        self.order = list(order)
        used = [blk for blk in ((u, v) for u in range(a) for v in range(b)) if blk not in self.skip]
        # slots actually read by some block: recvs beyond them are pruned
        self.need_q = max((u for u, _ in used), default=0) + 1
        self.need_kv = max((v for _, v in used), default=0) + 1

    def ready(self, blk: Block) -> bool:
        u, v = blk
        return u < self.have_q and v < self.have_kv and blk not in self.done

    def ready_blocks(self) -> List[Block]:
        return [blk for blk in self.order if self.ready(blk)]

    def pop_compute(self, x: int) -> Tuple[Block, ...]:
        out = []
        for blk in self.order:
            if len(out) >= x:
                break
            if self.ready(blk):
                out.append(blk)
                self.done.add(blk)
        return tuple(out)

    def row_done(self, u: int) -> bool:
        return all((u, v) in self.done for v in range(self.b))

    def col_done(self, v: int) -> bool:
        return all((u, v) in self.done for u in range(self.a))

    def all_done(self) -> bool:
        return len(self.done) == self.a * self.b


def greedy_forward_schedule(
    a: int,
    b: int,
    profile: Optional[Profile] = None,
    *,
    allow_concurrent_rings: bool = False,
    skip_blocks: Optional[Iterable[Block]] = None,
) -> Schedule:
    """Paper Algorithm 2.

    Phase 1 — receive everything, maximizing *profit* = unlocked blocks per
    unit transfer cost; overlap "just enough" compute (c_kind blocks).
    Phase 2 — send the a-1 partial O rows in ring order, inserting single
    compute steps while the next row is incomplete.
    Phase 3 — drain the remaining blocks (the de-prioritized local row).

    ``allow_concurrent_rings`` is the beyond-paper relaxation: the Q ring
    and KV ring use different links, so one recv_q and one
    recv_kv may be issued in the same step (restriction (2) is per-ring).

    ``skip_blocks`` prunes mask-empty blocks and the comm that only feeds
    them (trailing recvs, leading sends over fully skipped rows).
    """
    profile = profile or Profile()
    skip = _norm_skip(a, b, skip_blocks)
    st = _TileState(a, b, _fwd_priority_order(a, b), skip)
    req = comm_requirements(a, b, "fwd", skip)
    steps: List[Step] = []

    # ---- phase 1: Recv Q / Recv KV by profit -------------------------------
    while st.have_q < st.need_q or st.have_kv < st.need_kv:
        comms: List[str] = []
        budget = 0
        # profit of the next recv on each ring: blocks unlocked / cost
        profit_q = (st.have_kv / profile.cost(RECV_Q)) if st.have_q < st.need_q else -1.0
        profit_kv = (st.have_q / profile.cost(RECV_KV)) if st.have_kv < st.need_kv else -1.0
        if allow_concurrent_rings:
            if st.have_q < st.need_q:
                comms.append(RECV_Q)
                budget = max(budget, profile.blocks_to_hide(RECV_Q))
            if st.have_kv < st.need_kv:
                comms.append(RECV_KV)
                budget = max(budget, profile.blocks_to_hide(RECV_KV))
        elif profit_q > profit_kv:
            comms, budget = [RECV_Q], profile.blocks_to_hide(RECV_Q)
        else:
            comms, budget = [RECV_KV], profile.blocks_to_hide(RECV_KV)
        compute = st.pop_compute(budget)  # only already-received slots
        steps.append(Step(tuple(comms), compute))
        if RECV_Q in comms:
            st.have_q += 1
        if RECV_KV in comms:
            st.have_kv += 1

    # ---- phase 2: Send O rows in ring order (leading empty rows pruned) -----
    first_row = a - req[SEND_O]  # rows 1..first_row-1 are fully skipped
    for row in range(first_row, a):
        while not st.row_done(row):  # Send O invalid -> compute-only steps
            steps.append(Step((), st.pop_compute(1)))
        steps.append(Step((SEND_O,), st.pop_compute(profile.blocks_to_hide(SEND_O))))

    # ---- phase 3: drain ------------------------------------------------------
    while not st.all_done():
        steps.append(Step((), st.pop_compute(1)))

    return Schedule(a, b, "fwd", tuple(steps), skip)


def naive_forward_schedule(a: int, b: int) -> Schedule:
    """Figure 5(b): row-first recvs, every unlocked block computed eagerly —
    the un-balanced baseline the greedy algorithm improves on."""
    st = _TileState(a, b, [(u, v) for u in range(a) for v in range(b)])
    steps: List[Step] = []
    for _ in range(a - 1):
        steps.append(Step((RECV_Q,), st.pop_compute(a * b)))
        st.have_q += 1
    for _ in range(b - 1):
        steps.append(Step((RECV_KV,), st.pop_compute(a * b)))
        st.have_kv += 1
    for row in range(1, a):
        while not st.row_done(row):
            steps.append(Step((), st.pop_compute(1)))
        steps.append(Step((SEND_O,), ()))
    while not st.all_done():
        steps.append(Step((), st.pop_compute(1)))
    return Schedule(a, b, "fwd", tuple(steps))


def ring_forward_schedule(n: int) -> Schedule:
    """Ring-Attention = (a=1, b=n): n-1 Recv KV steps each hiding exactly one
    block (Figure 5(a)), then the final block."""
    st = _TileState(1, n, [(0, v) for v in range(n)])
    steps = []
    for _ in range(n - 1):
        steps.append(Step((RECV_KV,), st.pop_compute(1)))
        st.have_kv += 1
    while not st.all_done():
        steps.append(Step((), st.pop_compute(1)))
    return Schedule(1, n, "fwd", tuple(steps))


# --------------------------------------------------------------------------
# backward (Algorithm 3)
# --------------------------------------------------------------------------


def _bwd_row_order(a: int) -> List[int]:
    return list(range(1, a)) + [0]


def _bwd_col_order(b: int) -> List[int]:
    return list(range(1, b)) + [0]


class _BwdChooser:
    """ChooseNextBlock (Alg. 3 lines 1-7): alternate between finishing rows
    (unblocks Send dQ) and columns (unblocks Send dKV) by weighted
    completion proximity."""

    def __init__(self, st: _TileState, profile: Profile):
        self.st, self.profile = st, profile

    def _first_unfinished(self, rows: bool) -> Optional[int]:
        order = _bwd_row_order(self.st.a) if rows else _bwd_col_order(self.st.b)
        for idx in order:
            done = self.st.row_done(idx) if rows else self.st.col_done(idx)
            if not done:
                return idx
        return None

    def next_block(self) -> Optional[Block]:
        ready = self.st.ready_blocks()
        if not ready:
            return None
        r = self._first_unfinished(rows=True)
        c = self._first_unfinished(rows=False)
        n_dq = sum(1 for v in range(self.st.b) if (r, v) not in self.st.done) if r is not None else 0
        n_dkv = sum(1 for u in range(self.st.a) if (u, c) not in self.st.done) if c is not None else 0
        col_first = False
        if n_dq and n_dkv:
            col_first = self.profile.c_dq / n_dq < self.profile.c_dkv / n_dkv
        elif n_dkv:
            col_first = True
        if col_first:
            order = [(u, v) for v in _bwd_col_order(self.st.b) for u in _bwd_row_order(self.st.a)]
        else:
            order = [(u, v) for u in _bwd_row_order(self.st.a) for v in _bwd_col_order(self.st.b)]
        for blk in order:
            if self.st.ready(blk):
                return blk
        return None

    def pop(self, x: int) -> Tuple[Block, ...]:
        out = []
        for _ in range(x):
            blk = self.next_block()
            if blk is None:
                break
            self.st.done.add(blk)
            out.append(blk)
        return tuple(out)


def greedy_backward_schedule(
    a: int,
    b: int,
    profile: Optional[Profile] = None,
    *,
    allow_concurrent_rings: bool = False,
    skip_blocks: Optional[Iterable[Block]] = None,
) -> Schedule:
    """Paper Algorithm 3: Recv OdOQ along the Q ring, Recv KV along the KV
    ring (profit-driven), then alternate Send dQ (after each remote row
    completes) and Send dKV (after each remote column completes).

    ``skip_blocks`` prunes exactly like the forward generator (the dQ/dKV of
    an everywhere-empty block is zero, so the same blocks drop out)."""
    profile = profile or Profile()
    skip = _norm_skip(a, b, skip_blocks)
    st = _TileState(a, b, [(u, v) for u in _bwd_row_order(a) for v in _bwd_col_order(b)], skip)
    req = comm_requirements(a, b, "bwd", skip)
    chooser = _BwdChooser(st, profile)
    steps: List[Step] = []

    # ---- phase 1: receives ---------------------------------------------------
    while st.have_q < st.need_q or st.have_kv < st.need_kv:
        comms: List[str] = []
        budget = 0
        profit_q = (st.have_kv / profile.cost(RECV_ODOQ)) if st.have_q < st.need_q else -1.0
        profit_kv = (st.have_q / profile.cost(RECV_KV)) if st.have_kv < st.need_kv else -1.0
        if allow_concurrent_rings:
            if st.have_q < st.need_q:
                comms.append(RECV_ODOQ)
                budget = max(budget, profile.blocks_to_hide(RECV_ODOQ))
            if st.have_kv < st.need_kv:
                comms.append(RECV_KV)
                budget = max(budget, profile.blocks_to_hide(RECV_KV))
        elif profit_q > profit_kv:
            comms, budget = [RECV_ODOQ], profile.blocks_to_hide(RECV_ODOQ)
        else:
            comms, budget = [RECV_KV], profile.blocks_to_hide(RECV_KV)
        compute = chooser.pop(budget)
        steps.append(Step(tuple(comms), compute))
        if RECV_ODOQ in comms:
            st.have_q += 1
        if RECV_KV in comms:
            st.have_kv += 1

    # ---- phase 2: sends (leading fully-skipped rows/cols pruned) -------------
    first_row = a - req[SEND_DQ]  # first row whose dQ must be sent
    first_col = b - req[SEND_DKV]
    sent_dq, sent_dkv = 0, 0
    while sent_dq < req[SEND_DQ] or sent_dkv < req[SEND_DKV]:
        dq_valid = sent_dq < req[SEND_DQ] and st.row_done(first_row + sent_dq)
        dkv_valid = sent_dkv < req[SEND_DKV] and st.col_done(first_col + sent_dkv)
        if not (dq_valid or dkv_valid):
            steps.append(Step((), chooser.pop(1)))
            continue
        if dq_valid and dkv_valid and allow_concurrent_rings:
            budget = max(profile.blocks_to_hide(SEND_DQ), profile.blocks_to_hide(SEND_DKV))
            steps.append(Step((SEND_DQ, SEND_DKV), chooser.pop(budget)))
            sent_dq += 1
            sent_dkv += 1
        elif dq_valid:
            steps.append(Step((SEND_DQ,), chooser.pop(profile.blocks_to_hide(SEND_DQ))))
            sent_dq += 1
        else:
            steps.append(Step((SEND_DKV,), chooser.pop(profile.blocks_to_hide(SEND_DKV))))
            sent_dkv += 1

    while not st.all_done():
        steps.append(Step((), chooser.pop(1)))

    return Schedule(a, b, "bwd", tuple(steps), skip)


# --------------------------------------------------------------------------
# (de)serialization — the autotuner's on-disk plan cache stores schedules
# --------------------------------------------------------------------------


def schedule_to_json(s: Schedule) -> dict:
    return {
        "a": s.a,
        "b": s.b,
        "direction": s.direction,
        "steps": [
            {"comms": list(st.comms), "compute": [list(blk) for blk in st.compute]}
            for st in s.steps
        ],
        "skip": [list(blk) for blk in s.skip],
    }


def schedule_from_json(d: dict) -> Schedule:
    steps = tuple(
        Step(tuple(st["comms"]), tuple((int(u), int(v)) for u, v in st["compute"]))
        for st in d["steps"]
    )
    skip = tuple((int(u), int(v)) for u, v in d.get("skip", ()))
    return Schedule(int(d["a"]), int(d["b"]), d["direction"], steps, skip)


# --------------------------------------------------------------------------
# validation (used by tests and asserted by the distributed op at trace time)
# --------------------------------------------------------------------------


def validate_schedule(s: Schedule, *, strict_paper: bool = False) -> None:
    """Check every invariant the paper's restrictions imply (including the
    pruning rules when ``s.skip`` is non-empty).  Raises ``ValueError`` on
    the first violation."""
    a, b = s.a, s.b
    fwd = s.direction == "fwd"
    recv_q_kind = RECV_Q if fwd else RECV_ODOQ
    skip = set(_norm_skip(a, b, s.skip))
    expect = comm_requirements(a, b, s.direction, skip)
    # sends over leading fully-skipped rows/cols are pruned; later ones shift
    first_row = a - expect.get(SEND_O if fwd else SEND_DQ, 0)
    first_col = b - expect.get(SEND_DKV, 0)

    have_q, have_kv = 1, 1
    done: set = set(skip)  # skipped blocks complete rows/cols with zero work
    counts: Dict[str, int] = {}
    sent_o = sent_dq = sent_dkv = 0

    for idx, step in enumerate(s.steps):
        if strict_paper and len(step.comms) > 1:
            raise ValueError(f"step {idx}: restriction (2) violated: {step.comms}")
        q_ops = [c for c in step.comms if c in _Q_RING_OPS]
        kv_ops = [c for c in step.comms if c in _KV_RING_OPS]
        if len(q_ops) > 1 or len(kv_ops) > 1:
            raise ValueError(f"step {idx}: >1 op on one ring: {step.comms}")
        # sends must have payload complete BEFORE this step
        for c in step.comms:
            counts[c] = counts.get(c, 0) + 1
            if c == SEND_O or c == SEND_DQ:
                row = first_row + (sent_o if c == SEND_O else sent_dq)
                if not all((row, v) in done for v in range(b)):
                    raise ValueError(f"step {idx}: {c} #{row} before row {row} complete")
                if c == SEND_O:
                    sent_o += 1
                else:
                    sent_dq += 1
            elif c == SEND_DKV:
                col = first_col + sent_dkv
                if not all((u, col) in done for u in range(a)):
                    raise ValueError(f"step {idx}: send_dkv #{col} before col {col} complete")
                sent_dkv += 1
        # compute may only use chunks received in strictly earlier steps
        for (u, v) in step.compute:
            if not (0 <= u < a and 0 <= v < b):
                raise ValueError(f"step {idx}: block {(u, v)} out of range")
            if (u, v) in skip:
                raise ValueError(f"step {idx}: block {(u, v)} is mask-pruned but scheduled")
            if (u, v) in done:
                raise ValueError(f"step {idx}: block {(u, v)} computed twice")
            if u >= have_q or v >= have_kv:
                raise ValueError(
                    f"step {idx}: block {(u, v)} not ready (have_q={have_q}, have_kv={have_kv})"
                )
            done.add((u, v))
        # receives deliver at end of step
        for c in step.comms:
            if c == recv_q_kind:
                have_q += 1
            elif c == RECV_KV:
                have_kv += 1

    if len(done) != a * b:
        raise ValueError(f"{a*b - len(done)} blocks never computed")
    for kind, cnt in expect.items():
        if counts.get(kind, 0) != cnt:
            raise ValueError(f"{kind}: expected {cnt} ops, got {counts.get(kind, 0)}")
    for kind in counts:
        if kind not in expect:
            raise ValueError(f"unexpected op kind {kind} in {s.direction} schedule")
