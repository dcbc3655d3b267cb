"""The ring transport of the port's sequence-parallel attention: its
counterpart of ``lax.ppermute`` / ``lax.all_to_all`` / ``lax.all_gather``
inside JAX's ``shard_map``.

Every tensor the executors hand to a transport carries a leading *local
rank* axis ``[R, ...]``: the ranks of the ring this process holds.  Two
implementations share that interface (``n``, ``ranks``, ``hop``,
``all_to_all``, ``all_gather``, ``split``, ``join``; the virtual ring also
``gather_ranks``, the exchange of the sequence-sharded decode's combine):

  * ``VirtualRing(n)``: all n ranks in one process, on one device (R = n).
    A hop is an index permutation along the rank axis, ``out[dst] = x[src]``
    for each ``(src, dst)`` of the perm: a real device-to-device copy.  This
    is how one card runs a whole schedule; it cannot show link bandwidth,
    since every hop is a copy inside one device's memory.
  * ``ProcessGroupRing(group)``: one rank per process (R = 1).  A hop is
    ``dist.batch_isend_irecv`` to and from the perm's neighbours;
    ``all_to_all`` is ``dist.all_to_all_single``.  gloo runs it on the CPU.

``hop(leaves, perm, kind=..., mode=...)`` returns a pending handle whose
``wait()`` gives the moved leaves; the executors issue a step's hops before
its blocks and wait at the step's end.  ``mode`` is the executor's
``comm_overlap`` (``schedule.COMM_OVERLAP_MODES``):

  serial   the hop completes before ``hop`` returns (on the card: on the
           compute stream, ahead of the step's blocks);
  overlap  the copies run on a side CUDA stream (virtual ring on the card)
           or as outstanding P2P requests, joined at ``wait()``;
  bidir    as overlap, each leaf sent as two half-payload hops along its
           last axis.

All three move the same values, so the executors' results are bitwise equal
across modes.  Each hop is counted per comm kind (``recv_q``, ``recv_kv``,
``send_o``, ``recv_odoq``, ``send_dq``, ``send_dkv``; ``combine`` for the
decode's lse combine): ``stats.hops`` (logical
hops), ``stats.messages`` (transfers: two per leaf in bidir) and
``stats.bytes`` (bytes one rank sends, the unit of ``core/am.CommModel``).

**Group collectives** over an ``(a, b)`` grid of the n = a*b ranks (rank
c = x*b + y; ``Grid``) serve Algorithm 1's collective form
(``core/mesh_attention_collective.py``), JAX's ``lax.all_gather`` /
``lax.psum_scatter`` over the ``aq`` / ``akv`` axes of a 2-D mesh:
``group_all_gather(x, grid, axis)`` gives each rank its group's tensors in
member order, ``group_reduce_scatter(x, grid, axis)`` gives each rank the
sum, in member order, of its group's slots for it.  The ``aq`` group of rank
(x, y) is {u*b + y : u < a} (its index there is x), the ``akv`` group
{x*b + w : w < b} (index y).  Both are ``torch.autograd.Function``s, each
the other's gradient, with sums in a fixed order, so every transport and
mode gives the same bits.  They complete before they return in every mode;
``bidir`` splits each leaf of a gather into two half-payload transfers along
its last axis (the reduce-scatter, a reduction, is never split).  A group
collective counts one hop of its kind, one message per leaf (two in bidir),
and the bytes one rank sends: (group size - 1) x its chunk.  The virtual
ring copies inside one device; ``ProcessGroupRing`` runs them over
``dist.new_group`` subgroups (all-gather, and ``all_to_all_single`` for the
reduce-scatter), gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.schedule import validate_comm_overlap

__all__ = ["Grid", "RingStats", "VirtualRing", "ProcessGroupRing"]

Perm = Sequence[Tuple[int, int]]


@dataclasses.dataclass
class RingStats:
    """Per comm kind: logical hops, transfers, and bytes one rank sent."""

    hops: Dict[str, int] = dataclasses.field(default_factory=dict)
    messages: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, messages: int, nbytes: int) -> None:
        self.hops[kind] = self.hops.get(kind, 0) + 1
        self.messages[kind] = self.messages.get(kind, 0) + messages
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes

    def reset(self) -> None:
        self.hops.clear()
        self.messages.clear()
        self.bytes.clear()


class _Pending:
    """The result of one hop: ``wait()`` joins it and returns the leaves."""

    def __init__(self, leaves, join=None):
        self._leaves, self._join = leaves, join

    def wait(self):
        if self._join is not None:
            self._join()
            self._join = None
        return self._leaves


def _halves(x: torch.Tensor) -> List[torch.Tensor]:
    """bidir's split of one leaf along its last axis (whole when too small)."""
    if x.dim() < 2 or x.shape[-1] < 2:
        return [x]
    h = x.shape[-1] // 2
    return [x[..., :h], x[..., h:]]


def _payload_bytes(leaves, ranks: int) -> int:
    return sum(x.numel() * x.element_size() for x in leaves if x is not None) // ranks


@dataclasses.dataclass(frozen=True)
class Grid:
    """The (a, b) factorization of a ring's n = a*b ranks: rank c sits at
    (x, y) = divmod(c, b).  Axis ``"aq"`` varies x (groups of a ranks: a
    column), axis ``"akv"`` varies y (groups of b ranks: a row)."""

    a: int
    b: int

    def __post_init__(self):
        if self.a < 1 or self.b < 1:
            raise ValueError(f"a grid needs a, b >= 1, got ({self.a}, {self.b})")

    @property
    def n(self) -> int:
        return self.a * self.b

    def size(self, axis: str) -> int:
        if axis == "aq":
            return self.a
        if axis == "akv":
            return self.b
        raise ValueError(f"unknown group axis {axis!r}; expected aq | akv")

    def members(self, axis: str, rank: int) -> List[int]:
        """The ranks of ``rank``'s group along ``axis``, in member order."""
        x, y = divmod(rank, self.b)
        if axis == "aq":
            return [u * self.b + y for u in range(self.a)]
        self.size(axis)
        return [x * self.b + w for w in range(self.b)]

    def index(self, axis: str, rank: int) -> int:
        """``rank``'s place in its group along ``axis``."""
        x, y = divmod(rank, self.b)
        self.size(axis)
        return x if axis == "aq" else y

    def groups(self, axis: str) -> List[List[int]]:
        """Every group along ``axis``, each in member order."""
        lead = range(self.b) if axis == "aq" else range(0, self.n, self.b)
        return [self.members(axis, r) for r in lead]


def _seq_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ... in this order (the same bits on every
    transport)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc


class _GroupGather(torch.autograd.Function):
    """x [R, ...] -> [R, G, ...]; the gradient is the group reduce-scatter."""

    @staticmethod
    def forward(ctx, x, ring, grid, axis, split):
        ctx.ring, ctx.grid, ctx.axis = ring, grid, axis
        if not split or x.dim() < 2 or x.shape[-1] < 2:
            return ring._group_gather(x.contiguous(), grid, axis)
        h = x.shape[-1] // 2
        return torch.cat([ring._group_gather(x[..., :h].contiguous(), grid, axis),
                          ring._group_gather(x[..., h:].contiguous(), grid, axis)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring._group_scatter(g.contiguous(), ctx.grid, ctx.axis), None, None, None, None


class _GroupScatter(torch.autograd.Function):
    """x [R, G, ...] -> [R, ...]; the gradient is the group all-gather."""

    @staticmethod
    def forward(ctx, x, ring, grid, axis):
        ctx.ring, ctx.grid, ctx.axis = ring, grid, axis
        return ring._group_scatter(x.contiguous(), grid, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring._group_gather(g.contiguous(), ctx.grid, ctx.axis), None, None, None


class _GroupCollectives:
    """The public group collectives of both transports: stats and autograd
    here, the transfers in each transport's ``_group_gather`` /
    ``_group_scatter``."""

    def _check_grid(self, grid: "Grid") -> None:
        if grid.n != self.n:
            raise ValueError(f"a {grid.a}x{grid.b} grid needs {grid.n} ranks, the ring has {self.n}")

    def group_all_gather(self, leaves: Sequence[Optional[torch.Tensor]], grid: "Grid", axis: str,
                         *, kind: str, mode: str = "overlap") -> List[Optional[torch.Tensor]]:
        """Each leaf [R, ...] -> [R, G, ...]: local rank r's group members'
        tensors along ``axis``, in member order (JAX's ``lax.all_gather``
        over that mesh axis).  ``bidir`` moves each leaf as two halves."""
        validate_comm_overlap(mode)
        self._check_grid(grid)
        live = [x for x in leaves if x is not None]
        split = mode == "bidir"
        per = sum(len(_halves(x)) if split else 1 for x in live)
        G = grid.size(axis)
        self.stats.add(kind, per, (G - 1) * _payload_bytes(live, len(self.ranks)))
        return [None if x is None else _GroupGather.apply(x, self, grid, axis, split)
                for x in leaves]

    def group_reduce_scatter(self, x: torch.Tensor, grid: "Grid", axis: str, *,
                             kind: str) -> torch.Tensor:
        """x [R, G, ...] (one slot per group member) -> [R, ...]: the sum,
        in member order, of the group's slots for local rank r (JAX's
        untiled ``lax.psum_scatter`` over that mesh axis)."""
        self._check_grid(grid)
        G = grid.size(axis)
        if x.shape[1] != G:
            raise ValueError(f"a reduce-scatter over {axis} takes {G} slots, got {x.shape[1]}")
        self.stats.add(kind, 1, (G - 1) * _payload_bytes([x], len(self.ranks) * G))
        return _GroupScatter.apply(x, self, grid, axis)


def _check_perm(perm: Perm, n: int) -> Dict[int, int]:
    """dst -> src of a full permutation of the n ranks."""
    src_of = {d: s for s, d in perm}
    if sorted(src_of) != list(range(n)) or sorted(src_of.values()) != list(range(n)):
        raise ValueError(f"a ring hop needs a permutation of all {n} ranks, got {list(perm)}")
    return src_of


class VirtualRing(_GroupCollectives):
    """All n ranks of the ring in one process, on one device."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs n >= 1 ranks, got {n}")
        self.n = n
        self.ranks: Tuple[int, ...] = tuple(range(n))
        self.stats = RingStats()
        self._index: Dict[tuple, torch.Tensor] = {}
        self._side: Dict[torch.device, torch.cuda.Stream] = {}

    def __repr__(self) -> str:
        return f"VirtualRing(n={self.n})"

    def _src_index(self, perm: Perm, device) -> torch.Tensor:
        key = (tuple(perm), device)
        if key not in self._index:
            src_of = _check_perm(perm, self.n)
            self._index[key] = torch.tensor(
                [src_of[d] for d in range(self.n)], dtype=torch.int64, device=device
            )
        return self._index[key]

    def hop(self, leaves: Sequence[Optional[torch.Tensor]], perm: Perm, *, kind: str,
            mode: str = "overlap") -> _Pending:
        validate_comm_overlap(mode)
        live = [x for x in leaves if x is not None]
        if not live:
            raise ValueError("a hop needs at least one tensor")
        device = live[0].device
        idx = self._src_index(perm, device)
        parts = (lambda x: _halves(x)) if mode == "bidir" else (lambda x: [x])

        def move(x):
            if x is None:
                return None
            pieces = [p.index_select(0, idx) for p in parts(x)]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)

        self.stats.add(kind, sum(len(parts(x)) for x in live), _payload_bytes(live, self.n))
        if mode == "serial" or device.type != "cuda":
            return _Pending([move(x) for x in leaves])
        # overlap / bidir on the card: the copies run on a side stream that
        # first waits for the producers on the compute stream; wait() makes
        # the compute stream wait for the copies
        main = torch.cuda.current_stream(device)
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device=device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = [move(x) for x in leaves]
        for x in live:
            x.record_stream(side)  # the source stays allocated until the copy ran
        done = torch.cuda.Event()
        done.record(side)

        def join():
            main.wait_event(done)
            for y in out:
                if y is not None:
                    y.record_stream(main)

        return _Pending(out, join)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """Tiled all-to-all of per-rank tensors x [n, *shape]: rank r gets
        chunk r (of n, along ``split_axis`` of ``shape``) of every rank s,
        concatenated in rank order along ``concat_axis``.  Differentiable."""
        n = self.n
        c = x.shape[1 + split_axis] // n
        y = x.unflatten(1 + split_axis, (n, c)).movedim(1 + split_axis, 0)  # [r, s, ...]
        k = 1 + concat_axis
        y = y.movedim(1, k).flatten(k, k + 1)
        return y.contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, m] -> [n, n*m]: every rank gets all ranks' rows in order."""
        return x.reshape(1, -1).expand(self.n, -1).contiguous()

    def _group_index(self, grid: Grid, axis: str, device) -> torch.Tensor:
        """[n, G] int64: rank c's group members along ``axis``."""
        key = ("group", grid, axis, device)
        if key not in self._index:
            self._index[key] = torch.tensor(
                [grid.members(axis, c) for c in range(self.n)], dtype=torch.int64, device=device
            )
        return self._index[key]

    def _group_gather(self, x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
        idx = self._group_index(grid, axis, x.device)
        return x.index_select(0, idx.flatten()).view(self.n, idx.shape[1], *x.shape[1:])

    def _group_scatter(self, x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
        # rank r gets x[c, index(r)] from each member c of its group, summed
        # in member order: the j-th term for every rank is one gather
        idx = self._group_index(grid, axis, x.device)  # [n, G]
        mine = torch.tensor([grid.index(axis, r) for r in range(self.n)], device=x.device)
        flat = x.reshape(self.n * x.shape[1], *x.shape[2:])
        return _seq_sum([flat.index_select(0, idx[:, j] * x.shape[1] + mine)
                         for j in range(idx.shape[1])])

    def gather_ranks(self, leaves: Sequence[torch.Tensor], *, kind: str) -> List[torch.Tensor]:
        """Every rank's leaves [n, ...], as each rank holds them after an
        all-gather (the exchange of the sequence-sharded decode's lse
        combine).  This process already holds every rank, so the leaves come
        back as they are, without a copy; the stats count one hop of
        ``kind`` with the bytes one rank sends."""
        self.stats.add(kind, len(leaves), _payload_bytes(leaves, self.n))
        return list(leaves)

    def split(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """The global view [..., S (at ``axis``), ...] as the n ranks' chunks
        [n, ..., S/n, ...] (rank r holds positions r*S/n .. (r+1)*S/n - 1 of
        the given order).  Differentiable."""
        n = self.n
        if x.shape[axis] % n:
            raise ValueError(f"length {x.shape[axis]} is not divisible by n={n}")
        return x.unflatten(axis, (n, x.shape[axis] // n)).movedim(axis, 0).contiguous()

    def join(self, y: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Inverse of ``split``: [n, ..., S/n, ...] -> [..., S, ...]."""
        return y.movedim(0, axis).flatten(axis, axis + 1)


# --------------------------------------------------------------------------
# one rank per process
# --------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """dist's tiled all-to-all of one rank's tensor; its gradient is the
    all-to-all with the axes swapped."""

    @staticmethod
    def forward(ctx, x, ring, split_axis, concat_axis):
        ctx.ring, ctx.axes = ring, (split_axis, concat_axis)
        return ring._all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return ctx.ring._all_to_all(g.contiguous(), concat_axis, split_axis), None, None, None


class _LocalChunk(torch.autograd.Function):
    """The global view (the same on every process) -> this rank's chunk
    [1, ...]; the gradient of the replicated input gathers every rank's."""

    @staticmethod
    def forward(ctx, x, ring, axis):
        ctx.ring, ctx.axis = ring, axis
        m = x.shape[axis] // ring.n
        return x.narrow(axis, ring.rank * m, m).unsqueeze(0).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.ring._gather(g[0].contiguous(), ctx.axis), None, None


class _GatherChunks(torch.autograd.Function):
    """This rank's chunk [1, ...] -> the global view on every process; each
    process's loss is the same replicated function of it, so the gradient of
    the chunk is its own slice of the output's gradient."""

    @staticmethod
    def forward(ctx, y, ring, axis):
        ctx.ring, ctx.axis = ring, axis
        return ring._gather(y[0].contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        ring, axis = ctx.ring, ctx.axis
        m = g.shape[axis] // ring.n
        return g.narrow(axis, ring.rank * m, m).unsqueeze(0).contiguous(), None, None


class ProcessGroupRing(_GroupCollectives):
    """One rank of the ring per process, over ``torch.distributed`` (gloo on
    the CPU, NCCL across cards).  ``group`` None is the default group."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupRing needs torch.distributed.init_process_group")
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks: Tuple[int, ...] = (self.rank,)
        self.stats = RingStats()
        self._subgroups: Dict[Tuple[Grid, str], object] = {}

    def __repr__(self) -> str:
        return f"ProcessGroupRing(n={self.n}, rank={self.rank})"

    def _subgroup(self, grid: Grid, axis: str):
        """This rank's ``dist`` subgroup along ``axis``.  ``new_group`` is
        collective: every process creates every group, in the same order."""
        key = (grid, axis)
        if key not in self._subgroups:
            mine = None
            for members in grid.groups(axis):
                pg = dist.new_group([self._peer(r) for r in members])
                if self.rank in members:
                    mine = pg
            self._subgroups[key] = mine
        return self._subgroups[key]

    def _group_gather(self, x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
        parts = [torch.empty_like(x[0]) for _ in range(grid.size(axis))]
        dist.all_gather(parts, x[0].contiguous(), group=self._subgroup(grid, axis))
        return torch.stack(parts).unsqueeze(0)

    def _group_scatter(self, x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
        got = torch.empty_like(x[0])  # got[j]: member j's slot for this rank
        dist.all_to_all_single(got, x[0].contiguous(), group=self._subgroup(grid, axis))
        return _seq_sum(list(got.unbind(0))).unsqueeze(0)

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def hop(self, leaves: Sequence[Optional[torch.Tensor]], perm: Perm, *, kind: str,
            mode: str = "overlap") -> _Pending:
        validate_comm_overlap(mode)
        src_of = _check_perm(perm, self.n)
        dst_of = {s: d for d, s in src_of.items()}
        dst, src = self._peer(dst_of[self.rank]), self._peer(src_of[self.rank])
        live = [x for x in leaves if x is not None]
        ops, recv = [], []
        for x in leaves:
            if x is None:
                recv.append(None)
                continue
            parts = _halves(x) if mode == "bidir" else [x]
            got = []
            for p in parts:
                p = p.contiguous()
                r = torch.empty_like(p)
                ops.append(dist.P2POp(dist.isend, p, dst, self.group))
                ops.append(dist.P2POp(dist.irecv, r, src, self.group))
                got.append(r)
            recv.append(got)
        self.stats.add(kind, len(ops) // 2, _payload_bytes(live, 1))
        reqs = dist.batch_isend_irecv(ops)
        out: List[Optional[torch.Tensor]] = [None] * len(recv)

        def join():
            for req in reqs:
                req.wait()
            for i, got in enumerate(recv):
                if got is not None:
                    out[i] = got[0] if len(got) == 1 else torch.cat(got, dim=-1)

        pending = _Pending(out, join)
        if mode == "serial":
            pending.wait()
        return pending

    def _all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        n = self.n
        x0 = x[0]
        c = x0.shape[split_axis] // n
        send = x0.unflatten(split_axis, (n, c)).movedim(split_axis, 0).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=self.group)
        return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1).unsqueeze(0) \
            .contiguous()

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """As ``VirtualRing.all_to_all`` for this rank's x [1, *shape]."""
        return _AllToAll.apply(x, self, split_axis, concat_axis)

    def _gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=axis)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [1, m] -> [1, n*m]: every rank's rows in rank order."""
        return self._gather(x[0].contiguous(), 0).unsqueeze(0)

    def split(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's chunk [1, ..., S/n, ...] of the global view (the same
        on every process).  Differentiable: the gradient of the global view
        gathers every rank's chunk."""
        if x.shape[axis] % self.n:
            raise ValueError(f"length {x.shape[axis]} is not divisible by n={self.n}")
        return _LocalChunk.apply(x, self, axis)

    def join(self, y: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Inverse of ``split``: every rank's chunk gathered into the global
        view on every process."""
        return _GatherChunks.apply(y, self, axis)
