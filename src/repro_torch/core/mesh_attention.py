"""Mesh-Attention: the distributed attention op (paper §3), the port's copy of
``repro/core/mesh_attention.py``.

Every array argument holds the chunks of the ranks this process keeps, with
a leading rank axis: q [R, B, S/n, H, D] for the ``R = len(cfg.transport.
ranks)`` local ranks of an n-way ring (R = n on a ``VirtualRing``, 1 on a
``ProcessGroupRing``).  Causal inputs must be in the *striped* layout of
``core.tiling.stripe_permutation``.  The op executes the greedy step program
from ``core/schedule.py`` verbatim:

  * ``Recv Q`` / ``Recv KV``  -> one transport hop per step on the Q-ring /
    KV-ring neighbour shifts (``TileLayout.q_shift_perm`` / ``kv_shift_perm``).
    Chunk u arrives after u hops (Table 1).
  * compute block (u, v)      -> flash blocks between Q slot u and KV slot v
    (kernel #1 forward; #2 dQ and #3 dK/dV backward), accumulated into the
    row's (o, lse) with the online-softmax combine.  The band of each block
    comes from the global chunk indices, which depend on the rank: host ints
    here, gathered for the whole call into one int32 tensor on the device.
    The forward folds the local ranks into the kernel's batch with one band
    per row ([R*B, 4]) when no segment ids ride along; otherwise, and in
    the backward (one band per launch), it launches once per local rank.
  * ``Send O``  (step t)      -> hop the completed row t+1 partial to the
    lower Q-ring neighbour; the received row (t+2 mod a) partial is folded
    in (online softmax as the reduce operator, Alg. 1 line 4).

Backward (Alg. 3) is one ``torch.autograd.Function``: its forward runs the
forward program and saves (q, k, v, o, lse); its backward runs the Algorithm
3 program -- circulate OdOQ (or the Δ bundle) + KV, reduce dQ along the Q
ring and dKV along the KV ring with plain sums -- so autograd never
differentiates the ring code.  ``a = 1`` degenerates to Ring-Attention.

Each step is an issue / compute / commit pipeline governed by
``cfg.comm_overlap`` (``schedule.COMM_OVERLAP_MODES``): the step's hops are
issued before its blocks (``serial``: completed before them) and land in
their slots at the step's end, where the received O / dQ / dKV partials are
also folded in.  The merges and sums run in the schedule's order whatever the
mode, so ``serial``, ``overlap`` and ``bidir`` are bitwise equal.  (JAX folds
a received partial in at issue; the port folds it in at commit, so the two
packages agree to rounding, not bitwise.)

MLA's latent wire (``mesh_attention_wire``, JAX's beyond-paper path) runs
the same forward program with a ``kv_transform``: the KV ring carries an
opaque wire chunk (MLA's latent, one "head" of kv_lora_rank + rope), and
each received slot is expanded to per-head (k, v) once, at its first use.
It has no Algorithm-3 rule: under autograd the program runs outside any
``autograd.Function`` -- blocks through ``ops.differentiable_block_attention``,
hops through the ring's index selects, the merges in plain PyTorch -- so
autograd differentiates it as ``jax.grad`` does JAX's.  That needs every
rank in the process (a ``VirtualRing``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import schedule as S
from repro_torch.core.masking import MaskSpec
from repro_torch.core.tiling import TileLayout
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BAND_INF, NEG_INF

__all__ = ["MeshAttentionConfig", "mesh_attention", "mesh_attention_with_lse",
           "mesh_attention_wire"]

Band = Tuple[int, int, int, int]
FULL_BAND: Band = (0, 0, -BAND_INF, BAND_INF)
EMPTY_BAND: Band = (0, 0, 1, 0)  # lo > hi: nothing visible


@dataclasses.dataclass(frozen=True)
class MeshAttentionConfig:
    """Static configuration of one call.  ``transport`` (a ``VirtualRing`` or
    ``ProcessGroupRing`` of ``parallel/ring.py``) takes the place of JAX's
    ``axis_name``.  The mask is a first-class :class:`MaskSpec`; the legacy
    ``causal`` / ``window`` pair is normalized through :meth:`mask_spec`."""

    transport: object
    n: int  # ranks on the sequence-parallel ring
    a: int  # tile height; b = n // a; a=1 == Ring-Attention
    causal: bool = False
    window: Optional[int] = None  # sliding-window width (causal only)
    layout: str = "striped"  # striped (paper §3.7) | contiguous (SSM/hybrid)
    scale: Optional[float] = None
    fwd_schedule: Optional[S.Schedule] = None
    bwd_schedule: Optional[S.Schedule] = None
    bwd_wire: str = "qdod"  # "odoq" = paper wire (circulates O); "qdod" = Δ-trick
    block_q: int = 128
    block_kv: int = 128
    allow_concurrent_rings: bool = False
    mask: Optional[MaskSpec] = None  # takes precedence over causal/window
    comm_overlap: str = "overlap"

    def __post_init__(self):
        S.validate_comm_overlap(self.comm_overlap)
        if self.n % self.a:
            raise ValueError(f"a={self.a} must divide n={self.n}")
        if self.transport is not None and self.transport.n != self.n:
            raise ValueError(f"the transport has {self.transport.n} ranks, the config n={self.n}")
        if self.mask is not None and (self.causal or self.window is not None):
            raise ValueError("pass either mask= or the legacy causal/window flags, not both")
        if self.window is not None and not self.causal:
            raise ValueError("sliding window requires causal=True")
        if self.bwd_wire not in ("odoq", "qdod"):
            raise ValueError(self.bwd_wire)
        if self.layout not in ("striped", "contiguous"):
            raise ValueError(self.layout)

    @property
    def b(self) -> int:
        return self.n // self.a

    def mask_spec(self) -> MaskSpec:
        if self.mask is not None:
            return self.mask
        return MaskSpec.from_flags(self.causal, self.window)

    def schedules(self, seq: Optional[int] = None) -> Tuple[S.Schedule, S.Schedule]:
        """(fwd, bwd) schedules, mask-pruned when the mask proves slot blocks
        empty on every rank.  ``seq`` is the GLOBAL sequence length (needed
        to classify window/document blocks; None skips pruning)."""
        skip: frozenset = frozenset()
        if seq is not None:
            skip = self.mask_spec().empty_blocks(
                self.a, self.b, layout=self.layout, n=self.n, seq=seq
            )
        fwd = self.fwd_schedule or S.greedy_forward_schedule(
            self.a, self.b, allow_concurrent_rings=self.allow_concurrent_rings,
            skip_blocks=skip,
        )
        bwd = self.bwd_schedule or S.greedy_backward_schedule(
            self.a, self.b, allow_concurrent_rings=self.allow_concurrent_rings,
            skip_blocks=skip,
        )
        if (fwd.a, fwd.b) != (self.a, self.b) or (bwd.a, bwd.b) != (self.a, self.b):
            raise ValueError("schedule shape mismatch with (a, b)")
        for sched in (fwd, bwd):
            # a provided schedule may skip fewer blocks (e.g. an unpruned
            # baseline) but never blocks the mask cannot prove empty
            extra = set(sched.skip) - set(skip) if seq is not None else None
            if extra:
                raise ValueError(f"schedule skips non-empty blocks: {sorted(extra)}")
        S.validate_schedule(fwd)
        S.validate_schedule(bwd)
        return fwd, bwd


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _band_for_block(cfg: MeshAttentionConfig, i: int, u: int, v: int, m_q: int, m_kv: int):
    """(band, stride_q, stride_kv) of AM block (u, v) on rank i, host ints.

    striped layout: token t of global chunk c has position c + n*t  (stride n)
    contiguous layout: position c*m + t                              (stride 1)

    The band carries the positional part of the mask (causal / window /
    block-sparse bitmap); segment ids compose inside the kernel via the seg
    operands the rings circulate alongside Q and KV.
    """
    spec = cfg.mask_spec()
    if spec.kind == "full":
        return FULL_BAND, 1, 1
    qc = cfg.a * (i // cfg.a) + (i + u) % cfg.a  # global Q chunk (Table 1)
    kc = (i + cfg.a * v) % cfg.n  # global KV chunk (Table 1)
    if spec.kind == "block_sparse":
        # an invisible block (kept lock-step because some OTHER rank needs
        # it) gets an impossible band, so its partial is exactly empty
        return (FULL_BAND if spec.bitmap[qc][kc] else EMPTY_BAND), 1, 1
    lo, hi = spec.band()  # causal kinds: 0 <= q_pos - kv_pos (<= window-1)
    if cfg.layout == "striped":
        return (qc, kc, lo, hi), cfg.n, cfg.n
    return (qc * m_q, kc * m_kv, lo, hi), 1, 1


def _combine_f32(o1, lse1, o2, lse2):
    """Online-softmax combine with fp32 output accumulators.

    o: [..., S, H, D] fp32; lse: [..., H, S] fp32."""
    m = torch.maximum(lse1, lse2).clamp_min(NEG_INF)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    tot = w1 + w2
    live = tot > 0
    tot_safe = torch.where(live, tot, torch.ones_like(tot))
    c1 = (w1 / tot_safe).transpose(-1, -2)[..., None]
    c2 = (w2 / tot_safe).transpose(-1, -2)[..., None]
    o = o1 * c1 + o2 * c2
    lse = torch.where(live, m + torch.log(tot_safe), torch.full_like(m, NEG_INF))
    return o, lse


def _merge(acc: Optional[tuple], o, lse):
    o = o.float()
    lse = lse.float()
    if acc is None:
        return o, lse
    return _combine_f32(acc[0], acc[1], o, lse)


def _add(cur, new):
    new = new.float()
    return new if cur is None else cur + new


class _Bands:
    """Every computed block's band on every local rank, host ints, gathered
    into one int32 tensor on the device: the kernels read their band from
    device memory, and one copy per call keeps host-to-device copies out of
    the block loop."""

    def __init__(self, cfg: MeshAttentionConfig, sched: S.Schedule, m: int, batch: int, device):
        ranks = cfg.transport.ranks
        self.index: Dict[Tuple[int, int], int] = {}
        self.strides = (1, 1)
        rows = []
        for blk in sched.blocks():
            per_rank = []
            for i in ranks:
                band, sq, skv = _band_for_block(cfg, i, blk[0], blk[1], m, m)
                per_rank.append(band)
                self.strides = (sq, skv)
            self.index[blk] = len(rows)
            rows.append(per_rank)
        table = torch.tensor(rows, dtype=torch.int32).reshape(len(rows), len(ranks), 4)
        # the forward's folded launch: one band per (rank, batch row)
        per_row = table.repeat_interleave(batch, dim=1)
        if torch.device(device).type == "cuda":  # copied without stalling the host
            table, per_row = table.pin_memory(), per_row.pin_memory()
        self.per_rank = table.to(device, non_blocking=True)  # [blocks, R, 4]
        self.per_row = per_row.to(device, non_blocking=True)  # [blocks, R*B, 4]

    def rank(self, blk, r: int) -> torch.Tensor:
        return self.per_rank[self.index[blk], r]

    def rows(self, blk) -> torch.Tensor:
        return self.per_row[self.index[blk]]


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[R, B, ...] -> [R*B, ...] (a view: x is contiguous)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


# --------------------------------------------------------------------------
# forward program (Algorithm 2 structure)
# --------------------------------------------------------------------------


def _fwd_block(cfg, bands: _Bands, blk, q_slot, kv_slot, scale):
    """Block (u, v) on every local rank -> (o [R,B,m,H,D], lse [R,B,H,m]),
    through the block op with an autograd rule (used under grad by the
    latent wire alone; its backward one launch pair per rank)."""
    q_u, s_q = q_slot
    k_v, v_v, s_kv = kv_slot
    R, B = q_u.shape[0], q_u.shape[1]
    sq, skv = bands.strides
    kw = dict(scale=scale, stride_q=sq, stride_kv=skv, block_q=cfg.block_q,
              block_kv=cfg.block_kv)
    attend = ops.differentiable_block_attention
    if s_q is None:
        o, lse = attend(_fold(q_u), _fold(k_v), _fold(v_v), bands.rows(blk), groups=R, **kw)
        return o.view(R, B, *o.shape[1:]), lse.view(R, B, *lse.shape[1:])
    outs = [
        attend(q_u[r], k_v[r], v_v[r], bands.rank(blk, r), seg_q=s_q[r], seg_kv=s_kv[r], **kw)
        for r in range(R)
    ]
    return torch.stack([o for o, _ in outs]), torch.stack([lse for _, lse in outs])


def _fwd_program(q, k, v, cfg: MeshAttentionConfig, seg=None, kv_transform=None):
    """-> (o [R,B,m,H,D] in q's type, lse [R,B,H,m] fp32).  ``seg`` (int32
    [R, m], the local chunks of the segment-id array) rides the rings
    alongside Q and KV for document/segment masks; mask-pruned blocks are
    simply absent from the (possibly shorter) schedule, with the send
    counters re-based so the surviving ring reduce stays aligned.

    ``kv_transform`` (the latent wire): ``k`` is then an opaque wire chunk
    that circulates on the KV ring in place of (k, v), and
    ``kv_transform(chunk) -> (k, v)`` expands each received slot once, at
    its first use (without it the slots hold (k, v) as they are).  Under
    grad autograd differentiates the program: the blocks' op has a rule."""
    T = cfg.transport
    n, a = cfg.n, cfg.a
    lay = TileLayout(n, a)
    scale = cfg.scale if cfg.scale is not None else q.shape[-1] ** -0.5
    m = q.shape[2]
    sched, _ = cfg.schedules(n * m)
    bands = _Bands(cfg, sched, m, q.shape[1], q.device)
    q_perm, kv_perm = lay.q_shift_perm(), lay.kv_shift_perm()
    mode = cfg.comm_overlap

    qs: Dict[int, tuple] = {0: (q, seg)}
    if kv_transform is None:
        kv_transform, kv0 = (lambda k_, v_: (k_, v_)), (k, v)
    else:
        kv0 = (k,)
    kvs: Dict[int, tuple] = {0: (*kv0, seg)}
    kv_used: Dict[int, tuple] = {}

    def kv_at(slot: int):  # a slot's (k, v, seg), expanded once, at first use
        if slot not in kv_used:
            *bufs, s_kv = kvs[slot]
            kv_used[slot] = (*kv_transform(*bufs), s_kv)
        return kv_used[slot]

    o_acc: Dict[int, Optional[tuple]] = {u: None for u in range(a)}
    nq = nkv = 0
    # leading sends over fully-pruned rows are absent; re-base the counter
    nsend = (a - 1) - sum(1 for c in sched.comm_ops() if c == S.SEND_O)

    for step in sched.steps:
        # issue phase: the step's hops go out ahead of its blocks
        pending: List[tuple] = []
        for comm in step.comms:
            if comm == S.RECV_Q:
                pending.append(("q", T.hop(qs[nq], q_perm, kind=comm, mode=mode)))
            elif comm == S.RECV_KV:
                pending.append(("kv", T.hop(kvs[nkv], kv_perm, kind=comm, mode=mode)))
            elif comm == S.SEND_O:
                dst = (nsend + 2) % a  # row whose partial arrives (Table 1)
                pending.append((dst, T.hop(o_acc[nsend + 1], q_perm, kind=comm, mode=mode)))
                nsend += 1
            else:  # pragma: no cover
                raise ValueError(comm)
        # compute phase: the step's blocks, from previously delivered slots
        for (u, vv) in step.compute:
            o_b, l_b = _fwd_block(cfg, bands, (u, vv), qs[u], kv_at(vv), scale)
            o_acc[u] = _merge(o_acc[u], o_b, l_b)
        # commit phase: the transfers land in the next slots; received O partials
        # fold into their rows
        for key, hop in pending:
            got = hop.wait()
            if key == "q":
                nq += 1
                qs[nq] = tuple(got)
            elif key == "kv":
                nkv += 1
                kvs[nkv] = tuple(got)
            else:
                o_acc[key] = _merge(o_acc[key], *got)

    if o_acc[0] is None:  # every local-row block mask-pruned
        R, B, _, H, _ = q.shape
        return torch.zeros_like(q), torch.full((R, B, H, m), NEG_INF, device=q.device)
    o_f, lse_f = o_acc[0]
    return o_f.to(q.dtype), lse_f


# --------------------------------------------------------------------------
# backward program (Algorithm 3 structure)
# --------------------------------------------------------------------------


def _bwd_block(cfg, bands: _Bands, blk, bundle, kv_slot, scale):
    """Block (u, v) backward on every local rank, one launch pair per rank
    (the backward takes one band per call) -> (dq, dk, dv), [R, ...] each."""
    q_u, do_u, lse_u, delta_u, o_u, s_q = bundle
    k_v, v_v, s_kv = kv_slot
    sq, skv = bands.strides
    outs = [
        ops.block_attention_bwd(
            q_u[r], k_v[r], v_v[r], None if o_u is None else o_u[r], lse_u[r], do_u[r],
            bands.rank(blk, r), scale=scale, stride_q=sq, stride_kv=skv,
            block_q=cfg.block_q, block_kv=cfg.block_kv, delta=delta_u[r],
            seg_q=None if s_q is None else s_q[r], seg_kv=None if s_kv is None else s_kv[r],
        )
        for r in range(q_u.shape[0])
    ]
    return tuple(torch.stack(g) for g in zip(*outs))


def _bwd_program(cfg: MeshAttentionConfig, q, k, v, o, lse, do, seg=None):
    T = cfg.transport
    n, a, b = cfg.n, cfg.a, cfg.b
    lay = TileLayout(n, a)
    scale = cfg.scale if cfg.scale is not None else q.shape[-1] ** -0.5
    m = q.shape[2]
    _, sched = cfg.schedules(n * m)
    bands = _Bands(cfg, sched, m, q.shape[1], q.device)
    q_perm, kv_perm = lay.q_shift_perm(), lay.kv_shift_perm()
    mode = cfg.comm_overlap

    delta = torch.sum(do.float() * o.float(), dim=-1)  # [R, B, m, H]
    # the Q ring circulates the "OdOQ" bundle (paper wire) or the Δ-trick
    # bundle (rowsum(dO·O) replaces the full O chunk): (q, do, lse, delta,
    # o or None, seg or None)
    qb: Dict[int, tuple] = {0: (q, do, lse, delta, o if cfg.bwd_wire == "odoq" else None, seg)}
    kvs: Dict[int, tuple] = {0: (k, v, seg)}
    dq_acc: Dict[int, Optional[torch.Tensor]] = {u: None for u in range(a)}
    dkv_acc: Dict[int, Optional[tuple]] = {u: None for u in range(b)}
    nq = nkv = 0
    # leading sends over fully-pruned rows/cols are absent; re-base counters
    ndq = (a - 1) - sum(1 for c in sched.comm_ops() if c == S.SEND_DQ)
    ndkv = (b - 1) - sum(1 for c in sched.comm_ops() if c == S.SEND_DKV)

    for step in sched.steps:
        pending: List[tuple] = []
        for comm in step.comms:
            if comm == S.RECV_ODOQ:
                pending.append(("q", None, T.hop(qb[nq], q_perm, kind=comm, mode=mode)))
            elif comm == S.RECV_KV:
                pending.append(("kv", None, T.hop(kvs[nkv], kv_perm, kind=comm, mode=mode)))
            elif comm == S.SEND_DQ:
                hop = T.hop((dq_acc[ndq + 1],), q_perm, kind=comm, mode=mode)
                pending.append(("dq", (ndq + 2) % a, hop))
                ndq += 1
            elif comm == S.SEND_DKV:
                hop = T.hop(dkv_acc[ndkv + 1], kv_perm, kind=comm, mode=mode)
                pending.append(("dkv", (ndkv + 2) % b, hop))
                ndkv += 1
            else:  # pragma: no cover
                raise ValueError(comm)
        for (u, vv) in step.compute:
            dq_b, dk_b, dv_b = _bwd_block(cfg, bands, (u, vv), qb[u], kvs[vv], scale)
            dq_acc[u] = _add(dq_acc[u], dq_b)
            cur = dkv_acc[vv]
            dkv_acc[vv] = (_add(None if cur is None else cur[0], dk_b),
                           _add(None if cur is None else cur[1], dv_b))
        for key, dst, hop in pending:
            got = hop.wait()
            if key == "q":
                nq += 1
                qb[nq] = tuple(got)
            elif key == "kv":
                nkv += 1
                kvs[nkv] = tuple(got)
            elif key == "dq":
                dq_acc[dst] = _add(dq_acc[dst], got[0])
            else:
                cur = dkv_acc[dst]
                dkv_acc[dst] = (_add(None if cur is None else cur[0], got[0]),
                                _add(None if cur is None else cur[1], got[1]))

    dq = torch.zeros_like(q) if dq_acc[0] is None else dq_acc[0].to(q.dtype)
    if dkv_acc[0] is None:
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    return dq, dkv_acc[0][0].to(k.dtype), dkv_acc[0][1].to(v.dtype)


# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------


class _MeshAttention(torch.autograd.Function):
    """Forward: the Algorithm 2 program, saving (q, k, v, o, lse); backward:
    the Algorithm 3 program from them.  ``seg`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, cfg):
        o, lse = _fwd_program(q, k, v, cfg, seg=seg)
        ctx.save_for_backward(q, k, v, o, lse, seg)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = _bwd_program(ctx.cfg, q, k, v, o, lse, do.contiguous(), seg=seg)
        return dq, dk, dv, None, None


def _local_band(cfg: MeshAttentionConfig) -> Band:
    """Static band for the n == 1 degenerate path."""
    spec = cfg.mask_spec()
    if spec.kind == "block_sparse":
        if len(spec.bitmap) != cfg.n:
            raise ValueError(
                f"block_sparse bitmap is {len(spec.bitmap)}x{len(spec.bitmap)}, "
                f"but the sequence is split n={cfg.n} ways"
            )
        return FULL_BAND if spec.bitmap[0][0] else EMPTY_BAND
    lo, hi = spec.band()
    return (0, 0, lo, hi)


def _check_chunks(q, k, v, cfg: MeshAttentionConfig, seg) -> None:
    R = len(cfg.transport.ranks)
    if q.dim() != 5 or q.shape[0] != R or k.shape[:3] != q.shape[:3] or v.shape != k.shape:
        raise ValueError(
            f"mesh attention takes the local ranks' chunks q [R={R}, B, S/n, H, D] and k, v "
            f"[R, B, S/n, Hkv, D]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if seg is not None and tuple(seg.shape) != (R, q.shape[2]):
        raise ValueError(f"seg must be [R, S/n] = {(R, q.shape[2])}, got {tuple(seg.shape)}")


def mesh_attention(q, k, v, cfg: MeshAttentionConfig, seg=None):
    """Distributed attention over the local ranks' chunks.

    q: [R, B, S/n, H, D]; k, v: [R, B, S/n, Hkv, D] -> o: [R, B, S/n, H, D].
    Causal inputs must be striped (token t on chunk t mod n).  ``seg`` is the
    local [R, S/n] int32 segment-id chunks for document/segment masks."""
    spec = cfg.mask_spec()
    if spec.needs_segments and seg is None:
        raise ValueError(f"mask kind {spec.kind!r} needs a segment-id operand")
    _check_chunks(q, k, v, cfg, seg)
    if seg is not None:
        seg = seg.to(torch.int32)
    if cfg.n == 1:
        s0 = None if seg is None else seg[0]
        return ops.flash_attention(
            q[0], k[0], v[0], band=_local_band(cfg), scale=cfg.scale, seg_q=s0, seg_kv=s0,
        ).unsqueeze(0)
    return _MeshAttention.apply(q, k, v, seg, cfg)


def mesh_attention_wire(q, wire, cfg: MeshAttentionConfig, kv_transform, seg=None):
    """Mesh-Attention with a compressed KV wire (JAX's beyond-paper path).

    ``wire``: the local ranks' chunks [R, B, S/n, ...] of whatever should
    circulate on the KV ring (MLA's latent [R, B, S/n, 1, kvr + rope]);
    ``kv_transform(chunk) -> (k, v)`` expands one chunk, batch [B], per head
    at its first use.  q: [R, B, S/n, H, D] -> o: [R, B, S/n, H, D].
    Without grad it is the forward program as serving runs it; under grad
    autograd differentiates the program (no Algorithm-3 rule), which needs
    every rank in the process: on a ProcessGroupRing a wire whose q, wire or
    expansion requires grad raises, and a forward on tensors that need no
    gradient runs in any grad mode."""
    spec = cfg.mask_spec()
    if spec.needs_segments and seg is None:
        raise ValueError(f"mask kind {spec.kind!r} needs a segment-id operand")
    R = len(cfg.transport.ranks)
    if q.dim() != 5 or q.shape[0] != R or wire.shape[:3] != q.shape[:3]:
        raise ValueError(
            f"the latent wire takes the local ranks' chunks q [R={R}, B, S/n, H, D] and the "
            f"wire [R, B, S/n, ...]; got {tuple(q.shape)}, {tuple(wire.shape)}"
        )
    if seg is not None:
        seg = seg.to(torch.int32)
    B = q.shape[1]

    def refuse_grad(*ts):
        """A ProcessGroupRing's hops are plain P2P calls, which autograd
        cannot follow: a wire that gradients must cross is refused there."""
        if R < cfg.n and torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            raise NotImplementedError(
                "the latent wire under autograd differentiates the ring's hops, which a "
                "ProcessGroupRing runs as plain P2P calls: ROADMAP A.9 (multi-process sequence "
                "parallelism)"
            )

    refuse_grad(q, wire)

    def expand(chunk):  # [R, B, m, ...] -> per-head k, v [R, B, m, H, D]
        k, v = kv_transform(_fold(chunk))
        refuse_grad(k, v)  # the transform's own weights may want a gradient
        return k.reshape(R, B, *k.shape[1:]), v.reshape(R, B, *v.shape[1:])

    return _fwd_program(q, wire, None, cfg, seg=seg, kv_transform=expand)[0]


def mesh_attention_with_lse(q, k, v, cfg: MeshAttentionConfig, seg=None):
    """Forward-only variant exposing the log-sum-exp [R, B, H, S/n] (tests,
    serving); no autograd rule."""
    _check_chunks(q, k, v, cfg, seg)
    if seg is not None:
        seg = seg.to(torch.int32)
    with torch.no_grad():
        return _fwd_program(q, k, v, cfg, seg=seg)
