"""Algorithm 1's collective form: Mesh-Attention with group collectives (the
port's copy of ``repro/core/mesh_attention_collective.py``).

The paper's Algorithm 1 states the functional flow as whole-group
collectives -- all-gather Q in the Q group, all-gather KV in the KV group,
blockwise compute, reduce-scatter O with online softmax as the reduce
operator -- and §3.4 then *decomposes* them into ring P2P steps for
overlapping (``core/mesh_attention.py``).  This module runs Algorithm 1
directly over the ring transport's group collectives
(``parallel/ring.py``: ``group_all_gather`` / ``group_reduce_scatter`` over
a ``Grid(a, b)``, JAX's ``lax.all_gather`` / ``lax.psum_scatter`` over the
``aq`` / ``akv`` axes of a 2-D mesh).  It serves as a cross-check of the
ring decomposition: the same math, another communication.

Chunk layout: rank c = x*b + y holds global chunk c (positions c + n*t in
the striped layout of ``core.tiling.stripe_permutation``, c*m + t in the
contiguous one).  Its gathered Q set is the column {u*b + y : u < a} and its
KV set the row {x*b + w : w < b}, so every AM block is computed exactly once
and chunk c is in both sets.  The lse-weighted reduce-scatter over ``aq``
returns each rank exactly its own chunk's output.

Every (u, w) block is one launch of the flash forward (kernel #1) for all
the local ranks, folded into the launch's batch with one band per (rank,
row), as the executor's forward does; with segment ids it launches once per
local rank.  The op is differentiable, as JAX's is by autodiff: the block
sits in a ``torch.autograd.Function`` whose backward runs the dQ and dK/dV
kernels (#2, #3) through ``ops.block_attention_bwd`` once per local rank,
with the lse's gradient folded into Δ (d lse / d s = p, so ds = p * (dp - (Δ
- dlse))); the merges are plain differentiable tensor ops and the
collectives are each other's gradients.  The three ``comm_overlap`` modes
move the same values (bidir splits the gathers' leaves, never the
reductions), so they are bitwise equal.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import schedule as S
from repro_torch.core.mesh_attention import _combine_f32
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BAND_INF, NEG_INF
from repro_torch.parallel.ring import Grid

__all__ = ["mesh_attention_collective"]


class _Block(torch.autograd.Function):
    """One AM block for every local rank: (o, lse) of kernel #1 with one
    band per batch row ([R*B, 4]); the backward runs #2 / #3 per local rank
    (one band per launch) with the lse gradient folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, bands, seg_q, seg_kv, ranks, scale, stride_q, stride_kv):
        o, lse = ops.block_attention(q, k, v, bands, scale=scale, stride_q=stride_q,
                                     stride_kv=stride_kv, seg_q=seg_q, seg_kv=seg_kv)
        ctx.save_for_backward(q, k, v, o, lse, bands, seg_q, seg_kv)
        ctx.meta = (ranks, scale, stride_q, stride_kv)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, bands, seg_q, seg_kv = ctx.saved_tensors
        ranks, scale, stride_q, stride_kv = ctx.meta
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1)  # [RB, m, H]
        if dlse is not None:
            delta = delta - dlse.float().transpose(1, 2)
        rows = q.shape[0] // ranks
        grads = [
            ops.block_attention_bwd(
                q[sl], k[sl], v[sl], None, lse[sl], do[sl], bands[r * rows],
                scale=scale, stride_q=stride_q, stride_kv=stride_kv, delta=delta[sl],
                seg_q=seg_q, seg_kv=seg_kv,
            )
            for r in range(ranks)
            for sl in [slice(r * rows, (r + 1) * rows)]
        ]
        dq, dk, dv = (torch.cat(g) for g in zip(*grads))
        return dq, dk, dv, None, None, None, None, None, None, None


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[R, B, ...] -> [R*B, ...], contiguous (the kernels' layout; a slot of
    the gathered [R, G, B, ...] folds to a strided view when B = 1)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).contiguous()


def mesh_attention_collective(
    q: torch.Tensor,  # [R, B, m, H, D]: the local ranks' chunks
    k: torch.Tensor,  # [R, B, m, Hkv, D]
    v: torch.Tensor,
    ring,  # VirtualRing / ProcessGroupRing with n = a * b ranks
    a: int,  # tile height: the Q group's size
    b: int,  # tile width: the KV group's size
    *,
    causal: bool = False,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    mask=None,  # Optional[MaskSpec]; supersedes causal/window
    seg: Optional[torch.Tensor] = None,  # [R, m] int32 local segment-id chunks
    comm_overlap: str = "overlap",  # schedule.COMM_OVERLAP_MODES
) -> torch.Tensor:
    """Distributed attention by Algorithm 1's collectives -> o [R, B, m, H, D]
    in q's type.  Causal inputs must be in the layout ``layout`` names."""
    S.validate_comm_overlap(comm_overlap)
    grid = Grid(a, b)
    n = grid.n
    if ring.n != n:
        raise ValueError(f"a {a}x{b} grid needs {n} ranks, the ring has {ring.n}")
    if layout not in ("striped", "contiguous"):
        raise ValueError(layout)
    ranks = list(ring.ranks)
    R, B, m, H, D = q.shape
    if R != len(ranks) or k.shape[:3] != q.shape[:3] or v.shape != k.shape:
        raise ValueError(
            f"the collective takes the local ranks' chunks q [R={len(ranks)}, B, m, H, D] and "
            f"k, v [R, B, m, Hkv, D]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if scale is None:
        scale = D**-0.5
    if mask is not None:
        causal, window = mask.is_causal, mask.window
        if mask.needs_segments and seg is None:
            raise ValueError(f"mask kind {mask.kind!r} needs a segment-id operand")
    if seg is not None:
        seg = seg.to(torch.int32)
        if tuple(seg.shape) != (R, m):
            raise ValueError(f"seg must be [R, m] = {(R, m)}, got {tuple(seg.shape)}")

    # Algorithm 1 lines 1-2: group all-gathers (Q along aq, KV along akv)
    qs, seg_qs = ring.group_all_gather([q, seg], grid, "aq", kind="gather_q", mode=comm_overlap)
    ks, vs, seg_ks = ring.group_all_gather([k, v, seg], grid, "akv", kind="gather_kv",
                                           mode=comm_overlap)

    hi = (window - 1) if (causal and window) else BAND_INF
    stride = n if (causal and layout == "striped") else 1

    def band(c: int, u: int, w: int) -> List[int]:
        if not causal:
            return [0, 0, -BAND_INF, BAND_INF]
        x, y = divmod(c, b)
        qc, kc = u * b + y, x * b + w  # global chunk ids (row-major grid)
        if layout == "striped":
            return [qc, kc, 0, hi]
        return [qc * m, kc * m, 0, hi]

    # every block's bands for every (rank, batch row), one host-to-device copy
    table = torch.tensor([[[band(c, u, w)] * B for c in ranks] for u in range(a)
                          for w in range(b)], dtype=torch.int32)
    bands = table.reshape(a * b, R * B, 4).to(q.device)

    # Algorithm 1 line 3: blockwise compute, online-softmax accumulation
    o_rows, lse_rows = [], []
    for u in range(a):
        acc = None
        for w in range(b):
            blk = bands[u * b + w]
            if seg is None:
                o_b, l_b = _Block.apply(_fold(qs[:, u]), _fold(ks[:, w]), _fold(vs[:, w]), blk,
                                        None, None, R, scale, stride, stride)
            else:  # one segment-id array per launch: one launch per local rank
                outs = [_Block.apply(qs[r, u], ks[r, w], vs[r, w], blk[r * B:(r + 1) * B],
                                     seg_qs[r, u], seg_ks[r, w], 1, scale, stride, stride)
                        for r in range(R)]
                o_b = torch.cat([o for o, _ in outs])
                l_b = torch.cat([lse for _, lse in outs])
            o_b, l_b = o_b.float(), l_b.float()
            acc = (o_b, l_b) if acc is None else _combine_f32(acc[0], acc[1], o_b, l_b)
        o_rows.append(acc[0].view(R, B, m, H, D))
        lse_rows.append(acc[1].view(R, B, H, m))
    o_stack = torch.stack(o_rows, dim=1)  # [R, a, B, m, H, D]: partials for my Q set
    lse_stack = torch.stack(lse_rows, dim=1)  # [R, a, B, H, m]

    # Algorithm 1 line 4: reduce-scatter with online softmax as the reducer.
    # The lse across the Q group first (small), then the rescaled partials,
    # so rank x of the group receives exactly its own chunk (slot x)
    (lse_all,) = ring.group_all_gather([lse_stack], grid, "aq", kind="gather_lse")
    mx = torch.amax(lse_all, dim=1).clamp_min(NEG_INF)  # [R, a(slot), B, H, m]
    den = torch.sum(torch.exp(lse_all - mx[:, None]), dim=1)
    den = torch.where(den > 0, den, torch.ones_like(den))
    wgt = torch.exp(lse_stack - mx) / den  # my weight for each slot
    o_weighted = o_stack * wgt.transpose(-1, -2)[..., None]  # [R, a, B, m, H, D]
    o_mine = ring.group_reduce_scatter(o_weighted, grid, "aq", kind="scatter_o")
    return o_mine.to(q.dtype)
