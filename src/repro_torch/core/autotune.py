"""Tile-shape + schedule autotuning (paper Figure 6); a copy of
``repro/core/autotune.py``, which imports no JAX.

For a given attention shape and device count n, enumerate every factorization
n = a × b, derive the overlap profile (c_Q, c_KV, …) from the α-β hardware
model (on real hardware: from measurement — the `Profile` type is shared),
generate the greedy schedule, estimate runtime with the event simulator, and
pick the fastest plan.  The result feeds the distributed op, which
executes the chosen schedule step-for-step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import schedule as S
from repro_torch.core.am import CommModel
from repro_torch.core.masking import MaskSpec
from repro_torch.core.simulator import CostModel, HardwareModel, SimResult, make_cost_model, simulate
from repro_torch.core.tiling import factorizations

__all__ = ["TilePlan", "tune", "plan_for"]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    a: int
    b: int
    fwd: S.Schedule
    bwd: Optional[S.Schedule]
    fwd_sim: SimResult
    bwd_sim: Optional[SimResult]
    profile: S.Profile

    @property
    def total(self) -> float:
        return self.fwd_sim.total + (self.bwd_sim.total if self.bwd_sim else 0.0)

    @property
    def comm_bytes(self) -> int:
        return self.fwd_sim.comm_bytes + (self.bwd_sim.comm_bytes if self.bwd_sim else 0)


def _plan(
    comm: CommModel,
    a: int,
    hw: HardwareModel,
    *,
    causal: bool,
    with_backward: bool,
    allow_concurrent_rings: bool,
    mask: Optional[MaskSpec] = None,
    layout: str = "striped",
    comm_overlap: str = "overlap",
) -> TilePlan:
    b = comm.n // a
    S.validate_comm_overlap(comm_overlap)
    mask = mask if mask is not None else MaskSpec.from_flags(causal)
    # mask-empty slot blocks are pruned from BOTH schedules (their dQ/dKV is
    # zero), which shortens the simulated comm and compute alike.  An
    # analytic seq that does not divide n has no well-defined chunking, so
    # such plans stay unpruned (conservative).
    skip: frozenset = frozenset()
    if comm.seq % comm.n == 0:
        skip = mask.empty_blocks(a, b, layout=layout, n=comm.n, seq=comm.seq)
    # bidir halves t_chunk (per-direction bandwidth), which shrinks the
    # profile's c_* hiding requirements: the greedy search then co-schedules
    # fewer blocks per transfer and prefers tiles whose comm actually hides
    fwd_cost = make_cost_model(
        comm, hw, backward=False, mask=mask, comm_overlap=comm_overlap
    )
    bwd_cost = make_cost_model(
        comm, hw, backward=True, mask=mask, comm_overlap=comm_overlap
    )
    if skip:
        # visible_fraction averages over ALL a*b blocks, but the pruned
        # schedule only runs the survivors — rescale so the per-block time
        # reflects the visible work concentrated in the surviving blocks
        concentrate = (a * b) / (a * b - len(skip))
        fwd_cost = dataclasses.replace(fwd_cost, t_block=fwd_cost.t_block * concentrate)
        bwd_cost = dataclasses.replace(bwd_cost, t_block=bwd_cost.t_block * concentrate)
    fwd_profile = fwd_cost.profile()
    fwd = S.greedy_forward_schedule(
        a, b, fwd_profile, allow_concurrent_rings=allow_concurrent_rings, skip_blocks=skip
    )
    S.validate_schedule(fwd, strict_paper=not allow_concurrent_rings)
    fwd_sim = simulate(fwd, fwd_cost, comm, comm_overlap=comm_overlap)
    bwd = bwd_sim = None
    if with_backward:
        bwd = S.greedy_backward_schedule(
            a, b, bwd_cost.profile(), allow_concurrent_rings=allow_concurrent_rings,
            skip_blocks=skip,
        )
        S.validate_schedule(bwd, strict_paper=not allow_concurrent_rings)
        bwd_sim = simulate(bwd, bwd_cost, comm, comm_overlap=comm_overlap)
    return TilePlan(a=a, b=b, fwd=fwd, bwd=bwd, fwd_sim=fwd_sim, bwd_sim=bwd_sim, profile=fwd_profile)


def tune(
    comm: CommModel,
    hw: HardwareModel = HardwareModel(),
    *,
    causal: bool = False,
    with_backward: bool = True,
    allow_concurrent_rings: bool = False,
    candidates: Optional[List[int]] = None,
    mask: Optional[MaskSpec] = None,
    layout: str = "striped",
    comm_overlap: str = "overlap",
) -> TilePlan:
    """Figure-6 flow: profile -> greedy schedule -> simulate -> argmin.

    ``mask`` supersedes the legacy ``causal`` flag; mask structure changes
    both the per-block cost (visible fraction) and the schedule itself
    (pruned blocks/comm), so it can shift the optimal tile shape.
    ``comm_overlap`` selects the executor's step-cost model (serial |
    overlap | bidir) — hidden comm is free under overlap, so the optimum can
    move relative to the serial model.
    """
    if candidates is None:
        candidates = [a for a, _ in factorizations(comm.n)]
    plans = [
        _plan(
            comm,
            a,
            hw,
            causal=causal,
            with_backward=with_backward,
            allow_concurrent_rings=allow_concurrent_rings,
            mask=mask,
            layout=layout,
            comm_overlap=comm_overlap,
        )
        for a in candidates
    ]
    return min(plans, key=lambda p: p.total)


def plan_for(
    comm: CommModel,
    a: int,
    hw: HardwareModel = HardwareModel(),
    *,
    causal: bool = False,
    with_backward: bool = True,
    allow_concurrent_rings: bool = False,
    mask: Optional[MaskSpec] = None,
    layout: str = "striped",
    comm_overlap: str = "overlap",
) -> TilePlan:
    """Plan for a fixed tile height (a=1 reproduces Ring-Attention)."""
    return _plan(
        comm,
        a,
        hw,
        causal=causal,
        with_backward=with_backward,
        allow_concurrent_rings=allow_concurrent_rings,
        mask=mask,
        layout=layout,
        comm_overlap=comm_overlap,
    )
