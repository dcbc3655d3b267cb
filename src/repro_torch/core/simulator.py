"""Event-driven overlap simulator (paper Fig. 6 "estimate runtime" stage); a
copy of ``repro/core/simulator.py``, which imports no JAX.

Because every device in Mesh-Attention executes the identical lock-step
schedule (paper §3.2: the wrap-around mesh is fully symmetric), simulating a
single device's timeline yields the system's timeline.  The step cost is
``comm_overlap``-aware (the executor's knob, ``schedule.COMM_OVERLAP_MODES``):

  serial    step = comm + compute (every byte on the critical path, the
            hop-then-compute baseline), exposed = comm;
  overlap   step = max(payload, compute) + launch residual — communication
            issued at step start runs concurrently with the step's compute
            blocks (a side stream or asynchronous P2P requests), only the
            per-step launch cost α can never hide;
  bidir     as overlap, with each hop split across both ring directions, so
            the payload moves at per-direction link bandwidth (half the
            transfer time for the same bytes; ``make_cost_model`` bakes the
            halving into ``t_chunk``).

Ops on different rings within one step always run concurrently
(one link per ring).

The simulator powers:
  * the (a, b) autotuner (`core/autotune.py`),
  * the plan cache of ``core/dispatch.py``, through the same α-β
    ``HardwareModel`` profiles as the JAX package, so that both packages
    plan (and cache) identical schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import schedule as S
from repro_torch.core.am import CommModel

__all__ = ["HardwareModel", "CostModel", "SimResult", "simulate", "make_cost_model"]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """The JAX package's default α-β constants (its TPU v5e-class profile),
    kept equal so that plan-cache keys match across the packages; they
    describe no measurement of the port."""

    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bw: float = 819e9  # B/s
    link_bw: float = 50e9  # B/s per link
    attn_efficiency: float = 0.5  # achievable fraction of peak on flash blocks
    latency: float = 1e-6  # per-message fixed cost (α in α-β)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Seconds per compute block and per chunk transfer."""

    t_block: float
    t_chunk: Dict[str, float]  # comm-op kind -> seconds (launch cost included)
    block_flops: float
    t_launch: float = 0.0  # per-step comm issue cost (α) — never hidden

    def profile(self) -> S.Profile:
        """Convert to the scheduler's c_* constants (blocks per transfer)."""
        g = lambda k: self.t_chunk.get(k, 0.0) / self.t_block
        return S.Profile(
            c_q=g(S.RECV_Q),
            c_kv=g(S.RECV_KV),
            c_o=g(S.SEND_O),
            c_odoq=g(S.RECV_ODOQ),
            c_dq=g(S.SEND_DQ),
            c_dkv=g(S.SEND_DKV),
        )


@dataclasses.dataclass(frozen=True)
class SimResult:
    total: float  # seconds for the whole attention call
    compute: float  # pure compute time (sum of block times)
    comm: float  # pure serialized communication time
    exposed_comm: float  # communication NOT hidden by compute
    steps: int
    comm_bytes: int  # per-device bytes on the wire

    @property
    def overlap_efficiency(self) -> float:
        return self.compute / self.total if self.total else 1.0


def make_cost_model(
    comm: CommModel,
    hw: HardwareModel = HardwareModel(),
    *,
    causal: bool = False,
    backward: bool = False,
    mask=None,  # Optional[MaskSpec]: supersedes the causal flag
    comm_overlap: str = "overlap",
) -> CostModel:
    """α-β cost model for one (N, d, n) attention call.

    One compute block = flash attention between a Q chunk (m tokens) and a KV
    chunk (m tokens), m = batch·N/n: 4·m²·d FLOPs forward (QKᵀ and PV), 2.5×
    that backward (the five flash-backward matmuls), scaled by the mask's
    visible fraction (0.5 for plain causal; striping balances the saving
    across all blocks — paper §3.7; the flash kernels skip fully-masked
    tiles, recovering it block-wise).

    ``comm_overlap="bidir"`` halves the per-hop transfer time: the executor
    ships each chunk as a half-payload hop pair over both ring
    directions, so each half moves at full per-direction link bandwidth
    concurrently (the pair shares one launch).  Total bytes are unchanged.
    """
    S.validate_comm_overlap(comm_overlap)
    m = comm.batch * comm.seq / comm.n
    flops = 4.0 * m * m * comm.hidden
    if backward:
        flops *= 2.5
    if mask is not None:
        flops *= mask.visible_fraction(comm.seq)
    elif causal:
        flops *= 0.5
    t_block = flops / (hw.peak_flops * hw.attn_efficiency)
    eff_bw = hw.link_bw * (2.0 if comm_overlap == "bidir" else 1.0)
    t = lambda kind: hw.latency + comm.chunk_bytes(kind) / eff_bw
    t_chunk = {
        S.RECV_Q: t("q"),
        S.RECV_KV: t("kv"),
        S.SEND_O: t("o"),
        S.RECV_ODOQ: t("odoq"),
        S.SEND_DQ: t("dq"),
        S.SEND_DKV: t("dkv"),
    }
    return CostModel(
        t_block=t_block, t_chunk=t_chunk, block_flops=flops, t_launch=hw.latency
    )


_KIND_TO_CHUNK = {
    S.RECV_Q: "q",
    S.RECV_KV: "kv",
    S.SEND_O: "o",
    S.RECV_ODOQ: "odoq",
    S.SEND_DQ: "dq",
    S.SEND_DKV: "dkv",
}


def simulate(
    sched: S.Schedule,
    cost: CostModel,
    comm: Optional[CommModel] = None,
    comm_overlap: str = "overlap",
) -> SimResult:
    """Walk the lock-step schedule with the mode-dependent step cost.

    ``serial``: step = comm + compute, every transfer fully exposed.
    ``overlap``/``bidir``: step = max(payload, compute) + launch residual;
    exposed = the payload time compute could not cover, plus the residual.
    (``bidir`` also needs a ``make_cost_model(comm_overlap="bidir")`` cost so
    ``t_chunk`` reflects per-direction bandwidth.)
    """
    S.validate_comm_overlap(comm_overlap)
    total = 0.0
    compute_time = 0.0
    comm_time = 0.0
    exposed = 0.0
    comm_bytes = 0
    for step in sched.steps:
        t_comm = max((cost.t_chunk[c] for c in step.comms), default=0.0)
        t_comp = len(step.compute) * cost.t_block
        if comm_overlap == "serial":
            total += t_comm + t_comp
            exposed += t_comm
        else:
            resid = min(cost.t_launch, t_comm) if step.comms else 0.0
            payload = t_comm - resid
            total += max(payload, t_comp) + resid
            exposed += max(0.0, payload - t_comp) + resid
        compute_time += t_comp
        comm_time += sum(cost.t_chunk[c] for c in step.comms)
        if comm is not None:
            comm_bytes += sum(comm.chunk_bytes(_KIND_TO_CHUNK[c]) for c in step.comms)
    return SimResult(
        total=total,
        compute=compute_time,
        comm=comm_time,
        exposed_comm=exposed,
        steps=len(sched.steps),
        comm_bytes=comm_bytes,
    )
