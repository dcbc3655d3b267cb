"""Assignment-matrix communication model (paper §1, §3.1, §3.8, Table 2).

All volumes are *per device*, expressed either in
  * "chunk units" (1 unit = one Q-sized chunk = (N/n)·d elements — a KV chunk
    is 2 units, matching the paper's Figure-1 arithmetic), or
  * elements (scaled by N·d), via the closed forms of Table 2.

A copy of ``repro/core/am.py``, which imports no JAX.  These analytics drive
the autotuner's cost model and the checks that pin the executor's measured
communication (the transport's byte counters, ``parallel/ring.py``) to the
theory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.schedule import validate_comm_overlap
from repro_torch.core.tiling import TileLayout, best_square_a, factorizations

__all__ = [
    "CommModel",
    "ring_volume",
    "ulysses_volume",
    "startrail_volume",
    "mesh_volume",
    "mesh_volume_chunks",
    "commcom_ratio",
    "table2",
    "ppermute_pair_factor",
    "logical_ppermute_steps",
]


def ppermute_pair_factor(comm_overlap: str = "overlap") -> int:
    """Transport messages sent per logical ring hop.

    ``bidir`` ships every hop as a half-payload pair (one permute per ring
    direction) whose bytes sum to exactly one hop's traffic, so byte volumes
    stay mode-invariant while the raw op count doubles.  serial/overlap emit
    one permute per hop.
    """
    validate_comm_overlap(comm_overlap)
    return 2 if comm_overlap == "bidir" else 1


def logical_ppermute_steps(op_count: int, comm_overlap: str = "overlap") -> int:
    """Collapse a measured message count (``parallel/ring.py``'s
    ``messages``) to logical ring steps: a bidirectional half-payload pair is ONE step's
    traffic — its bytes are summed, its two ops are not two steps.  Keeps the
    measured-vs-theory comparison honest across comm_overlap modes."""
    factor = ppermute_pair_factor(comm_overlap)
    if op_count % factor:
        raise ValueError(
            f"{op_count} collective-permutes cannot be grouped into "
            f"half-payload pairs ({comm_overlap!r} expects multiples of {factor})"
        )
    return op_count // factor


def ring_volume(n: int) -> float:
    """Ring-Attention fwd per-device volume, in units of N*d elements.

    Each device receives n-1 KV chunks of size 2*N*d/n: (2 - 2/n)·N·d.
    """
    return 2.0 - 2.0 / n


def ulysses_volume(n: int) -> float:
    """DS-Ulysses: 4 all-to-alls (Q, K, V, O), each (n-1)/n^2·N·d per device."""
    return 4.0 * (n - 1) / (n * n)


def startrail_volume(n: int, C: Optional[float] = None) -> float:
    """StarTrail with attention-parallel size C (defaults to the paper's
    optimum C = sqrt(n/2)): ((4C-4)/n + 2/C)·N·d."""
    if C is None:
        C = math.sqrt(n / 2.0)
    return (4.0 * C - 4.0) / n + 2.0 / C


def mesh_volume(n: int, a: Optional[int] = None) -> float:
    """Mesh-Attention fwd per-device volume (paper §3.8).

    (a-1) Q chunks + (n/a - 1) KV chunks (x2 for K and V) + (a-1) O chunks,
    each chunk N*d/n elements: (2a/n + 2/a - 4/n)·N·d.
    """
    if a is None:
        a = best_square_a(n)
    b = n // a
    return ((a - 1) + 2.0 * (b - 1) + (a - 1)) / n


def mesh_volume_chunks(n: int, a: int) -> Dict[str, int]:
    """Chunk-count view used by the intro example and the scheduler."""
    return TileLayout(n, a).comm_chunks_per_device()


def commcom_ratio(n: int, a: int) -> float:
    """Communication units per computation block for one device.

    A device computes a*b = n blocks; it communicates (a-1) Q units +
    2*(b-1) KV units + (a-1) O units.  Ring (a=1): 2(n-1)/n — the paper's
    16/9 for n = 9.
    """
    b = n // a
    return ((a - 1) + 2.0 * (b - 1) + (a - 1)) / float(n)


def mesh_backward_volume(n: int, a: int) -> float:
    """Backward pass per-device volume, in units of N*d (paper §3.6).

    Q-group ring carries OdOQ (O, dO, Q: 3 chunk-sized tensors; lse is
    negligible) for a-1 steps; KV-group carries KV (2 units) for b-1 steps;
    dQ (1 unit) is reduced along the Q group (a-1 sends) and dKV (2 units)
    along the KV group (b-1 sends).
    """
    b = n // a
    return (3.0 * (a - 1) + 2.0 * (b - 1) + 1.0 * (a - 1) + 2.0 * (b - 1)) / n


def ring_backward_volume(n: int) -> float:
    """Ring-Attention backward: KV circulates (2 units x (n-1)) and dKV is
    passed around for reduction (2 units x (n-1))."""
    return 4.0 * (n - 1) / n


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Concrete sizes for one attention call.

    seq: global sequence length N; hidden: d = heads*head_dim (Q width);
    kv_hidden: kv_heads*head_dim (K or V width — GQA shrinks KV traffic,
    paper §4.7); bytes: per element.
    """

    seq: int
    hidden: int
    n: int
    kv_hidden: Optional[int] = None
    bytes_per_elem: int = 2
    batch: int = 1

    @property
    def kvh(self) -> int:
        return self.kv_hidden if self.kv_hidden is not None else self.hidden

    def chunk_bytes(self, kind: str) -> int:
        """Bytes of one chunk of the given kind on the wire."""
        base = self.batch * (self.seq // self.n) * self.bytes_per_elem
        if kind in ("q", "o", "dq"):
            return base * self.hidden
        if kind in ("kv", "dkv"):
            return base * 2 * self.kvh
        if kind == "odoq":  # O + dO + Q (lse negligible)
            return base * 3 * self.hidden
        raise ValueError(f"unknown chunk kind {kind!r}")

    def fwd_bytes(self, a: int) -> int:
        b = self.n // a
        return (
            (a - 1) * self.chunk_bytes("q")
            + (b - 1) * self.chunk_bytes("kv")
            + (a - 1) * self.chunk_bytes("o")
        )

    def bwd_bytes(self, a: int) -> int:
        b = self.n // a
        return (
            (a - 1) * self.chunk_bytes("odoq")
            + (b - 1) * self.chunk_bytes("kv")
            + (a - 1) * self.chunk_bytes("dq")
            + (b - 1) * self.chunk_bytes("dkv")
        )

    def ring_fwd_bytes(self) -> int:
        return (self.n - 1) * self.chunk_bytes("kv")

    def ring_bwd_bytes(self) -> int:
        return (self.n - 1) * (self.chunk_bytes("kv") + self.chunk_bytes("dkv"))

    def best_a(self, backward: bool = False) -> int:
        """Divisor of n minimizing the modeled byte volume (GQA shifts the
        optimum away from sqrt(n) because Q and KV chunks have different
        widths — this is the Figure-6 'estimate runtime, pick best' step in
        its pure-communication form)."""
        key = self.bwd_bytes if backward else self.fwd_bytes
        return min((a for a, _ in factorizations(self.n)), key=key)


def table2(n: int) -> Dict[str, float]:
    """Paper Table 2: per-device forward volumes (units of N*d) at size n."""
    return {
        "ring": ring_volume(n),
        "ulysses": ulysses_volume(n),
        "startrail": startrail_volume(n),
        "mesh": mesh_volume(n),
    }
