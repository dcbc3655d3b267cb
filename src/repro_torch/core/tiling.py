"""Tile-based workload distribution for Mesh-Attention (paper §3.2); a copy
of ``repro/core/tiling.py``, which imports no JAX, kept here so that the port
stands alone.

The assignment matrix (AM) is the n x n matrix whose entry AM[i][j] names the
device responsible for computing the attention block between Q chunk i and KV
chunk j.  Mesh-Attention partitions the AM into n tiles of shape (a, b) with
n = a * b, arranges devices row-first over the tiles, and rotates the KV chunk
indices so that every device retains the *local Q-KV property*: it computes
the block between its own Q and KV chunk without any communication.

Everything in this module is pure Python / integer arithmetic so that it can
be unit- and property-tested exhaustively and reused both by the scheduler
(`core/schedule.py`) and by the distributed implementation
(`core/mesh_attention.py`), which turns the same index maps into the
transport's ring hops (``parallel/ring.py``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "TileLayout",
    "factorizations",
    "best_square_a",
    "stripe_permutation",
    "unstripe_permutation",
    "striped_causal_offset",
]


def factorizations(n: int) -> List[Tuple[int, int]]:
    """All ordered factorizations n = a * b with a, b >= 1.

    ``a`` is the Q-group size (tile height); ``a == 1`` recovers
    Ring-Attention, ``a == n`` is the column-wise (communicate-Q) extreme.
    """
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    out = []
    for a in range(1, n + 1):
        if n % a == 0:
            out.append((a, n // a))
    return out


def best_square_a(n: int) -> int:
    """The divisor of n closest to sqrt(n) (paper §3.8: comm is minimized
    at a -> sqrt(n) by AM-GM)."""
    best, best_gap = 1, float("inf")
    root = math.sqrt(n)
    for a, _ in factorizations(n):
        gap = abs(math.log(a / root))
        if gap < best_gap:
            best, best_gap = a, gap
    return best


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """The (a, b) tiling of the assignment matrix for n = a*b devices.

    Device naming follows the paper: device ``i`` sits at tile
    (row-band ``i // a``, column-residue ``i % a``).

    * Q group  g = i // a   : devices {a*g + x | x in [0, a)}  (b groups, size a)
    * KV group r = i % a    : devices {r + a*x | x in [0, b)}  (a groups, size b)
    """

    n: int
    a: int

    def __post_init__(self):
        if self.n % self.a != 0:
            raise ValueError(f"a={self.a} does not divide n={self.n}")
        if self.a < 1:
            raise ValueError(f"a must be >= 1, got {self.a}")

    @property
    def b(self) -> int:
        return self.n // self.a

    # ---- groups ------------------------------------------------------------
    def q_group(self, i: int) -> int:
        return i // self.a

    def kv_group(self, i: int) -> int:
        return i % self.a

    def q_group_members(self, g: int) -> List[int]:
        return [self.a * g + x for x in range(self.a)]

    def kv_group_members(self, r: int) -> List[int]:
        return [r + self.a * x for x in range(self.b)]

    # ---- ring neighbours ----------------------------------------------------
    def succ_q(self, i: int) -> int:
        """Successor of device i in its Q group ring."""
        return self.a * (i // self.a) + (i + 1) % self.a

    def pred_q(self, i: int) -> int:
        return self.a * (i // self.a) + (i - 1) % self.a

    def succ_kv(self, i: int) -> int:
        """Successor of device i in its KV group ring (stride a)."""
        return (i + self.a) % self.n

    def pred_kv(self, i: int) -> int:
        return (i - self.a) % self.n

    def q_ring_perm(self) -> List[Tuple[int, int]]:
        """(src, dst) pairs implementing one Recv-Q ring step for ALL devices.

        Data flows predecessor -> device, i.e. every device sends to its
        successor.  With a == 1 the Q ring is a self-loop and no permutation
        is needed (returns []).
        """
        if self.a == 1:
            return []
        return [(i, self.succ_q(i)) for i in range(self.n)]

    def kv_ring_perm(self) -> List[Tuple[int, int]]:
        if self.b == 1:
            return []
        return [(i, self.succ_kv(i)) for i in range(self.n)]

    # ---- canonical data-flow permutations used by the distributed op ----------
    #
    # Slot arithmetic (Table 1) fixes the flow direction: device i's slot u+1
    # is device (i+1 in group)'s slot u, so on every ring step each device
    # forwards its in-flight buffer to the *lower* neighbour and receives from
    # the *higher* one.  The same downward perm serves Recv Q (all-gather),
    # Send O and Send dQ (reduce-scatter) on the Q ring — and analogously for
    # the KV ring with stride a — so the whole algorithm uses exactly two
    # neighbour shifts, which map to uniform single-hop moves between neighbours.

    def q_shift_perm(self) -> List[Tuple[int, int]]:
        if self.a == 1:
            return []
        return [(i, self.pred_q(i)) for i in range(self.n)]

    def kv_shift_perm(self) -> List[Tuple[int, int]]:
        if self.b == 1:
            return []
        return [(i, self.pred_kv(i)) for i in range(self.n)]

    # ---- Table 1: local slot -> global chunk index ---------------------------
    def q_chunk(self, i: int, u: int) -> int:
        """Global index of Q#u on device i (paper Table 1)."""
        return self.a * (i // self.a) + (i + u) % self.a

    def o_chunk(self, i: int, u: int) -> int:
        return self.q_chunk(i, u)

    def kv_chunk(self, i: int, u: int) -> int:
        """Global index of KV#u on device i (paper Table 1)."""
        return (i + self.a * u) % self.n

    def q_slot_of(self, i: int, v: int) -> int:
        """Inverse of q_chunk: which local slot holds global Q chunk v."""
        g = i // self.a
        if v // self.a != g:
            raise ValueError(f"Q chunk {v} is not in device {i}'s Q group")
        return (v - i) % self.a

    def kv_slot_of(self, i: int, v: int) -> int:
        if v % self.a != i % self.a:
            raise ValueError(f"KV chunk {v} is not in device {i}'s KV group")
        return ((v - i) % self.n) // self.a

    # ---- assignment matrix ----------------------------------------------------
    def assignment_matrix(self) -> np.ndarray:
        """AM[q_chunk][kv_chunk] = responsible device.

        Derivation: device i covers Q rows of its band i//a and KV columns of
        its residue class i % a, therefore AM[qi][kj] = a*(qi//a) + kj % a.
        """
        qi = np.arange(self.n)[:, None]
        kj = np.arange(self.n)[None, :]
        return self.a * (qi // self.a) + kj % self.a

    def comm_chunks_per_device(self) -> dict:
        """Paper §3.2/§3.8: per-device chunk counts (Q recv, KV recv, O send)."""
        return {"q": self.a - 1, "kv": self.b - 1, "o": self.a - 1}


# ---- striped (causal) sequence layout -----------------------------------------


@lru_cache(maxsize=128)
def _stripe_perm_cached(seq_len: int, n: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    m = seq_len // n
    fwd = tuple(int((j // m) + n * (j % m)) for j in range(seq_len))
    inv = [0] * seq_len
    for j, src in enumerate(fwd):
        inv[src] = j
    return fwd, tuple(inv)


def stripe_permutation(seq_len: int, n: int) -> np.ndarray:
    """Gather indices that produce the striped layout (paper §3.7).

    ``striped[j] = original[perm[j]]``.  Chunk ``c`` (positions
    ``c*m .. (c+1)*m-1`` of the striped sequence, with ``m = seq_len // n``)
    holds the original tokens {c + n*x | x in [0, m)}: token t lives in chunk
    ``t mod n`` — Striped-Attention's round-robin assignment, which balances
    the causal mask across all (rotated) AM blocks.
    """
    if seq_len % n != 0:
        raise ValueError(f"seq_len={seq_len} not divisible by n={n}")
    return np.asarray(_stripe_perm_cached(seq_len, n)[0], dtype=np.int64)


def unstripe_permutation(seq_len: int, n: int) -> np.ndarray:
    """Inverse gather: ``original[j] = striped[inv[j]]``."""
    if seq_len % n != 0:
        raise ValueError(f"seq_len={seq_len} not divisible by n={n}")
    return np.asarray(_stripe_perm_cached(seq_len, n)[1], dtype=np.int64)


def striped_causal_offset(q_chunk: int, kv_chunk: int) -> int:
    """Mask offset for block (Q chunk, KV chunk) under the striped layout.

    Striped token indices: q_tok = q_chunk + n*t, kv_tok = kv_chunk + n*s.
    Causality q_tok >= kv_tok reduces to ``t >= s`` when q_chunk >= kv_chunk
    and ``t > s`` otherwise.  We encode this as an offset o such that position
    (t, s) is visible iff ``t - s + o >= 0``: o = 0 or -1.
    """
    return 0 if q_chunk >= kv_chunk else -1
