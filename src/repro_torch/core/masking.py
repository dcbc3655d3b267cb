"""First-class attention masks: one hashable spec for every layer of the stack
(copy of ``repro/core/masking.py``, which imports no JAX).

A spec is a static description of the mask, hashable, and every layer asks
it the question it cares about:

  * kernels:   ``band()`` (+ optional runtime segment-id operands),
  * scheduler: ``block_visibility(a, b, ...)`` — classify each (u, v) slot
    block of the tile as FULL / PARTIAL / EMPTY so the greedy schedules can
    *prune* EMPTY blocks and the communication that only feeds them,
  * simulator: ``visible_fraction(seq)`` — mask-aware per-block FLOP scaling,
  * plan cache: ``signature()`` — enters the autotuner cache key, and equals
    the JAX package's, so a plan cache written by one package is read by the
    other.

Kinds
-----
  full         no mask
  causal       token i attends j iff 0 <= i - j (<= window-1 when windowed)
  document     causal within *statically known* packed documents: position
               lengths ``doc_lens`` partition the sequence into contiguous
               documents (serve prefill packing, synthetic packed batches).
               Static boundaries are what makes schedule pruning possible.
  segment      causal within *runtime* segment ids (an int32 [S] operand
               rides along with q/k/v).  Block structure is unknown when
               the schedule is built, so no pruning — only kernel-level masking.
  block_sparse an explicit n x n chunk-level visibility bitmap.

Lock-step pruning rule: the distributed schedule is identical on every
device, so a slot block (u, v) may be dropped only when the global (Q chunk,
KV chunk) pair it maps to is fully masked on EVERY device of the tile.
``block_visibility`` applies exactly that quantifier.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.tiling import TileLayout

__all__ = [
    "MaskSpec",
    "FULL",
    "PARTIAL",
    "EMPTY",
    "BAND_INF",
    "segment_ids_from_doc_lens",
    "positions_from_doc_lens",
    "prefix_chunk_visibility",
]

# classification of one attention block under a mask
FULL = "full"  # every (q, kv) pair visible
PARTIAL = "partial"  # some visible, some masked
EMPTY = "empty"  # fully masked -> prunable (when true on every device)

BAND_INF = 2**30  # matches kernels/ref.py

Block = Tuple[int, int]

# dense-evaluation budget for striped document blocks (m*m pairs per block);
# beyond it we conservatively return PARTIAL (never prunes, always correct)
_DENSE_CAP = 1 << 16


def segment_ids_from_doc_lens(doc_lens, seq: int) -> np.ndarray:
    """[S] int32 document id per position (contiguous original order)."""
    if sum(doc_lens) != seq:
        raise ValueError(f"doc_lens {tuple(doc_lens)} do not sum to seq={seq}")
    return np.repeat(np.arange(len(doc_lens), dtype=np.int32), np.asarray(doc_lens))


def positions_from_doc_lens(doc_lens) -> np.ndarray:
    """[S] int32 per-document positions (restart at each document start)."""
    return np.concatenate([np.arange(l, dtype=np.int32) for l in doc_lens])


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Hashable static description of an attention mask (see module doc)."""

    kind: str = "full"
    window: Optional[int] = None  # causal kinds only; width inclusive of self
    doc_lens: Optional[Tuple[int, ...]] = None  # kind == "document"
    bitmap: Optional[Tuple[Tuple[bool, ...], ...]] = None  # kind == "block_sparse"

    def __post_init__(self):
        if self.kind not in ("full", "causal", "document", "segment", "block_sparse"):
            raise ValueError(f"unknown mask kind {self.kind!r}")
        if self.window is not None:
            if not self.is_causal:
                raise ValueError(f"window requires a causal mask kind, got {self.kind!r}")
            if self.window < 1:
                raise ValueError(f"window must be >= 1, got {self.window}")
        if self.kind == "document":
            if not self.doc_lens or any(l < 1 for l in self.doc_lens):
                raise ValueError(f"document mask needs positive doc_lens, got {self.doc_lens}")
        elif self.doc_lens is not None:
            raise ValueError("doc_lens is only valid for kind='document'")
        if self.kind == "block_sparse":
            if not self.bitmap or any(len(r) != len(self.bitmap) for r in self.bitmap):
                raise ValueError("block_sparse needs a square non-empty bitmap")
        elif self.bitmap is not None:
            raise ValueError("bitmap is only valid for kind='block_sparse'")

    # ---- constructors ------------------------------------------------------

    @staticmethod
    def full() -> "MaskSpec":
        return MaskSpec(kind="full")

    @staticmethod
    def causal(window: Optional[int] = None) -> "MaskSpec":
        return MaskSpec(kind="causal", window=window)

    @staticmethod
    def document(doc_lens, window: Optional[int] = None) -> "MaskSpec":
        return MaskSpec(kind="document", window=window,
                        doc_lens=tuple(int(l) for l in doc_lens))

    @staticmethod
    def segment(window: Optional[int] = None) -> "MaskSpec":
        return MaskSpec(kind="segment", window=window)

    @staticmethod
    def block_sparse(bitmap) -> "MaskSpec":
        return MaskSpec(kind="block_sparse",
                        bitmap=tuple(tuple(bool(x) for x in row) for row in bitmap))

    @staticmethod
    def from_flags(causal: bool, window: Optional[int] = None) -> "MaskSpec":
        """The legacy (causal, window) boolean pair as a spec."""
        if causal:
            return MaskSpec.causal(window)
        if window:
            raise ValueError("sliding window requires causal=True")
        return MaskSpec.full()

    # ---- basic properties --------------------------------------------------

    @property
    def is_causal(self) -> bool:
        return self.kind in ("causal", "document", "segment")

    @property
    def needs_segments(self) -> bool:
        """Kernel-level masking needs an int32 segment-id operand."""
        return self.kind in ("document", "segment")

    def band(self) -> Tuple[int, int]:
        """(lo, hi) of the position-difference band q_pos - kv_pos."""
        if self.kind == "block_sparse" or not self.is_causal:
            return (-BAND_INF, BAND_INF)
        return (0, (self.window - 1) if self.window else BAND_INF)

    def signature(self) -> str:
        """Stable short string for plan-cache keys and reports."""
        if self.kind == "full":
            return "full"
        w = f"w{self.window}" if self.window else ""
        if self.kind == "causal":
            return f"causal{w}"
        if self.kind == "segment":
            return f"segment{w}"
        if self.kind == "document":
            lens = ",".join(str(l) for l in self.doc_lens)
            return f"doc[{lens}]{w}"
        rows = "".join("".join("1" if x else "0" for x in r) for r in self.bitmap)
        return f"bs[{len(self.bitmap)}:{rows}]"

    # ---- static segment arrays (document kind) ------------------------------

    def segment_array(self, seq: int) -> np.ndarray:
        """[S] int32 segment ids in original contiguous order."""
        if self.kind != "document":
            raise ValueError(f"segment_array is only defined for 'document', not {self.kind!r}")
        return segment_ids_from_doc_lens(self.doc_lens, seq)

    def _doc_of(self, pos: int) -> int:
        # doc_starts[d] <= pos < doc_starts[d+1]
        starts = self._doc_starts()
        return bisect_right(starts, pos) - 1

    def _doc_starts(self) -> Tuple[int, ...]:
        starts, acc = [], 0
        for l in self.doc_lens:
            starts.append(acc)
            acc += l
        return tuple(starts)

    # ---- per-chunk-pair classification --------------------------------------

    def _band_visibility(self, qc: int, kc: int, *, n: int, m: int, layout: str) -> str:
        """Band-only classification of the (qc, kc) chunk pair."""
        lo, hi = self.band()
        if lo <= -BAND_INF and hi >= BAND_INF:
            return FULL
        if layout == "striped":
            d0, stride = qc - kc, n
        else:
            d0, stride = (qc - kc) * m, 1
        # diff takes values d0 + stride*j, j in [-(m-1), m-1]
        if d0 - stride * (m - 1) >= lo and d0 + stride * (m - 1) <= hi:
            return FULL
        j_lo = max(_ceil_div(lo - d0, stride), -(m - 1))
        j_hi = min((hi - d0) // stride, m - 1)
        return EMPTY if j_lo > j_hi else PARTIAL

    def _doc_visibility(self, qc: int, kc: int, *, m: int) -> str:
        """Document-membership classification (contiguous layout)."""
        dq0 = self._doc_of(qc * m)
        dq1 = self._doc_of(qc * m + m - 1)
        dk0 = self._doc_of(kc * m)
        dk1 = self._doc_of(kc * m + m - 1)
        if dq1 < dk0 or dk1 < dq0:
            return EMPTY
        if dq0 == dq1 == dk0 == dk1:
            return FULL
        return PARTIAL

    def _dense_visibility(self, qc: int, kc: int, *, n: int, m: int, layout: str) -> str:
        """Exact classification by evaluating the mask on the chunk pair."""
        if layout == "striped":
            qpos = qc + n * np.arange(m)
            kpos = kc + n * np.arange(m)
        else:
            qpos = qc * m + np.arange(m)
            kpos = kc * m + np.arange(m)
        lo, hi = self.band()
        diff = qpos[:, None] - kpos[None, :]
        vis = (diff >= lo) & (diff <= hi)
        if self.kind == "document":
            seg = self.segment_array(n * m)
            vis &= seg[qpos][:, None] == seg[kpos][None, :]
        if vis.all():
            return FULL
        if not vis.any():
            return EMPTY
        return PARTIAL

    def chunk_visibility(self, qc: int, kc: int, *, n: int, seq: int, layout: str = "striped") -> str:
        """Classify the global (Q chunk qc, KV chunk kc) block of an n-way
        sequence split under this mask.  Conservative: never EMPTY unless the
        block is provably fully masked."""
        if seq % n:
            raise ValueError(f"seq={seq} not divisible by n={n}")
        m = seq // n
        if self.kind == "block_sparse":
            if len(self.bitmap) != n:
                raise ValueError(
                    f"block_sparse bitmap is {len(self.bitmap)}x{len(self.bitmap)}, "
                    f"but the sequence is split {n} ways"
                )
            return FULL if self.bitmap[qc][kc] else EMPTY
        band = self._band_visibility(qc, kc, n=n, m=m, layout=layout)
        if self.kind in ("full", "causal"):
            return band
        if self.kind == "segment":
            # runtime ids: the band can still prove emptiness, never fullness
            return band if band == EMPTY else PARTIAL
        # document
        if sum(self.doc_lens) != seq:
            raise ValueError(
                f"document mask covers {sum(self.doc_lens)} tokens, call has seq={seq}"
            )
        if layout == "contiguous":
            doc = self._doc_visibility(qc, kc, m=m)
            if band == EMPTY or doc == EMPTY:
                return EMPTY
            if band == FULL and doc == FULL:
                return FULL
            return PARTIAL
        # striped documents interleave; evaluate exactly when cheap
        if m * m <= _DENSE_CAP:
            return self._dense_visibility(qc, kc, n=n, m=m, layout=layout)
        return band if band == EMPTY else PARTIAL

    # ---- schedule-level classification --------------------------------------

    def block_visibility(
        self, a: int, b: int, *, layout: str = "striped", n: Optional[int] = None,
        seq: Optional[int] = None,
    ) -> Dict[Block, str]:
        """Classify every (u, v) slot block of the (a, b) tile.

        A slot block maps to a different global chunk pair on each device
        (Table 1); the lock-step schedule is shared, so the classification
        quantifies over all devices: EMPTY/FULL only when EMPTY/FULL
        everywhere, PARTIAL otherwise.
        """
        n = n if n is not None else a * b
        if n != a * b:
            raise ValueError(f"n={n} != a*b={a * b}")
        if seq is None:
            seq = n  # m=1: token-level == chunk-level classification
        lay = TileLayout(n, a)
        out: Dict[Block, str] = {}
        for u in range(a):
            for v in range(b):
                classes = {
                    self.chunk_visibility(
                        lay.q_chunk(i, u), lay.kv_chunk(i, v), n=n, seq=seq, layout=layout
                    )
                    for i in range(n)
                }
                if classes == {EMPTY}:
                    out[(u, v)] = EMPTY
                elif classes == {FULL}:
                    out[(u, v)] = FULL
                else:
                    out[(u, v)] = PARTIAL
        return out

    def empty_blocks(
        self, a: int, b: int, *, layout: str = "striped", n: Optional[int] = None,
        seq: Optional[int] = None,
    ) -> frozenset:
        """The prunable slot blocks: empty on every device of the tile."""
        vis = self.block_visibility(a, b, layout=layout, n=n, seq=seq)
        return frozenset(blk for blk, c in vis.items() if c == EMPTY)

    # ---- oracles / analytics -------------------------------------------------

    def dense_mask(self, seq: int, segments: Optional[np.ndarray] = None) -> np.ndarray:
        """[S, S] boolean mask in original (contiguous) token order — the
        ground truth the kernels and the pruned schedules are tested against.
        ``segments`` supplies the runtime ids for kind='segment'."""
        idx = np.arange(seq)
        lo, hi = self.band()
        vis = (idx[:, None] - idx[None, :] >= lo) & (idx[:, None] - idx[None, :] <= hi)
        if self.kind == "document":
            seg = self.segment_array(seq)
            vis &= seg[:, None] == seg[None, :]
        elif self.kind == "segment":
            if segments is None:
                raise ValueError("kind='segment' needs the runtime segment ids")
            seg = np.asarray(segments)
            vis &= seg[:, None] == seg[None, :]
        elif self.kind == "block_sparse":
            nb = len(self.bitmap)
            if seq % nb:
                raise ValueError(f"seq={seq} not divisible by bitmap size {nb}")
            m = seq // nb
            bm = np.asarray(self.bitmap, dtype=bool)
            vis &= np.kron(bm, np.ones((m, m), dtype=bool))
        return vis

    def visible_fraction(self, seq: int) -> float:
        """Fraction of (q, kv) pairs visible — the mask-aware FLOP scaling the
        simulator applies per block (striping spreads it evenly, §3.7)."""
        if self.kind == "full":
            return 1.0

        def causal_pairs(length: int) -> float:
            w = min(self.window or length, length)
            # rows 0..w-1 see i+1 keys; rows w.. see w keys
            return w * (w + 1) / 2.0 + (length - w) * w

        if self.kind in ("causal", "segment"):
            # segment ids are unknown statically; assume one document
            return causal_pairs(seq) / float(seq * seq)
        if self.kind == "document":
            if sum(self.doc_lens) != seq:
                raise ValueError(
                    f"document mask covers {sum(self.doc_lens)} tokens, seq={seq}"
                )
            return sum(causal_pairs(l) for l in self.doc_lens) / float(seq * seq)
        nb = len(self.bitmap)
        return sum(sum(1 for x in row if x) for row in self.bitmap) / float(nb * nb)


def prefix_chunk_visibility(
    q_lo: int, q_hi: int, k_lo: int, k_hi: int, window: Optional[int] = None
) -> str:
    """Classify a continuous-prefill chunk block: queries at absolute
    positions ``[q_lo, q_hi]`` (one prompt chunk) against resident KV
    positions ``[k_lo, k_hi]`` under prefix-causal visibility -- pair (p_q,
    p_k) visible iff ``p_k <= p_q`` and, with a sliding window, ``p_k >
    p_q - window``.

    The host-side mirror of the banded chunk kernel
    (``core.decode_attention.sharded_cache_chunk_decode``): EMPTY blocks are
    those whose rows the kernel's bounds leave without a key (JAX's window
    prune skips them), FULL blocks need no mask at all, PARTIAL blocks hit
    the band.  All bounds inclusive."""
    if q_hi < q_lo or k_hi < k_lo:
        raise ValueError("empty position range")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k_lo > q_hi:  # every key is in the chunk's future
        return EMPTY
    if window is not None and k_hi <= q_lo - window:  # every key fell off
        return EMPTY
    newest_ok = k_hi <= q_lo  # oldest query already sees the newest key
    oldest_ok = window is None or k_lo > q_hi - window  # newest query keeps the oldest key
    if newest_ok and oldest_ok:
        return FULL
    return PARTIAL
