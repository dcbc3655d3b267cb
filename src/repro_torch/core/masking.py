"""Attention masks as one hashable spec (trimmed copy of
``repro/core/masking.py``).

This slice needs three kinds, each with an optional sliding window:

  full      no mask
  causal    token i attends j iff 0 <= i - j (<= window-1 when windowed)
  segment   causal within runtime segment ids (an int32 [S] operand rides
            along with q/k/v): packed multi-document prefill rows

The document and block-sparse kinds, and the schedule-pruning queries
(``block_visibility`` ...), arrive with the mesh executors.  The numpy
helpers that turn document lengths into segment ids and per-document
positions (the training data pipeline's) are copied here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["MaskSpec", "BAND_INF", "segment_ids_from_doc_lens", "positions_from_doc_lens"]

BAND_INF = 2**30  # matches kernels/ref.py

_KINDS = ("full", "causal", "segment")


def segment_ids_from_doc_lens(doc_lens, seq: int) -> np.ndarray:
    """[S] int32 document id per position (contiguous original order)."""
    if sum(doc_lens) != seq:
        raise ValueError(f"doc_lens {tuple(doc_lens)} do not sum to seq={seq}")
    return np.repeat(np.arange(len(doc_lens), dtype=np.int32), np.asarray(doc_lens))


def positions_from_doc_lens(doc_lens) -> np.ndarray:
    """[S] int32 per-document positions (restart at each document start)."""
    return np.concatenate([np.arange(l, dtype=np.int32) for l in doc_lens])


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    kind: str = "full"
    window: Optional[int] = None  # causal kinds only; width inclusive of self

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown mask kind {self.kind!r}; this port supports {_KINDS}"
            )
        if self.window is not None:
            if not self.is_causal:
                raise ValueError(f"window requires a causal mask kind, got {self.kind!r}")
            if self.window < 1:
                raise ValueError(f"window must be >= 1, got {self.window}")

    @staticmethod
    def full() -> "MaskSpec":
        return MaskSpec(kind="full")

    @staticmethod
    def causal(window: Optional[int] = None) -> "MaskSpec":
        return MaskSpec(kind="causal", window=window)

    @staticmethod
    def segment(window: Optional[int] = None) -> "MaskSpec":
        return MaskSpec(kind="segment", window=window)

    @staticmethod
    def from_flags(causal: bool, window: Optional[int] = None) -> "MaskSpec":
        """The legacy (causal, window) boolean pair as a spec."""
        if causal:
            return MaskSpec.causal(window)
        if window:
            raise ValueError("sliding window requires causal=True")
        return MaskSpec.full()

    @property
    def is_causal(self) -> bool:
        return self.kind in ("causal", "segment")

    @property
    def needs_segments(self) -> bool:
        """Kernel-level masking needs an int32 segment-id operand."""
        return self.kind == "segment"

    def band(self) -> Tuple[int, int]:
        """(lo, hi) of the position-difference band q_pos - kv_pos."""
        if not self.is_causal:
            return (-BAND_INF, BAND_INF)
        return (0, (self.window - 1) if self.window else BAND_INF)

    def signature(self) -> str:
        if self.kind == "full":
            return "full"
        w = f"w{self.window}" if self.window else ""
        return f"{self.kind}{w}"
