"""ServeConfig: one frozen object for every serving knob (copy of
``repro/serve/config.py``: same fields, same defaults, same validation).

``cache_dtype`` is a torch dtype (default ``torch.float32``, as in JAX).
Knobs whose machinery is not ported yet raise ``NotImplementedError`` here:
continuous prefill (``prefill_chunk`` / ``tick_token_budget``), speculative
decode (``spec_k >= 2``), the quantized pool (``kv_dtype != "fp"``) and
oversubscription (``oversubscribe > 1.0``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["ServeConfig"]

KV_DTYPES = ("fp", "int8", "fp8")
_DECODE_KERNELS = ("auto", "native", "gather", "band")
_PACK_PLANS = ("greedy", "binpack")
_SPEC_DRAFTS = ("ngram", "off")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serving knob in one validated, hashable place."""

    max_seq: int = 256  # per-request cap: len(prompt) + max_new_tokens
    num_slots: int = 4  # concurrent requests (cache batch rows)
    cache_dtype: Any = torch.float32  # KV cache dtype (must match the params')
    prefill_buckets: Optional[Tuple[int, ...]] = None  # one-shot prefill sizes
    eos_id: Optional[int] = None  # early-stop token
    pack_prefill: bool = True  # pack same-tick prompts into one row
    pack_max: int = 4  # max prompts per packed row
    pack_plan: str = "binpack"  # greedy | binpack (FFD by marginal cost)
    paged: bool = False  # paged KV pool + prefix sharing
    page_size: Optional[int] = None  # tokens per page (paged)
    num_pages: Optional[int] = None  # physical pool size (paged)
    decode_kernel: str = "auto"  # auto | native | gather | band
    kv_dtype: str = "fp"  # fp | int8 | fp8 (only fp is ported)
    prefill_chunk: Optional[int] = None  # continuous prefill (not ported)
    tick_token_budget: Optional[int] = None  # (not ported)
    spec_k: int = 0  # speculative decode (not ported)
    spec_draft: str = "ngram"
    spec_max_misses: Optional[int] = 4
    oversubscribe: float = 1.0  # (> 1.0 not ported)
    nan_guard: bool = True  # retire (not propagate) non-finite-logit slots
    health_every: int = 0  # invariant sweep every N ticks (0 = on demand)

    def __post_init__(self):
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.pack_max < 1:
            raise ValueError(f"pack_max must be >= 1, got {self.pack_max}")
        if self.pack_plan not in _PACK_PLANS:
            raise ValueError(f"pack_plan must be one of {_PACK_PLANS}, got {self.pack_plan!r}")
        if self.decode_kernel not in _DECODE_KERNELS:
            raise ValueError(
                f"decode_kernel must be one of {_DECODE_KERNELS}, got {self.decode_kernel!r}"
            )
        if not isinstance(self.cache_dtype, torch.dtype):
            raise TypeError(f"cache_dtype must be a torch dtype, got {self.cache_dtype!r}")
        if self.prefill_buckets is not None:
            buckets = tuple(int(b) for b in self.prefill_buckets)
            if not buckets or any(b < 1 for b in buckets):
                raise ValueError(f"prefill_buckets must be positive, got {buckets}")
            object.__setattr__(self, "prefill_buckets", buckets)
        if not self.paged and (self.page_size is not None or self.num_pages is not None):
            raise ValueError("page_size/num_pages require paged=True")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages is not None and self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {self.kv_dtype!r}")
        if self.spec_k < 0 or self.spec_k == 1:
            raise ValueError(
                f"spec_k must be 0 (off) or >= 2 (current token + drafts), got {self.spec_k}"
            )
        if self.spec_draft not in _SPEC_DRAFTS:
            raise ValueError(f"spec_draft must be one of {_SPEC_DRAFTS}, got {self.spec_draft!r}")
        if self.spec_max_misses is not None and self.spec_max_misses < 1:
            raise ValueError(f"spec_max_misses must be >= 1 or None, got {self.spec_max_misses}")
        if self.oversubscribe < 1.0:
            raise ValueError(f"oversubscribe must be >= 1.0, got {self.oversubscribe}")
        if self.health_every < 0:
            raise ValueError(f"health_every must be >= 0, got {self.health_every}")
        not_ported = [
            name for name, on in (
                ("prefill_chunk / tick_token_budget (continuous prefill)",
                 self.prefill_chunk is not None or self.tick_token_budget is not None),
                ("spec_k >= 2 (speculative decode)", self.spec_k >= 2),
                (f"kv_dtype={self.kv_dtype!r} (quantized KV pool)", self.kv_dtype != "fp"),
                ("oversubscribe > 1.0 (preempt-and-recompute)", self.oversubscribe > 1.0),
            ) if on
        ]
        if not_ported:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + "; ".join(not_ported)
            )
