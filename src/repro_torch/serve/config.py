"""ServeConfig: one frozen object for every serving knob (copy of
``repro/serve/config.py``: same fields, same defaults, same validation).

``cache_dtype`` is a torch dtype (default ``torch.float32``, as in JAX).

* ``prefill_chunk`` / ``tick_token_budget``: continuous prefill -- admitted
  prompts stream into their slot in chunks, interleaved with decode, at most
  ``tick_token_budget`` decode + chunk tokens per tick (the head-of-line
  chunk is always granted).
* ``spec_k`` (>= 2), ``spec_draft``, ``spec_max_misses``: speculative
  decode -- verify the current token plus up to ``spec_k - 1`` prompt-lookup
  drafts per slot in one chunk launch; greedy accept/reject keeps the tokens
  identical to plain decode.  After ``spec_max_misses`` consecutive missed
  verify ticks a slot stops drafting for ``16 * spec_max_misses`` ticks.
* ``kv_dtype`` ("int8" / "fp8", paged only): the pool stores codes plus
  per-(token, kv-head) fp32 scales, dequantized inside the decode kernel.

Oversubscription (``oversubscribe > 1.0``, preempt-and-recompute) is not
ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import kv_quant

__all__ = ["ServeConfig"]

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
    kv_dtype: str = "fp"  # fp | int8 | fp8: paged-pool storage precision
    prefill_chunk: Optional[int] = None  # continuous prefill: chunk size
    tick_token_budget: Optional[int] = None  # cap decode+chunk tokens per tick
    spec_k: int = 0  # speculative decode: tokens verified per slot per tick
    spec_draft: str = "ngram"  # ngram (prompt lookup) | off
    spec_max_misses: Optional[int] = 4  # consecutive missed verify ticks
    # before a slot's drafting suspends for a cooldown (None = never)
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
        if self.kv_dtype not in kv_quant.KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {kv_quant.KV_DTYPES}, got {self.kv_dtype!r}"
            )
        if self.kv_dtype != "fp":
            if not self.paged:
                raise ValueError("kv_dtype requires paged=True (pool storage)")
            if self.kv_dtype == "fp8" and not kv_quant.fp8_supported():
                raise ValueError(
                    "kv_dtype='fp8' requires torch.float8_e4m3fn; use 'int8'"
                )
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.tick_token_budget is not None:
            if self.prefill_chunk is None:
                raise ValueError(
                    "tick_token_budget only budgets continuous prefill; set prefill_chunk as well"
                )
            if self.tick_token_budget < 1:
                raise ValueError(
                    f"tick_token_budget must be >= 1, got {self.tick_token_budget}"
                )
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
        if self.oversubscribe > 1.0:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: oversubscribe > 1.0 "
                "(preempt-and-recompute)"
            )
