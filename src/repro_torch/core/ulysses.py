"""DeepSpeed-Ulysses baseline (Jacobs et al. 2023) -- head-parallel
attention, the port's copy of ``repro/core/ulysses.py``.

Two all-to-alls transpose between sequence- and head-sharding so each rank
computes full attention for H/n complete heads locally; a final all-to-all
restores sequence sharding for O.  Communication is 4·(n-1)/n²·N·d per rank
(paper Table 2) but parallelism is capped at the KV-head count.

Takes the local ranks' chunks [R, B, S/n, H, D] of the transport (as
``mesh_attention``) in the *contiguous* sequence layout: after the gather
each rank sees the full sequence, so plain causal masking applies.  On a
``VirtualRing`` the n ranks' flash calls fold into one launch (their batch
rows side by side).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

__all__ = ["ulysses_attention"]


def ulysses_attention(
    q: torch.Tensor,  # [R, B, S/n, H, D]
    k: torch.Tensor,  # [R, B, S/n, Hkv, D]
    v: torch.Tensor,
    transport,
    n: int,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    seg: Optional[torch.Tensor] = None,  # [R, S/n] int32 local segment-id chunks
) -> torch.Tensor:
    R, B = q.shape[0], q.shape[1]
    H, Hkv = q.shape[3], k.shape[3]

    def flash(q, k, v, seg_full):
        o = ops.flash_attention(
            q.reshape(R * B, *q.shape[2:]), k.reshape(R * B, *k.shape[2:]),
            v.reshape(R * B, *v.shape[2:]), causal=causal, window=window, scale=scale,
            seg_q=seg_full, seg_kv=seg_full,
        )
        return o.view(R, B, *o.shape[1:])

    if n == 1:
        return flash(q, k, v, None if seg is None else seg[0])
    if Hkv % n:
        raise ValueError(
            f"DS-Ulysses parallelism is capped by the KV head count: "
            f"n={n} does not divide Hkv={Hkv} (the paper's §2.3 limitation)"
        )
    del H
    # seq-sharded -> head-sharded: split heads (axis 2 of each rank's
    # [B, S/n, H, D]) across ranks, concatenate sequence chunks (axis 1)
    qh = transport.all_to_all(q, split_axis=2, concat_axis=1, kind="ulysses")
    kh = transport.all_to_all(k, split_axis=2, concat_axis=1, kind="ulysses")
    vh = transport.all_to_all(v, split_axis=2, concat_axis=1, kind="ulysses")
    seg_full = None
    if seg is not None:
        # after the transpose every rank holds the FULL sequence; gather the
        # (tiny, int32) segment ids to match: the same on every rank
        seg_full = transport.all_gather(seg.to(torch.int32))[0]
    oh = flash(qh, kh, vh, seg_full)
    # head-sharded -> seq-sharded
    return transport.all_to_all(oh, split_axis=1, concat_axis=2, kind="ulysses")
