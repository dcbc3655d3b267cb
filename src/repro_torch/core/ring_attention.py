"""Ring-Attention baseline (Liu et al. 2023), the port's copy of
``repro/core/ring_attention.py``.

Ring-Attention is exactly the (a=1, b=n) row-wise special case of the
Mesh-Attention assignment matrix: each rank keeps its Q chunk and the KV
chunks circulate through a single logical ring.  The baseline is therefore
that special case -- identical kernels, identical ring machinery, only the
tile shape differs.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import schedule as S
from repro_torch.core.mesh_attention import MeshAttentionConfig, mesh_attention

__all__ = ["ring_attention", "ring_config"]


def ring_config(
    transport,
    n: int,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
) -> MeshAttentionConfig:
    return MeshAttentionConfig(
        transport=transport,
        n=n,
        a=1,
        causal=causal,
        window=window,
        scale=scale,
        fwd_schedule=S.ring_forward_schedule(n) if n > 1 else None,
        block_q=block_q,
        block_kv=block_kv,
    )


def ring_attention(q, k, v, transport, n: int, **kw):
    """Distributed attention with the Ring schedule over the local ranks'
    chunks ([R, B, S/n, H, D], as ``mesh_attention``)."""
    return mesh_attention(q, k, v, ring_config(transport, n, **kw))
