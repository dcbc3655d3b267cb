"""Attention layer: GQA/MHA projections over the dispatch seam (copy of
``repro/models/attention.py``): causal self-attention for the decoders,
non-causal self-attention for whisper's encoder, and cross-attention from
the decoder's rows to the encoder's.

The projections are plain matrix products; the attention itself goes through
``repro_torch.core.dispatch``.  No backend module is imported here.

MLA (minicpm3-4b): q through a low-rank bottleneck, k and v from one latent
per token (``kv_lora_rank`` dims of compressed KV and ``qk_rope_head_dim``
of shared roped key), expanded per head for prefill and training (V padded
up to the qk width, so one flash call serves q, k and v, forward and
backward, and sliced back after it).  Over a ring the expanded heads go
through ``distributed_attention`` as a dense decoder's do (JAX's default,
``mla_latent_wire`` off); with ``ctx.mla_latent_wire`` at sp_size > 1 the
latent itself circulates on the Mesh-Attention executor's KV ring and each
received chunk is expanded per head at its first use
(``dispatch.latent_wire_attention``, JAX's beyond-paper wire: 288 values a
token on minicpm3-4b's KV hops in place of 2 x 40 x 96), in the forward,
every prefill over the ring and training alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.masking import MaskSpec
from repro_torch.models.layers import dense_init, norm_params, pre_norm, rms_norm, rope
from repro_torch.parallel.context import ParallelCtx

__all__ = [
    "init_attention_params",
    "init_cross_attention_params",
    "attention_block",
    "cross_attention_block",
    "distributed_attention",
    "decode_attention_step",
    "chunk_attention_step",
]


# --------------------------------------------------------------------------
# dispatch adapters
# --------------------------------------------------------------------------


def distributed_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    ctx: ParallelCtx,
    *,
    causal: bool,
    window: Optional[int] = None,
    layout: str = "striped",
    segments: Optional[torch.Tensor] = None,  # [S] int32, same order as tokens
) -> torch.Tensor:
    """``segments`` switches the mask to causal-within-document (packed
    multi-document rows)."""
    if segments is not None:
        cfg = dispatch.plan_from_ctx(ctx, mask=MaskSpec.segment(window=window), layout=layout)
        return dispatch.distributed_attention(q, k, v, cfg=cfg, ctx=ctx, segments=segments)
    cfg = dispatch.plan_from_ctx(ctx, causal=causal, window=window, layout=layout)
    return dispatch.distributed_attention(q, k, v, cfg=cfg, ctx=ctx)


def decode_attention_step(
    q, k_new, v_new, k_cache, v_cache, pos, ctx: ParallelCtx,
    *,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    block_table: Optional[torch.Tensor] = None,  # [B, max_pages]: paged cache
    decode_kernel: Optional[str] = None,  # None -> ctx.decode_kernel
    write_coords=None,  # paged: the append's coordinates, shared by all layers
    k_scale: Optional[torch.Tensor] = None,  # f32 scale tables: quantized pool
    v_scale: Optional[torch.Tensor] = None,
):
    """Returns (o, k_cache, v_cache), the caches updated in place; with
    ``k_scale``/``v_scale`` (quantized paged pool) ``(o, k_cache, v_cache,
    k_scale, v_scale)``."""
    return dispatch.decode_attention_step(
        q, k_new, v_new, k_cache, v_cache, pos, ctx,
        window=window, layout=layout, scale=scale, block_table=block_table,
        decode_kernel=decode_kernel, write_coords=write_coords,
        k_scale=k_scale, v_scale=v_scale,
    )


def chunk_attention_step(
    q, k_new, v_new, k_cache, v_cache, starts, lens, write_starts, ctx: ParallelCtx,
    *,
    window: Optional[int] = None,
    layout: str = "striped",
    scale: Optional[float] = None,
    block_table: Optional[torch.Tensor] = None,  # [B, max_pages]: paged cache
    k_scale: Optional[torch.Tensor] = None,  # f32 scale tables: quantized pool
    v_scale: Optional[torch.Tensor] = None,
    write_coords=None,  # the chunk's write coordinates, shared by all layers
):
    """Continuous-prefill chunk append + prefix-causal attention; returns
    like ``decode_attention_step``."""
    return dispatch.chunk_attention_step(
        q, k_new, v_new, k_cache, v_cache, starts, lens, write_starts, ctx,
        window=window, layout=layout, scale=scale, block_table=block_table,
        k_scale=k_scale, v_scale=v_scale, write_coords=write_coords,
    )


# --------------------------------------------------------------------------
# parameters and projections (one layer slice: params without the L dim)
# --------------------------------------------------------------------------


def init_attention_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype, device) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(dtype=dtype, device=device)
        return {
            **norm_params(cfg.norm, (L, D), dtype, device),
            "wq_a": dense_init(gen, (L, D, m.q_lora_rank), **kw),
            "q_ln": torch.zeros((L, m.q_lora_rank), **kw),
            "wq_b": dense_init(gen, (L, m.q_lora_rank, H * qk), **kw),
            "wkv_a": dense_init(gen, (L, D, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
            "kv_ln": torch.zeros((L, m.kv_lora_rank), **kw),
            "wkv_b": dense_init(gen, (L, m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
                                **kw),
            "wo": dense_init(gen, (L, H * m.v_head_dim, D), **kw),
        }
    p = {
        **norm_params(cfg.norm, (L, D), dtype, device),
        "wq": dense_init(gen, (L, D, H * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (L, D, Hkv * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (L, D, Hkv * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (L, H * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        p.update(
            bq=torch.zeros((L, H * hd), dtype=dtype, device=device),
            bk=torch.zeros((L, Hkv * hd), dtype=dtype, device=device),
            bv=torch.zeros((L, Hkv * hd), dtype=dtype, device=device),
        )
    return p


def init_cross_attention_params(gen: torch.Generator, cfg: ModelConfig, L: int, dtype,
                                device) -> dict:
    """Cross-attention: H heads for q and for the encoder's k, v (no GQA, no
    RoPE), the decoder-side norm."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    return {
        **norm_params(cfg.norm, (L, D), dtype, device),
        "wq": dense_init(gen, (L, D, H * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (L, D, H * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (L, D, H * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (L, H * hd, D), dtype=dtype, device=device),
    }


def mla_latent(x, p, cfg: ModelConfig, positions):
    """MLA's per-token latent [B,S,1,kvr+rope]: the normed compressed KV and
    the roped shared key.  What the cache stores and what prefill writes."""
    m = cfg.mla
    kv_a = x @ p["wkv_a"]  # [B,S,kvr + rope]
    c_kv = rms_norm(kv_a[..., : m.kv_lora_rank], p["kv_ln"])
    k_rope = rope(kv_a[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)


def mla_q(x, p, cfg: ModelConfig, positions):
    """-> (q_nope [B,S,H,nope], q_rope [B,S,H,rope] roped)."""
    B, S, _ = x.shape
    m = cfg.mla
    cq = rms_norm(x @ p["wq_a"], p["q_ln"])
    q = (cq @ p["wq_b"]).reshape(B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    return q[..., : m.qk_nope_head_dim], rope(q[..., m.qk_nope_head_dim:], positions,
                                              cfg.rope_theta)


def _mla_q_latent(x, p, cfg: ModelConfig, positions):
    """-> (q [B,S,H,qk] roped, latent [B,S,1,kvr+rope] roped)."""
    q_nope, q_rope = mla_q(x, p, cfg, positions)
    return torch.cat([q_nope, q_rope], dim=-1), mla_latent(x, p, cfg, positions)


def _mla_expand(lat, wkv_b, cfg: ModelConfig):
    """latent [B,m,1,kvr+rope] -> per-head (k [B,m,H,qk], v [B,m,H,qk]: V
    zero-padded from v_head_dim up to qk, so one flash call serves q, k and
    v; the caller slices o back)."""
    m = cfg.mla
    H = cfg.num_heads
    B, S = lat.shape[0], lat.shape[1]
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kv_b = (lat[:, :, 0, : m.kv_lora_rank] @ wkv_b).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    r = lat[..., m.kv_lora_rank:].expand(B, S, H, m.qk_rope_head_dim)  # roped already
    k = torch.cat([kv_b[..., : m.qk_nope_head_dim], r], dim=-1)
    v = torch.nn.functional.pad(kv_b[..., m.qk_nope_head_dim:], (0, qk - m.v_head_dim))
    return k.contiguous(), v.contiguous()


def _project_qkv(x, p, cfg: ModelConfig, positions):
    """-> q [B,S,H,hd], k [B,S,Hkv,hd], v [B,S,Hkv,hd] (q, k roped); MLA:
    per-head q, k and padded v of the qk width."""
    if cfg.mla is not None:
        q, lat = _mla_q_latent(x, p, cfg, positions)
        return (q,) + _mla_expand(lat, p["wkv_b"], cfg)
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, cfg.num_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, cfg.num_kv_heads, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def _latent_wire_attention(
    q, lat, wkv_b, cfg: ModelConfig, ctx: ParallelCtx, *, causal, segments=None
):
    """MLA x Mesh-Attention with the compressed latent on the KV ring: wire
    bytes per KV hop drop from 2·H·qk to kvr+rope (minicpm3-4b: 7,680 ->
    288 values a token).  Backend "mesh" whatever ``ctx.attn_impl`` says,
    at the expanded heads' scale qk^-0.5."""
    scale = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5
    if segments is not None:
        plan = dispatch.plan_from_ctx(
            ctx, mask=MaskSpec.segment(window=cfg.window), layout=cfg.causal_layout,
            backend="mesh", scale=scale,
        )
    else:
        plan = dispatch.plan_from_ctx(
            ctx, causal=causal, layout=cfg.causal_layout, backend="mesh", scale=scale,
        )
    return dispatch.latent_wire_attention(
        q, lat, wkv_b, lambda chunk, wb: _mla_expand(chunk, wb, cfg), cfg=plan, ctx=ctx,
        segments=segments,
    )


def attention_block(
    x: torch.Tensor,  # [B, S, D]
    p: dict,  # one layer's params
    cfg: ModelConfig,
    ctx: ParallelCtx,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    segments: Optional[torch.Tensor] = None,  # [S] int32 packed-document ids
) -> torch.Tensor:
    """Pre-norm self-attention with residual (``causal=False``: whisper's
    encoder, every row sees every key)."""
    B, S, _ = x.shape
    h = pre_norm(x, p, cfg.norm)
    if cfg.mla is not None and ctx.mla_latent_wire and ctx.sp_size > 1:
        q, lat = _mla_q_latent(h, p, cfg, positions)
        o = _latent_wire_attention(
            q, lat, p["wkv_b"], cfg, ctx, causal=causal, segments=segments
        )
    else:
        q, k, v = _project_qkv(h, p, cfg, positions)
        o = distributed_attention(
            q, k, v, ctx, causal=causal, window=cfg.window, layout=cfg.causal_layout,
            segments=segments,
        )
    if cfg.mla is not None:
        o = o[..., : cfg.mla.v_head_dim]
    return x + o.reshape(B, S, -1) @ p["wo"]


def cross_kv(enc: torch.Tensor, p: dict, cfg: ModelConfig):
    """The encoder rows' cross-attention k, v [B, S_enc, H, hd]: what
    ``cross_attention_block`` attends to and what prefill caches."""
    B, S = enc.shape[0], enc.shape[1]
    k = (enc @ p["wk"]).reshape(B, S, cfg.num_heads, cfg.hd)
    v = (enc @ p["wv"]).reshape(B, S, cfg.num_heads, cfg.hd)
    return k, v


def cross_attention_block(
    x: torch.Tensor,  # [B, S_dec, D]
    enc: torch.Tensor,  # [B, S_enc, D] (encoder output)
    p: dict,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    kv=None,  # ``cross_kv(enc, p, cfg)`` when the caller has it already
) -> torch.Tensor:
    """Pre-norm cross-attention with residual: the decoder's rows attend to
    every encoder row (a full band, Sq = S_dec against Skv = S_enc)."""
    B, S, _ = x.shape
    h = pre_norm(x, p, cfg.norm)
    q = (h @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.hd)
    k, v = cross_kv(enc, p, cfg) if kv is None else kv
    o = distributed_attention(q, k, v, ctx, causal=False)
    return x + o.reshape(B, S, -1) @ p["wo"]
