"""Model assembly: init / forward / loss / cache / prefill / decode for the
families of ``repro/models/transformer.py``.

  dense   -- attention + gated MLP
  moe     -- attention + MoE (``models/moe.py``; over a ring, "ep" archs take
             the dispatch all-to-all of expert parallelism where JAX does)
  ssm     -- SSD blocks only (``models/ssm.py``; attention-free, no MLP)
  hybrid  -- parallel attention + SSD heads, mean-fused, then the MLP (hymba)
  audio   -- whisper: a stubbed frontend (a projection of the mel frames), a
             non-causal encoder, and a decoder of causal self-attention,
             cross-attention to the encoder and an ungated MLP; LayerNorm
  vlm     -- pixtral: the decoder backbone, whose positions below
             ``num_patches`` take projected patch embeddings (stubbed frontend)

A dense config with ``mla`` (minicpm3-4b) runs Multi-head Latent Attention:
prefill and the forward expand the latent per head (``models/attention.py``),
while the cache holds the latent itself, one "head" of kv_lora_rank + rope
dims written as both K and V, and decode, chunks and verifies absorb
W^{kv_b}_K into q and W^{kv_b}_V into the output (``_decode_qkv``,
``_decode_attn_out``), at the softmax scale qk^-0.5.  MLA trains and serves
at sp_size 1 and over the ring: there the expanded heads go through the
Mesh-Attention executor (JAX's default path), or, with
``ctx.mla_latent_wire``, the latent itself rides its KV ring
(``models/attention.py``); the serving cache is the latent, sharded over the
ranks like any one-head cache, and decode, chunks and verifies absorb as on
one rank.

Parameters are a plain dict mirroring the JAX pytree -- stacked ``[L, ...]``
leaves with ``x @ W`` weights of shape ``[D_in, D_out]`` -- so weights from
JAX convert by copy (``repro_torch.convert.params_from_jax``).  Layers run
as a Python loop over per-layer slices (views of the stacked leaves).
Gradients are taken with respect to the stacked leaves; with ``ctx.remat``
each layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, as ``jax.checkpoint`` makes JAX's layer scan do.

The cache functions update the cache dict and its tensors IN PLACE (slice
and index assignment, where JAX rebuilds the arrays) and return the same
dict.  A quantized paged pool (``init_cache(kv_dtype="int8"|"fp8")``) holds
codes plus ``k_scale``/``v_scale`` tables; every write path (prefill, packed
prefill, decode append, chunk, verify) quantizes at write time.  Writes that
JAX drops with ``mode="drop"`` and sentinel indices are filtered with a
boolean mask before writing here.  The SSM state and conv window stay
per-slot dense (``cache["ssm"]``), and so do the encoder's cross-attention
K/V (``cache["cross_k"]``, ``cache["cross_v"]``, written by prefill); the
paged path raises for SSM, hybrid and encoder archs, the packed, chunked
and verify paths also for frontend archs, as in JAX.  Every MoE call takes
the same [B, S, D] rows as its JAX counterpart (the bucket, the packed row,
the chunk, the verify window), so each has JAX's capacity; over a ring of n
the rows come in the order JAX's do (a one-shot prefill's striped prompt, a
chunk's or packed row's own order), so each rank's n-th is JAX's segment.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch, kv_quant
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dense_init,
    layer_norm,
    norm_params,
    pre_norm,
    rms_norm,
    rope,
    vocab_cross_entropy,
)
from repro_torch.models.mlp import init_mlp_params, mlp_block
from repro_torch.parallel.context import ParallelCtx

__all__ = [
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "prefill",
    "prefill_packed",
    "prefill_chunk",
    "decode_step",
    "verify_step",
    "param_count",
]


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense, MoE, SSM, hybrid, VLM and audio families:
    GQA/MHA attention, routed (and shared) experts, SSD blocks, RMSNorm or
    LayerNorm, gated or plain MLPs, a non-causal encoder with
    cross-attention, the stubbed audio and vision frontends, and MLA in a
    dense decoder (over a ring: ``check_ring_supported``)."""
    unsupported = [
        name for name, bad in (
            ("family not " + " / ".join(_FAMILIES), cfg.family not in _FAMILIES),
            ("SSM config or hybrid flag off its family",
             (cfg.ssm is not None) != (cfg.family in ("ssm", "hybrid"))
             or cfg.hybrid != (cfg.family == "hybrid")),
            ("MoE config off its family", (cfg.moe is not None) != (cfg.family == "moe")),
            ("MLA off the dense family", cfg.mla is not None and cfg.family != "dense"),
            (f"norm {cfg.norm!r}", cfg.norm not in ("rmsnorm", "layernorm")),
            (f"frontend {cfg.frontend!r}", cfg.frontend not in (None, "audio_stub", "vision_stub")),
        ) if bad
    ]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet; the port serves the "
            "dense, moe, ssm, hybrid, vlm and audio families"
        )


def check_ring_supported(cfg: ModelConfig, ctx: ParallelCtx, what: str) -> None:
    """Frontend and encoder archs run at sp_size 1 only: over a ring they
    raise (ROADMAP A.9)."""
    if ctx.sp_size == 1:
        return
    if cfg.encoder_layers or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} a frontend or encoder arch over a sequence-parallel ring is "
            "not ported: ROADMAP A.9 (frontend and encoder archs over the ring)"
        )


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None,
                ctx: Optional[ParallelCtx] = None) -> Dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (default: the card).  Same pytree and init law as JAX's ``init_params``,
    but not the same numbers: tests convert JAX weights instead.  Under
    ``ctx`` an "ep" MoE arch gets its experts padded to a multiple of
    sp_size (``moe.padded_experts``), as JAX's ``init_params(ctx=...)``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    p: Dict = {"embed": dense_init(gen, (V, D), in_axis=-1, dtype=dtype, device=dev)}
    layers: Dict = {}
    if cfg.family != "ssm":
        layers["attn"] = attn.init_attention_params(gen, cfg, L, dtype, dev)
    if cfg.ssm is not None:
        layers["ssm"] = ssm_mod.init_ssm_params(gen, cfg, L, dtype, dev)
    if cfg.moe is not None:
        layers["moe"] = moe_mod.init_moe_params(gen, cfg, L, dtype, dev, ctx=ctx)
    elif cfg.family != "ssm" and cfg.d_ff > 0:
        layers["mlp"] = init_mlp_params(gen, cfg, L, dtype, dev)
    if cfg.encoder_layers:
        layers["xattn"] = attn.init_cross_attention_params(gen, cfg, L, dtype, dev)
    p["layers"] = layers
    p.update(_final_norm_params(cfg, dtype, dev))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (D, V), dtype=dtype, device=dev)
    if cfg.encoder_layers:
        Le = cfg.encoder_layers
        p["encoder"] = {
            "layers": {"attn": attn.init_attention_params(gen, cfg, Le, dtype, dev),
                       "mlp": init_mlp_params(gen, cfg, Le, dtype, dev)},
            **_final_norm_params(cfg, dtype, dev),
        }
    if cfg.frontend:
        p["frontend"] = {"proj": dense_init(gen, (cfg.frontend_dim, D), dtype=dtype, device=dev)}
    return p


def _final_norm_params(cfg: ModelConfig, dtype, device) -> Dict:
    """``final_ln`` (and ``final_ln_b`` for LayerNorm) of a stack."""
    return {f"final_{k}": v for k, v in norm_params(cfg.norm, (cfg.d_model,), dtype,
                                                        device).items()}


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def _layer_slices(layers: Dict):
    """Every layer's params (``layers``: a stack's ``{group: {name: [L,
    ...]}}``): views of the stacked leaves, one ``unbind`` per leaf, so a
    backward stacks each leaf's per-layer gradients in one op."""
    per_leaf = {
        group: {name: leaf.unbind(0) for name, leaf in leaves.items()}
        for group, leaves in layers.items()
    }
    n = len(next(iter(next(iter(per_leaf.values())).values())))
    return [
        {group: {name: views[i] for name, views in leaves.items()}
         for group, leaves in per_leaf.items()}
        for i in range(n)
    ]


def _head(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _final_norm(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    """A stack's final norm (the decoder's, or the encoder's with ``p`` its
    params)."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["final_ln"], p["final_ln_b"])
    return rms_norm(x, p["final_ln"])


def _logits(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    x = _final_norm(x, params, cfg)
    return x @ _head(params, cfg).to(x.dtype)


def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(device=params["embed"].device, dtype=torch.int64)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _ssm_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx, ssm_cache=None):
    """The SSD block; with ``ssm_cache`` (one layer's cache views, as
    ``_layer_cache`` gives them) its final conv window and state land there."""
    if ssm_cache is None:
        return ssm_mod.ssm_block(x, lp["ssm"], cfg, ctx)
    y, state = ssm_mod.ssm_block(x, lp["ssm"], cfg, ctx, return_state=True)
    _write_ssm(ssm_cache, state)
    return y


def _ffn_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx):
    """The feed-forward half of a layer: the experts or the gated MLP ->
    (x, aux); aux is the MoE load-balance term, else None."""
    if cfg.moe is not None:
        return moe_mod.moe_block(x, lp["moe"], cfg, ctx)
    if cfg.d_ff > 0:
        x = mlp_block(x, lp["mlp"], cfg)
    return x, None


def _decoder_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx, positions, segments=None,
                   ssm_cache=None, enc=None, enc_kv=None):
    """One layer -> (x, aux) (aux: the MoE layer's, else None).  With
    ``enc`` (the encoder's output) the layer cross-attends to it after its
    self-attention; ``enc_kv``, when given, is that layer's ``cross_kv``."""
    if cfg.family == "ssm":
        return _ssm_block(x, lp, cfg, ctx, ssm_cache), None
    if cfg.hybrid:
        a = attn.attention_block(x, lp["attn"], cfg, ctx, positions, segments=segments) - x
        s = _ssm_block(x, lp, cfg, ctx, ssm_cache) - x
        x = x + 0.5 * (a + s)
    else:
        x = attn.attention_block(x, lp["attn"], cfg, ctx, positions, segments=segments)
    if enc is not None:
        x = attn.cross_attention_block(x, enc, lp["xattn"], cfg, ctx, kv=enc_kv)
    return _ffn_block(x, lp, cfg, ctx)


def _encoder_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx, positions):
    """One encoder layer: non-causal self-attention, then the MLP."""
    x = attn.attention_block(x, lp["attn"], cfg, ctx, positions, causal=False)
    return mlp_block(x, lp["mlp"], cfg)


def _encode_audio(params, cfg: ModelConfig, ctx: ParallelCtx, frames) -> torch.Tensor:
    """Stubbed conv frontend: mel frames [B, encoder_seq, frontend_dim] ->
    projected embeddings -> the encoder's layers and final norm ->
    [B, encoder_seq, D].  Each layer is checkpointed as the decoder's are."""
    proj = params["frontend"]["proj"]
    x = torch.as_tensor(frames, device=proj.device).to(params["embed"].dtype) @ proj
    pos = torch.arange(cfg.encoder_seq, dtype=torch.int32, device=x.device)
    enc = params["encoder"]
    remat = ctx.remat and torch.is_grad_enabled()
    for lp in _layer_slices(enc["layers"]):
        if remat:
            x = checkpoint(_encoder_block, x, lp, cfg, ctx, pos, use_reentrant=False)
        else:
            x = _encoder_block(x, lp, cfg, ctx, pos)
    return _final_norm(x, enc, cfg)


def _merge_patches(x, params, positions, patches, num_patches: int) -> torch.Tensor:
    """VLM stub: positions < ``num_patches`` take the projected patch
    embeddings [B, P, frontend_dim] @ proj, gathered by true position."""
    proj = params["frontend"]["proj"]
    px = torch.as_tensor(patches, device=x.device).to(x.dtype) @ proj  # [B, P, D]
    positions = torch.as_tensor(positions, device=x.device).to(torch.int64)
    gathered = px[:, positions.clamp(0, num_patches - 1)]  # [B, S, D]
    return torch.where((positions < num_patches)[None, :, None], gathered, x)


def _embed_inputs(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict, positions):
    """(x, enc): the token embeddings with the patches merged (vlm), and the
    encoder's output (audio) or None."""
    x = _embed(params, batch["tokens"])
    if cfg.frontend == "vision_stub":
        x = _merge_patches(x, params, positions, batch["patches"], cfg.num_patches)
    enc = _encode_audio(params, cfg, ctx, batch["frames"]) if cfg.encoder_layers else None
    return x, enc


def _forward(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict):
    """-> (logits, aux): aux is the fp32 sum over layers of the MoE
    load-balance term (0 for the other families)."""
    check_supported(cfg)
    check_ring_supported(cfg, ctx, "running")
    positions = batch["positions"]
    segments = batch.get("segments")
    x, enc = _embed_inputs(params, cfg, ctx, batch, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = ctx.remat and torch.is_grad_enabled()
    for lp in _layer_slices(params["layers"]):
        if remat:
            x, a = checkpoint(
                _decoder_block, x, lp, cfg, ctx, positions, segments, None, enc,
                use_reentrant=False,
            )
        else:
            x, a = _decoder_block(x, lp, cfg, ctx, positions, segments, enc=enc)
        if a is not None:
            aux = aux + a
    return _logits(x, params, cfg), aux


def forward(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict) -> torch.Tensor:
    """-> logits [B, S, V].  batch: tokens [B, S], positions [S], optional
    segments [S] (packed multi-document rows: causal within each document),
    frames [B, encoder_seq, frontend_dim] (audio) / patches [B, num_patches,
    frontend_dim] (vlm).  Under autograd with ``ctx.remat`` each layer is
    checkpointed."""
    return _forward(params, cfg, ctx, batch)[0]


def loss_fn(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict):
    """-> (loss, metrics {"loss", "ce", "aux"}), loss = ce + 0.01 aux as in
    JAX.  batch as ``forward`` plus labels [B, S] and an optional loss mask
    [B, S]."""
    logits, aux = _forward(params, cfg, ctx, batch)
    ce = vocab_cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------


def attn_cache_dims(cfg: ModelConfig):
    """(kv heads, head dim) as the cache stores them: MLA's absorbed-latent
    cache is one "head" of kv_lora_rank + rope dims (JAX's
    ``_attn_cache_dims``, whose k and v widths agree)."""
    if cfg.mla is not None:
        return 1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    return cfg.num_kv_heads, cfg.hd


def init_cache(cfg: ModelConfig, batch: int, cap: int, dtype=torch.bfloat16, ctx=None,
               paged=None, kv_dtype: str = "fp"):
    """Decode cache with a per-slot position vector ``pos: [B]`` on
    ``ctx.device``.  Dense: K/V ``[L, B, cap, Hkv, D]`` (MLA: Hkv 1, D the
    latent's width: ``attn_cache_dims``).  ``paged`` (a
    ``serve.kv_pool.PagedLayout``) switches K/V to a physical page pool
    ``[L, num_pages, n*page_size, Hkv, D]`` plus an int32 block table
    ``"bt": [B, max_pages]`` (-1 = unallocated).  ``kv_dtype`` "int8" /
    "fp8" (paged only) stores the pool quantized, with per-(token, kv-head)
    fp32 scales ``"k_scale"/"v_scale": [L, num_pages, n*page_size, Hkv]``
    indexed like the pool.  With ``ctx.sp_size`` n > 1 the layout is JAX's
    global-logical one: rank i of the ring owns the i-th n-th of the dense
    cap axis and of each page's columns.  SSM and hybrid archs add the
    per-slot dense
    ``"ssm": {"conv": [L, B, width-1, conv_dim] in ``dtype``, "state":
    [L, B, H, P, N] fp32}``, one global copy per slot at any n (the states
    are replicated over the ring, as in JAX); the attention-free family has
    no K/V.  Encoder archs add the per-slot dense cross-attention K/V
    ``"cross_k"/"cross_v": [L, B, encoder_seq, H, hd]`` in ``dtype``, which
    prefill writes from the encoder's output."""
    check_supported(cfg)
    ctx = ctx or ParallelCtx()
    dev = resolve_device(ctx.device)
    store = kv_quant.storage_dtype(kv_dtype, dtype)
    if kv_dtype != "fp" and paged is None:
        raise ValueError("quantized KV storage requires the paged cache")
    L = cfg.num_layers
    hkv, d = attn_cache_dims(cfg)
    cache: Dict = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.ssm is not None:
        cache["ssm"] = ssm_mod.init_ssm_cache(cfg, L, batch, dtype, dev)
    if cfg.family == "ssm":
        return cache
    if cfg.encoder_layers:
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((L, batch, cfg.encoder_seq, cfg.num_heads, cfg.hd),
                                     dtype=dtype, device=dev)
    if paged is not None:
        if paged.n != ctx.sp_size:
            raise ValueError(
                f"paged layout is sharded over n={paged.n} but the ctx has sp_size={ctx.sp_size}"
            )
        if paged.virtual_cap < cap:
            raise ValueError(f"paged virtual capacity {paged.virtual_cap} < cap {cap}")
        shape = (L, paged.num_pages, paged.chunk, hkv, d)
        cache["bt"] = torch.full((batch, paged.max_pages), -1, dtype=torch.int32, device=dev)
        if kv_dtype != "fp":
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros(shape[:-1], dtype=kv_quant.SCALE_DTYPE, device=dev)
    else:
        shape = (L, batch, cap, hkv, d)
    cache["k"] = torch.zeros(shape, dtype=store, device=dev)
    cache["v"] = torch.zeros(shape, dtype=store, device=dev)
    return cache


def _layer_cache(cache, i: int) -> Dict:
    """Layer i's views of the K/V (scale, cross-attention K/V) tensors and of
    the SSM state."""
    out = {key: cache[key][i] for key in ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")
           if key in cache}
    if "ssm" in cache:
        out["ssm"] = {key: val[i] for key, val in cache["ssm"].items()}
    return out


def _write_ssm(cache_l: Dict, new: Dict) -> None:
    """Copy a layer's new conv window and state into its cache views."""
    for key in ("conv", "state"):
        cache_l["ssm"][key].copy_(new[key])


def _write_kv(cache, i: int, index, kk, vv) -> None:
    """Write K/V at ``index`` of layer i's cache (quantized for a quantized
    pool, its scales at the same index)."""
    for key, new in (("k", kk), ("v", vv)):
        scales = cache.get(f"{key}_scale")
        kv_quant.store(cache[key][i], None if scales is None else scales[i], index, new)


def _decode_qkv(h, lp, cfg: ModelConfig, pos):
    """Cache-space projections for decode.  h [B,S,D] -> (q [B,S,H,hd],
    k_new [B,S,Hkv,hd], v_new, scale).  ``pos``: scalar, [B] per-slot
    vector (S=1 decode) or a [B, S] position grid.  MLA: W^{kv_b}_K absorbed
    into q (q [B,S,H,kvr+rope] against the latent [B,S,1,kvr+rope], which
    is both k_new and v_new) at the scale qk^-0.5 of the expanded heads."""
    B, S = h.shape[0], h.shape[1]
    pos = torch.as_tensor(pos, device=h.device)
    if pos.dim() == 2:
        positions = pos
    elif pos.dim() == 1:
        positions = pos[:, None]
    else:
        positions = pos.reshape(1)
    if cfg.mla is not None:
        m = cfg.mla
        q_nope, q_rope = attn.mla_q(h, lp, cfg, positions)
        lat = attn.mla_latent(h, lp, cfg, positions)
        # q_lat[h, r] = sum_n q_nope[h, n] Wb[r, h, n]
        wb_k = lp["wkv_b"].reshape(m.kv_lora_rank, cfg.num_heads, -1)[..., : m.qk_nope_head_dim]
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wb_k)
        q_eff = torch.cat([q_lat, q_rope], dim=-1)
        return q_eff, lat, lat, (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    hd = cfg.hd
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rope(q.reshape(B, S, cfg.num_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, cfg.num_kv_heads, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v, hd**-0.5


def _decode_attn_out(o, x, lp, cfg: ModelConfig) -> torch.Tensor:
    """x + the attention output o [B,S,H,D] through ``wo``; MLA: o's latent
    dims (the first kv_lora_rank) through W^{kv_b}_V first."""
    B, S = o.shape[0], o.shape[1]
    if cfg.mla is not None:
        m = cfg.mla
        wb_v = lp["wkv_b"].reshape(m.kv_lora_rank, cfg.num_heads, -1)[..., m.qk_nope_head_dim:]
        o = torch.einsum("bshr,rhv->bshv", o[..., : m.kv_lora_rank], wb_v)
    return x + o.reshape(B, S, -1) @ lp["wo"]


def _decode_block(x, lp, cache_l, cfg: ModelConfig, ctx: ParallelCtx, pos, bt=None,
                  write_coords=None):
    """One layer's decode over this layer's cache slices (updated in place);
    ``bt`` is the layer-shared block table when the cache is paged, and
    ``write_coords`` the layer-shared coordinates of the append."""
    if cfg.family == "ssm":
        y, new = ssm_mod.ssm_decode_step(x, lp["ssm"], cache_l["ssm"], cfg)
        _write_ssm(cache_l, new)
        return y
    B, S = x.shape[0], x.shape[1]
    h = pre_norm(x, lp["attn"], cfg.norm)
    q, k_new, v_new, scale = _decode_qkv(h, lp["attn"], cfg, pos)
    # the decode cache is always striped over the ring's ranks
    o = attn.decode_attention_step(
        q, k_new, v_new, cache_l["k"], cache_l["v"], pos, ctx,
        window=cfg.window, layout="striped", scale=scale, block_table=bt,
        write_coords=write_coords, k_scale=cache_l.get("k_scale"),
        v_scale=cache_l.get("v_scale"),
    )[0]
    y = _decode_attn_out(o, x, lp["attn"], cfg)
    if cfg.hybrid:
        s, new = ssm_mod.ssm_decode_step(x, lp["ssm"], cache_l["ssm"], cfg)
        _write_ssm(cache_l, new)
        y = x + 0.5 * ((y - x) + (s - x))
    if cfg.encoder_layers:
        # cross-attention against the encoder K/V prefill cached
        xp = lp["xattn"]
        qc = (pre_norm(y, xp, cfg.norm) @ xp["wq"]).reshape(B, S, cfg.num_heads, cfg.hd)
        oc, _ = kops.block_attention(qc, cache_l["cross_k"], cache_l["cross_v"],
                                     kops.full_band())
        y = y + oc.reshape(B, S, -1) @ xp["wo"]
    return _ffn_block(y, lp, cfg, ctx)[0]


def decode_step(params, cache, tokens, cfg: ModelConfig, ctx: ParallelCtx):
    """One greedy decode step over all slots: tokens [B,1] -> (next [B,1],
    cache, logits [B,1,V]).  The cache is updated in place (K/V appended at
    each row's ``pos``, then ``pos`` advanced by one for every row); rows of
    free slots tick harmlessly -- their writes are filtered past capacity or
    through unallocated pages, and the engine ignores their outputs (an SSM
    row's state advances too; the next prefill into the slot overwrites it).
    The paged append's coordinates depend only on ``pos`` and the block
    table, so they are computed once here for every layer."""
    pos = cache["pos"]
    bt = cache.get("bt")
    coords = None
    if bt is not None:
        page_size = cache["k"].shape[2] // ctx.sp_size
        coords = dispatch.paged_write_coords(bt, pos, page_size, ctx.ring, ctx.sp_size,
                                             layout="striped")
    x = _embed(params, tokens)
    for i, lp in enumerate(_layer_slices(params["layers"])):
        x = _decode_block(x, lp, _layer_cache(cache, i), cfg, ctx, pos, bt=bt,
                          write_coords=coords)
    logits = _logits(x, params, cfg)
    nxt = torch.argmax(logits, dim=-1).to(tokens.dtype)
    cache["pos"] = pos + 1
    return nxt, cache, logits


def _cache_scatter_indices(cfg: ModelConfig, S: int, cap: int, n: int):
    """Prefill K/V index j -> the dense cache's column (JAX's
    ``_cache_scatter_indices``): position p lives at column (p % n) * (cap/n)
    + p // n (rank p % n, slot p // n).  For striped-train archs index j
    already is position (j // (S/n)) + n * (j % (S/n)) (the engine stripes
    the prompt), which lands in contiguous runs of each rank's slice.  One
    rank: index j is column j, a slice."""
    if n <= 1:
        return slice(None, S)
    j = torch.arange(S)
    p = (j // (S // n)) + n * (j % (S // n)) if cfg.causal_layout == "striped" else j
    return (p % n) * (cap // n) + p // n


def _paged_prefill_coords(positions, bt_rows, n: int, page_size: int, write_mask):
    """Scatter coordinates for writing true positions ``positions`` [S]
    through a block table into the pool ``[num_pages, n*page_size, ...]``.
    ``bt_rows`` is one request's row [max_pages], or a per-token
    [S, max_pages] (packed prefill).  Returns ``(tokens, pages, cols)``:
    the indices of the tokens that are written and where -- masked,
    unallocated and past-capacity tokens are filtered out (JAX sends them to
    an out-of-range page that ``mode="drop"`` discards)."""
    max_pages = bt_rows.shape[-1]
    p = positions.to(torch.int64)
    j = p // n
    lp = j // page_size
    col = (p % n) * page_size + j % page_size
    lp_c = lp.clamp(0, max_pages - 1)
    if bt_rows.dim() == 1:
        page = bt_rows[lp_c]
    else:
        page = torch.gather(bt_rows, 1, lp_c[:, None])[:, 0]
    write = write_mask & (page >= 0) & (lp < max_pages)
    toks = torch.nonzero(write).squeeze(1)
    return toks, page[toks].to(torch.int64), col[toks]


def _project_kv_for_cache(h, lp, cfg: ModelConfig, positions):
    """The K/V (MLA: the latent, as both) a prefill writes into the cache for
    ``h`` [B, S, D]."""
    if cfg.mla is not None:
        lat = attn.mla_latent(h, lp, cfg, positions)
        return lat, lat
    B, S = h.shape[0], h.shape[1]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        k, v = k + lp["bk"], v + lp["bv"]
    k = rope(k.reshape(B, S, cfg.num_kv_heads, cfg.hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.hd)
    return k, v


def prefill(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict, cache):
    """Forward over the prompt, writing the KV cache per layer (in place).

    ``batch``: tokens [B, S], positions [S], optional ``length`` [B] of true
    prompt lengths when tokens are right-padded to a bucket: logits are
    taken at each row's last REAL position (``positions == length - 1``) and
    ``pos`` starts each row at its length; pads are causally invisible to the
    real tokens and decode overwrites each pad's cache entry before reading it.

    A PAGED cache (it carries ``"bt"``) is the whole slot pool: K/V of the
    single request (batch 1) scatter through the block-table row of
    ``batch["slot"]``; positions below ``batch["shared_len"]`` (a prefix
    admitted as shared pages) and pads are not written.

    SSM and hybrid archs keep each layer's final conv window and state in
    ``cache["ssm"]`` (dense cache only): the prompt must be unpadded, since
    the recurrence has no pad correction (the engine's exact mode).  Over a
    ring (``ctx.sp_size`` > 1) the SSD blocks run the sequence-sharded scan
    (``models/ssm.py``) and keep its global state and conv tail.

    Frontend archs take their side inputs in ``batch`` as ``forward`` does:
    pixtral merges ``patches`` below ``num_patches``; whisper encodes
    ``frames`` once and writes every layer's cross-attention K/V into
    ``cache["cross_k"/"cross_v"]`` (dense cache only).

    Returns (logits [B, 1, V], cache)."""
    check_supported(cfg)
    tokens, positions = batch["tokens"], batch["positions"]
    positions = torch.as_tensor(positions, device=params["embed"].device)
    B, S = tokens.shape
    has_attn = cfg.family != "ssm"
    paged = "bt" in cache
    if paged and (cfg.ssm is not None or cfg.encoder_layers):
        raise ValueError("the paged cache serves attention-only decoder archs")
    x, enc = _embed_inputs(params, cfg, ctx, batch, positions)
    if paged:
        if B != 1:
            raise ValueError("paged prefill writes one request (batch=1) per call")
        n = ctx.sp_size
        page_size = cache["k"].shape[2] // n
        slot = int(batch["slot"])
        shared_len = int(batch.get("shared_len", 0))
        length_s = int(torch.as_tensor(batch["length"]).reshape(-1)[0]) if "length" in batch else S
        write_mask = (positions < length_s) & (positions >= shared_len)
        toks, pages, cols = _paged_prefill_coords(
            positions, cache["bt"][slot], n, page_size, write_mask
        )
    elif has_attn:
        cap = cache["k"].shape[2]
        if S > cap:
            raise ValueError(f"prompt of {S} tokens exceeds the cache capacity {cap}")
        cols = _cache_scatter_indices(cfg, S, cap, ctx.sp_size)
        if isinstance(cols, torch.Tensor):
            cols = cols.to(x.device)

    for i, lp in enumerate(_layer_slices(params["layers"])):
        if has_attn:
            h = pre_norm(x, lp["attn"], cfg.norm)
            kk, vv = _project_kv_for_cache(h, lp["attn"], cfg, positions)
            if paged:
                _write_kv(cache, i, (pages, cols), kk[0, toks], vv[0, toks])
            else:
                _write_kv(cache, i, (slice(None), cols), kk, vv)
        enc_kv = None
        if enc is not None:
            # the encoder rows' cross K/V: cached for decode, attended here
            enc_kv = attn.cross_kv(enc, lp["xattn"], cfg)
            for key, new in zip(("cross_k", "cross_v"), enc_kv):
                cache[key][i].copy_(new)
        # the SSD block keeps its final conv window and state in the cache
        ssm_cache = _layer_cache(cache, i) if cfg.ssm is not None else None
        x = _decoder_block(x, lp, cfg, ctx, positions, ssm_cache=ssm_cache, enc=enc,
                           enc_kv=enc_kv)[0]

    if "length" in batch:
        length = torch.as_tensor(batch["length"], device=x.device).to(torch.int64).reshape(B)
        last_idx = (positions[None, :] == (length[:, None] - 1)).to(torch.int32).argmax(dim=1)
        new_pos = length
    else:
        # the last position need not be the last index (striped layouts)
        last_idx = torch.argmax(positions).expand(B)
        new_pos = torch.full((B,), S, device=x.device)
    x_last = x[torch.arange(B, device=x.device), last_idx][:, None]  # [B, 1, D]
    logits = _logits(x_last, params, cfg)
    if paged:
        # the pool cache's pos covers every slot; only this one was prefilled
        cache["pos"][slot] = length_s
    else:
        cache["pos"] = new_pos.to(device=cache["pos"].device, dtype=torch.int32)
    return logits, cache


def prefill_packed(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict, cache):
    """Packed multi-document prefill: several prompts share ONE batch row
    under a segment mask (causal within each prompt, nothing across), and
    each document's K/V is written into ITS OWN slot of the pool cache.

    ``batch``: tokens [1, P] (the packed, right-padded row), positions [P]
    (per-document, restarting at each document; RoPE uses these, while the
    causal band runs over the row index), segments [P] (document id; pads
    carry an id >= k), doc_lens [k], slots [k], optional shared_lens [k]
    (paged only: positions below are left to the pages' owner).

    ``cache`` is the dense pool ([L, num_slots, cap, ...]) or the paged pool
    with its block table.  Returns (first-token logits [k, V], cache).
    Attention-only decoder archs: the SSD state has no per-document reset,
    and encoder / frontend archs have per-row side inputs that do not pack."""
    check_supported(cfg)
    if cfg.ssm is not None or cfg.encoder_layers or cfg.frontend:
        raise ValueError("packed prefill supports attention-only decoder archs")
    dev = params["embed"].device
    tokens = batch["tokens"]
    positions = torch.as_tensor(batch["positions"], device=dev)
    segments = torch.as_tensor(batch["segments"], device=dev).to(torch.int32)
    doc_lens = torch.as_tensor(batch["doc_lens"], device=dev).to(torch.int64)
    slots = torch.as_tensor(batch["slots"], device=dev).to(torch.int64)
    k_docs = slots.shape[0]
    n = ctx.sp_size
    x = _embed(params, tokens)

    pad = segments >= k_docs
    seg_c = segments.clamp(0, k_docs - 1).to(torch.int64)
    if "bt" in cache:
        page_size = cache["k"].shape[2] // n
        shared = batch.get("shared_lens")
        shared = (
            torch.zeros((k_docs,), dtype=torch.int64, device=dev) if shared is None
            else torch.as_tensor(shared, device=dev).to(torch.int64)
        )
        write_mask = (~pad) & (positions >= shared[seg_c])
        toks, rows, cols = _paged_prefill_coords(
            positions, cache["bt"][slots[seg_c]], n, page_size, write_mask
        )
    else:
        # document d's position p lands in slot row slots[d] at the striped
        # cache column (p % n) * (cap/n) + p // n; pads are filtered out
        cap = cache["k"].shape[2]
        toks = torch.nonzero(~pad).squeeze(1)
        rows = slots[seg_c[toks]]
        p = positions[toks].to(torch.int64)
        cols = (p % n) * (cap // n) + p // n

    for i, lp in enumerate(_layer_slices(params["layers"])):
        h = pre_norm(x, lp["attn"], cfg.norm)
        kk, vv = _project_kv_for_cache(h, lp["attn"], cfg, positions)
        _write_kv(cache, i, (rows, cols), kk[0, toks], vv[0, toks])
        x = _decoder_block(x, lp, cfg, ctx, positions, segments=segments)[0]

    # document d's last real token sits where segments == d AND positions ==
    # doc_lens[d] - 1
    match = (segments[None, :] == torch.arange(k_docs, device=dev)[:, None]) & (
        positions[None, :] == (doc_lens - 1)[:, None]
    )
    last_idx = match.to(torch.int32).argmax(dim=1)  # [k]
    logits = _logits(x[0, last_idx], params, cfg)  # [k, V]
    cache["pos"][slots] = doc_lens.to(torch.int32)
    return logits, cache


# --------------------------------------------------------------------------
# continuous prefill and speculative verify: chunks over the live cache
# --------------------------------------------------------------------------


def _chunk_forward(params, cfg: ModelConfig, ctx: ParallelCtx, tokens, starts, lens,
                   write_starts, cache) -> torch.Tensor:
    """Shared core of ``prefill_chunk`` and ``verify_step``: append a [B, C]
    chunk batch into the live cache (in place) through the banded multi-row
    attention and return the hidden states [B, C, D] of every chunk
    position, before the final norm.  Attention-only decoder archs: no SSM
    state, no encoder, no frontend."""
    check_supported(cfg)
    if cfg.ssm is not None or cfg.encoder_layers or cfg.frontend is not None:
        raise ValueError("chunked prefill serves attention-only decoder archs")
    dev = params["embed"].device
    starts = torch.as_tensor(starts, device=dev).to(torch.int64)
    lens = torch.as_tensor(lens, device=dev).to(torch.int64)
    write_starts = torch.as_tensor(write_starts, device=dev).to(torch.int64)
    B, C = tokens.shape
    positions = starts[:, None] + torch.arange(C, device=dev)[None, :]
    bt = cache.get("bt")
    # where the chunk's K/V land depends only on the rows and the block
    # table: computed once (one host read-back) for every layer
    n = ctx.sp_size
    coords = dispatch.chunk_write_coords(
        starts, lens, write_starts, C, ctx.ring, n, "striped", m=cache["k"].shape[2],
        block_table=bt, page_size=cache["k"].shape[2] // n,
    )
    x = _embed(params, tokens)
    for i, lp in enumerate(_layer_slices(params["layers"])):
        cache_l = _layer_cache(cache, i)
        h = pre_norm(x, lp["attn"], cfg.norm)
        q, k_new, v_new, scale = _decode_qkv(h, lp["attn"], cfg, positions)
        # the decode cache is always striped over the ring: chunk rows
        # scatter by absolute position exactly like single-token appends
        o = attn.chunk_attention_step(
            q, k_new, v_new, cache_l["k"], cache_l["v"], starts, lens, write_starts, ctx,
            window=cfg.window, layout="striped", scale=scale, block_table=bt,
            k_scale=cache_l.get("k_scale"), v_scale=cache_l.get("v_scale"),
            write_coords=coords,
        )[0]
        x = _decode_attn_out(o, x, lp["attn"], cfg)
        x = _ffn_block(x, lp, cfg, ctx)[0]
    return x


def prefill_chunk(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict, cache):
    """Continuous prefill: append one C-token chunk per slot into the live
    cache (in place) and attend prefix-causally over everything resident.

    ``batch`` holds [B (= num_slots), C] operands: ``tokens`` (right-padded
    per row), ``starts`` [B] (absolute position of each row's chunk base),
    ``lens`` [B] (valid tokens; 0 = inactive row: nothing written, output
    ignored), ``write_starts`` [B] (skip K/V writes below: a shared prefix
    already resident) and ``pos_set`` [B] (new ``cache["pos"]`` per row, or
    -1 to keep it: mid-prefill rows stay parked past capacity).

    Returns (logits [B, V] at each row's last valid chunk token, cache)."""
    tokens = batch["tokens"]
    dev = params["embed"].device
    lens = torch.as_tensor(batch["lens"], device=dev).to(torch.int64)
    pos_set = torch.as_tensor(batch["pos_set"], device=dev).to(torch.int32)
    B, C = tokens.shape
    x = _chunk_forward(params, cfg, ctx, tokens, batch["starts"], lens,
                       batch["write_starts"], cache)
    last = (lens - 1).clamp(0, C - 1)
    logits = _logits(x[torch.arange(B, device=dev), last], params, cfg)  # [B, V]
    cache["pos"] = torch.where(pos_set >= 0, pos_set, cache["pos"])
    return logits, cache


def verify_step(params, cfg: ModelConfig, ctx: ParallelCtx, batch: Dict, cache,
                return_logits: bool = False):
    """Speculative verify: score K candidate tokens per slot in ONE chunk
    launch and commit the longest accepted prefix.

    ``batch``: ``tokens`` [B, K] (column 0 the row's current token, columns
    1.. the draft), ``starts`` [B] (each row's cache position), ``lens`` [B]
    (0: inactive; 1: a plain decode tick; k: a k-1 token draft) and
    ``write_starts`` [B].  With ``y[i]`` the argmax at chunk position i,
    draft token ``tokens[i+1]`` is accepted while it equals ``y[i]``; the
    committed tokens are ``y[0 .. commit-1]`` with ``commit = accepted + 1``.
    K/V past the committed prefix is stale and band-invisible.

    Returns ``(y [B, K] int32, commit [B] int32, cache)`` with ``pos =
    starts + commit`` for active rows, plus the logits [B, K, V] with
    ``return_logits``."""
    tokens = batch["tokens"]
    dev = params["embed"].device
    starts = torch.as_tensor(batch["starts"], device=dev).to(torch.int64)
    lens = torch.as_tensor(batch["lens"], device=dev).to(torch.int64)
    B, K = tokens.shape
    x = _chunk_forward(params, cfg, ctx, tokens, starts, lens, batch["write_starts"], cache)
    logits = _logits(x, params, cfg)  # [B, K, V]
    y = torch.argmax(logits, dim=-1).to(torch.int32)
    if K > 1:
        drafts = tokens[:, 1:].to(device=dev, dtype=torch.int32)
        match = (drafts == y[:, :-1]) & (torch.arange(1, K, device=dev)[None, :] < lens[:, None])
        accepted = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
    else:
        accepted = torch.zeros((B,), dtype=torch.int64, device=dev)
    commit = torch.where(lens > 0, torch.minimum(accepted + 1, lens), torch.zeros_like(lens))
    cache["pos"] = torch.where(lens > 0, starts + commit, cache["pos"].to(torch.int64)).to(
        torch.int32
    )
    commit = commit.to(torch.int32)
    if return_logits:
        return y, commit, cache, logits
    return y, commit, cache
