"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against on the card, and
what the kernel wrappers run for tensors that lie on the CPU.

Conventions shared with the kernels:
  * q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] with H % Hkv == 0 (GQA).
  * outputs: o [B, Sq, H, D] and lse [B, H, Sq] (natural log-sum-exp of the
    scaled scores; ``NEG_INF`` for fully-masked rows).
  * masking is a *band* in token space: position pair (i, j) is visible iff
    ``lo <= (q_offset + stride_q*i) - (kv_offset + stride_kv*j) <= hi``.
    A band entry may be a Python int or a ``[B]`` tensor (one band per batch
    row, as a dense-cache decode step uses).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

NEG_INF = -1e30
BAND_INF = 2**30

BandEntry = Union[int, torch.Tensor]
Band = Tuple[BandEntry, BandEntry, BandEntry, BandEntry]


def band_mask(
    sq: int,
    sk: int,
    band: Sequence[BandEntry],
    *,
    stride_q: int = 1,
    stride_kv: int = 1,
    device=None,
) -> torch.Tensor:
    """[Sq, Sk] bool, or [B, Sq, Sk] when band entries are [B] tensors."""
    q_off, kv_off, lo, hi = (
        torch.as_tensor(x, dtype=torch.int64, device=device) for x in band
    )
    qpos = q_off[..., None] + stride_q * torch.arange(sq, device=device)
    kpos = kv_off[..., None] + stride_kv * torch.arange(sk, device=device)
    diff = qpos[..., :, None] - kpos[..., None, :]
    return (diff >= lo[..., None, None]) & (diff <= hi[..., None, None])


def repeat_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """Expand Hkv heads to H query heads (GQA)."""
    hkv = x.shape[2]
    if hkv == h:
        return x
    return torch.repeat_interleave(x, h // hkv, dim=2)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention in fp32 under a boolean mask broadcastable to
    [B, H, Sq, Skv]; masked scores are replaced (never added to), so garbage
    behind the mask cannot leak into visible rows."""
    H = q.shape[2]
    kr = repeat_kv(k, H).float()
    vr = repeat_kv(v, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)  # fully-masked rows
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vr)
    lse = torch.where(
        l[..., 0] > 0, m[..., 0] + torch.log(l_safe[..., 0]),
        torch.full_like(l[..., 0], NEG_INF),
    )
    return o.to(q.dtype), lse.float()


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    band: Optional[Sequence[BandEntry]] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    seg_q: Optional[torch.Tensor] = None,  # [Sq] int32 segment ids
    seg_kv: Optional[torch.Tensor] = None,  # [Skv]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [B,Sq,H,D], lse [B,H,Sq]); fp32 softmax arithmetic.

    ``seg_q``/``seg_kv`` compose a segment-id (packed-document) mask with the
    band: (i, j) visible iff the band admits it AND seg_q[i] == seg_kv[j].
    """
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    if scale is None:
        scale = D**-0.5
    mask = None
    if band is not None:
        mask = band_mask(Sq, Sk, band, stride_q=stride_q, stride_kv=stride_kv, device=q.device)
        mask = mask[:, None] if mask.dim() == 3 else mask  # per-row bands: [B,1,Sq,Sk]
    if seg_q is not None:
        sm = seg_q.to(q.device)[:, None] == seg_kv.to(q.device)[None, :]
        mask = sm if mask is None else (mask & sm)
    return masked_attention(q, k, v, mask, scale)


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: Optional[torch.Tensor],
    lse: torch.Tensor,  # [B, H, Sq]
    do: torch.Tensor,  # [B, Sq, H, D]
    *,
    scale: Optional[float] = None,
    band: Optional[Sequence[int]] = None,
    stride_q: int = 1,
    stride_kv: int = 1,
    delta: Optional[torch.Tensor] = None,  # [B, Sq, H]; derived from o if None
    seg_q: Optional[torch.Tensor] = None,  # [Sq] int32 segment ids
    seg_kv: Optional[torch.Tensor] = None,  # [Skv]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward from the saved (o, lse): returns (dq, dk, dv)
    in the input types; fp32 arithmetic.

    The math of the backward kernels: P = exp(S - lse) on visible pairs,
    dS = P * (dP - delta) * scale, with dk/dv summed over the GQA query-head
    group.  ``delta`` (= rowsum(do * o)) may be passed instead of ``o``.
    Masked pairs are selected to 0, so an empty row (lse = NEG_INF) gives 0.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D**-0.5
    g = H // Hkv
    kr = repeat_kv(k, H).float()
    vr = repeat_kv(v, H).float()
    qf = q.float()
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    p = torch.exp(s - lse.float()[..., None])  # true softmax weights via the final lse
    mask = None
    if band is not None:
        mask = band_mask(Sq, Sk, band, stride_q=stride_q, stride_kv=stride_kv, device=q.device)
    if seg_q is not None:
        sm = seg_q.to(q.device)[:, None] == seg_kv.to(q.device)[None, :]
        mask = sm if mask is None else (mask & sm)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    if delta is None:
        delta = torch.sum(dof * o.float(), dim=-1)  # [B, Sq, H]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta.float().transpose(1, 2)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, Sk, Hkv, g, D).sum(dim=3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, Sk, Hkv, g, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def combine_partials(
    o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor, lse2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax reduce of two partial attention outputs over disjoint
    KV sets.  o: [B, S, H, D]; lse: [B, H, S].  Safe for NEG_INF partials."""
    m = torch.maximum(lse1, lse2).clamp_min(NEG_INF)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    tot = w1 + w2
    tot_safe = torch.where(tot > 0, tot, torch.ones_like(tot))
    c1 = (w1 / tot_safe)[..., None].transpose(1, 2)  # [B,S,H,1]
    c2 = (w2 / tot_safe)[..., None].transpose(1, 2)
    o = o1 * c1.to(o1.dtype) + o2 * c2.to(o2.dtype)
    lse = torch.where(tot > 0, m + torch.log(tot_safe), torch.full_like(tot, NEG_INF))
    return o, lse


# --------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) oracle: the sequential recurrence
# --------------------------------------------------------------------------


def ssd_ref(
    x: torch.Tensor,  # [B, S, H, P]   (P = head channel dim)
    dt: torch.Tensor,  # [B, S, H]     (softplus-activated step sizes)
    A: torch.Tensor,  # [H]            (negative decay rates)
    Bm: torch.Tensor,  # [B, S, G, N]  (input projection, G state groups)
    Cm: torch.Tensor,  # [B, S, G, N]  (output projection)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference of the SSD recurrence (arXiv:2405.21060):

        h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T
        y_t = C_t h_t

    in fp32, one step per token from h_0 = 0.  Returns (y [B,S,H,P] in x's
    dtype, final_state [B,H,P,N] fp32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    Bh = Bm.to(f32).repeat_interleave(rep, dim=2)  # [B,S,H,N]
    Ch = Cm.to(f32).repeat_interleave(rep, dim=2)
    xf, dtf = x.to(f32), dt.to(f32)
    decay = torch.exp(dtf * A.to(f32)[None, None, :])  # [B,S,H]
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * Bh[:, t, :, None, :]
        h = decay[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    return y.to(x.dtype), h
