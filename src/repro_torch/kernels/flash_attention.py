"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention_fwd``
and ``flash_attention_bwd``).  Both run every product on the tensor cores,
bf16 inputs as one term per value and fp32 inputs as two bf16 terms (hi +
lo) written by a split pre-pass.  The forward is ``csrc/flash_fwd_tc.cuh``,
built as ``csrc/flash_fwd_tc.cu`` and, at MLA's head dims 96 and 288, as
``csrc/flash_fwd_mla.cu``, with two bodies picked by shape (``_fwd_plan``):
the tile body (wgmma) for prefill, chunks, windows and training, the decode
body (mma.sync, split keys) for at most ``DECODE_MAX_ROWS`` packed rows
(``DECODE_MAX_ROWS_D256`` at head dim 256; none at
``TILE_ONLY_HEAD_DIMS``); each has a bf16 and an fp32 instantiation, at
head dims ``FWD_HEAD_DIMS``.  The backward is ``csrc/flash_bwd.cu``: the dQ
and dK/dV kernels (``_bwd_plan``), at head dims ``BWD_HEAD_DIMS`` (at 96 as
three 32-dim column blocks, at 256 with 32-row streamed tiles and two
warpgroups a CTA).  See the notes at the sources' tops for the designs.

The wrappers launch the kernels for CUDA tensors and run the plain versions
(``ref.attention_ref``, ``ref.attention_bwd_ref``) for CPU tensors; there is
no other fallback.  ``flash_attention_fwd.launches`` counts forward launches
and ``.launches_<body>`` those of each body of ``_fwd_plan`` (``tile``,
``decode``: bf16; ``tile_fp32``, ``decode_fp32``), ``.launches_fp32`` the
fp32 ones of both; ``fwd_split_terms.launches`` counts the fp32 forward's
pre-pass.  ``flash_attention_bwd.launches_dq`` and ``.launches_dkv`` count
the two backward kernels' launches, ``.launches_tc_bf16`` and
``.launches_tc_fp32`` the backward calls of each body;
``split_terms.launches`` counts the fp32 backward's pre-pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_KV = 128
# both directions take head dim 256 (gemma-7b) and minicpm3-4b's 96 (the
# expanded heads of MLA's prefill and training) too; the forward also takes
# 288 (the absorbed latent of decode, chunks and verifies); both MLA widths
# run on its tile body alone
FWD_HEAD_DIMS = (32, 64, 96, 128, 256, 288)
BWD_HEAD_DIMS = (32, 64, 96, 128, 256)
TILE_ONLY_HEAD_DIMS = (96, 288)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the decode body takes up to 32 packed rows (Sq * H / Hkv): a decode tick
# (Sq = 1) and a speculative verify (Sq = spec_k), in either type; at head
# dim 256 one 16-row tile (its o accumulators fill a lane's registers)
DECODE_MAX_ROWS = 32
DECODE_MAX_ROWS_D256 = 16
# key splits fill the card when B * Hkv CTAs would leave most of its SMs idle
NUM_SMS = 132  # H100 SXM
MAX_SPLITS = 8

# bf16 terms per input value of each forward body: bf16 inputs are exact in
# one, fp32 inputs go in as hi + lo (tests/test_torch_fwd_split.py)
FWD_TERMS = {"tile": 1, "decode": 1, "tile_fp32": 2, "decode_fp32": 2}
# bf16 terms of P in both bodies (csrc/flash_fwd_tc.cu's PFrag)
FWD_P_TERMS = 3

BandArg = Union[Sequence[Union[int, torch.Tensor]], torch.Tensor]


def _band_tuple(band: BandArg, batch: int):
    """Band as a 4-tuple for the plain version: ints, or [B] tensors for a
    per-row [B, 4] band tensor."""
    if isinstance(band, torch.Tensor):
        if band.dim() == 1:
            return tuple(int(x) for x in band.tolist())
        if band.shape != (batch, 4):
            raise ValueError(f"band tensor must be [4] or [B={batch}, 4], got {tuple(band.shape)}")
        return tuple(band[:, i] for i in range(4))
    return tuple(band)


def _band_device(band: BandArg, batch: int, device) -> Tuple[torch.Tensor, int]:
    """(int32 band on the device, batch stride) for the kernel."""
    if not isinstance(band, torch.Tensor):
        entries = list(band)
        if any(isinstance(x, torch.Tensor) and x.dim() == 1 for x in entries):
            band = torch.stack(
                [torch.as_tensor(x, device=device).to(torch.int32).expand(batch) for x in entries],
                dim=1,
            )
        else:
            band = torch.tensor([int(x) for x in entries], dtype=torch.int32)
    band = band.to(device=device, dtype=torch.int32).contiguous()
    if band.dim() == 1 and band.shape == (4,):
        return band, 0
    if band.shape == (batch, 4):
        return band, 4
    raise ValueError(f"band must be [4] or [B={batch}, 4], got {tuple(band.shape)}")


def _check_kernel_inputs(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         stride_q: int, stride_kv: int, head_dims: Tuple[int, ...]) -> None:
    """What the CUDA kernels take: q [B,Sq,H,D]; k, v [B,Skv,Hkv,D] with
    q's device and dtype (fp32/bf16), D in ``head_dims``, contiguous."""
    B, _, _, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must match q's device and dtype ({q.device}, {q.dtype})")
        if t.shape != (B, Skv, Hkv, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, Skv, Hkv, D)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in head_dims:
        raise ValueError(f"{fn} kernel takes head dims {head_dims}, not {D}")
    if stride_q < 1 or stride_kv < 1:
        raise ValueError("strides must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _seg_device(seg_q, seg_kv, Sq: int, Skv: int, device):
    if seg_q is None:
        return None, None
    seg_q = seg_q.to(device=device, dtype=torch.int32).contiguous()
    seg_kv = seg_kv.to(device=device, dtype=torch.int32).contiguous()
    if seg_q.shape != (Sq,) or seg_kv.shape != (Skv,):
        raise ValueError("seg_q must be [Sq] and seg_kv [Skv]")
    # the forward's tile body and the backward's dQ kernel read seg_kv with
    # TMA, the backward's dK/dV kernel seg_q
    if seg_kv.data_ptr() % 16:
        seg_kv = seg_kv.clone()
    if seg_q.data_ptr() % 16:
        seg_q = seg_q.clone()
    return seg_q, seg_kv


def _fwd_plan(B: int, Sq: int, H: int, Hkv: int, D: int, dtype) -> Tuple[str, int]:
    """(body, key splits) of the forward, from the shapes and type alone (the
    host never reads the band): "decode" when the packed rows of one kv head
    (Sq * H / Hkv) fit the decode body, with the keys split across CTAs when
    B * Hkv CTAs would leave most of the SMs idle, else "tile" (always at
    ``TILE_ONLY_HEAD_DIMS``); with a "_fp32" suffix for fp32 inputs (their
    two-term instantiations)."""
    if D not in FWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd kernel takes head dims {FWD_HEAD_DIMS}, not {D}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd kernel takes float32 or bfloat16, not {dtype}")
    suffix = "_fp32" if dtype == torch.float32 else ""
    if (D in TILE_ONLY_HEAD_DIMS
            or Sq * (H // Hkv) > (DECODE_MAX_ROWS_D256 if D == 256 else DECODE_MAX_ROWS)):
        return "tile" + suffix, 1
    ctas = B * Hkv
    if 2 * ctas > NUM_SMS:
        return "decode" + suffix, 1
    return "decode" + suffix, min(MAX_SPLITS, -(-2 * NUM_SMS // ctas))


# bf16 terms per input value of each backward body: bf16 inputs are exact
# in one, fp32 inputs go in as hi + lo (tests/test_torch_bwd_split.py)
BWD_TERMS = {"tc_bf16": 1, "tc_fp32": 2}
# bf16 terms of P and dS in both bodies (csrc/flash_bwd.cu's TP)
BWD_P_TERMS = 2


def _bwd_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int, dtype) -> str:
    """The backward's body, from the shapes and type alone (the host never
    reads the band): "tc_bf16" for bf16 inputs, "tc_fp32" for fp32 inputs
    (split into two bf16 terms by a pre-pass).  Both run the tensor-core dQ
    and dK/dV kernels, at every head dim of ``BWD_HEAD_DIMS``; raises for
    what they do not take."""
    if H < 1 or Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes head dims {BWD_HEAD_DIMS}, not {D}")
    if dtype == torch.float32:
        return "tc_fp32"
    if dtype == torch.bfloat16:
        return "tc_bf16"
    raise TypeError(f"flash_attention_bwd kernel takes float32 or bfloat16, not {dtype}")


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    band: BandArg,  # 4 ints / int32 [4] / int32 [B, 4]: (q_off, kv_off, lo, hi)
    *,
    scale: float,
    stride_q: int = 1,
    stride_kv: int = 1,
    block_q: int = DEFAULT_BLOCK_Q,
    block_kv: int = DEFAULT_BLOCK_KV,
    seg_q: Optional[torch.Tensor] = None,  # [Sq] int32 segment ids
    seg_kv: Optional[torch.Tensor] = None,  # [Skv]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [B,Sq,H,D] in q.dtype, lse [B,H,Sq] fp32).

    ``block_q``/``block_kv`` are kept for signature parity with the TPU
    kernel; the CUDA tile is the kernel's own, and it masks the ragged edge
    instead of requiring ``Sq % block_q == 0``."""
    del block_q, block_kv
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("pass both seg_q and seg_kv, or neither")
    if q.device.type == "cpu":
        return ref.attention_ref(
            q, k, v, scale=scale, band=_band_tuple(band, B),
            stride_q=stride_q, stride_kv=stride_kv, seg_q=seg_q, seg_kv=seg_kv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, not {q.device}")
    _check_kernel_inputs("flash_attention_fwd", q, k, v, stride_q, stride_kv, FWD_HEAD_DIMS)
    band_d, band_stride = _band_device(band, B, q.device)
    seg_q, seg_kv = _seg_device(seg_q, seg_kv, Sq, Skv, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0:
        return o, lse.fill_(ref.NEG_INF)
    body, splits = _fwd_plan(B, Sq, H, Hkv, D, q.dtype)
    terms = FWD_TERMS[body]
    # fp32: the bf16 terms of each operand, [terms, *shape] (fresh, so
    # 16-byte aligned as TMA needs)
    operands = fwd_split_terms(q, k, v) if terms > 1 else (q, k, v)
    if body == "tile" and (k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("the tile body reads k and v with TMA: they must be 16-byte aligned")
    ptrs = (
        *(t.data_ptr() for t in operands), band_d.data_ptr(), band_stride,
        seg_q.data_ptr() if seg_q is not None else None,
        seg_kv.data_ptr() if seg_kv is not None else None,
        o.data_ptr(), lse.data_ptr(),
    )
    dims = (B, Sq, Skv, H, Hkv, D, float(scale), int(stride_q), int(stride_kv), terms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # MLA's head dims are a library of their own (csrc/flash_fwd_mla.cu)
    lib = _build.load("flash_fwd_mla" if D in TILE_ONLY_HEAD_DIMS else "flash_fwd_tc")
    if body.startswith("tile"):
        _build.check(lib.flash_fwd_tile(*ptrs, *dims, stream), "flash_fwd_tile")
    else:
        parts = (None, None)
        if splits > 1:  # the splits' normalized partials, merged by their lse
            o_parts = torch.empty((splits, B, Sq, H, D), dtype=torch.float32, device=q.device)
            lse_parts = torch.empty((splits, B, H, Sq), dtype=torch.float32, device=q.device)
            parts = (o_parts.data_ptr(), lse_parts.data_ptr())
        _build.check(lib.flash_fwd_decode(*ptrs, *parts, splits, *dims, stream),
                     "flash_fwd_decode")
    setattr(flash_attention_fwd, f"launches_{body}",
            getattr(flash_attention_fwd, f"launches_{body}") + 1)
    if terms > 1:
        flash_attention_fwd.launches_fp32 += 1
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_tile = 0
flash_attention_fwd.launches_decode = 0
flash_attention_fwd.launches_tile_fp32 = 0
flash_attention_fwd.launches_decode_fp32 = 0
flash_attention_fwd.launches_fp32 = 0


def split_terms_ref(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) as [2, *x.shape] bf16 terms: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return torch.stack([hi, (x - hi.float()).to(torch.bfloat16)])


def _split(source: str, entry: str, xs: Tuple[torch.Tensor, ...], counter):
    """The fp32 bodies' pre-pass: each of xs (fp32, contiguous, on one
    device) as [2, *shape] bf16 terms (hi, lo), which the tensor-core bodies
    load like bf16 tiles.  One launch of ``entry`` in ``csrc/<source>.cu``
    for CUDA tensors, counted on ``counter.launches``; the plain version for
    CPU tensors."""
    if xs[0].device.type == "cpu":
        return tuple(split_terms_ref(t) for t in xs)
    if any(t.dtype != torch.float32 or t.device != xs[0].device or not t.is_contiguous()
           for t in xs):
        raise ValueError(f"{counter.__name__} takes contiguous float32 tensors on one device")
    out = tuple(torch.empty((2, *t.shape), dtype=torch.bfloat16, device=t.device) for t in xs)
    n = len(xs)
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    _build.check(getattr(_build.load(source), entry)(
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in xs)),
        (ctypes.c_void_p * n)(*(t.data_ptr() for t in out)),
        (ctypes.c_longlong * n)(*(t.numel() for t in xs)), n, stream), entry)
    counter.launches += 1
    return out


def fwd_split_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The fp32 forward's pre-pass (``_split``): q, k, v (v shaped as k)."""
    if v.shape != k.shape:
        raise ValueError("v must be shaped as k")
    return _split("flash_fwd_tc", "flash_fwd_split", (q, k, v), fwd_split_terms)


fwd_split_terms.launches = 0


def split_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor):
    """The fp32 backward body's pre-pass (``_split``): q, k, v, do (do
    shaped as q, v as k)."""
    if do.shape != q.shape or v.shape != k.shape:
        raise ValueError("do must be shaped as q, and v as k")
    return _split("flash_bwd", "flash_bwd_split", (q, k, v, do), split_terms)


split_terms.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    o: Optional[torch.Tensor],  # [B, Sq, H, D]; may be None when delta is given
    lse: torch.Tensor,  # [B, H, Sq] fp32
    do: torch.Tensor,  # [B, Sq, H, D]
    band: BandArg,  # 4 ints / int32 [4]: (q_off, kv_off, lo, hi)
    *,
    scale: float,
    stride_q: int = 1,
    stride_kv: int = 1,
    block_q: int = DEFAULT_BLOCK_Q,
    block_kv: int = DEFAULT_BLOCK_KV,
    delta: Optional[torch.Tensor] = None,  # [B, Sq, H] = rowsum(do * o)
    seg_q: Optional[torch.Tensor] = None,  # [Sq] int32 segment ids
    seg_kv: Optional[torch.Tensor] = None,  # [Skv]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward from the saved (o, lse): (dq, dk, dv) in the
    input types, dk/dv summed over the GQA group.

    ``delta`` is computed in plain PyTorch from ``o`` when it is not passed,
    as JAX does outside its Pallas calls; the kernels read it as fp32
    [B, H, Sq].  The band is one for the whole batch (JAX's backward takes
    no per-row band).  ``block_q``/``block_kv`` are kept for signature
    parity; the CUDA tiles are the kernels' own."""
    del block_q, block_kv
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("pass both seg_q and seg_kv, or neither")
    if delta is None and o is None:
        raise ValueError("pass o or delta")
    if isinstance(band, torch.Tensor):
        if band.shape != (4,):
            raise ValueError(
                f"the backward takes one band for the batch ([4]), not {tuple(band.shape)}"
            )
    else:
        band = tuple(int(x) for x in band)
        if len(band) != 4:
            raise ValueError(f"band must have 4 entries, got {band}")
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(
            q, k, v, o, lse, do, scale=scale, band=_band_tuple(band, B), stride_q=stride_q,
            stride_kv=stride_kv, delta=delta, seg_q=seg_q, seg_kv=seg_kv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    body = _bwd_plan(B, Sq, Skv, H, Hkv, D, q.dtype)
    _check_kernel_inputs("flash_attention_bwd", q, k, v, stride_q, stride_kv, BWD_HEAD_DIMS)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q ({tuple(q.shape)}, {q.dtype}, {q.device})")
    if not do.is_contiguous():
        raise ValueError("do must be contiguous")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 [B, H, Sq] = {(B, H, Sq)} on {q.device}")
    if delta is None:
        delta = torch.sum(do.float() * o.float(), dim=-1)
    if delta.shape != (B, Sq, H) or delta.device != q.device:
        raise ValueError(f"delta must be [B, Sq, H] = {(B, Sq, H)} on {q.device}")
    delta_t = delta.float().transpose(1, 2).contiguous()  # [B, H, Sq], the kernels' layout
    lse = lse.contiguous()
    # the kernels read their operands with TMA: the bf16 inputs themselves,
    # or the fp32 inputs' terms (fresh scratch); lse and delta either way
    tma = {"lse": lse, "delta": delta_t}
    if body == "tc_bf16":
        tma.update(q=q, k=k, v=v, do=do)
    for name, t in tma.items():
        if t.data_ptr() % 16:
            raise ValueError(f"the backward reads {name} with TMA: it must be 16-byte aligned")
    band_d, _ = _band_device(band, B, q.device)
    seg_q, seg_kv = _seg_device(seg_q, seg_kv, Sq, Skv, q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B == 0 or Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # fp32: hi and lo bf16 terms of each operand, [2, *shape]
    operands = split_terms(q, k, v, do) if body == "tc_fp32" else (q, k, v, do)
    seg_ptrs = (
        seg_q.data_ptr() if seg_q is not None else None,
        seg_kv.data_ptr() if seg_kv is not None else None,
    )
    common = (*(t.data_ptr() for t in operands), lse.data_ptr(), delta_t.data_ptr(),
              band_d.data_ptr(), *seg_ptrs)
    dims = (B, Sq, Skv, H, Hkv, D, float(scale), int(stride_q), int(stride_kv),
            BWD_TERMS[body], stream)
    _build.check(lib.flash_bwd_dq(*common, dq.data_ptr(), *dims), "flash_bwd_dq")
    flash_attention_bwd.launches_dq += 1
    _build.check(lib.flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(), *dims), "flash_bwd_dkv")
    flash_attention_bwd.launches_dkv += 1
    if body == "tc_fp32":
        flash_attention_bwd.launches_tc_fp32 += 1
    else:
        flash_attention_bwd.launches_tc_bf16 += 1
    return dq, dk, dv


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0
flash_attention_bwd.launches_tc_bf16 = 0
flash_attention_bwd.launches_tc_fp32 = 0
