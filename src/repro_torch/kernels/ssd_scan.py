"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/ssd_scan.py`` (``ssd_scan_fwd``).  What it
computes is the chunked dual form of ``repro/models/ssm.py`` (``_ssd_chunked``
+ ``ssd_scan``) from a zero initial state: within each chunk of ``c`` tokens
the quadratic form ``y = (L o C B^T o dt) x`` with the decay matrix
``L[t, s] = exp(acum_t - acum_s)`` for ``s <= t``, and across chunks the
linear carry of the [P, N] state.  The decay matrix is masked by SELECTION:
the exponent of ``s > t`` is set to -inf before ``exp``.  (The Pallas kernel
multiplies ``exp(...)`` by a 0/1 mask; once a chunk's sum of dt*|A| passes
~88, ``exp`` of a hidden pair is inf and inf * 0 is NaN.)

The kernel is ``csrc/ssd_scan.cu`` (see the note at its top for the
design): four chunk-parallel passes on the tensor cores, three launches of
one C call, into scratch this wrapper allocates.  ``ssd_scan_fwd`` launches them
for CUDA tensors and runs ``ssd_scan_plain`` for CPU tensors; there is no
other fallback.  ``ssd_scan_fwd.launches`` counts calls: one per call,
however many kernels the call launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan_plain", "ssd_scan_fwd"]

KERNEL_HEAD_DIMS = (16, 32, 64)  # P
KERNEL_STATE_DIMS = (8, 16, 32, 64, 128)  # N
MAX_CHUNK = 64


def _chunk_of(S: int, chunk: int) -> int:
    c = min(chunk, S)
    if c < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if S % c:
        raise ValueError(f"S={S} not divisible by chunk={c}")
    return c


def _check_shapes(x, dt, A, Bm, Cm) -> None:
    Bsz, S, H, _ = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, H) or A.shape != (H,):
        raise ValueError(f"dt must be [B, S, H] = {(Bsz, S, H)} and A [H], got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if Bm.shape != (Bsz, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be [B, S, G, N] = {(Bsz, S, G, N)}, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"H={H} not divisible by G={G}")


def ssd_scan_plain(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (softplus applied)
    A: torch.Tensor,  # [H] (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked dual form in fp32 from h0 = 0 -> (y [B,S,H,P] in x's
    dtype, final state [B,H,P,N] fp32).  Head h reads group h // (H // G).
    Differentiable: every mask is a selection, so no inf meets a zero."""
    _check_shapes(x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    c = _chunk_of(S, chunk)
    nc = S // c
    f32 = torch.float32
    xr = x.to(f32).reshape(Bsz, nc, c, H, P)
    dtr = dt.to(f32).reshape(Bsz, nc, c, H)
    Br = Bm.to(f32).repeat_interleave(H // G, dim=2).reshape(Bsz, nc, c, H, N)
    Cr = Cm.to(f32).repeat_interleave(H // G, dim=2).reshape(Bsz, nc, c, H, N)
    acum = torch.cumsum(dtr * A.to(f32), dim=2)  # [B,nc,c,H] inclusive

    # intra-chunk: y[t] = sum_{s<=t} L[t,s] (C_t . B_s) dt_s x_s
    hidden = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    expo = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B,nc,t,s,H]
    L = torch.exp(expo.masked_fill(hidden[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bzthn,bzshn->bztsh", Cr, Br)
    y = torch.einsum("bztsh,bzshp->bzthp", L * scores * dtr[:, :, None], xr)

    # each chunk's contribution to its end state, and the carry across chunks
    w = torch.exp(acum[:, :, -1:, :] - acum) * dtr  # [B,nc,c,H]
    chunk_state = torch.einsum("bzchn,bzchp->bzhpn", Br * w[..., None], xr)
    total = torch.exp(acum[:, :, -1, :])  # [B,nc,H]
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = total[:, z, :, None, None] * h + chunk_state[:, z]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]: state entering chunk z
    y = y + torch.einsum("bzthn,bzth,bzhpn->bzthp", Cr, torch.exp(acum), h_in)
    return y.reshape(Bsz, S, H, P).to(x.dtype), h


def _strides(t: torch.Tensor, name: str, rows16: bool = False):
    """(batch, seq, head/group) element strides; the last dim must be dense.
    ``rows16``: every row starts 16-byte aligned (the kernel reads B and C
    rows as float4)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")
    if rows16 and (t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3])):
        raise ValueError(f"{name} rows must start 16-byte aligned (data pointer and strides)")
    return t.stride(0), t.stride(1), t.stride(2)


def ssd_scan_fwd(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (softplus applied)
    A: torch.Tensor,  # [H] (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y [B,S,H,P] in x's dtype, final state [B,H,P,N] fp32), from a zero
    initial state, with ``chunk = min(chunk, S)`` dividing S.

    On the card: x, dt, A, Bm, Cm fp32, as the model gives them, each with
    its last dim contiguous (any batch / sequence / head strides, so views
    into a fused projection need no copy); P in ``KERNEL_HEAD_DIMS``, N in
    ``KERNEL_STATE_DIMS``, chunk <= ``MAX_CHUNK``.  The kernel is
    forward-only: it raises under autograd."""
    _check_shapes(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_fwd runs on cuda or cpu tensors, not {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    c = _chunk_of(S, chunk) if S else 1
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}")
    if P not in KERNEL_HEAD_DIMS:
        raise ValueError(f"ssd_scan_fwd kernel takes head dims P in {KERNEL_HEAD_DIMS}, not {P}")
    if N not in KERNEL_STATE_DIMS:
        raise ValueError(f"ssd_scan_fwd kernel takes state dims N in {KERNEL_STATE_DIMS}, not {N}")
    if c > MAX_CHUNK:
        raise ValueError(f"ssd_scan_fwd kernel takes chunks of at most {MAX_CHUNK}, not {c}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise NotImplementedError(
            "the SSD scan kernel is forward-only; differentiate ssd_scan_plain instead"
        )
    A = A.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz == 0 or S == 0 or H == 0:
        return y, state.zero_()
    # scratch: the group's scores per chunk (c rounded up to 16 a side),
    # exp(acum_last) per chunk and head, and the chunk states (then the
    # states entering each chunk)
    nz, cp = S // c, -(-c // 16) * 16
    scores = torch.empty((Bsz, nz, G, cp, cp), dtype=torch.float32, device=x.device)
    decay = torch.empty((Bsz, nz, H), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nz, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan")
    err = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), scores.data_ptr(), decay.data_ptr(),
        states.data_ptr(), Bsz, S, H, P, G, N, c,
        *_strides(x, "x"), *dt.stride(), *_strides(Bm, "Bm", True), *_strides(Cm, "Cm", True),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd_scan")
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0
