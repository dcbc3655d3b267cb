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
however many kernels the call launches, and ``.launches_autograd`` those
with ``AUTOGRAD_TERMS``.  The kernel's products run in
split precision, every fp32 operand as ``TERMS`` bf16 terms; the forward
under autograd takes ``AUTOGRAD_TERMS``, which brings it to the plain fp32
form's accuracy, so that a train step's gradients on the card stay as
close to the CPU's as the other kernels keep them.

The gradient (#5b, no TPU counterpart: JAX differentiates its jnp scan) is
``csrc/ssd_scan_bwd.cu``, the chunked form run backwards on the tensor
cores, every fp32 operand as ``BWD_TERMS`` bf16 terms: one kernel walks the
chunks forwards and backwards for each chunk's incoming state and the
gradient of its outgoing one, a second takes each chunk's gradients of x,
dt, B and C with a group's heads in turn (so dB and dC are summed over the
group without per-head copies), and a third sums the head slices and dA
in a fixed order.  ``ssd_scan_bwd`` launches it for CUDA tensors and runs
``ssd_scan_bwd_plain`` (the same passes in fp32 PyTorch) for CPU tensors;
``ssd_scan_bwd.launches`` counts its calls.  Under autograd
``ssd_scan_fwd`` goes through ``_SSDScan``, whose forward is the forward
above and whose backward is ``ssd_scan_bwd``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan_plain", "ssd_scan_fwd", "ssd_scan_bwd_plain", "ssd_scan_bwd"]

KERNEL_HEAD_DIMS = (16, 32, 64)  # P
KERNEL_STATE_DIMS = (8, 16, 32, 64, 128)  # N
MAX_CHUNK = 64
# bf16 terms of every fp32 operand of the forward kernel's products: outside
# autograd (serving), and under it (the training forward and its recompute)
TERMS = 2
AUTOGRAD_TERMS = 3
# bf16 terms of every fp32 operand of the backward kernel's (#5b) products,
# settled by tests/test_torch_ssd_bwd_split.py; csrc/ssd_scan_bwd.cu compiles
# the same count
BWD_TERMS = 3


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
    if rows16 and not _rows16(t):
        raise ValueError(f"{name} rows must start 16-byte aligned (data pointer and strides)")
    return t.stride(0), t.stride(1), t.stride(2)


def _rows16(t: torch.Tensor) -> bool:
    """Every row of t (its last dim) starts 16-byte aligned."""
    return t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in t.stride()[:-1])


def _bwd_heads_per_block(Bsz: int, nz: int, G: int, rep: int) -> int:
    """Heads of a group that one block of #5b's chunk kernel walks: the
    fewest slices of a group's heads that give the launch (chunks x groups x
    slices x batch rows) two blocks per SM of an H100 (132 SMs)."""
    slices = min(rep, max(1, -(-264 // (Bsz * nz * G))))
    return -(-rep // slices)


def _check_kernel_inputs(name, tensors, P, N, c) -> None:
    """What the CUDA kernels take: fp32 on one device, P in
    ``KERNEL_HEAD_DIMS``, N in ``KERNEL_STATE_DIMS``, chunk <= ``MAX_CHUNK``."""
    dev = tensors[0][1].device
    for tname, t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{tname} must be float32 on {dev}")
    if P not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dims P in {KERNEL_HEAD_DIMS}, not {P}")
    if N not in KERNEL_STATE_DIMS:
        raise ValueError(f"{name} kernel takes state dims N in {KERNEL_STATE_DIMS}, not {N}")
    if c > MAX_CHUNK:
        raise ValueError(f"{name} kernel takes chunks of at most {MAX_CHUNK}, not {c}")


def _forward(x, dt, A, Bm, Cm, chunk, terms):
    """The forward on x's device: the kernel with ``terms`` bf16 terms of
    each operand for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_fwd runs on cuda or cpu tensors, not {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    c = _chunk_of(S, chunk) if S else 1
    _check_kernel_inputs("ssd_scan_fwd", (("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                                          ("Cm", Cm)), P, N, c)
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
        terms, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd_scan")
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.launches_autograd += terms == AUTOGRAD_TERMS
    return y, state


class _SSDScan(torch.autograd.Function):
    """The scan under autograd: forward #5 with ``AUTOGRAD_TERMS`` terms
    (the plain forward on the CPU), backward #5b (``ssd_scan_bwd``).  The inputs are saved as they come
    (views into the fused projection, no copies); a final state nobody used
    reaches the backward as None."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _forward(x, dt, A, Bm, Cm, chunk, AUTOGRAD_TERMS)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return (*ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate, chunk=ctx.chunk), None)


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
    ``KERNEL_STATE_DIMS``, chunk <= ``MAX_CHUNK``.  Under autograd (grad
    enabled and an input that requires it) the call goes through
    ``_SSDScan``: the same forward with ``AUTOGRAD_TERMS`` bf16 terms of
    each operand in place of ``TERMS``, and ``ssd_scan_bwd`` for the
    gradients."""
    _check_shapes(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    return _forward(x, dt, A, Bm, Cm, chunk, TERMS)


ssd_scan_fwd.launches = 0
ssd_scan_fwd.launches_autograd = 0  # of them, with AUTOGRAD_TERMS


def ssd_scan_bwd_plain(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    dy: torch.Tensor,  # [B, S, H, P]
    dstate: Optional[torch.Tensor] = None,  # [B, H, P, N] or None (zeros)
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_scan_plain`` -> (dx, ddt, dA, dBm, dCm), in the
    inputs' dtypes, computed in fp32 by the chunked passes the kernel runs:

      (a) each chunk's incoming state h_in[z], recomputed from h0 = 0;
      (b) the reverse pass over chunks: g[z], the gradient of the state
          leaving chunk z, from g[nz-1] = dstate and
          g[z-1] = exp(acum_last[z]) g[z] + sum_t exp(acum_t) dy_t (x) C_t;
      (c) each chunk's intra-chunk and carry terms of dx, dB, dC and the
          direct dt term, with every decay masked by selection (exponents
          <= 0);
      (d) d(acum) -> d(dt*A) by a reverse prefix sum inside the chunk (plus
          the carry <g[z], h_in[z]> on acum_last): ddt += A d(a), dA =
          sum dt d(a); dB and dC summed over the heads of a group."""
    _check_shapes(x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.shape != x.shape:
        raise ValueError(f"dy must be [B, S, H, P] = {tuple(x.shape)}, got {tuple(dy.shape)}")
    c = _chunk_of(S, chunk)
    nc, rep = S // c, H // G
    f32 = torch.float32
    xr = x.to(f32).reshape(Bsz, nc, c, H, P)
    dyr = dy.to(f32).reshape(Bsz, nc, c, H, P)
    dtr = dt.to(f32).reshape(Bsz, nc, c, H)
    Br = Bm.to(f32).repeat_interleave(rep, dim=2).reshape(Bsz, nc, c, H, N)
    Cr = Cm.to(f32).repeat_interleave(rep, dim=2).reshape(Bsz, nc, c, H, N)
    Af = A.to(f32)
    acum = torch.cumsum(dtr * Af, dim=2)  # [B,nc,c,H] inclusive, <= 0
    W = torch.exp(acum[:, :, -1:, :] - acum)  # decay from token s to the chunk's end
    E = torch.exp(acum)  # decay from the chunk's start to token t
    total = torch.exp(acum[:, :, -1, :])  # [B,nc,H]

    # (a) the states entering each chunk
    chunk_state = torch.einsum("bzchn,bzchp->bzhpn", Br * (W * dtr)[..., None], xr)
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = total[:, z, :, None, None] * h + chunk_state[:, z]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]
    # (b) the gradient of the state leaving each chunk
    dyC = torch.einsum("bzthp,bzthn->bzhpn", dyr * E[..., None], Cr)
    g = torch.zeros_like(h) if dstate is None else dstate.to(f32)
    gs = [None] * nc
    for z in range(nc - 1, -1, -1):
        gs[z] = g
        g = total[:, z, :, None, None] * g + dyC[:, z]
    g = torch.stack(gs, dim=1)  # [B,nc,H,P,N]

    # (c) per chunk: L[t, s] = exp(acum_t - acum_s) for s <= t, 0 by selection
    hidden = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    expo = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B,nc,t,s,H]
    L = torch.exp(expo.masked_fill(hidden[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bzthn,bzshn->bztsh", Cr, Br)  # C_t . B_s
    D = torch.einsum("bzthp,bzshp->bztsh", dyr, xr)  # dy_t . x_s
    P1 = L * scores
    Q = P1 * D
    dS = L * dtr[:, :, None] * D  # d(scores)
    gB = torch.einsum("bzshn,bzhpn->bzshp", Br, g)
    dx = dtr[..., None] * (torch.einsum("bztsh,bzthp->bzshp", P1, dyr) + W[..., None] * gB)
    xg = torch.einsum("bzshp,bzhpn->bzshn", xr, g)
    dB = torch.einsum("bztsh,bzthn->bzshn", dS, Cr) + (W * dtr)[..., None] * xg
    dyh = torch.einsum("bzthp,bzhpn->bzthn", dyr, h_in)
    dC = torch.einsum("bztsh,bzshn->bzthn", dS, Br) + E[..., None] * dyh
    xgB = (xg * Br).sum(-1)  # <g, x_s (x) B_s>  [B,nc,c,H]
    # Q's diagonal leaves d(acum) exactly (it enters a row and a column with
    # opposite signs), so the sums below skip it: strict rows and columns
    below = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device), -1)
    Qs = Q * below[None, None, :, :, None]
    diag = torch.diagonal(Q, dim1=2, dim2=3).transpose(2, 3)  # [B,nc,c,H]
    col_strict = Qs.sum(2)  # over t > s: [B,nc,s,H]
    ddt = diag + col_strict + W * xgB

    # (d) d(acum), then d(dt*A) by a reverse prefix sum inside the chunk
    U = W * dtr * xgB
    dacum = (Qs * dtr[:, :, None]).sum(3) - dtr * col_strict + E * (dyh * Cr).sum(-1) - U
    carry = U.sum(2) + total * (g * h_in).sum((-1, -2))  # on acum_last
    dacum = torch.cat([dacum[:, :, :-1], dacum[:, :, -1:] + carry[:, :, None]], dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dacum, (2,)), dim=2), (2,))
    ddt = ddt + Af * da
    dA = (dtr * da).sum((0, 1, 2))
    dBm = dB.reshape(Bsz, S, G, rep, N).sum(3)
    dCm = dC.reshape(Bsz, S, G, rep, N).sum(3)
    return (dx.reshape(Bsz, S, H, P).to(x.dtype), ddt.reshape(Bsz, S, H).to(dt.dtype),
            dA.to(A.dtype), dBm.to(Bm.dtype), dCm.to(Cm.dtype))


def ssd_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The scan's gradients -> (dx [B,S,H,P], ddt [B,S,H], dA [H], dBm, dCm
    [B,S,G,N]) from dy [B,S,H,P] and the final state's gradient dstate
    [B,H,P,N] (None: zeros).  CUDA tensors launch #5b (inputs as
    ``ssd_scan_fwd`` takes them, fp32; every gradient fp32 and contiguous);
    CPU tensors run ``ssd_scan_bwd_plain``.  Two launches on the same
    inputs give bitwise-equal gradients (no atomics)."""
    _check_shapes(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dstate, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda or cpu tensors, not {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.shape != x.shape or (dstate is not None and dstate.shape != (Bsz, H, P, N)):
        raise ValueError(f"dy must be [B, S, H, P] = {tuple(x.shape)} and dstate [B, H, P, N], "
                         f"got {tuple(dy.shape)}, {None if dstate is None else tuple(dstate.shape)}")
    c = _chunk_of(S, chunk) if S else 1
    named = [("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("dy", dy)]
    _check_kernel_inputs("ssd_scan_bwd", named + ([] if dstate is None else [("dstate", dstate)]),
                         P, N, c)
    # the kernel loads the rows of x, B and C with 16-byte copies: a view
    # whose rows are not 16-byte aligned goes in as a contiguous copy
    x, Bm, Cm = (t if _rows16(t) else t.contiguous() for t in (x, Bm, Cm))
    A, dy = A.contiguous(), dy.contiguous()
    dstate = None if dstate is None else dstate.contiguous()
    f32, dev = torch.float32, x.device
    dx = torch.empty((Bsz, S, H, P), dtype=f32, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dBm = torch.empty((Bsz, S, G, N), dtype=f32, device=dev)
    dCm = torch.empty((Bsz, S, G, N), dtype=f32, device=dev)
    if Bsz == 0 or S == 0 or H == 0:
        return dx, ddt, dA.zero_(), dBm, dCm
    # scratch: the states entering each chunk and the gradients of the states
    # leaving it, each head slice's dB and dC, each chunk's share of dA
    nz, rep = S // c, H // G
    hps = _bwd_heads_per_block(Bsz, nz, G, rep)
    slices = -(-rep // hps)
    hin = torch.empty((Bsz, nz, H, P, N), dtype=f32, device=dev)
    gst = torch.empty((Bsz, nz, H, P, N), dtype=f32, device=dev)
    dBp = torch.empty((Bsz, S, G, slices, N), dtype=f32, device=dev)
    dCp = torch.empty((Bsz, S, G, slices, N), dtype=f32, device=dev)
    dAp = torch.empty((Bsz, nz, H), dtype=f32, device=dev)
    lib = _build.load("ssd_scan_bwd")
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
        0 if dstate is None else dstate.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
        hin.data_ptr(), gst.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(),
        Bsz, S, H, P, G, N, c, hps,
        *_strides(x, "x"), *dt.stride(), *_strides(Bm, "Bm"), *_strides(Cm, "Cm"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm


ssd_scan_bwd.launches = 0
