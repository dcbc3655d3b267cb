"""The SSD scan backward's split-precision arithmetic (#5b), emulated on the
CPU against the JAX package.

``csrc/ssd_scan_bwd.cu`` runs every product of the chunked scan's gradient
on the tensor cores (bf16 operands, fp32 sums), in the order this file
repeats:

  (a) the chunk states: each chunk's own end state (x w)^T B (w_s =
      exp(acum_last - acum_s) dt_s) and its term of the state gradient
      (E dy)^T C (E_t = exp(acum_t)), then the passes across chunks in fp32:
      h_in[z], the state entering chunk z, and g[z], the gradient of the
      state leaving it;
  (b) per chunk and group: the scores S = C B^T once; per head D = dy x^T,
      the masked matrices L S and L dt D formed in fp32 (every decay by
      selection), dx = dt (L S)^T dy + dt W B g^T, and the group's sums
      dB = sum_h W dt (x g)_h + M^T C and dC = sum_h E (dy h_in)_h + M B
      with M = sum_h L dt D over the group's heads (x and dy are split once
      per head, and the row weights W dt and E scale the products' rows); the
      d(acum) row and column sums, the reverse prefix sum and the
      exponentials in fp32.

Every fp32 operand goes in as ``BWD_TERMS`` bf16 terms, and each product
runs the term pairs i + j < BWD_TERMS.  The operands fall in four classes:
"x" (x, dy and their row-scaled forms), "bc" (B and C), "m" (the masked
c x c matrices L S and M) and "h" (the states h_in and g).

This file holds the emulation's dx, ddt, dA, dB and dC to ``jax.grad`` of
``repro.models.ssm.ssd_scan`` and of the sequential oracle
``repro.kernels.ref.ssd_ref`` at tests/test_torch_ssm_train.py's
``SCAN_CASES``, each within its ``SCAN_TOL`` of the gradient's largest
|value|; at dt 3, A -1 (where JAX's chunked gradient is NaN, ROADMAP C.7)
to the sequential oracle alone.  It shows that one term fewer of any
operand class reads clearly worse, and that ``BWD_TERMS`` comes within 2x
of the plain backward's own distance to the sequential oracle.

The emulation sums in round-to-nearest fp32 in its own order, with one
head slice per group (the kernel may split a group's heads over blocks and
sum their partials in a fixed order); the tensor cores truncate as they
accumulate, which only the card can show (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan as tssd
from split_terms import products, terms
from test_torch_ssm_train import SCAN_CASES, SCAN_TOL, _chunked_jax, _scan_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_TERMS = tssd.BWD_TERMS
CLASSES = ("x", "bc", "m", "h")
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def test_term_counts_match_the_kernel_source():
    """The count emulated here is the one csrc/ssd_scan_bwd.cu compiles, its
    products run the same term pairs, and no fp32 product loop is left."""
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/ssd_scan_bwd.cu")).read()
    common = open(os.path.join(ROOT, "src/repro_torch/csrc/ssd_common.cuh")).read()
    compiled = re.search(r"constexpr int T = (\d);  // BWD_TERMS", src)
    assert compiled and int(compiled.group(1)) == BWD_TERMS == 3
    assert "if (i + j < T) mma_bf16(d, a[i], b0[j], b1[j]);" in common
    assert '#include "ssd_common.cuh"' in src
    assert "mma_terms<T, " in src and "fmaf(a[" not in src


def split_ssd_bwd(x, dt, A, Bm, Cm, dy, dstate, chunk, nterms):
    """The kernel's arithmetic -> (dx, ddt, dA, dB, dC).  ``nterms``: bf16
    terms per operand class, keyed as ``CLASSES``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, c = H // G, min(chunk, S)
    nz = S // c
    T = lambda v, k: terms(v, nterms[k])  # noqa: E731
    xr, dyr = x.reshape(Bsz, nz, c, H, P), dy.reshape(Bsz, nz, c, H, P)
    dtr = dt.reshape(Bsz, nz, c, H)
    Br, Cr = Bm.reshape(Bsz, nz, c, G, N), Cm.reshape(Bsz, nz, c, G, N)
    Bh, Ch = Br.repeat_interleave(rep, dim=3), Cr.repeat_interleave(rep, dim=3)
    acum = torch.cumsum(dtr * A, dim=2)  # [B,nz,c,H]
    W = torch.exp(acum[:, :, -1:] - acum)
    E = torch.exp(acum)
    decay = torch.exp(acum[:, :, -1])  # [B,nz,H]
    xw = xr * (W * dtr)[..., None]  # the A operands of (a): x w and E dy
    dyE = dyr * E[..., None]

    # (a) each chunk's own end state and state-gradient term, then the passes
    own = products(T(xw, "x"), T(Bh, "bc"), "bzshp,bzshn->bzhpn")
    term = products(T(dyE, "x"), T(Ch, "bc"), "bzthp,bzthn->bzhpn")
    h = torch.zeros((Bsz, H, P, N))
    h_in = []
    for z in range(nz):
        h_in.append(h)
        h = decay[:, z, :, None, None] * h + own[:, z]
    h_in = torch.stack(h_in, dim=1)  # [B,nz,H,P,N]
    gr = torch.zeros((Bsz, H, P, N)) if dstate is None else dstate.clone()
    gs = [None] * nz
    for z in range(nz - 1, -1, -1):
        gs[z] = gr
        gr = decay[:, z, :, None, None] * gr + term[:, z]
    g = torch.stack(gs, dim=1)

    # (b) per chunk: the group's scores, then every head
    S_ = products(T(Cr, "bc"), T(Br, "bc"), "bztgn,bzsgn->bzgts")
    Sh = S_.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2)  # [B,nz,t,s,H]
    D = products(T(dyr, "x"), T(xr, "x"), "bzthp,bzshp->bztsh")
    vis = torch.tril(torch.ones((c, c), dtype=torch.bool))[None, None, :, :, None]
    expo = acum[:, :, :, None, :] - acum[:, :, None, :, :]
    L = torch.exp(expo.masked_fill(~vis, float("-inf")))
    LS = torch.where(vis, L * Sh, 0.0)
    Q = LS * D
    LdtD = torch.where(vis, L * dtr[:, :, None] * D, 0.0)
    M = LdtD.reshape(Bsz, nz, c, c, G, rep).sum(-1)  # [B,nz,t,s,G]
    intra = products(T(LS, "m"), T(dyr, "x"), "bztsh,bzthp->bzshp")
    carry = products(T(Bh, "bc"), T(g, "h"), "bzshn,bzhpn->bzshp")
    dx = dtr[..., None] * (intra + W[..., None] * carry)
    xgB = (xr * carry).sum(-1)  # <g, x_s B_s^T>
    dBc = products(T(xr, "x"), T(g, "h"), "bzshp,bzhpn->bzshn") * (W * dtr)[..., None]
    dB = dBc.reshape(Bsz, nz, c, G, rep, N).sum(4) + \
        products(T(M, "m"), T(Cr, "bc"), "bztsg,bztgn->bzsgn")
    dCc = products(T(dyr, "x"), T(h_in, "h"), "bzthp,bzhpn->bzthn") * E[..., None]
    V = (Ch * dCc).sum(-1)  # E_t (dy_t h_in) . C_t
    dC = dCc.reshape(Bsz, nz, c, G, rep, N).sum(4) + \
        products(T(M, "m"), T(Br, "bc"), "bztsg,bzsgn->bztgn")
    dot = (g * h_in).sum((-1, -2))  # <g, h_in> [B,nz,H]

    # d(acum): strict rows and columns of Q (its diagonal cancels), then the
    # reverse prefix sum
    below = torch.tril(torch.ones((c, c), dtype=torch.bool), -1)[None, None, :, :, None]
    Qs = torch.where(below, Q, 0.0)
    diag = torch.diagonal(Q, dim1=2, dim2=3).transpose(2, 3)
    col = Qs.sum(2)
    row = (Qs * dtr[:, :, None]).sum(3)
    U = W * dtr * xgB
    dacum = row - dtr * col + V - U
    dacum[:, :, -1] += U.sum(2) + decay * dot
    da = torch.flip(torch.cumsum(torch.flip(dacum, (2,)), dim=2), (2,))
    ddt = diag + col + W * xgB + A * da
    dA = (dtr * da).sum((0, 1, 2))
    return (dx.reshape(Bsz, S, H, P), ddt.reshape(Bsz, S, H), dA,
            dB.reshape(Bsz, S, G, N), dC.reshape(Bsz, S, G, N))


KERNEL = {k: BWD_TERMS for k in CLASSES}


def _jax_grads(fn, args, dy, ds):
    """jax.grad of <y, dy> + <final state, ds> (ds None: the state unused),
    under jit (one XLA program per shape: eager dispatch of the chunked
    scan's gradient takes ~6 s a case here)."""
    def loss(*a):
        y, st = fn(*a)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(st * ds)
    grad = jax.jit(jax.grad(loss, argnums=tuple(range(5))))
    return [np.asarray(g) for g in grad(*map(jnp.asarray, args))]


@functools.lru_cache(maxsize=None)
def _case(case, dt_value=None):
    """(torch inputs, dy, dstate, chunk, {oracle: gradients}) of a
    SCAN_CASES case, or of the dt-3 case."""
    if case == "large_dt":
        (B, S, H, P, G, N, chunk), with_ds, seed = (1, 128, 2, 16, 1, 16, 64), True, 7
    elif case == "wide":
        B, S, H, P, G, N, chunk, with_ds = WIDE
        seed = 11
    else:
        B, S, H, P, G, N, chunk, with_ds = SCAN_CASES[case]
        seed = len(case)
    args, dy, ds = _scan_inputs(B, S, H, P, G, N, seed=seed, dt_value=dt_value)
    ds = ds if with_ds else None
    want = {"sequential": _jax_grads(jref.ssd_ref, args, dy, ds)}
    if dt_value is None:
        want["chunked"] = _jax_grads(_chunked_jax(chunk, H, G), args, dy, ds)
    t = [torch.from_numpy(a) for a in args]
    return t, torch.from_numpy(dy), None if ds is None else torch.from_numpy(ds), chunk, want


def _ratio(got, want):
    """max over the five gradients of max |delta| / (SCAN_TOL x max(1, max
    |want|)), and whether every gradient is finite."""
    worst = 0.0
    for g, w in zip(got, want):
        tol = SCAN_TOL * max(1.0, float(np.abs(w).max()))
        worst = max(worst, float(np.abs(g.numpy() - w).max()) / tol)
    return worst, all(bool(torch.isfinite(g).all()) for g in got)


def _split_ratio(case, oracle, nterms, dt_value=None):
    t, dy, ds, chunk, want = _case(case, dt_value)
    return _ratio(split_ssd_bwd(*t, dy, ds, chunk, nterms), want[oracle])


@pytest.mark.parametrize("oracle", ("chunked", "sequential"))
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_split_backward_matches_jax(case, oracle):
    ratio, finite = _split_ratio(case, oracle, KERNEL)
    assert finite and ratio <= 1.0, (case, oracle, ratio)


def test_split_backward_large_dt_is_finite():
    """dt 3, A -1 (S 128, chunk 64): a chunk's sum of dt*|A| passes 88; every
    exponent the kernel takes is <= 0, so every gradient stays finite and
    within the gate of the sequential oracle (JAX's chunked gradient is NaN
    there, ROADMAP C.7)."""
    ratio, finite = _split_ratio("large_dt", "sequential", KERNEL, dt_value=3.0)
    assert finite and ratio <= 1.0, ratio


# one term fewer of each class, against the sequential oracle on a row with
# wider heads (P 32, N 32), four chunks, groups of two and a nonzero d(final
# state).  Readings of this emulation: BWD_TERMS 0.028 of the gate; one term
# fewer of x 0.215 (7.6x), of B and C 0.270 (9.6x), of L S and M 0.253
# (9.0x), of h_in and g 0.101 (3.6x).  (On the SCAN_CASES rows two terms of
# every class read 0.42-0.93 of the gate, 6-51x the plain backward.)
WIDE = (1, 128, 4, 32, 2, 32, 32, True)


@pytest.mark.parametrize("cls", CLASSES)
def test_one_term_fewer_reads_worse(cls):
    kernel, _ = _split_ratio("wide", "sequential", KERNEL)
    cheaper, _ = _split_ratio("wide", "sequential", {**KERNEL, cls: BWD_TERMS - 1})
    assert kernel <= 1.0 and cheaper >= 3 * kernel, (cls, kernel, cheaper)


# BWD_TERMS against the plain backward (ssd_scan_bwd_plain, fp32), each to
# the sequential oracle.  Readings of this emulation (split / plain, of the
# gate): one_group 0.028 / 0.025, groups 0.058 / 0.058, chunk1 0.007 /
# 0.011, chunk_is_S 0.072 / 0.161, dstate 0.073 / 0.073.  At mamba2-370m's
# widths (S 256, 4 heads of P 64, N 128, chunk 64) the split reads 0.354
# against 0.151, 2.3x: dA, the sum over every token, carries it (0.354 /
# 0.097; dx, ddt, dB, dC within 0.01 of the plain backward), and no term
# count moves it (one term fewer of any class: 0.33-0.54)
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_bwd_terms_reach_the_plain_backward(case):
    t, dy, ds, chunk, want = _case(case)
    split, _ = _ratio(split_ssd_bwd(*t, dy, ds, chunk, KERNEL), want["sequential"])
    plain, _ = _ratio(tssd.ssd_scan_bwd_plain(*t, dy, ds, chunk), want["sequential"])
    assert split <= 2 * plain, (case, split, plain)
