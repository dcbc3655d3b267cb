"""The SSD scan kernel's split-precision arithmetic, emulated on the CPU
against the JAX package.

``csrc/ssd_scan.cu`` runs every product of the Mamba-2 SSD chunked scan on
the tensor cores (bf16 operands, fp32 sums), in four passes: (a) the
scores C.B^T once per chunk and group, (b) each chunk's own end state
sum_s (x_s w_s) B_s^T with w_s = exp(acum_last - acum_s) dt_s, (c) the
state pass across chunks in fp32, (d) y = exp(acum_t) C h_in^T + M x with the
decay-weighted scores M = scores * exp(acum_t - acum_s) * dt_s formed in
fp32 for s <= t (0 by selection elsewhere).  Every fp32 operand -- x, x w,
B, C, M and h_in -- goes in as ``TERMS`` bf16 terms (hi + lo) outside
autograd, ``AUTOGRAD_TERMS`` under it, and each product runs the term pairs
i + j < max(terms of its two operands).

This file repeats that arithmetic in PyTorch -- the four passes in the
kernel's order, each operand rounded into its bf16 terms with
``.to(torch.bfloat16)`` and residuals, exactly the kernel's cross products,
sums in fp32 -- and holds y and the final state to ``chip_smoke.py``'s
``SSD_REL_TOL`` (of the output's scale) against three JAX references on
the same numpy inputs: the Pallas ``ssd_scan_fwd`` in interpret mode (at
moderate dt: it returns NaN once a chunk's sum of dt*|A| passes ~88),
``repro.models.ssm.ssd_scan`` and the sequential oracle
``repro.kernels.ref.ssd_ref``.  It also shows that one term fewer of any
operand breaks that gate, so the kernel's term count is needed, and that
the training forward's third term brings the split to the plain fp32
chunked form's own distance from the sequential oracle.

The emulation sums in round-to-nearest fp32 in its own order (and the
prefix sum of dt*A sequentially, where the kernel scans a warp's lanes);
the tensor cores truncate as they accumulate, at most 36 products into one
accumulator here, which only the card can show (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_fwd as jssd_kernel
from repro.models import ssm as jssm
from repro_torch.kernels import ssd_scan as tssd
from split_terms import products as _products
from split_terms import terms as _terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 terms of every fp32 operand, as kernels/ssd_scan.py passes them to
# csrc/ssd_scan.cu: outside autograd (serving) and under it (training)
TERMS = tssd.TERMS
AUTOGRAD_TERMS = tssd.AUTOGRAD_TERMS
OPERANDS = ("x", "bc", "m", "h")  # x (and x w), B and C, M, h_in


def _smoke_ssd_tol():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.SSD_REL_TOL


SSD_REL_TOL = _smoke_ssd_tol()


def test_term_counts_match_the_kernel_source():
    """The counts emulated here are the ones csrc/ssd_scan.cu compiles, and
    the kernel's products run the same term pairs (csrc/ssd_common.cuh,
    shared with the backward)."""
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/ssd_scan.cu")).read()
    compiled = re.search(r"return \(int\)\(terms == (\d) \? dispatch_n<(\d)>\(a, s\) : "
                         r"dispatch_n<(\d)>\(a, s\)\);", src)
    assert compiled and int(compiled.group(1)) == int(compiled.group(2))
    assert {int(compiled.group(2)), int(compiled.group(3))} == {TERMS, AUTOGRAD_TERMS}
    assert (TERMS, AUTOGRAD_TERMS) == (2, 3)
    common = open(os.path.join(ROOT, "src/repro_torch/csrc/ssd_common.cuh")).read()
    assert '#include "ssd_common.cuh"' in src
    assert "if (i + j < T) mma_bf16(d, a[i], b0[j], b1[j]);" in common
    assert SSD_REL_TOL == 1e-4


def split_ssd(x, dt, A, Bm, Cm, chunk, terms):
    """The kernel's arithmetic -> (y [B,S,H,P], final state [B,H,P,N]).
    ``terms``: bf16 terms per operand, keyed as ``OPERANDS``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    c = min(chunk, S)
    nz = S // c
    xr = x.reshape(Bsz, nz, c, H, P)
    dtr = dt.reshape(Bsz, nz, c, H)
    Br = Bm.reshape(Bsz, nz, c, G, N)
    Cr = Cm.reshape(Bsz, nz, c, G, N)
    # (a) the scores, once per chunk and group
    scores = _products(_terms(Cr, terms["bc"]), _terms(Br, terms["bc"]), "bztgn,bzsgn->bzgts")
    # (b) the prefix sum of dt*A, exp(acum_last), and each chunk's own end state
    acum = torch.cumsum(dtr * A, dim=2)  # [B,nz,c,H]
    w = torch.exp(acum[:, :, -1:] - acum) * dtr
    Bh = Br.repeat_interleave(rep, dim=3)
    own = _products(_terms(xr * w[..., None], terms["x"]), _terms(Bh, terms["bc"]),
                    "bzshp,bzshn->bzhpn")
    decay = torch.exp(acum[:, :, -1])  # [B,nz,H]
    # (c) the state pass in fp32: the state entering each chunk
    h = torch.zeros((Bsz, H, P, N))
    h_in = []
    for z in range(nz):
        h_in.append(h)
        h = decay[:, z, :, None, None] * h + own[:, z]
    h_in = torch.stack(h_in, dim=1)  # [B,nz,H,P,N]
    # (d) y: M by selection, then exp(acum_t) C h_in^T + M x
    vis = torch.tril(torch.ones((c, c), dtype=torch.bool))[None, None, :, :, None]
    expo = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B,nz,t,s,H]
    L = torch.exp(expo.masked_fill(~vis, float("-inf")))
    sc = scores.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2)  # [B,nz,t,s,H]
    M = torch.where(vis, sc * L * dtr[:, :, None], 0.0)
    intra = _products(_terms(M, terms["m"]), _terms(xr, terms["x"]), "bztsh,bzshp->bzthp")
    Ch = Cr.repeat_interleave(rep, dim=3)
    inter = _products(_terms(Ch, terms["bc"]), _terms(h_in, terms["h"]), "bzthn,bzhpn->bzthp")
    y = inter * torch.exp(acum)[..., None] + intra
    return y.reshape(Bsz, S, H, P), h


def _inputs(seed, B, S, H, P, G, N, dt_value=None, dt_scale=1.0):
    """numpy inputs as the model gives them: dt through softplus (times
    ``dt_scale``), A = -exp(.); or dt = dt_value everywhere and A = -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((B, S, H))))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    if dt_value is not None:
        dt = np.full((B, S, H), dt_value, np.float32)
        A = np.full((H,), -1.0, np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _reference(oracle, arrays, chunk):
    """(y, final state) of one JAX reference, as torch tensors."""
    x, dt, A, Bm, Cm = map(jnp.asarray, arrays)
    if oracle == "pallas":
        out = jssd_kernel(x, dt, A, Bm, Cm, chunk=chunk, interpret=True)
    elif oracle == "chunked":  # models/ssm.py takes B and C per head
        rep = x.shape[2] // Bm.shape[2]
        out = jssm.ssd_scan(x, dt, A, jnp.repeat(Bm, rep, axis=2), jnp.repeat(Cm, rep, axis=2),
                            min(chunk, x.shape[1]))
    else:
        out = jref.ssd_ref(x, dt, A, Bm, Cm)
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def _ratios(arrays, chunk, oracle, splits):
    """max |delta| of y and the final state over the gate (SSD_REL_TOL of the
    reference's max |y|, at least 1), per split."""
    want_y, want_st = _reference(oracle, arrays, chunk)
    tol = SSD_REL_TOL * max(1.0, float(want_y.abs().max()))
    t = [torch.from_numpy(a) for a in arrays]
    out = {}
    for name, terms in splits.items():
        y, st = split_ssd(*t, chunk, terms)
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        out[name] = max(float((y - want_y).abs().max()), float((st - want_st).abs().max())) / tol
    return out


KERNEL = {op: TERMS for op in OPERANDS}
# (B, S, H, P, G, N, chunk): the shapes of tests/test_torch_ssm.py, then a
# row at mamba2-370m's widths (P 64, N 128, chunk 64; 4 heads of its 32)
SHAPES = {
    "s32_n16_c8": (1, 32, 2, 8, 1, 16, 8),
    "groups2_n8_c16": (2, 64, 4, 16, 2, 8, 16),
    "s48_c8": (1, 48, 3, 8, 1, 8, 8),
    "groups2_p32_c16": (1, 16, 2, 32, 2, 32, 16),
    "mamba2_width": (1, 256, 4, 64, 1, 128, 64),
}
ORACLES = ("pallas", "chunked", "sequential")


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_matches_jax(shape, oracle):
    """Against the Pallas kernel the inputs take half the step sizes, so
    that no chunk's sum of dt*|A| reaches the ~88 where that kernel's
    product mask turns into NaN (at mamba2 width one head's chunk reaches
    96 with the model's dt); the other references take the model's dt."""
    B, S, H, P, G, N, chunk = SHAPES[shape]
    dt_scale = 0.5 if oracle == "pallas" else 1.0
    arrays = _inputs(S + 7 * H, B, S, H, P, G, N, dt_scale=dt_scale)
    if oracle == "pallas":
        c = min(chunk, S)
        decay = (arrays[1] * -arrays[2]).reshape(B, S // c, c, H).sum(axis=2)
        assert decay.max() < 80.0
    ratio = _ratios(arrays, chunk, oracle, {"kernel": KERNEL})["kernel"]
    assert ratio <= 1.0, (shape, oracle, ratio)


@pytest.mark.parametrize("oracle", ("chunked", "sequential"))
def test_split_large_dt_stays_finite_and_within_the_gate(oracle):
    """dt = 3, A = -1: a chunk's sum of dt*|A| reaches 192, past the ~88 where
    exp(-acum_s) would overflow; every exponent the kernel takes is <= 0.
    (The Pallas kernel gives NaN here, ROADMAP C.1.)"""
    B, S, H, P, G, N, chunk = SHAPES["mamba2_width"]
    arrays = _inputs(5, B, S, H, P, G, N, dt_value=3.0)
    ratio = _ratios(arrays, chunk, oracle, {"kernel": KERNEL})["kernel"]
    assert ratio <= 1.0, (oracle, ratio)


# one term fewer of each operand, on the mamba2-width row against the
# sequential oracle.  Readings of this emulation over the shapes above: the
# kernel's split 0.06-0.15 of the gate; one term of x 16-32x, of B and C
# 19-40x, of M 15-30x, of h_in 2.3-23x where the state matters (a single
# chunk has no h_in, and dt = 3 decays it away within a chunk)
@pytest.mark.parametrize("operand", OPERANDS)
def test_one_term_fewer_breaks_the_gate(operand):
    B, S, H, P, G, N, chunk = SHAPES["mamba2_width"]
    arrays = _inputs(S + 7 * H, B, S, H, P, G, N)
    cheaper = {**KERNEL, operand: TERMS - 1}
    ratios = _ratios(arrays, chunk, "sequential", {"kernel": KERNEL, "cheaper": cheaper})
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["cheaper"] > 2.0, ratios


# the training forward's split against the serving one and against the plain
# fp32 chunked form, each to the sequential oracle.  Readings of this
# emulation: three terms 0.0013-0.011 of the gate, the plain form
# 0.0012-0.011, two terms 0.05-0.10
@pytest.mark.parametrize("shape", list(SHAPES))
def test_autograd_terms_reach_the_plain_form(shape):
    B, S, H, P, G, N, chunk = SHAPES[shape]
    arrays = _inputs(S + 7 * H, B, S, H, P, G, N)
    training = {op: AUTOGRAD_TERMS for op in OPERANDS}
    ratios = _ratios(arrays, chunk, "sequential", {"kernel": KERNEL, "training": training})
    want_y, want_st = _reference("sequential", arrays, chunk)
    y, st = tssd.ssd_scan_plain(*[torch.from_numpy(a) for a in arrays], chunk=chunk)
    tol = SSD_REL_TOL * max(1.0, float(want_y.abs().max()))
    plain = max(float((y - want_y).abs().max()), float((st - want_st).abs().max())) / tol
    assert ratios["training"] <= min(0.02, 2 * plain), (ratios, plain)
    assert ratios["kernel"] >= 5 * ratios["training"], (ratios, plain)
