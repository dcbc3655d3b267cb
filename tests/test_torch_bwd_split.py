"""The backward kernels' split-precision arithmetic, emulated on the CPU
against the JAX package's backward.

``csrc/flash_bwd.cu`` runs every product of the flash backward on the
tensor cores: bf16 operands, fp32 sums.  bf16 inputs go in as one exact
term; fp32 inputs as ``BWD_TERMS["tc_fp32"]`` bf16 terms (hi + lo, written
by the split pre-pass); P and dS as ``BWD_P_TERMS`` terms; each product runs
the term pairs i + j < max(terms of its two operands).  This file repeats
that arithmetic in PyTorch -- each operand rounded into the kernel's terms
with ``.to(torch.bfloat16)`` and residuals, exactly the kernel's cross
products summed in fp32, P and dS formed in fp32 and split as the kernel
splits them -- and holds dq, dk, dv to ``chip_smoke.py``'s ``BWD_TOLS``
against JAX's Pallas ``flash_attention_bwd`` in interpret mode (small
shapes) and its jnp oracle ``repro.kernels.ref.attention_bwd_ref`` (larger
shapes).  It also shows that the next-cheaper split breaks those
tolerances, so the term counts the kernel uses are needed.

The emulation sums in round-to-nearest fp32.  The tensor cores truncate as
they accumulate; the kernel bounds that by folding its fp32 accumulators
into the output every few tiles, which only the card can show
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import os
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

INF = jref.BAND_INF
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_bwd_tols():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.BWD_TOLS


BWD_TOLS = _smoke_bwd_tols()
# bf16 terms per input value of each input type, as the wrapper routes them
IN_TERMS = {torch.float32: tfa.BWD_TERMS["tc_fp32"], torch.bfloat16: tfa.BWD_TERMS["tc_bf16"]}
P_TERMS = tfa.BWD_P_TERMS


def test_term_counts_match_the_kernel_source():
    """The counts emulated here are the ones csrc/flash_bwd.cu compiles."""
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/flash_bwd.cu")).read()
    assert int(re.search(r"constexpr int TP = (\d+);", src).group(1)) == P_TERMS
    assert re.search(r"if \(terms == 1\) return \(int\)dispatch_d<DKV, 1>", src)
    assert re.search(r"if \(terms == 2\) return \(int\)dispatch_d<DKV, 2>", src)
    assert IN_TERMS == {torch.float32: 2, torch.bfloat16: 1} and P_TERMS == 2


def _terms(x, n):
    """x (fp32 values) as n bf16-valued fp32 tensors: hi, then what each
    earlier term leaves (a residual of a rounding is exact in fp32)."""
    out, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _products(a, b, eq):
    """sum over the term pairs i + j < max(len(a), len(b)) of einsum(eq,
    a_i, b_j): the products the kernel issues, each exact, summed in fp32."""
    n = max(len(a), len(b))
    acc = None
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < n:
                z = torch.einsum(eq, x, y)
                acc = z if acc is None else acc + z
    return acc


def split_bwd(q, k, v, o, lse, do, *, scale, band, stride_q, stride_kv, seg_q, seg_kv,
              in_terms, p_terms):
    """The kernels' arithmetic: (dq, dk, dv) in the input type."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    Q, dO = _terms(q, in_terms), _terms(do, in_terms)
    K = [tref.repeat_kv(t, H) for t in _terms(k, in_terms)]
    V = [tref.repeat_kv(t, H) for t in _terms(v, in_terms)]
    mask = tref.band_mask(Sq, Skv, band, stride_q=stride_q, stride_kv=stride_kv)
    if seg_q is not None:
        mask = mask & (seg_q[:, None] == seg_kv[None, :])
    s = _products(Q, K, "bqhd,bkhd->bhqk")
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)  # select, never multiply
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    dp = _products(dO, V, "bqhd,bkhd->bhqk")
    ds = torch.where(mask, p * (dp - delta) * scale, 0.0)
    P, dS = _terms(p, p_terms), _terms(ds, p_terms)
    dq = _products(dS, K, "bhqk,bkhd->bqhd")
    dk = _products(dS, Q, "bhqk,bqhd->bkhd").reshape(B, Skv, Hkv, g, D).sum(3)
    dv = _products(P, dO, "bhqk,bqhd->bkhd").reshape(B, Skv, Hkv, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _case(name, S, H, Hkv, D, dtype, seed):
    """Inputs of one case (numpy, from the seed), and the band's arguments."""
    rng = np.random.default_rng(seed)
    band, sq, skv, seg = (0, 0, 0, INF), 1, 1, None
    if name == "window":
        band = (0, 0, 0, S // 4 - 1)
    elif name == "striped":  # stride-2 stripes, chunk 1 against chunk 0
        band, sq, skv = (1, 0, 0, INF), 2, 2
    elif name == "segment":  # packed documents; row 0 sees no key
        cuts = np.sort(rng.choice(np.arange(1, S), 5, replace=False))
        seg = np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D), (1, S, H, D))]
    if dtype == torch.bfloat16:  # the same bf16 values on both sides
        arrays = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]
    seg_q = seg_kv = None
    if seg is not None:
        seg_kv = seg.copy()
        seg_q = seg.copy()
        seg_q[0] = -1
    return arrays, dict(band=band, stride_q=sq, stride_kv=skv, seg_q=seg_q, seg_kv=seg_kv)


def _run(name, S, H, Hkv, D, dtype, splits, oracle):
    """(max |delta| / tolerance) per split, against JAX's Pallas backward in
    interpret mode (``oracle="pallas"``) or its jnp oracle."""
    arrays, bk = _case(name, S, H, Hkv, D, dtype, zlib.crc32(f"{name}{S}{H}".encode()))
    scale = D**-0.5
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    qj, kj, vj, doj = (jnp.asarray(a).astype(jdt) for a in arrays)
    jseg = {}
    if bk["seg_q"] is not None:
        jseg = dict(seg_q=jnp.asarray(bk["seg_q"]), seg_kv=jnp.asarray(bk["seg_kv"]))
    common = dict(scale=scale, stride_q=bk["stride_q"], stride_kv=bk["stride_kv"], **jseg)
    oj, lsej = jref.attention_ref(qj, kj, vj, band=bk["band"], **common)
    if oracle == "pallas":
        want = jfa.flash_attention_bwd(qj, kj, vj, oj, lsej, doj, jnp.asarray(bk["band"], jnp.int32),
                                       block_q=64, block_kv=64, interpret=True, **common)
    else:
        want = jref.attention_bwd_ref(qj, kj, vj, oj, lsej, doj, band=bk["band"], **common)
    want = [torch.from_numpy(np.array(w.astype(jnp.float32))) for w in want]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    o = torch.from_numpy(np.array(oj.astype(jnp.float32))).to(dtype)
    lse = torch.from_numpy(np.array(lsej))
    tseg = {key: (torch.from_numpy(x) if x is not None else None)
            for key, x in bk.items() if key.startswith("seg")}
    atol, rtol = BWD_TOLS[dtype]
    ratios = {}
    for in_terms, p_terms in splits:
        got = split_bwd(q, k, v, o, lse, do, scale=scale, band=bk["band"],
                        stride_q=bk["stride_q"], stride_kv=bk["stride_kv"],
                        in_terms=in_terms, p_terms=p_terms, **tseg)
        if bk["seg_q"] is not None:  # the row that sees no key: dq exactly 0
            assert torch.all(got[0][:, 0] == 0)
        ratios[(in_terms, p_terms)] = max(
            float(((g.float() - w).abs() / (atol + rtol * w.abs())).max())
            for g, w in zip(got, want)
        )
    return ratios


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
BANDS = ("causal", "window", "striped", "segment")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", BANDS)
def test_split_matches_pallas_interpret(name, dtype):
    """Small shapes (S = 128, D = 128; group 1 and 4) against the Pallas
    backward in interpret mode."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    for H, Hkv in ((2, 2), (4, 1)):
        ratio = _run(name, 128, H, Hkv, 128, dt, [split], "pallas")[split]
        assert ratio <= 1.0, (name, dtype, H, Hkv, ratio)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", BANDS)
def test_split_matches_jnp_oracle(name, dtype):
    """S = 1024 at 2 heads (D = 128) against the jnp oracle."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    ratio = _run(name, 1024, 2, 2, 128, dt, [split], "jnp")[split]
    assert ratio <= 1.0, (name, dtype, ratio)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_matches_jnp_oracle_gqa(dtype):
    """Granite's group of 4 (8 / 2 heads of 128) at S = 512, causal."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    ratio = _run("causal", 512, 8, 2, 128, dt, [split], "jnp")[split]
    assert ratio <= 1.0, (dtype, ratio)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", BANDS)
def test_split_matches_pallas_interpret_d256(name, dtype):
    """Head dim 256 (gemma-7b), where each score sums 256 products: S = 128,
    MHA and a group of 2, against the Pallas backward in interpret mode."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    for H, Hkv in ((2, 2), (4, 2)):
        ratio = _run(name, 128, H, Hkv, 256, dt, [split], "pallas")[split]
        assert ratio <= 1.0, (name, dtype, H, Hkv, ratio)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", BANDS)
def test_split_matches_jnp_oracle_d256(name, dtype):
    """Head dim 256 at S = 1024, MHA (2 / 2 heads) and a group of 2 (4 / 2),
    against the jnp oracle."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    for H, Hkv in ((2, 2), (4, 2)):
        ratio = _run(name, 1024, H, Hkv, 256, dt, [split], "jnp")[split]
        assert ratio <= 1.0, (name, dtype, H, Hkv, ratio)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", BANDS)
def test_split_matches_pallas_interpret_d96(name, dtype):
    """Head dim 96 (minicpm3-4b's expanded MLA heads), where each score sums
    96 products: S = 128, MHA and a group of 2, against the Pallas backward
    in interpret mode."""
    dt = DTYPES[dtype]
    split = (IN_TERMS[dt], P_TERMS)
    for H, Hkv in ((2, 2), (4, 2)):
        ratio = _run(name, 128, H, Hkv, 96, dt, [split], "pallas")[split]
        assert ratio <= 1.0, (name, dtype, H, Hkv, ratio)


# the next-cheaper splits, each on the S = 1024 causal case: fp32 with one
# term for P and dS, or one term for the inputs; bf16 with one term for P
# and dS.  Readings of this emulation: 23x, 48x and 11x their limits (the
# chosen splits: 0.11 and 0.81; over the four bands at S = 1024, fp32 reads
# 0.10-0.16 and bf16 0.81-0.92, where one bf16 ulp of rounding on output is
# most of the limit).
CHEAPER = {
    "fp32_single_p": (torch.float32, (2, 1)),
    "fp32_single_inputs": (torch.float32, (1, 2)),
    "bf16_single_p": (torch.bfloat16, (1, 1)),
}


@pytest.mark.parametrize("case", list(CHEAPER))
def test_cheaper_split_breaks_the_gate(case):
    dtype, cheaper = CHEAPER[case]
    chosen = (IN_TERMS[dtype], P_TERMS)
    ratios = _run("causal", 1024, 2, 2, 128, dtype, [chosen, cheaper], "jnp")
    assert ratios[chosen] <= 1.0, ratios
    assert ratios[cheaper] > 2.0, ratios
