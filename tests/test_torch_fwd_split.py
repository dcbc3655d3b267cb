"""The fp32 flash forward's split-precision arithmetic, emulated on the CPU
against the JAX package's forward.

``csrc/flash_fwd_tc.cu`` runs every product of the flash forward on the
tensor cores: bf16 operands, fp32 sums.  bf16 inputs go in as one exact
term; fp32 inputs as ``FWD_TERMS["tile_fp32"]`` (= ``["decode_fp32"]``)
bf16 terms each: hi, then what hi leaves (both bodies read them from a
split pre-pass, ``fwd_split_terms``).  S = Q K^T runs the term pairs
i + j < T; the softmax is fp32; P enters P.V as ``FWD_P_TERMS`` (three)
bf16 terms and P.V runs the pairs i + j < max(3, T) over V's terms.  This file repeats
that arithmetic in PyTorch -- each operand rounded into its terms with
``.to(torch.bfloat16)`` and residuals, exactly the kernel's cross products
summed in fp32 -- and holds o and lse to ``chip_smoke.py``'s ``TOLS`` (fp32:
1e-4) and ``LSE_TOL`` (1e-4) against JAX's Pallas ``flash_attention_fwd``
in interpret mode (small shapes) and its jnp oracle
``repro.kernels.ref.attention_ref`` (larger shapes, per-row bands).  It also
shows that one input term fewer breaks the gate, so the count the kernel
uses is needed.  Readings of this emulation: T = 2 reads 0.13-0.20 of the
gate at unit-normal inputs (|o| up to 3.9) and 0.59-0.74 in the
``large_o`` case (v x 3 over windows of 3 keys: |o| up to 11.7); T = 3
would read 0.01-0.04; T = 1 (bf16 q, k, v) reads 75-440x the gate.  The
``_d256`` cases (gemma-7b's head dim: 256 dims sum into every score) hold
T = 2 to the same gate, and T = 1 breaks it there too.

What the emulation cannot show: it sums in round-to-nearest fp32, with the
whole row's softmax at once.  The tensor cores truncate as they accumulate,
and the kernel's o accumulators live across every key tile of a row (16,384
keys on the mesh path), rescaled tile by tile.  The backward bounds its own
drift by folding its accumulators every ``FOLD`` tiles
(``csrc/flash_bwd.cu``); whether the forward needs the same only the card
can show (``tests/test_torch_cuda.py``'s long-row case, ``chip_smoke.py``).
"""

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
# chip_smoke.py's TOLS[("flash_attention_fwd", torch.float32)] and LSE_TOL
# (tests/test_torch_cuda.py reads the same two from the script)
O_TOL = 1e-4
LSE_TOL = 1e-4
T_FP32 = tfa.FWD_TERMS["tile_fp32"]
P_TERMS = tfa.FWD_P_TERMS


def test_term_counts_match_the_kernel_source():
    """The counts emulated here are the ones csrc/flash_fwd_tc.cu compiles
    (its kernels in csrc/flash_fwd_tc.cuh), and the gates the ones
    chip_smoke.py holds the kernel to."""
    src = "".join(open(os.path.join(ROOT, "src/repro_torch/csrc", f)).read()
                  for f in ("flash_fwd_tc.cuh", "flash_fwd_tc.cu"))
    assert re.search(r"struct PFrag \{\s*uint32_t r\[3\]", src)
    for body in ("tile", "decode"):
        assert re.search(rf"if \(terms == 1\) return \(int\)dispatch_{body}<1>", src)
        assert re.search(rf"if \(terms == 2\) return \(int\)dispatch_{body}<2>", src)
    assert tfa.FWD_TERMS == {"tile": 1, "decode": 1, "tile_fp32": 2, "decode_fp32": 2}
    assert P_TERMS == 3
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert re.search(r'\("flash_attention_fwd", torch\.float32\): 1e-4,', smoke)
    assert re.search(r"^LSE_TOL = 1e-4$", smoke, re.M)


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


def split_fwd(q, k, v, *, scale, band, stride_q, stride_kv, seg_q, seg_kv, terms,
              p_terms=P_TERMS):
    """The kernels' arithmetic for fp32 inputs: (o fp32, lse fp32)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    Q = _terms(q, terms)
    K = [tref.repeat_kv(t, H) for t in _terms(k, terms)]
    V = [tref.repeat_kv(t, H) for t in _terms(v, terms)]
    mask = tref.band_mask(Sq, Skv, band, stride_q=stride_q, stride_kv=stride_kv)
    if seg_q is not None:
        mask = mask & (seg_q[:, None] == seg_kv[None, :])
    if mask.dim() == 3:  # one band per batch row
        mask = mask[:, None]
    s = _products(Q, K, "bqhd,bkhd->bhqk") * scale
    s = torch.where(mask, s, tref.NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(tref.NEG_INF)
    p = torch.where(mask, torch.exp(s - m), 0.0)  # select, never multiply
    l = p.sum(-1, keepdim=True)
    acc = _products(_terms(p, p_terms), V, "bhqk,bkhd->bqhd")
    l_safe = torch.where(l > 0, l, 1.0)
    o = acc / l_safe.squeeze(-1).transpose(1, 2)[..., None]
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l_safe[..., 0]), tref.NEG_INF)
    return o, lse


def _case(name, B, Sq, Skv, H, Hkv, D, seed):
    """Inputs of one case (numpy, from the seed), and the band's arguments.
    ``band`` is one 4-tuple, or a list of one per batch row."""
    rng = np.random.default_rng(seed)
    band, sq, skv, seg, v_scale = (0, 0, 0, INF), 1, 1, None, 1.0
    if name == "window":
        band = (0, 0, 0, Skv // 4 - 1)
    elif name == "striped":  # stride-2 stripes, chunk 1 against chunk 0
        band, sq, skv = (1, 0, 0, INF), 2, 2
    elif name == "segment":  # packed documents; row 0 sees no key
        cuts = np.sort(rng.choice(np.arange(1, Sq), 5, replace=False))
        seg = np.searchsorted(cuts, np.arange(Sq), side="right").astype(np.int32)
    elif name == "per_row":  # a verify per slot, each at its own depth
        pos = rng.integers(0, Skv - Sq + 1, B)
        band = [(int(p), 0, 0, INF) for p in pos]
    elif name == "large_o":  # windows of 3 keys over large values: |o| >= 2
        band, v_scale = (0, 0, 0, 2), 3.0
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    arrays[2] *= v_scale
    seg_q = seg_kv = None
    if seg is not None:
        seg_kv = seg.copy()
        seg_q = seg.copy()
        seg_q[0] = -1
    return arrays, dict(band=band, stride_q=sq, stride_kv=skv, seg_q=seg_q, seg_kv=seg_kv)


def _want(arrays, bk, scale, oracle):
    """JAX's (o, lse) as torch fp32: its Pallas forward in interpret mode or
    its jnp oracle; a per-row band runs row by row (both take one band)."""
    qj, kj, vj = (jnp.asarray(a) for a in arrays)
    jseg = {}
    if bk["seg_q"] is not None:
        jseg = dict(seg_q=jnp.asarray(bk["seg_q"]), seg_kv=jnp.asarray(bk["seg_kv"]))
    common = dict(scale=scale, stride_q=bk["stride_q"], stride_kv=bk["stride_kv"], **jseg)
    bands = bk["band"] if isinstance(bk["band"], list) else [bk["band"]]
    rows = [slice(b, b + 1) for b in range(len(bands))] if len(bands) > 1 else [slice(None)]
    outs = []
    for band, r in zip(bands, rows):
        if oracle == "pallas":
            o, lse = jfa.flash_attention_fwd(qj[r], kj[r], vj[r], jnp.asarray(band, jnp.int32),
                                             block_q=64, block_kv=64, interpret=True, **common)
        else:
            o, lse = jref.attention_ref(qj[r], kj[r], vj[r], band=band, **common)
        outs.append((np.array(o), np.array(lse)))
    return (torch.from_numpy(np.concatenate([o for o, _ in outs])),
            torch.from_numpy(np.concatenate([lse for _, lse in outs])))


def _run(name, B, Sq, Skv, H, Hkv, D, terms_list, oracle):
    """{terms: max(|o delta| / O_TOL, |lse delta| / LSE_TOL)} for each input
    term count, against JAX's forward; also the largest |o| of the case."""
    arrays, bk = _case(name, B, Sq, Skv, H, Hkv, D, zlib.crc32(f"{name}{Sq}{H}{D}".encode()))
    scale = D**-0.5
    o_want, lse_want = _want(arrays, bk, scale, oracle)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    tseg = {key: (torch.from_numpy(x) if x is not None else None)
            for key, x in bk.items() if key.startswith("seg")}
    band = bk["band"]
    if isinstance(band, list):
        band = tuple(torch.tensor(col) for col in zip(*band))
    live = lse_want > jref.NEG_INF / 2
    ratios = {}
    for terms in terms_list:
        o, lse = split_fwd(q, k, v, scale=scale, band=band, stride_q=bk["stride_q"],
                           stride_kv=bk["stride_kv"], terms=terms, **tseg)
        # a row that sees no key: o exactly 0 and lse NEG_INF, as JAX's
        assert torch.all(o.transpose(1, 2)[~live] == 0) and torch.all(lse[~live] == lse_want[~live])
        err_o = float((o - o_want).abs().max())
        err_lse = float((lse - lse_want)[live].abs().max()) if live.any() else 0.0
        ratios[terms] = max(err_o / O_TOL, err_lse / LSE_TOL)
    return ratios, float(o_want.abs().max())


# name -> (B, Sq, Skv, H, Hkv, D); interpret-mode Pallas at S = 128 (64
# at head dim 256)
PALLAS_CASES = {
    "causal": (1, 128, 128, 2, 2, 128),
    "causal_gqa4": (1, 128, 128, 8, 2, 128),
    "window": (1, 128, 128, 4, 1, 128),
    "striped": (1, 128, 128, 2, 2, 64),
    "segment": (1, 128, 128, 2, 2, 128),
    "large_o": (1, 128, 128, 2, 2, 128),
    "causal_d256": (1, 64, 64, 2, 2, 256),
    "segment_gqa2_d256": (1, 64, 64, 4, 2, 256),
}


def _name(case):
    """The band kind of a case: its key without the shape's suffixes."""
    return case.split("_gqa")[0].split("_d256")[0]


def _limit(name):
    """The share of the gate a case may read: half of it, or all of it where
    |o| reaches 12 (an absolute 1e-4 is there 2**-17 of the value)."""
    return 1.0 if name == "large_o" else 0.5


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_split_matches_pallas_interpret(case):
    name = _name(case)
    ratio = _run(name, *PALLAS_CASES[case], [T_FP32], "pallas")[0][T_FP32]
    assert ratio <= _limit(name), (case, ratio)


# against the jnp oracle at larger shapes: granite's group of 4 at D 128,
# qwen2.5-32b's group of 5 (at D 64 here), a verify per slot (per-row band,
# 5 rows x group 4 = 20 packed rows: the decode body's shape)
ORACLE_CASES = {
    "causal": (1, 1024, 1024, 2, 2, 128),
    "causal_gqa4": (1, 512, 512, 8, 2, 128),
    "causal_gqa5": (1, 512, 512, 10, 2, 64),
    "window": (1, 1024, 1024, 2, 2, 128),
    "segment": (1, 1024, 1024, 2, 2, 128),
    "per_row": (4, 5, 1024, 8, 2, 128),
    "large_o": (1, 1024, 1024, 4, 1, 128),
    # gemma-7b's head dim 256 (MHA): a causal row, a window, a verify per
    # slot (5 rows: the decode body), large |o|
    "causal_d256": (1, 1024, 1024, 2, 2, 256),
    "window_d256": (1, 512, 512, 2, 2, 256),
    "per_row_d256": (4, 5, 1024, 4, 4, 256),
    "large_o_d256": (1, 1024, 1024, 2, 2, 256),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_split_matches_jnp_oracle(case):
    name = _name(case)
    ratios, o_max = _run(name, *ORACLE_CASES[case], [T_FP32], "jnp")
    assert ratios[T_FP32] <= _limit(name), (case, ratios)
    if name == "large_o":
        assert o_max >= 2.0, o_max


# one input term fewer (bf16 q, k, v: T = 1) on four cases
@pytest.mark.parametrize("case", ["causal", "causal_gqa5", "large_o", "causal_d256"])
def test_one_term_fewer_breaks_the_gate(case):
    name = _name(case)
    ratios, _ = _run(name, *ORACLE_CASES[case], [T_FP32, T_FP32 - 1], "jnp")
    assert ratios[T_FP32] <= _limit(name), ratios
    assert ratios[T_FP32 - 1] > 2.0, ratios


def test_pre_pass_plain_version_is_the_emulated_split():
    """fwd_split_terms on the CPU (the pre-pass's plain version) gives the
    terms this file emulates, bitwise, NaN and infinities included."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy((rng.standard_normal(s) * 10.0 ** rng.integers(-8, 8, s))
                           .astype(np.float32))
          for s in ((2, 5, 4, 32), (2, 9, 2, 32), (2, 9, 2, 32))]
    xs[1][0, 0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    got = tfa.fwd_split_terms(*xs)
    for x, g in zip(xs, got):
        assert g.dtype == torch.bfloat16 and g.shape == (T_FP32, *x.shape)
        for t, want in enumerate(_terms(x, T_FP32)):
            assert torch.equal(g[t].float(), want) or torch.equal(
                g[t].float().nan_to_num(), want.nan_to_num())
    assert torch.isnan(got[1][:, 0, 0, 0, 0]).all()
