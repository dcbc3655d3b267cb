"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips on hosts without CUDA (the
``cuda`` marker).  This file imports neither JAX nor ``repro``: it runs on
the machine with the card, where JAX is not installed.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode as pk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

pytestmark = pytest.mark.cuda

# (atol, rtol) of o.  fp32: the kernel and the plain version both sum in
# fp32, in another order; bf16: o is rounded to bf16 on output, and one ulp
# is at most 2**-7 of the value
TOLS = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2**-7)}
# lse is fp32 for either input type
LSE_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


INF = ref.BAND_INF
FLASH_CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, band, stride_q, stride_kv, segments); the
    # band is one 4-tuple, or a list of B of them (one per batch row, [B, 4])
    "full": (2, 64, 96, 4, 2, 32, (0, 0, -INF, INF), 1, 1, False),
    "causal_ragged": (1, 100, 100, 4, 1, 64, (0, 0, 0, INF), 1, 1, False),
    "striped": (1, 128, 128, 8, 2, 128, (1, 0, 0, INF), 2, 2, False),
    "window": (1, 160, 160, 4, 4, 128, (0, 0, 0, 31), 1, 1, False),
    "segments": (1, 96, 96, 4, 2, 64, (0, 0, 0, INF), 1, 1, True),
    "hidden_rows": (1, 64, 64, 2, 2, 32, (0, 40, 0, INF), 1, 1, False),
    "decode_row": (3, 1, 200, 8, 2, 128, (150, 0, 0, INF), 1, 1, False),
    # hymba-1.5b's attention geometry (25 / 5 heads of 64) under a window
    "hymba_window": (1, 300, 300, 25, 5, 64, (0, 0, 0, 127), 1, 1, False),
    "granite_segments": (1, 1024, 1024, 32, 8, 128, (0, 0, 0, INF), 1, 1, True),
    # a speculative verify (spec_k 4) and a prefill chunk (256) over granite
    # heads, each batch row at its own depth
    "verify": (8, 4, 2048, 32, 8, 128,
               [(p, 0, 0, INF) for p in (0, 5, 100, 777, 1500, 2043, 2044, 3000)], 1, 1, False),
    "chunk": (8, 256, 2048, 32, 8, 128,
              [(p, 0, 0, INF) for p in (0, 256, 512, 1000, 1500, 1792, 100, 1900)], 1, 1, False),
    # Sq = 1 decode ticks, one band per slot: a row past Skv (sees them all)
    # and a fully hidden row (lo = 5 leaves no key at pos 3)
    "decode_slots_granite": (8, 1, 300, 32, 8, 128,
                             [(p, 0, 0, INF) for p in (0, 17, 64, 150, 299, 5000, 220)]
                             + [(3, 0, 5, INF)], 1, 1, False),
    "decode_slots_hymba": (8, 1, 300, 25, 5, 64,
                           [(p, 0, 0, 63) for p in (0, 17, 64, 150, 299, 5000, 220)]
                           + [(3, 0, 5, 63)], 1, 1, False),
    # a window with segment ids whose tiles start off a multiple of 4 keys:
    # the tile body's 1-D TMA box of ids must start 16-byte aligned
    "segments_window": (1, 300, 300, 4, 2, 64, (3, 0, 0, 41), 1, 1, True),
}


def _band_arg(band, dev):
    """The case's band as the wrapper takes it, and as the plain version does."""
    if isinstance(band, list):
        t = torch.tensor(band, dtype=torch.int32, device=dev)
        return t, tuple(t[:, i] for i in range(4))
    return band, band


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_fwd_matches_plain(dev, case, dtype):
    B, Sq, Skv, H, Hkv, D, band, sq, skv, seg = FLASH_CASES[case]
    band, plain_band = _band_arg(band, dev)
    rng = np.random.default_rng(7)
    q = _randn(rng, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _randn(rng, B, Skv, Hkv, D, dtype=dtype, dev=dev)
    v = _randn(rng, B, Skv, Hkv, D, dtype=dtype, dev=dev)
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv)
    if seg:
        ids = np.sort(rng.integers(0, 4, Sq)).astype(np.int32)
        kw["seg_q"] = kw["seg_kv"] = torch.from_numpy(ids).to(dev)
    body, _ = fa._fwd_plan(B, Sq, H, Hkv, D, dtype)
    counters = ("launches", "launches_tile", "launches_decode", "launches_fp32")
    before = {c: getattr(fa.flash_attention_fwd, c) for c in counters}
    o, lse = fa.flash_attention_fwd(q, k, v, band, **kw)
    torch.cuda.synchronize()
    moved = {c: getattr(fa.flash_attention_fwd, c) - before[c] for c in counters}
    assert moved == {c: int(c in ("launches", f"launches_{body}")) for c in counters}
    o_ref, lse_ref = ref.attention_ref(q, k, v, band=plain_band, **kw)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    # empty rows: exactly o = 0 and lse = NEG_INF
    assert torch.equal(lse[~live], lse_ref[~live])
    assert torch.all(o.transpose(1, 2)[~live] == 0)
    if case in ("hidden_rows", "decode_slots_granite", "decode_slots_hymba"):
        assert (~live).any()


@pytest.mark.parametrize("case", ["granite_segments", "hymba_window", "chunk",
                                  "decode_slots_hymba", "verify"])
def test_flash_fwd_tensor_core_repeat_is_bitwise(dev, case):
    """The bf16 bodies sum in a fixed order (the decode body's key splits
    merge without atomics): two launches give identical outputs."""
    B, Sq, Skv, H, Hkv, D, band, sq, skv, seg = FLASH_CASES[case]
    band, _ = _band_arg(band, dev)
    rng = np.random.default_rng(11)
    q, k, v = (_randn(rng, B, S, h, D, dtype=torch.bfloat16, dev=dev)
               for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv)
    if seg:
        ids = np.sort(rng.integers(0, 4, Sq)).astype(np.int32)
        kw["seg_q"] = kw["seg_kv"] = torch.from_numpy(ids).to(dev)
    body, splits = fa._fwd_plan(B, Sq, H, Hkv, D, torch.bfloat16)
    assert body == ("decode" if case.startswith(("decode", "verify")) else "tile")
    if case == "decode_slots_hymba":
        assert splits > 1
    first = fa.flash_attention_fwd(q, k, v, band, **kw)
    second = fa.flash_attention_fwd(q, k, v, band, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_fwd_per_row_band(dev):
    """[B, 4] bands: every batch row at its own depth in one launch (the
    dense-cache decode step)."""
    rng = np.random.default_rng(3)
    B, Skv, H, Hkv, D = 4, 300, 8, 2, 128
    q = _randn(rng, B, 1, H, D, dtype=torch.float32, dev=dev)
    k = _randn(rng, B, Skv, Hkv, D, dtype=torch.float32, dev=dev)
    v = _randn(rng, B, Skv, Hkv, D, dtype=torch.float32, dev=dev)
    pos = torch.tensor([0, 17, 299, 5000], dtype=torch.int32, device=dev)
    band = torch.stack([pos, 0 * pos, 0 * pos, 0 * pos + 63], dim=1)
    o, lse = fa.flash_attention_fwd(q, k, v, band, scale=D**-0.5)
    o_ref, lse_ref = ref.attention_ref(
        q, k, v, scale=D**-0.5, band=tuple(band[:, i] for i in range(4))
    )
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


BWD_CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, band, stride_q, stride_kv, segments)
    "full_gqa": (2, 64, 96, 4, 2, 32, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1, False),
    "causal_ragged": (1, 100, 100, 4, 1, 64, (0, 0, 0, ref.BAND_INF), 1, 1, False),
    "striped": (1, 128, 128, 8, 2, 128, (1, 0, 0, ref.BAND_INF), 2, 2, False),
    "window": (1, 160, 160, 4, 4, 128, (0, 0, 0, 31), 1, 1, False),
    "segments": (1, 96, 96, 4, 2, 64, (0, 0, 0, ref.BAND_INF), 1, 1, True),
    "hidden_rows": (1, 64, 70, 2, 2, 32, (0, 40, 0, ref.BAND_INF), 1, 1, False),
    "granite_gqa": (1, 200, 200, 32, 8, 128, (0, 0, 0, ref.BAND_INF), 1, 1, False),
    # D = 128 with Sq and Skv not multiples of the kernels' 64-row tiles
    "ragged_d128": (1, 333, 271, 8, 2, 128, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1, False),
    # hymba-1.5b's group of 5 (25 / 5 heads of 64) under its window
    "hymba_group5": (1, 300, 300, 25, 5, 64, (0, 0, 0, 127), 1, 1, False),
    # a cross-length band: 100 queries over 260 keys, kv_off = -160
    "cross_length": (2, 100, 260, 8, 4, 64, (0, -160, 0, ref.BAND_INF), 1, 1, False),
    # tiles whose row vectors (lse, delta, segment ids) start off a 16-byte
    # boundary: the kernels' 1-D TMA boxes are aligned down
    "offset_window": (1, 256, 256, 2, 2, 64, (5, 0, 0, 31), 1, 1, False),
    "segments_window": (2, 301, 299, 6, 3, 32, (3, 0, 0, 40), 1, 1, True),
}
# (atol, rtol) of dq/dk/dv.  fp32: both sides sum in fp32 in other orders;
# bf16: the outputs are rounded to bf16 (one ulp is at most 2**-7 of the value)
BWD_TOLS = {torch.float32: (2e-4, 0.0), torch.bfloat16: (2e-3, 2**-7)}


def _bwd_inputs(case, dtype, dev, seed=5):
    B, Sq, Skv, H, Hkv, D, band, sq, skv, seg = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    q = _randn(rng, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _randn(rng, B, Skv, Hkv, D, dtype=dtype, dev=dev)
    v = _randn(rng, B, Skv, Hkv, D, dtype=dtype, dev=dev)
    do = _randn(rng, B, Sq, H, D, dtype=dtype, dev=dev)
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv)
    if seg:
        ids = torch.from_numpy(np.sort(rng.integers(0, 4, Sq)).astype(np.int32)).to(dev)
        kw["seg_q"] = kw["seg_kv"] = ids
        if Skv != Sq:
            kw["seg_kv"] = torch.from_numpy(
                np.sort(rng.integers(0, 4, Skv)).astype(np.int32)).to(dev)
    o, lse = ref.attention_ref(q, k, v, band=band, **kw)
    return q, k, v, o, lse, do, band, kw


@pytest.mark.parametrize("with_delta", [False, True], ids=["from_o", "delta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_matches_plain(dev, case, dtype, with_delta):
    q, k, v, o, lse, do, band, kw = _bwd_inputs(case, dtype, dev)
    delta = (do.float() * o.float()).sum(-1) if with_delta else None
    before = (fa.flash_attention_bwd.launches_dq, fa.flash_attention_bwd.launches_dkv)
    got = fa.flash_attention_bwd(q, k, v, None if with_delta else o, lse, do, band,
                                 delta=delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.launches_dq, fa.flash_attention_bwd.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)
    atol, rtol = BWD_TOLS[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)
    if case == "hidden_rows":  # rows 0..39 see no key: their dq is exactly 0
        assert torch.all(got[0][:, :40] == 0)


def test_flash_bwd_repeat_is_bitwise(dev):
    """No atomics: two launches give identical gradients."""
    q, k, v, o, lse, do, band, kw = _bwd_inputs("granite_gqa", torch.float32, dev)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_repeat_is_bitwise_bf16(dev):
    """No atomics on the bf16 body either."""
    q, k, v, o, lse, do, band, kw = _bwd_inputs("granite_gqa", torch.bfloat16, dev)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_bwd_body_counters(dev, dtype):
    """The body counters show which body ran: the type picks it, and only
    the fp32 body runs the split pre-pass."""
    q, k, v, o, lse, do, band, kw = _bwd_inputs("hymba_group5", dtype, dev)
    def counts():
        return {"fp32": fa.flash_attention_bwd.launches_tc_fp32,
                "bf16": fa.flash_attention_bwd.launches_tc_bf16, "split": fa.split_terms.launches}

    before = counts()
    fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    delta = {n: c - before[n] for n, c in counts().items()}
    fp32 = dtype == torch.float32
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1:3]
    assert fa._bwd_plan(B, Sq, Skv, H, Hkv, D, dtype) == ("tc_fp32" if fp32 else "tc_bf16")
    assert delta == {"fp32": int(fp32), "bf16": int(not fp32), "split": int(fp32)}


def test_split_terms_match_plain(dev):
    """The fp32 pre-pass against its plain version: both round to nearest
    even, so the terms are bitwise equal, and hi + lo carries x to 2**-16."""
    rng = np.random.default_rng(11)
    xs = [_randn(rng, 1, 333, h, 128, dtype=torch.float32, dev=dev) * 3 for h in (8, 2, 2, 8)]
    got = fa.split_terms(*xs)
    for g, x in zip(got, xs):
        want = fa.split_terms_ref(x)
        assert g.shape == (2, *x.shape) and torch.equal(g, want)
        assert float((g.float().sum(0) - x).abs().max()) <= 2**-16 * float(x.abs().max())


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def test_flash_bwd_refuses_misaligned_operands(dev):
    """TMA reads 16-byte aligned rows: a misaligned operand is refused, not
    worked round (bf16: q, k, v, dO themselves; either type: lse)."""
    q, k, v, o, lse, do, band, kw = _bwd_inputs("granite_gqa", torch.bfloat16, dev)
    for i in range(4):
        args = [q, k, v, do]
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_bwd(args[0], args[1], args[2], o, lse, args[3], band, **kw)
    q, k, v, o, lse, do, band, kw = _bwd_inputs("granite_gqa", torch.float32, dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd(q, k, v, o, _misaligned(lse), do, band, **kw)


def test_flash_attention_op_grads_on_card(dev):
    """The autograd op on the card (forward + dQ/dKV kernels) against the
    same op on the CPU (plain versions)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(8)
    B, S, H, Hkv, D = 1, 96, 4, 2, 64
    base = [_randn(rng, B, S, h, D, dtype=torch.float32, dev=dev) for h in (H, Hkv, Hkv)]
    w = _randn(rng, B, S, H, D, dtype=torch.float32, dev=dev)
    seg = torch.from_numpy(np.repeat(np.arange(3), [30, 50, 16]).astype(np.int32))
    grads = {}
    for where in ("cuda", "cpu"):
        xs = [t.to(where).requires_grad_(True) for t in base]
        o = ops.flash_attention(*xs, causal=True, seg_q=seg.to(where))
        grads[where] = torch.autograd.grad((o * w.to(where)).sum(), xs)
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g_card.cpu(), g_cpu, atol=2e-4, rtol=0)


def _pool(rng, depths, page_size, max_pages, hkv, d, dtype, dev, holes=False):
    """Random block tables over a shuffled pool: pages past a row's depth stay
    -1, unwritten page tails hold garbage the kernel must not see."""
    B = len(depths)
    num_pages = B * max_pages + 3
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        for lp in range(-(-depth // page_size)):
            if holes and lp == 1:
                continue  # an unallocated page inside the visible range
            bt[b, lp] = perm[nxt]
            nxt += 1
    k_pool = _randn(rng, num_pages, page_size, hkv, d, dtype=dtype, dev=dev) * 3
    v_pool = _randn(rng, num_pages, page_size, hkv, d, dtype=dtype, dev=dev)
    return k_pool, v_pool, torch.from_numpy(bt).to(dev)


PAGED_CASES = {
    # name: (depths, page_size, H, Hkv, D, stride_kv, kv_off, window, num_splits, holes)
    "granite_like": ((37, 1, 250, 16, 0, 129), 16, 32, 8, 128, 1, 0, None, None, False),
    "one_token_pages": ((5, 9, 2), 1, 4, 2, 32, 1, 0, None, 3, False),
    "big_pages": ((70, 200, 33), 48, 8, 8, 64, 1, 0, None, 2, False),
    "striped_window": ((30, 64, 11), 4, 16, 4, 128, 2, 1, 24, None, False),
    "holes": ((40, 45), 8, 8, 2, 64, 1, 0, None, None, True),
    # one split: the main kernel writes o and lse itself
    "one_split": ((37, 1, 250, 0), 16, 32, 8, 128, 1, 0, None, 1, False),
    # more splits than visible pages (and 16-slot tiles): blocks without a share
    "splits_over_pages": ((9, 2, 0), 4, 32, 8, 128, 1, 0, None, 4, False),
    # rows of 38 and 19 tiles over 3 blocks each: shares of 12, 13, 13 and 6, 6, 7
    "uneven_shares": ((600, 300), 16, 32, 8, 128, 1, 0, None, 3, False),
    # hymba's group of 5, a window, holes and 8-slot pages, rows over 2 blocks
    "window_holes_group5": ((300, 161, 5), 8, 10, 2, 64, 1, 0, 200, 5, True),
    # the largest group (16 heads per kv head), a 25-tile row over 4 blocks
    "group16": ((400, 33), 16, 32, 2, 64, 1, 0, None, 4, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_matches_plain(dev, case, dtype):
    depths, ps, H, Hkv, D, stride, kv_off, window, splits, holes = PAGED_CASES[case]
    rng = np.random.default_rng(11)
    max_pages = -(-max(depths) // ps) + 1
    k_pool, v_pool, bt = _pool(rng, depths, ps, max_pages, Hkv, D, dtype, dev, holes)
    B = len(depths)
    q = _randn(rng, B, 1, H, D, dtype=dtype, dev=dev)
    # the last visible local slot of each row is depth - 1 (depth 0: empty row)
    pos = torch.tensor(
        [kv_off + stride * (d - 1) if d else -1 for d in depths], dtype=torch.int32, device=dev
    )
    kw = dict(stride_kv=stride, window=window)
    before = pk.paged_flash_decode.launches
    o, lse = pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, kv_off, num_splits=splits, **kw)
    torch.cuda.synchronize()
    assert pk.paged_flash_decode.launches == before + 1
    o_ref, lse_ref = pk.paged_decode_ref(q, k_pool, v_pool, bt, pos, kv_off, **kw)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    assert torch.equal(lse[~live], lse_ref[~live])
    assert torch.all(o[:, 0][~live[..., 0]] == 0)


QUANT_DTYPES = ["int8"] + (["fp8"] if hasattr(torch, "float8_e4m3fn") else [])


def _quant_pool(rng, depths, kv_dtype, dev, page_size=16, hkv=8, d=128):
    """A granite-shaped quantized pool: codes and per-(token, head) scales
    from random K/V, a shuffled block table, -1 past each row's depth."""
    from repro_torch.core import kv_quant

    max_pages = -(-max(depths) // page_size) + 1
    k_pool, v_pool, bt = _pool(rng, depths, page_size, max_pages, hkv, d, torch.float32, dev)
    (kq, ks), (vq, vs) = (kv_quant.quantize(t, kv_dtype) for t in (k_pool, v_pool))
    return kq, vq, ks, vs, bt


@pytest.mark.parametrize("window", [None, 512], ids=["full", "window512"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_paged_decode_quant_matches_plain(dev, kv_dtype, dtype, window):
    """The quantized branch (int8 / fp8 codes + fp32 scales) against the
    plain version, which dequantizes the same codes; granite heads, mixed
    depths with partial last pages and an empty row."""
    depths = (1, 17, 250, 777, 1500, 0)
    rng = np.random.default_rng(12)
    kq, vq, ks, vs, bt = _quant_pool(rng, depths, kv_dtype, dev)
    q = _randn(rng, len(depths), 1, 32, 128, dtype=dtype, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    kw = dict(stride_kv=1, window=window, k_scale=ks, v_scale=vs)
    before = (pk.paged_flash_decode.launches, pk.paged_flash_decode.quant_launches)
    o, lse = pk.paged_flash_decode(q, kq, vq, bt, pos, 0, **kw)
    torch.cuda.synchronize()
    assert (pk.paged_flash_decode.launches, pk.paged_flash_decode.quant_launches) == (
        before[0], before[1] + 1)
    o_ref, lse_ref = pk.paged_decode_ref(q, kq, vq, bt, pos, 0, **kw)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    # the empty row: exactly o = 0, lse = NEG_INF
    assert torch.all(o[-1] == 0) and torch.all(lse[-1] == ref.NEG_INF)


@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_paged_decode_quant_repeat_is_bitwise(dev, kv_dtype):
    rng = np.random.default_rng(13)
    kq, vq, ks, vs, bt = _quant_pool(rng, (40, 300, 5), kv_dtype, dev)
    q = _randn(rng, 3, 1, 32, 128, dtype=torch.bfloat16, dev=dev)
    pos = torch.tensor([39, 299, 4], dtype=torch.int32, device=dev)
    a = pk.paged_flash_decode(q, kq, vq, bt, pos, 0, stride_kv=1, k_scale=ks, v_scale=vs)
    b = pk.paged_flash_decode(q, kq, vq, bt, pos, 0, stride_kv=1, k_scale=ks, v_scale=vs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


QUANT_SHAPES = {
    # name: (depths, page_size, H, Hkv, D, window, num_splits, holes)
    "d32_pages4_window": ((70, 33, 0), 4, 8, 2, 32, 24, 3, True),
    "d64_pages48_group16": ((300, 97), 48, 16, 1, 64, None, 3, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(QUANT_SHAPES))
@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_paged_decode_quant_shapes_match_plain(dev, kv_dtype, case, dtype):
    """The quantized branch at head dims 32 and 64 (fewer 16-byte chunks per
    row than granite's), 4- and 48-slot pages, a window, holes, and a group
    of 16, against the plain version."""
    from repro_torch.core import kv_quant

    depths, ps, H_, Hkv, D_, window, splits, holes = QUANT_SHAPES[case]
    rng = np.random.default_rng(18)
    max_pages = -(-max(depths) // ps) + 1
    k_pool, v_pool, bt = _pool(rng, depths, ps, max_pages, Hkv, D_, torch.float32, dev, holes)
    (kq, ks), (vq, vs) = (kv_quant.quantize(t, kv_dtype) for t in (k_pool, v_pool))
    q = _randn(rng, len(depths), 1, H_, D_, dtype=dtype, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    kw = dict(stride_kv=1, window=window, k_scale=ks, v_scale=vs)
    o, lse = pk.paged_flash_decode(q, kq, vq, bt, pos, 0, num_splits=splits, **kw)
    o_ref, lse_ref = pk.paged_decode_ref(q, kq, vq, bt, pos, 0, **kw)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    assert torch.equal(lse[~live], lse_ref[~live])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_paged_decode_scalar_pos(dev, dtype):
    """One position for every row, as a Python int (passed by value) and as a
    0-d device tensor, against the plain version."""
    rng = np.random.default_rng(19)
    k_pool, v_pool, bt = _pool(rng, (200, 200, 200), 16, 14, 8, 128, dtype, dev)
    q = _randn(rng, 3, 1, 32, 128, dtype=dtype, dev=dev)
    o_ref, lse_ref = pk.paged_decode_ref(q, k_pool, v_pool, bt, 150, 0, stride_kv=1)
    atol, rtol = TOLS[dtype]
    for pos in (150, torch.tensor(150, dtype=torch.int32, device=dev)):
        o, lse = pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, 0, stride_kv=1)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=0)


def test_paged_decode_scale_checks(dev):
    """Scales need a quantized pool and a quantized pool needs scales, on the
    card as on the CPU; no fallback path exists."""
    rng = np.random.default_rng(14)
    kq, vq, ks, vs, bt = _quant_pool(rng, (20,), "int8", dev)
    q = _randn(rng, 1, 1, 32, 128, dtype=torch.float32, dev=dev)
    with pytest.raises(TypeError):
        pk.paged_flash_decode(q, kq, vq, bt, 19, 0, stride_kv=1)
    with pytest.raises(TypeError):
        pk.paged_flash_decode(q, kq.float(), vq.float(), bt, 19, 0, stride_kv=1,
                              k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError):
        pk.paged_flash_decode(q, kq, vq, bt, 19, 0, stride_kv=1,
                              k_scale=ks[:, :8].contiguous(), v_scale=vs[:, :8].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_paged_decode_repeat_is_bitwise(dev, dtype):
    """Two launches over an fp pool (several splits, the combine kernel)
    give bitwise-equal o and lse."""
    rng = np.random.default_rng(15)
    depths = (40, 300, 5, 0)
    k_pool, v_pool, bt = _pool(rng, depths, 16, 20, 8, 128, dtype, dev)
    q = _randn(rng, len(depths), 1, 32, 128, dtype=dtype, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    a = pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, 0, stride_kv=1, num_splits=6)
    b = pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, 0, stride_kv=1, num_splits=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_combine_matches_plain(dev, dtype):
    """The combine kernel against combine_split_partials: some empty splits,
    an all-empty row (exactly o = 0, lse = NEG_INF); an empty split's o is
    never read (NaN there changes nothing)."""
    rng = np.random.default_rng(16)
    B, S, H_, D_ = 4, 5, 8, 128
    o_parts = _randn(rng, B, S, H_, D_, dtype=torch.float32, dev=dev)
    lse_parts = _randn(rng, B, S, H_, dtype=torch.float32, dev=dev) * 4
    empty = torch.from_numpy(rng.random((B, S, H_)) < 0.3).to(dev)
    empty[2] = True  # an all-empty row
    lse_parts[empty] = ref.NEG_INF
    o_parts[empty] = 1e3  # finite garbage, so the plain version stays finite
    before = pk.split_combine.launches
    o, lse = pk.split_combine(o_parts, lse_parts, dtype)
    torch.cuda.synchronize()
    assert pk.split_combine.launches == before + 1
    o_ref, lse_ref = pk.combine_split_partials(o_parts, lse_parts)
    assert o.dtype == dtype and o.shape == o_ref.shape and lse.shape == lse_ref.shape
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    assert torch.all(o[2] == 0) and torch.all(lse[2] == ref.NEG_INF)
    assert torch.equal(lse[~live], lse_ref[~live])
    o_parts[empty] = float("nan")
    o2, lse2 = pk.split_combine(o_parts, lse_parts, dtype)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("quant", [False, True], ids=["fp_pool", "int8_pool"])
def test_paged_decode_runs_no_op_after_launch(dev, monkeypatch, quant):
    """One CUDA call of paged_flash_decode (bf16, several splits): the
    profiler sees no aten op from the launch on, and exactly two kernels
    (the main one and the combine)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import _build

    rng = np.random.default_rng(17)
    depths = (1, 17, 250, 777, 0)
    if quant:
        k_pool, v_pool, ks, vs, bt = _quant_pool(rng, depths, "int8", dev)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k_pool, v_pool, bt = _pool(rng, depths, 16, 50, 8, 128, torch.bfloat16, dev)
        kw = {}
    q = _randn(rng, len(depths), 1, 32, 128, dtype=torch.bfloat16, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    run = lambda: pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, 0, stride_kv=1,  # noqa: E731
                                        num_splits=4, **kw)
    run()  # builds and loads the library
    torch.cuda.synchronize()
    lib = _build.load("paged_decode")
    launch = lib.paged_decode

    def marked(*args):
        with record_function("paged_decode_launch"):
            return launch(*args)

    monkeypatch.setattr(lib, "paged_decode", marked)

    def window():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return prof

    # a warm-up window first: the process's first profiling session can
    # close before the tracer has delivered the card's events
    window()
    torch.cuda.synchronize()
    prof = window()
    events = prof.events()
    mark = [e for e in events if e.name == "paged_decode_launch"
            and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(mark) == 1
    t0 = mark[0].time_range.start
    after = [e.name for e in events if e.name.startswith("aten::") and e.time_range.start >= t0]
    assert after == [], f"aten ops at or after the launch: {after}"
    kernels = {ev.key: ev.count for ev in prof.key_averages()  # the mark shows on the card too
               if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key != mark[0].name}
    ours = {k: n for k, n in kernels.items() if "paged_decode_" in k}
    assert sum(ours.values()) == 2 and sum(kernels.values()) == 2, kernels


def test_combine_all_empty_rows_exact(dev):
    o_parts = torch.randn(2, 3, 4, 32, device=dev)
    lse_parts = torch.full((2, 3, 4), ref.NEG_INF, device=dev)
    o, lse = pk.combine_split_partials(o_parts, lse_parts)
    assert torch.all(o == 0) and torch.all(lse == ref.NEG_INF)


@pytest.mark.parametrize("window", [None, 5])
def test_dense_decode_native_and_band_match_plain(dev, window):
    """The dense cache through the split-K kernel (identity block table) and
    through the band kernel agree with the CPU plain versions."""
    from repro_torch.core import decode_attention as da

    rng = np.random.default_rng(9)
    B, m, H_, Hkv, D_ = 3, 48, 8, 2, 64
    q = _randn(rng, B, 1, H_, D_, dtype=torch.float32, dev=dev)
    kc = _randn(rng, B, m, Hkv, D_, dtype=torch.float32, dev=dev)
    vc = _randn(rng, B, m, Hkv, D_, dtype=torch.float32, dev=dev)
    pos = torch.tensor([0, 20, 47], dtype=torch.int32, device=dev)
    want = da.sharded_cache_decode(q.cpu(), kc.cpu(), vc.cpu(), pos.cpu(), None, 1, window=window)
    for kernel in ("band", "native"):
        got = da.sharded_cache_decode(q, kc, vc, pos, None, 1, window=window, kernel=kernel)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def _ring_pool(rng, n, depths, kv_dtype, dtype, dev, page_size=16, hkv=8, d=128):
    """A pool [P, n*page_size, Hkv, D] sharded over n ranks (rank i owns
    columns [i*ps, (i+1)*ps)), the block table of rows of the given depths,
    and the scale tables of an int8 / fp8 pool (None for an fp one)."""
    from repro_torch.core import kv_quant

    max_pages = -(-max(depths) // (n * page_size)) + 1
    k_pool, v_pool, bt = _pool(rng, [-(-x // n) for x in depths], page_size, max_pages, hkv,
                               d, torch.float32, dev)
    wide = [torch.cat([_randn(rng, *k_pool.shape, dtype=torch.float32, dev=dev) * 3
                       for _ in range(n - 1)] + [k_pool], dim=1),
            torch.cat([_randn(rng, *v_pool.shape, dtype=torch.float32, dev=dev)
                       for _ in range(n - 1)] + [v_pool], dim=1)]
    if kv_dtype == "fp":
        return wide[0].to(dtype), wide[1].to(dtype), None, None, bt
    (kq, ks), (vq, vs) = (kv_quant.quantize(t, kv_dtype) for t in wide)
    return kq, vq, ks, vs, bt


# 8 slots at depths up to 2047, and rows whose later ranks see no key yet
RING_DEPTHS = (1, 2, 3, 100, 777, 1500, 2000, 2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kv_dtype", ["fp"] + QUANT_DTYPES)
def test_paged_decode_folded_ranks_match_plain(dev, kv_dtype, dtype):
    """Sequence-sharded decode over a ring of 4 at granite heads: the 4
    ranks folded into ONE paged decode launch (shifted depths, a negative
    one for a rank that sees no key), the ranks' rows against the plain
    version, the blind rows exactly o = 0, lse = NEG_INF, and the combined
    output against the CPU's."""
    from repro_torch.core import decode_attention as da
    from repro_torch.parallel.ring import VirtualRing

    n = 4
    rng = np.random.default_rng(21)
    kp, vp, ks, vs, bt = _ring_pool(rng, n, RING_DEPTHS, kv_dtype, dtype, dev)
    B = len(RING_DEPTHS)
    q = _randn(rng, B, 1, 32, 128, dtype=dtype, dev=dev)
    pos = torch.tensor([x - 1 for x in RING_DEPTHS], dtype=torch.int32, device=dev)
    fk, fv, fbt, fks, fvs = da._folded_pool(kp, vp, bt, ks, vs, n)
    kv_off, stride = da._rank_offsets(n, fbt.shape[1] * fk.shape[1], "striped", dev)
    launches = (pk.paged_flash_decode.launches, pk.paged_flash_decode.quant_launches)
    o, lse = da._native_partial(q, fk, fv, fbt, pos, kv_off, stride, None, None, fks, fvs)
    torch.cuda.synchronize()
    counted = (pk.paged_flash_decode.launches - launches[0]
               + pk.paged_flash_decode.quant_launches - launches[1])
    assert counted == 1 and o.shape[0] == B * n
    pos_r = (pos.long().repeat_interleave(n) - kv_off.repeat(B)).to(torch.int32)
    o_ref, lse_ref = pk.paged_decode_ref(da._fold_rows(q, n), fk, fv, fbt, pos_r, 0,
                                         stride_kv=stride, k_scale=fks, v_scale=fvs)
    blind = pos_r < 0
    assert blind.sum() == 6  # depths 1, 2, 3: ranks 1-3, 2-3 and 3 see no key
    assert torch.all(o[blind] == 0) and torch.all(lse[blind] == ref.NEG_INF)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[~blind], lse_ref[~blind], atol=LSE_TOL, rtol=0)
    ring = VirtualRing(n)
    sc = dict(k_scale=ks, v_scale=vs)
    got = da.paged_cache_decode(q, kp, vp, bt, pos, ring, n, kernel="native", **sc)
    want = da.paged_cache_decode(q.cpu(), kp.cpu(), vp.cpu(), bt.cpu(), pos.cpu(), VirtualRing(n),
                                 n, kernel="native",
                                 **{k: None if t is None else t.cpu() for k, t in sc.items()})
    # the combined rows carry each side's rounding of its partials to q's
    # type: up to one ulp (rtol) of the largest partial
    c_atol = atol + rtol * float(o_ref.float().abs().max())
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=c_atol, rtol=rtol)
    assert ring.stats.hops == {"combine": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [1, 4, 256], ids=["decode", "verify", "chunk"])
def test_flash_fwd_folded_ranks_match_plain(dev, C, dtype):
    """The flash forward over the dense cache's rank view at a ring of 4:
    one launch with a band per (slot, rank) -- (start, rank, 0, hi), stride
    4 -- at granite heads, 8 slots of 2048; chunks that start at 0 leave the
    later ranks' first rows blind (exactly o = 0, lse = NEG_INF)."""
    from repro_torch.core import decode_attention as da

    n, B, cap = 4, 8, 2048
    rng = np.random.default_rng(22)
    kc = _randn(rng, B, cap, 8, 128, dtype=dtype, dev=dev)
    vc = _randn(rng, B, cap, 8, 128, dtype=dtype, dev=dev)
    q = _randn(rng, B, C, 32, 128, dtype=dtype, dev=dev)
    starts = torch.tensor([0, 1, 2, 256, 777, 1000, 1500, cap - C], dtype=torch.int32,
                          device=dev)
    kv_off, stride = da._rank_offsets(n, cap // n, "striped", dev)
    before = fa.flash_attention_fwd.launches
    o, lse = da._banded_partial(q, da._rank_view(kc, n), da._rank_view(vc, n), starts, kv_off,
                                stride, INF, None)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1 and o.shape[0] == B * n
    o_ref, lse_ref = da._banded_partial(q.cpu(), da._rank_view(kc.cpu(), n),
                                        da._rank_view(vc.cpu(), n), starts.cpu(), kv_off.cpu(),
                                        stride, INF, None)
    # row c of a chunk sees rank i iff start + c >= i
    blind = ((starts.cpu().long().repeat_interleave(n)[:, None] + torch.arange(C))
             < kv_off.cpu().repeat(B)[:, None])  # [B*n, C]
    assert blind.any()
    o_b, lse_b = o.cpu().float(), lse.cpu().transpose(1, 2)  # [B*n, C, H]
    assert torch.all(o_b[blind] == 0) and torch.all(lse_b[blind] == ref.NEG_INF)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o_b, o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse.cpu()[live], lse_ref[live], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["dense", "paged_chunk_spec", "int8_chunk_spec"])
def test_ring_engine_on_card_matches_cpu(dev, mode):
    """Reduced granite-8b, fp32, at sp_size 4 (a virtual ring on one card):
    the card (kernels) and the CPU (plain versions) serve the same streams,
    each decode tick launches the decode kernel once per layer for all
    ranks, and pages drain."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("granite-8b").reduced()
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = {k: val.to(dev) for k, val in params.items() if k != "layers"}
    on_card["layers"] = {
        g: {n: t.to(dev) for n, t in leaves.items()} for g, leaves in params["layers"].items()
    }
    kw = {"dense": dict(paged=False),
          "paged_chunk_spec": dict(paged=True, page_size=4, prefill_chunk=8,
                                   tick_token_budget=16, spec_k=4),
          "int8_chunk_spec": dict(paged=True, page_size=4, prefill_chunk=8,
                                  tick_token_budget=16, spec_k=4, kv_dtype="int8")}[mode]
    serve = ServeConfig(max_seq=64, num_slots=3, **kw)
    rng = np.random.default_rng(0)
    prompts = [np.tile(np.array([7, 11, 13, 7], np.int32), 6),
               rng.integers(0, cfg.vocab_size, (21,), dtype=np.int32),
               rng.integers(0, cfg.vocab_size, (9,), dtype=np.int32)]
    streams = {}
    for name, p, device in (("card", on_card, "cuda"), ("cpu", params, "cpu")):
        before = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches
        eng = ServeEngine(cfg, p, ParallelCtx(sp_size=4, device=device), serve=serve)
        rids = [eng.submit(x, 10, arrival_tick=t) for t, x in enumerate(prompts)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
        launched = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches - before
        if device == "cuda" and kw["paged"]:
            assert launched == cfg.num_layers * eng.decode_launches > 0
            assert eng.kv_cache_stats()["pages_in_use"] == 0
    assert streams["card"] == streams["cpu"]


@pytest.mark.parametrize("kv_dtype", QUANT_DTYPES)
def test_quant_chunk_spec_engine_on_card_matches_cpu(dev, kv_dtype):
    """Reduced granite-8b, fp32, quantized paged pool with continuous prefill
    and speculative verify: the card (4q for decode ticks, the flash
    forward for chunks and verify) and the CPU serve the same streams, the
    decode ticks went through 4q only, and pages and scales drain."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("granite-8b").reduced()
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = {k: val.to(dev) for k, val in params.items() if k != "layers"}
    on_card["layers"] = {
        g: {n: t.to(dev) for n, t in leaves.items()} for g, leaves in params["layers"].items()
    }
    serve = ServeConfig(max_seq=64, num_slots=3, paged=True, page_size=4, kv_dtype=kv_dtype,
                        prefill_chunk=8, tick_token_budget=16, spec_k=4)
    rng = np.random.default_rng(0)
    prompts = [np.tile(np.array([7, 11, 13, 7], np.int32), 6),
               rng.integers(0, cfg.vocab_size, (21,), dtype=np.int32)]
    streams = {}
    for name, p, device in (("card", on_card, "cuda"), ("cpu", params, "cpu")):
        before = (pk.paged_flash_decode.launches, pk.paged_flash_decode.quant_launches)
        eng = ServeEngine(cfg, p, ParallelCtx(device=device), serve=serve)
        rids = [eng.submit(x, 10, arrival_tick=t) for t, x in enumerate(prompts)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
        kv = eng.kv_cache_stats()
        assert kv["pages_in_use"] == 0 and kv["scale_entries_in_use"] == 0
        assert kv["dequant_fallbacks"] == 0
        launched = (pk.paged_flash_decode.launches - before[0],
                    pk.paged_flash_decode.quant_launches - before[1])
        if device == "cuda":
            assert launched == (0, cfg.num_layers * eng.decode_launches)
    assert streams["card"] == streams["cpu"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "single"])
def test_engine_on_card_matches_cpu(dev, paged, pack):
    """Reduced granite-8b, fp32: the engine on the card (kernels) and on the
    CPU (plain versions) serve identical greedy streams."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("granite-8b").reduced()
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = {k: val.to(dev) for k, val in params.items() if k != "layers"}
    on_card["layers"] = {
        g: {n: t.to(dev) for n, t in leaves.items()} for g, leaves in params["layers"].items()
    }
    serve = ServeConfig(max_seq=64, num_slots=3, paged=paged, page_size=4 if paged else None,
                        pack_prefill=pack)
    rng = np.random.default_rng(0)
    trace = [(5, 0), (19, 0), (11, 1), (30, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n, _ in trace]
    streams = {}
    for name, p, device in (("card", on_card, "cuda"), ("cpu", params, "cpu")):
        eng = ServeEngine(cfg, p, ParallelCtx(device=device), serve=serve)
        rids = [eng.submit(x, 6, arrival_tick=t) for x, (_, t) in zip(prompts, trace)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
        if paged:
            assert eng.kv_cache_stats()["pages_in_use"] == 0
    assert streams["card"] == streams["cpu"]


# --------------------------------------------------------------------------
# kernel #5: the SSD chunked scan
# --------------------------------------------------------------------------

SSD_CASES = {
    # name: (B, S, H, P, G, N, chunk) -- the chip_smoke shapes
    "mamba2_2048": (1, 2048, 32, 64, 1, 128, 64),
    "mamba2_1536": (1, 1536, 32, 64, 1, 128, 64),
    "mamba2_short": (1, 48, 32, 64, 1, 128, 64),  # one chunk of 48
    "hymba_1024": (1, 1024, 50, 64, 1, 16, 64),
    "batch4_512": (4, 512, 32, 64, 1, 128, 64),
    "reduced": (2, 64, 16, 16, 1, 16, 8),
    "groups": (1, 96, 8, 32, 4, 32, 32),
}


def _ssd_inputs(B, S, H, P, G, N, dev, seed=3, dt_value=None):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    x, Bm, Cm = f(B, S, H, P), f(B, S, G, N), f(B, S, G, N)
    dt = torch.nn.functional.softplus(f(B, S, H)) if dt_value is None else \
        torch.full((B, S, H), dt_value, device=dev)
    A = -torch.exp(0.5 * f(H)) if dt_value is None else -torch.ones(H, device=dev)
    return x, dt, A, Bm, Cm


def _ssd_check(got, want):
    """y and state within 1e-4 * max(1, max |y_plain|): fp32 sums in another
    order (the state's scale is the output's)."""
    tol = 1e-4 * max(1.0, float(want[0].abs().max()))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g.float() - w.float()).abs().max()) <= tol


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_scan_matches_plain(dev, case):
    B, S, H, P, G, N, chunk = SSD_CASES[case]
    args = _ssd_inputs(B, S, H, P, G, N, dev)
    before = ssd.ssd_scan_fwd.launches
    got = ssd.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_fwd.launches == before + 1
    _ssd_check(got, ssd.ssd_scan_plain(*args, chunk=chunk))
    assert got[0].dtype == torch.float32 and got[1].shape == (B, H, P, N)


def test_ssd_scan_large_dt_and_strided_views(dev):
    """dt = 3, A = -1: a chunk's decay passes exp(-88), where a product mask
    would give NaN; and x / B / C as views into one fused projection."""
    B, S, H, P, G, N = 1, 256, 4, 64, 1, 128
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, G, N, dev, dt_value=3.0)
    fused = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, N), Cm.reshape(B, S, N)], dim=-1)
    xv = fused[..., : H * P].reshape(B, S, H, P)
    bv = fused[..., H * P : H * P + N].reshape(B, S, G, N)
    cv = fused[..., H * P + N :].reshape(B, S, G, N)
    assert not xv.is_contiguous()
    got = ssd.ssd_scan_fwd(xv, dt, A, bv, cv, chunk=64)
    torch.cuda.synchronize()
    _ssd_check(got, ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=64))


def test_ssd_scan_repeat_is_bitwise_and_x_is_fp32_only(dev):
    args = _ssd_inputs(2, 256, 8, 64, 1, 128, dev, seed=9)
    a = ssd.ssd_scan_fwd(*args, chunk=64)
    b = ssd.ssd_scan_fwd(*args, chunk=64)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # the model casts the scan's inputs to fp32, so the kernel takes no other x
    with pytest.raises(TypeError):
        ssd.ssd_scan_fwd(args[0].to(torch.bfloat16), *args[1:], chunk=64)


def test_ssd_scan_refuses_other_shapes(dev):
    for P, N in ((8, 16), (64, 12), (128, 16)):
        args = _ssd_inputs(1, 64, 2, P, 1, N, dev)
        with pytest.raises(ValueError):
            ssd.ssd_scan_fwd(*args, chunk=64)
    args = _ssd_inputs(1, 256, 2, 64, 1, 16, dev)
    with pytest.raises(ValueError):
        ssd.ssd_scan_fwd(*args, chunk=128)  # chunks of at most 64
    with pytest.raises(NotImplementedError):
        ssd.ssd_scan_fwd(args[0].requires_grad_(True), *args[1:], chunk=64)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_engine_on_card_matches_cpu(dev, arch):
    """Reduced SSM / hybrid models, fp32: the engine on the card (SSD kernel,
    flash forward for hymba) and on the CPU serve identical streams."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = {k: val.to(dev) for k, val in params.items() if k != "layers"}
    on_card["layers"] = {
        g: {n: t.to(dev) for n, t in leaves.items()} for g, leaves in params["layers"].items()
    }
    rng = np.random.default_rng(0)
    trace = [(8, 0), (24, 0), (5, 1), (32, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n, _ in trace]
    streams = {}
    for name, p, device in (("card", on_card, "cuda"), ("cpu", params, "cpu")):
        eng = ServeEngine(cfg, p, ParallelCtx(device=device),
                          serve=ServeConfig(max_seq=64, num_slots=3))
        before = ssd.ssd_scan_fwd.launches
        rids = [eng.submit(x, 6, arrival_tick=t) for x, (_, t) in zip(prompts, trace)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
        launched = ssd.ssd_scan_fwd.launches - before
        assert launched == (cfg.num_layers * eng.prefill_launches if device == "cuda" else 0)
    assert streams["card"] == streams["cpu"]


NAN_FLASH = {
    # name: (dtype, B, Sq, Skv, band): the body _fwd_plan picks for it
    "fp32": (torch.float32, 2, 64, 200, (0, 0, -INF, INF)),
    "tile": (torch.bfloat16, 2, 256, 300, (0, 0, -INF, INF)),
    "decode_split": (torch.bfloat16, 2, 1, 2048, (2047, 0, 0, INF)),
    "decode_one_split": (torch.bfloat16, 80, 1, 300, (299, 0, 0, INF)),
}


@pytest.mark.parametrize("case", list(NAN_FLASH))
def test_flash_fwd_nan_score_reaches_o_and_lse(dev, case):
    """A NaN key (the serving engine's chaos poison) makes the rows that see
    it NaN in o and lse, through every body and the decode body's split
    combine, as JAX's kernels do -- the engine's NaN guard reads it there.
    Rows of the other batch entries stay the plain version's."""
    dtype, B, Sq, Skv, band = NAN_FLASH[case]
    rng = np.random.default_rng(23)
    q = _randn(rng, B, Sq, 32, 128, dtype=dtype, dev=dev)
    k = _randn(rng, B, Skv, 8, 128, dtype=dtype, dev=dev)
    v = _randn(rng, B, Skv, 8, 128, dtype=dtype, dev=dev)
    k[0, 0] = float("nan")  # key 0 of batch row 0, every kv head
    counters = ("launches_fp32", "launches_tile", "launches_decode")
    before = [getattr(fa.flash_attention_fwd, c) for c in counters]
    o, lse = fa.flash_attention_fwd(q, k, v, band, scale=128**-0.5)
    torch.cuda.synchronize()
    body = case.split("_")[0]
    after = [getattr(fa.flash_attention_fwd, c) - b for c, b in zip(counters, before)]
    assert after == [int(c == f"launches_{body}") for c in counters]
    assert torch.isnan(o[0].float()).all() and torch.isnan(lse[0]).all()
    o_ref, lse_ref = ref.attention_ref(q[1:], k[1:], v[1:], scale=128**-0.5, band=band)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o[1:].float(), o_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[1:], lse_ref, atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["simt", "mma"])
@pytest.mark.parametrize("kv_dtype", ["fp"] + QUANT_DTYPES)
def test_paged_decode_nan_score_reaches_o_and_lse(dev, kv_dtype, dtype, splits):
    """The poison of ``ServeEngine.poison_slot_cache`` -- NaN in position 0
    of a slot's first page, in K (fp pool) or in the fp32 K scale
    (quantized) -- makes that slot's o and lse NaN through the mma and simt
    bodies and the split combine; the other slots keep the plain version's
    output."""
    rng = np.random.default_rng(24)
    depths = (300, 200, 37)
    if kv_dtype == "fp":
        max_pages = -(-max(depths) // 16) + 1
        kp, vp, bt = _pool(rng, depths, 16, max_pages, 8, 128, dtype, dev)
        ks = vs = None
        kp[int(bt[0, 0])][0] = float("nan")
    else:
        kp, vp, ks, vs, bt = _quant_pool(rng, depths, kv_dtype, dev)
        ks[int(bt[0, 0])][0] = float("nan")
    q = _randn(rng, len(depths), 1, 32, 128, dtype=dtype, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    o, lse = pk.paged_flash_decode(q, kp, vp, bt, pos, 0, stride_kv=1, num_splits=splits,
                                   k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isnan(o[0].float()).all() and torch.isnan(lse[0]).all()
    o_ref, lse_ref = pk.paged_decode_ref(q, kp, vp, bt, pos, 0, stride_kv=1, k_scale=ks,
                                         v_scale=vs)
    assert torch.isnan(o_ref[0].float()).all()  # the plain version agrees
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o[1:].float(), o_ref[1:].float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=LSE_TOL, rtol=0)
