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
    # head dim 256 (gemma-7b: 16 / 16 heads): the tile body's 32-key tiles
    # (one warpgroup a CTA in fp32) with segments and a window off a multiple
    # of 4 keys, GQA 2 under a window, a ragged causal row, a chunk, rows
    # long enough for the fp32 body's fold; the decode body's one 16-row
    # tile (ticks with a hidden row, a verify), and 18 packed rows, past
    # its 16, on the tile body
    "gemma_segments": (1, 384, 384, 16, 16, 256, (0, 0, 0, INF), 1, 1, True),
    "gemma_segments_window": (1, 300, 300, 4, 2, 256, (3, 0, 0, 41), 1, 1, True),
    "gemma_group2_window": (1, 200, 200, 4, 2, 256, (0, 0, 0, 63), 1, 1, False),
    "gemma_causal_ragged": (1, 333, 333, 2, 2, 256, (0, 0, 0, INF), 1, 1, False),
    "gemma_long": (1, 2048, 2048, 2, 2, 256, (0, 0, 0, INF), 1, 1, False),
    "gemma_chunk": (8, 256, 1024, 16, 16, 256,
                    [(p, 0, 0, INF) for p in (0, 256, 512, 700, 300, 768, 100, 900)], 1, 1,
                    False),
    "decode_slots_gemma": (8, 1, 300, 16, 16, 256,
                           [(p, 0, 0, INF) for p in (0, 17, 64, 150, 299, 5000, 220)]
                           + [(3, 0, 5, INF)], 1, 1, False),
    "verify_gemma": (8, 5, 1024, 16, 16, 256,
                     [(p, 0, 0, INF) for p in (0, 5, 100, 777, 1000, 1019, 1020, 3000)], 1, 1,
                     False),
    "gemma_rows_18": (2, 9, 300, 4, 2, 256, [(150, 0, 0, INF), (299, 0, 0, INF)], 1, 1, False),
    # 4 kv-head CTAs: the keys split 8 ways, merged by the combine
    "decode_split_gemma": (2, 1, 2048, 4, 2, 256, [(2047, 0, 0, INF), (900, 0, 0, 511)], 1, 1,
                           False),
    # whisper-base (8 / 8 heads of 64): the encoder's non-causal 1536 rows,
    # cross-attention prefill (the 64-token bucket over 1536 encoder rows;
    # a ragged 37 at batch 2), cross-attention decode (8 slots x 1 over
    # 1536, the keys split across CTAs) and the decoder's dense-cache
    # self-attention decode (8 slots over max_seq 448)
    "whisper_encoder": (1, 1536, 1536, 8, 8, 64, (0, 0, -INF, INF), 1, 1, False),
    "whisper_cross_prefill": (1, 64, 1536, 8, 8, 64, (0, 0, -INF, INF), 1, 1, False),
    "whisper_cross_ragged": (2, 37, 1536, 8, 8, 64, (0, 0, -INF, INF), 1, 1, False),
    "whisper_cross_decode": (8, 1, 1536, 8, 8, 64, (0, 0, -INF, INF), 1, 1, False),
    "whisper_self_decode": (8, 1, 448, 8, 8, 64,
                            [(p, 0, 0, INF) for p in (4, 17, 64, 100, 200, 300, 447, 0)], 1, 1,
                            False),
    # minicpm3-4b's MLA on the tile body alone: head dim 96 (prefill over the
    # expanded 40 / 40 heads: a ragged causal row, segments under a window
    # off a multiple of 4 keys, a short prompt of 9 rows) and head dim 288
    # (the absorbed latent, 40 query heads on one kv head: a chunk, a
    # verify, decode ticks with a hidden row, segments and a window with
    # GQA 2, rows long enough for the fp32 body's fold)
    "mla_prefill_d96": (1, 333, 333, 40, 40, 96, (0, 0, 0, INF), 1, 1, False),
    "mla_segments_window_d96": (1, 300, 300, 4, 2, 96, (3, 0, 0, 41), 1, 1, True),
    "mla_short_d96": (2, 9, 9, 40, 40, 96, (0, 0, 0, INF), 1, 1, False),
    "mla_chunk_d288": (8, 256, 1024, 40, 1, 288,
                       [(p, 0, 0, INF) for p in (0, 256, 512, 700, 300, 768, 100, 900)], 1, 1,
                       False),
    "mla_verify_d288": (8, 5, 1024, 40, 1, 288,
                        [(p, 0, 0, INF) for p in (0, 5, 100, 777, 1000, 1019, 1020, 3000)], 1,
                        1, False),
    "mla_decode_d288": (8, 1, 300, 40, 1, 288,
                        [(p, 0, 0, INF) for p in (0, 17, 64, 150, 299, 5000, 220)]
                        + [(3, 0, 5, INF)], 1, 1, False),
    "mla_segments_window_d288": (1, 300, 300, 4, 2, 288, (3, 0, 0, 41), 1, 1, True),
    "mla_long_d288": (1, 2048, 2048, 2, 2, 288, (0, 0, 0, INF), 1, 1, False),
}


FWD_COUNTERS = ("launches", "launches_tile", "launches_decode", "launches_tile_fp32",
                "launches_decode_fp32", "launches_fp32")


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
    fp32 = dtype == torch.float32
    assert body.endswith("_fp32") == fp32
    before = {c: getattr(fa.flash_attention_fwd, c) for c in FWD_COUNTERS}
    split_before = fa.fwd_split_terms.launches
    o, lse = fa.flash_attention_fwd(q, k, v, band, **kw)
    torch.cuda.synchronize()
    moved = {c: getattr(fa.flash_attention_fwd, c) - before[c] for c in FWD_COUNTERS}
    want = ["launches", f"launches_{body}"] + (["launches_fp32"] if fp32 else [])
    assert moved == {c: int(c in want) for c in FWD_COUNTERS}
    # fp32: one pre-pass launch writes the operands' two bf16 terms
    assert fa.fwd_split_terms.launches - split_before == int(fp32)
    assert o.dtype == dtype
    o_ref, lse_ref = ref.attention_ref(q, k, v, band=plain_band, **kw)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    live = lse_ref > ref.NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    # empty rows: exactly o = 0 and lse = NEG_INF
    assert torch.equal(lse[~live], lse_ref[~live])
    assert torch.all(o.transpose(1, 2)[~live] == 0)
    if case in ("hidden_rows", "decode_slots_granite", "decode_slots_hymba",
                "decode_slots_gemma", "mla_decode_d288"):
        assert (~live).any()
    if D == 256:  # 16 packed rows at most on the decode body
        assert body.startswith("decode") == (Sq * (H // Hkv) <= 16)
    if D in fa.TILE_ONLY_HEAD_DIMS:
        assert body.startswith("tile")


# (case, dtype): every body of both types -- the tile body (granite
# segments, hymba's window, chunks), the decode body with one split (verify)
# and with several (hymba's decode slots)
REPEAT_CASES = [(c, torch.bfloat16) for c in ("granite_segments", "hymba_window", "chunk",
                                              "decode_slots_hymba", "verify")] + [
    (c, torch.float32) for c in ("granite_segments", "chunk", "decode_slots_hymba", "verify")] + [
    (c, d) for c in ("gemma_segments", "decode_slots_gemma", "verify_gemma")
    for d in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("case,dtype", REPEAT_CASES,
                         ids=[f"{c}-{'fp32' if d == torch.float32 else 'bf16'}"
                              for c, d in REPEAT_CASES])
def test_flash_fwd_tensor_core_repeat_is_bitwise(dev, case, dtype):
    """The bodies sum in a fixed order (the decode body's key splits merge
    without atomics, the fp32 tile body folds its accumulators into its own
    rows of o): two launches give identical outputs."""
    B, Sq, Skv, H, Hkv, D, band, sq, skv, seg = FLASH_CASES[case]
    band, _ = _band_arg(band, dev)
    rng = np.random.default_rng(11)
    q, k, v = (_randn(rng, B, S, h, D, dtype=dtype, dev=dev)
               for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv)
    if seg:
        ids = np.sort(rng.integers(0, 4, Sq)).astype(np.int32)
        kw["seg_q"] = kw["seg_kv"] = torch.from_numpy(ids).to(dev)
    body, splits = fa._fwd_plan(B, Sq, H, Hkv, D, dtype)
    want = "decode" if case.startswith(("decode", "verify")) else "tile"
    assert body == want + ("_fp32" if dtype == torch.float32 else "")
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


@pytest.mark.parametrize("kind", ["causal", "full"])
def test_flash_fwd_fp32_long_rows(dev, kind):
    """fp32 rows over 16,384 keys at the paper's heads (32 / 32 of 128), as
    the mesh path's local flash runs them: the tile body's o accumulators
    span 256 key tiles, and the tensor cores truncate as they accumulate
    (the body folds them into o every FOLD tiles).  The plain version takes
    a few slices of rows, the last ones seeing every key."""
    S, H, D = 16384, 32, 128
    rng = np.random.default_rng(31)
    q, k, v = (_randn(rng, 1, S, H, D, dtype=torch.float32, dev=dev) for _ in range(3))
    band = (0, 0, 0 if kind == "causal" else -INF, INF)
    assert fa._fwd_plan(1, S, H, H, D, torch.float32) == ("tile_fp32", 1)
    o, lse = fa.flash_attention_fwd(q, k, v, band, scale=D**-0.5)
    torch.cuda.synchronize()
    atol, _ = TOLS[torch.float32]
    for r0 in (0, 4096, S - 256):
        rows = slice(r0, r0 + 256)
        o_ref, lse_ref = ref.attention_ref(q[:, rows], k, v, scale=D**-0.5,
                                           band=(r0, 0, *band[2:]))
        torch.testing.assert_close(o[:, rows], o_ref, atol=atol, rtol=0)
        torch.testing.assert_close(lse[:, :, rows], lse_ref, atol=LSE_TOL, rtol=0)


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
    # head dim 256 (gemma-7b): 32-row streamed tiles, dK/dV over two
    # warpgroups; causal MHA, a ragged window at GQA 2, segments, stripes,
    # a cross-length band
    "causal_d256": (1, 256, 256, 4, 4, 256, (0, 0, 0, ref.BAND_INF), 1, 1, False),
    "window_gqa2_d256": (1, 333, 333, 8, 4, 256, (0, 0, 0, 63), 1, 1, False),
    "segments_d256": (2, 200, 200, 4, 2, 256, (0, 0, 0, ref.BAND_INF), 1, 1, True),
    "striped_d256": (1, 192, 192, 2, 2, 256, (1, 0, 0, ref.BAND_INF), 2, 2, False),
    "cross_length_d256": (1, 100, 260, 4, 2, 256, (0, -160, 0, ref.BAND_INF), 1, 1, False),
    # whisper-base's training bands (8 / 8 heads of 64): the encoder's
    # non-causal square, the decoder rows' full band over the encoder rows
    # (448 x 1536), and ragged row counts (440; 441, whose rows' lse and
    # delta vectors start off a 16-byte boundary in every head but the first)
    "whisper_encoder": (2, 1536, 1536, 8, 8, 64, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1,
                        False),
    "whisper_cross": (2, 448, 1536, 8, 8, 64, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1, False),
    "whisper_cross_ragged": (1, 440, 1536, 8, 8, 64, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1,
                             False),
    "whisper_cross_odd": (1, 441, 1536, 8, 8, 64, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1,
                          False),
    # head dim 96 (minicpm3-4b's expanded MLA heads: three 32-dim column
    # blocks of 64-byte swizzle): causal MHA at its 40 / 40 heads, Sq and Skv
    # off the 64-row tiles, segments, a window at GQA 2, stripes, a
    # cross-length band
    "causal_mha_d96": (1, 256, 256, 40, 40, 96, (0, 0, 0, ref.BAND_INF), 1, 1, False),
    "ragged_d96": (1, 333, 271, 4, 4, 96, (0, 0, -ref.BAND_INF, ref.BAND_INF), 1, 1, False),
    "segments_d96": (2, 200, 200, 4, 4, 96, (0, 0, 0, ref.BAND_INF), 1, 1, True),
    "window_gqa2_d96": (1, 333, 333, 8, 4, 96, (0, 0, 0, 63), 1, 1, False),
    "striped_d96": (1, 192, 192, 4, 4, 96, (1, 0, 0, ref.BAND_INF), 2, 2, False),
    "cross_length_d96": (1, 100, 260, 4, 4, 96, (0, -160, 0, ref.BAND_INF), 1, 1, False),
}
BWD_D96_CASES = [name for name in BWD_CASES if name.endswith("_d96")]
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_D96_CASES)
def test_flash_bwd_d96_repeat_is_bitwise(dev, case, dtype):
    """At head dim 96 every case takes the body its type names, and a second
    launch gives identical gradients."""
    q, k, v, o, lse, do, band, kw = _bwd_inputs(case, dtype, dev)
    B, Sq, H, D = q.shape
    body = fa._bwd_plan(B, Sq, k.shape[1], H, k.shape[2], D, dtype)
    before = getattr(fa.flash_attention_bwd, f"launches_{body}")
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, band, **kw)
    torch.cuda.synchronize()
    assert body == ("tc_fp32" if dtype == torch.float32 else "tc_bf16")
    assert getattr(fa.flash_attention_bwd, f"launches_{body}") == before + 2
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_bwd_mesh_blocks_d96_match_plain(dev, dtype):
    """The backward as the Mesh-Attention executor launches it over a ring of
    4 (mesh a = 2, striped, causal) at head dim 96: every AM block of every
    rank with its own band ([4], strides 4), against the plain version and
    bitwise on a repeat; rows that see no key get dq exactly 0."""
    from repro_torch.core.masking import MaskSpec
    from repro_torch.core.mesh_attention import MeshAttentionConfig, _band_for_block

    rng = np.random.default_rng(96)
    n, a, m, H, D = 4, 2, 320, 8, 96
    cfg = MeshAttentionConfig(transport=None, n=n, a=a, mask=MaskSpec.causal())
    q = _randn(rng, 1, m, H, D, dtype=dtype, dev=dev)
    k = _randn(rng, 1, m, H, D, dtype=dtype, dev=dev)
    v = _randn(rng, 1, m, H, D, dtype=dtype, dev=dev)
    do = _randn(rng, 1, m, H, D, dtype=dtype, dev=dev)
    atol, rtol = BWD_TOLS[dtype]
    blind_rows = 0
    for i in range(n):
        for u in range(a):
            for w in range(n // a):
                band, sq, skv = _band_for_block(cfg, i, u, w, m, m)
                kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv)
                o, lse = ref.attention_ref(q, k, v, band=band, **kw)
                delta = (do.float() * o.float()).sum(-1)
                band_t = torch.tensor(band, dtype=torch.int32, device=dev)
                got = fa.flash_attention_bwd(q, k, v, None, lse, do, band_t, delta=delta, **kw)
                again = fa.flash_attention_bwd(q, k, v, None, lse, do, band_t, delta=delta, **kw)
                want = ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)
                for name, g, g2, r in zip(("dq", "dk", "dv"), got, again, want):
                    assert torch.equal(g, g2), (i, u, w, name)
                    torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol,
                                               msg=f"{(i, u, w)} {name}")
                blind = ~ref.band_mask(m, m, band, stride_q=sq, stride_kv=skv,
                                       device=dev).any(dim=1)
                assert torch.all(got[0][0][blind] == 0)
                blind_rows += int(blind.sum())
    assert blind_rows > 0  # some block shows a rank's first row no key


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


def test_fwd_split_terms_match_plain(dev):
    """The fp32 forward's pre-pass (the backward's split body under the
    forward's kernel name) against its plain version: bitwise equal terms,
    one launch for q, k and v."""
    rng = np.random.default_rng(12)
    xs = [_randn(rng, 1, 333, h, 128, dtype=torch.float32, dev=dev) * 3 for h in (8, 2, 2)]
    before = fa.fwd_split_terms.launches
    got = fa.fwd_split_terms(*xs)
    assert fa.fwd_split_terms.launches - before == 1
    for g, x in zip(got, xs):
        assert g.shape == (2, *x.shape) and torch.equal(g, fa.split_terms_ref(x))


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
    # head dim 256 (gemma-7b's 16 / 16 heads; Q's fragments from shared
    # memory, the fp32 body's one-stage rings), and GQA 2 with a window and
    # holes over 3 blocks
    "gemma_like": ((37, 1, 250, 16, 0, 129), 16, 16, 16, 256, 1, 0, None, None, False),
    "gemma_group2_window_holes": ((300, 161, 5), 8, 8, 4, 256, 1, 0, 200, 3, True),
    # head dim 288 (minicpm3-4b's absorbed latent: the wide bodies): 40 query
    # heads on one kv head at serving depths, a window with holes over 3
    # blocks, the full 48 rows, and a group of 12 (two idle row tiles)
    "mla_like": ((37, 1, 250, 16, 0, 129, 2047, 900), 16, 40, 1, 288, 1, 0, None, None, False),
    "mla_window_holes": ((300, 161, 5), 8, 40, 1, 288, 1, 0, 200, 3, True),
    "mla_group48": ((400, 33), 16, 48, 1, 288, 1, 0, None, 4, False),
    "mla_group12": ((400, 33, 0), 16, 24, 2, 288, 1, 0, None, None, False),
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
    # head dim 256: gemma-7b's heads at serving depths, and GQA 2 with a
    # window and holes
    "d256_gemma": ((1, 17, 250, 777, 0), 16, 16, 16, 256, None, None, False),
    "d256_group2_window": ((300, 97, 0), 16, 8, 4, 256, 128, 3, True),
    # head dim 288 (the wide bodies): minicpm3-4b's 40 heads on the latent at
    # serving depths, and a window with holes over 3 blocks
    "d288_mla": ((1, 17, 250, 777, 2047, 0), 16, 40, 1, 288, None, None, False),
    "d288_window_holes": ((300, 97, 0), 16, 40, 1, 288, 128, 3, True),
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


@pytest.mark.parametrize("D_", [256, 288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_combine_d256_matches_plain(dev, dtype, D_):
    """The combine at head dims 256 and 288 (8 and 9 dims a lane), an
    all-empty row."""
    rng = np.random.default_rng(17)
    B, S, H_ = 3, 6, 4
    o_parts = _randn(rng, B, S, H_, D_, dtype=torch.float32, dev=dev)
    lse_parts = _randn(rng, B, S, H_, dtype=torch.float32, dev=dev) * 4
    lse_parts[1] = ref.NEG_INF
    o, lse = pk.split_combine(o_parts, lse_parts, dtype)
    o_ref, lse_ref = pk.combine_split_partials(o_parts, lse_parts)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[[0, 2]], lse_ref[[0, 2]], atol=LSE_TOL, rtol=0)
    assert torch.all(o[1] == 0) and torch.all(lse[1] == ref.NEG_INF)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("Sq", [448, 440])
def test_flash_attention_op_cross_band_grads_match_plain(dev, Sq, dtype):
    """ops.flash_attention with causal=False and Sq != Skv (whisper's
    cross-attention under autograd): the forward kernel, then the dQ and
    dK/dV kernels, against the same op on the CPU (the plain versions)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(Sq)
    shapes = [(2, Sq, 8, 64), (2, 1536, 8, 64), (2, 1536, 8, 64), (2, Sq, 8, 64)]
    q, k, v, do = (_randn(rng, *s, dtype=dtype, dev=dev) for s in shapes)
    grads = {}
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq,
              fa.flash_attention_bwd.launches_dkv)
    for where in ("cuda", "cpu"):
        leaves = [t.to(where).detach().requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=False)
        grads[where] = (out, *torch.autograd.grad(out, leaves, do.to(where)))
    after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq,
             fa.flash_attention_bwd.launches_dkv)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    atol, rtol = BWD_TOLS[dtype]
    for name, g, w in zip(("o", "dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.float().cpu(), w.float(), atol=atol, rtol=rtol, msg=name)


@pytest.mark.parametrize("arch,paged", [("whisper-base", False), ("pixtral-12b", False),
                                        ("pixtral-12b", True)])
def test_frontend_engine_on_card_matches_cpu(dev, arch, paged):
    """Reduced whisper-base (the encoder once per admission, cross-attention
    decode over the slot's rows) and pixtral-12b (prompts past its 8
    patches), fp32: the engine on the card and on the CPU serve identical
    greedy streams."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, seed=0, device="cpu")
    serve = ServeConfig(max_seq=64, num_slots=3, paged=paged, page_size=4 if paged else None)
    rng = np.random.default_rng(0)
    trace = [(5, 0), (19, 0), (11, 1), (30, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n, _ in trace]
    streams = {}
    for name, p, device in (("card", to(params, dev), "cuda"), ("cpu", params, "cpu")):
        eng = ServeEngine(cfg, p, ParallelCtx(device=device), serve=serve)
        rids = [eng.submit(x, 6, arrival_tick=t) for x, (_, t) in zip(prompts, trace)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
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
    # a chunk that is no multiple of 16 (40 rows padded to 48) with groups of
    # 4 heads, N 8 padded to 16 on the tensor cores
    "chunk40_groups": (2, 120, 8, 32, 2, 8, 40),
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


@pytest.mark.parametrize("autograd", [False, True], ids=["serving", "autograd"])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_scan_matches_plain(dev, case, autograd):
    """Outside autograd the kernel's serving split, under it the training
    forward's (AUTOGRAD_TERMS), each against the plain version."""
    B, S, H, P, G, N, chunk = SSD_CASES[case]
    args = _ssd_inputs(B, S, H, P, G, N, dev)
    if autograd:
        args = [t.requires_grad_(True) for t in args]
    before = ssd.ssd_scan_fwd.launches, ssd.ssd_scan_fwd.launches_autograd
    got = [t.detach() for t in ssd.ssd_scan_fwd(*args, chunk=chunk)]
    torch.cuda.synchronize()
    assert (ssd.ssd_scan_fwd.launches, ssd.ssd_scan_fwd.launches_autograd) == \
        (before[0] + 1, before[1] + autograd)
    with torch.no_grad():
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
    # the kernel takes autograd inputs: its backward is #5b
    x = args[0].clone().requires_grad_(True)
    before = ssd.ssd_scan_bwd.launches
    ssd.ssd_scan_fwd(x, *args[1:], chunk=64)[0].sum().backward()
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == before + 1 and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("case,dstate", [
    pytest.param(case, dstate, id=case + ("-dstate" if dstate else ""))
    for case, dstate in (("mamba2_2048", False), ("mamba2_short", False), ("hymba_1024", False),
                         ("batch4_512", True), ("reduced", True), ("groups", True),
                         ("chunk40_groups", True))
])
def test_ssd_scan_bwd_matches_plain(dev, case, dstate):
    """#5b against ssd_scan_bwd_plain: each gradient within 1e-4 of its
    largest |value| (fp32 sums in another order), a repeat bitwise equal;
    and autograd through ssd_scan_fwd launches it once."""
    B, S, H, P, G, N, chunk = SSD_CASES[case]
    args = _ssd_inputs(B, S, H, P, G, N, dev, seed=5)
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)).to(dev)
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32)).to(dev) \
        if dstate else None
    before = ssd.ssd_scan_bwd.launches
    got = ssd.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    again = ssd.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == before + 2
    want = ssd.ssd_scan_bwd_plain(*args, dy, ds, chunk)
    for g, a, w in zip(got, again, want):
        assert torch.isfinite(g).all() and torch.equal(g, a)
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, st = ssd.ssd_scan_fwd(*leaves, chunk=chunk)
    ((y * dy).sum() + (0 if ds is None else (st * ds).sum())).backward()
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == before + 3
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_ssd_scan_bwd_large_dt_matches_plain(dev):
    """dt = 3, A = -1 at mamba2's widths: a chunk's sum of dt*|A| passes 88,
    where exp(-acum) would overflow; #5b masks every decay by selection, so
    its gradients are finite and within 1e-4 of the plain version's."""
    B, S, H, P, G, N = 1, 256, 8, 64, 1, 128
    args = _ssd_inputs(B, S, H, P, G, N, dev, seed=7, dt_value=3.0)
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)).to(dev)
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32)).to(dev)
    got = ssd.ssd_scan_bwd(*args, dy, ds, chunk=64)
    torch.cuda.synchronize()
    want = ssd.ssd_scan_bwd_plain(*args, dy, ds, 64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("arch,sp", [
    pytest.param(arch, sp, id=arch + ("-ring4" if sp > 1 else ""))
    for sp in (1, 4) for arch in ("mamba2-370m", "hymba-1.5b")
])
def test_ssm_engine_on_card_matches_cpu(dev, arch, sp):
    """Reduced SSM / hybrid models, fp32: the engine on the card (SSD kernel,
    flash forward for hymba) and on the CPU serve identical streams.  The
    ring4 cases serve on the card over a ring of 4 (the sequence-sharded
    scan, one #5 launch per layer for all ranks; a 4-token prompt leaves
    each rank one row) against the CPU on one rank."""
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
    trace = [(8, 0), (24, 0), (5 if sp == 1 else 4, 1), (32, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32) for n, _ in trace]
    streams = {}
    for name, p, device in (("card", on_card, "cuda"), ("cpu", params, "cpu")):
        ctx = ParallelCtx(sp_size=sp if device == "cuda" else 1, device=device)
        eng = ServeEngine(cfg, p, ctx, serve=ServeConfig(max_seq=64, num_slots=3))
        before = ssd.ssd_scan_fwd.launches
        rids = [eng.submit(x, 6, arrival_tick=t) for x, (_, t) in zip(prompts, trace)]
        done = eng.run()
        streams[name] = [done[r].generated for r in rids]
        launched = ssd.ssd_scan_fwd.launches - before
        assert launched == (cfg.num_layers * eng.prefill_launches if device == "cuda" else 0)
    assert streams["card"] == streams["cpu"]


NAN_FLASH = {
    # name: (dtype, B, Sq, Skv, band, the body _fwd_plan picks for it[,
    # heads (H, Hkv, D): granite's 32 / 8 of 128 unless given])
    "fp32": (torch.float32, 2, 64, 200, (0, 0, -INF, INF), "tile_fp32"),
    "tile": (torch.bfloat16, 2, 256, 300, (0, 0, -INF, INF), "tile"),
    "decode_split": (torch.bfloat16, 2, 1, 2048, (2047, 0, 0, INF), "decode"),
    "decode_one_split": (torch.bfloat16, 80, 1, 300, (299, 0, 0, INF), "decode"),
    "decode_split_fp32": (torch.float32, 2, 1, 2048, (2047, 0, 0, INF), "decode_fp32"),
    # head dim 256: both bodies in both types, the decode split merged
    "gemma_fp32": (torch.float32, 2, 64, 200, (0, 0, -INF, INF), "tile_fp32", (4, 4, 256)),
    "gemma_tile": (torch.bfloat16, 2, 256, 300, (0, 0, -INF, INF), "tile", (4, 4, 256)),
    "gemma_decode_split": (torch.bfloat16, 2, 1, 2048, (2047, 0, 0, INF), "decode",
                           (4, 4, 256)),
    "gemma_decode_split_fp32": (torch.float32, 2, 1, 2048, (2047, 0, 0, INF), "decode_fp32",
                                (4, 4, 256)),
}


@pytest.mark.parametrize("case", list(NAN_FLASH))
def test_flash_fwd_nan_score_reaches_o_and_lse(dev, case):
    """A NaN key (the serving engine's chaos poison) makes the rows that see
    it NaN in o and lse, through every body and the decode body's split
    combine, as JAX's kernels do -- the engine's NaN guard reads it there.
    Rows of the other batch entries stay the plain version's."""
    dtype, B, Sq, Skv, band, body, *heads = NAN_FLASH[case]
    H_, Hkv, D_ = heads[0] if heads else (32, 8, 128)
    rng = np.random.default_rng(23)
    q = _randn(rng, B, Sq, H_, D_, dtype=dtype, dev=dev)
    k = _randn(rng, B, Skv, Hkv, D_, dtype=dtype, dev=dev)
    v = _randn(rng, B, Skv, Hkv, D_, dtype=dtype, dev=dev)
    k[0, 0] = float("nan")  # key 0 of batch row 0, every kv head
    counters = FWD_COUNTERS[1:]
    before = [getattr(fa.flash_attention_fwd, c) for c in counters]
    o, lse = fa.flash_attention_fwd(q, k, v, band, scale=D_**-0.5)
    torch.cuda.synchronize()
    after = [getattr(fa.flash_attention_fwd, c) - b for c, b in zip(counters, before)]
    fp32 = dtype == torch.float32
    assert after == [int(c == f"launches_{body}" or (fp32 and c == "launches_fp32"))
                     for c in counters]
    assert torch.isnan(o[0].float()).all() and torch.isnan(lse[0]).all()
    o_ref, lse_ref = ref.attention_ref(q[1:], k[1:], v[1:], scale=D_**-0.5, band=band)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["simt", "mma"])
@pytest.mark.parametrize("kv_dtype", ["fp"] + QUANT_DTYPES)
def test_paged_decode_nan_score_reaches_o_and_lse_d256(dev, kv_dtype, dtype):
    """The NaN path at head dim 256 (gemma-7b's 16 / 16 heads), over 4
    splits: the poisoned slot's o and lse are NaN, the others the plain
    version's."""
    from repro_torch.core import kv_quant

    rng = np.random.default_rng(25)
    depths = (300, 200, 37)
    k_pool, v_pool, bt = _pool(rng, depths, 16, -(-max(depths) // 16) + 1, 16, 256,
                               torch.float32 if kv_dtype != "fp" else dtype, dev)
    if kv_dtype == "fp":
        ks = vs = None
        k_pool[int(bt[0, 0])][0] = float("nan")
    else:
        (k_pool, ks), (v_pool, vs) = (kv_quant.quantize(t, kv_dtype) for t in (k_pool, v_pool))
        ks[int(bt[0, 0])][0] = float("nan")
    q = _randn(rng, len(depths), 1, 16, 256, dtype=dtype, dev=dev)
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device=dev)
    o, lse = pk.paged_flash_decode(q, k_pool, v_pool, bt, pos, 0, stride_kv=1, num_splits=4,
                                   k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isnan(o[0].float()).all() and torch.isnan(lse[0]).all()
    o_ref, lse_ref = pk.paged_decode_ref(q, k_pool, v_pool, bt, pos, 0, stride_kv=1, k_scale=ks,
                                         v_scale=vs)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o[1:].float(), o_ref[1:].float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[1:], lse_ref[1:], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_bwd_d256_matches_plain_and_repeats(dev, dtype):
    """The backward at head dim 256, ragged (Sq 1000 over Skv 1000, not a
    multiple of the 64-key CTAs or the 32-row tiles) at GQA 2: against the
    plain version, on the body the plan names, and bitwise on a repeat."""
    rng = np.random.default_rng(29)
    B, S, H, Hkv, D = 1, 1000, 4, 2, 256
    q = _randn(rng, B, S, H, D, dtype=dtype, dev=dev)
    k = _randn(rng, B, S, Hkv, D, dtype=dtype, dev=dev)
    v = _randn(rng, B, S, Hkv, D, dtype=dtype, dev=dev)
    do = _randn(rng, B, S, H, D, dtype=dtype, dev=dev)
    band = (0, 0, 0, INF)
    o, lse = ref.attention_ref(q, k, v, scale=D**-0.5, band=band)
    body = fa._bwd_plan(B, S, S, H, Hkv, D, dtype)
    before = getattr(fa.flash_attention_bwd, f"launches_{body}")
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, band, scale=D**-0.5)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, band, scale=D**-0.5)
    torch.cuda.synchronize()
    assert body == ("tc_fp32" if dtype == torch.float32 else "tc_bf16")
    assert getattr(fa.flash_attention_bwd, f"launches_{body}") == before + 2
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, scale=D**-0.5, band=band)
    atol, rtol = BWD_TOLS[dtype]
    for name, a, b, w in zip(("dq", "dk", "dv"), first, second, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol, msg=name)


def test_moe_block_over_the_ring_matches_cpu_and_repeats(dev):
    """qwen2-moe-a2.7b's MoE layer at full width (60 experts of 1408, top-4,
    the shared expert), fp32, cf 1.25, over a virtual ring of 4 (the
    dispatch all-to-all of expert parallelism): the card against the CPU
    (the same experts chosen, the same entries dropped, y within 1e-4 of
    its largest entry), and bitwise on a repeat on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=1)
    params = tfm.init_params(cfg, seed=0, device="cpu", ctx=ParallelCtx(sp_size=4, device="cpu"))
    p_cpu = {k: v[0] for k, v in params["layers"]["moe"].items()}
    p_cpu["ln"] = torch.rand(p_cpu["ln"].shape, generator=torch.Generator().manual_seed(1)) - 0.5
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    x = _randn(np.random.default_rng(33), 2, 256, cfg.d_model, dtype=torch.float32,
               dev=torch.device("cpu"))
    drops = {}
    orig = moe._dispatch_indices

    def counting(idx, E, C):
        slot, valid = orig(idx, E, C)
        drops[idx.device.type] = drops.get(idx.device.type, 0) + int((~valid).sum())
        return slot, valid

    moe._dispatch_indices = counting
    try:
        y_cpu, aux_cpu = moe.moe_block(x, p_cpu, cfg, ParallelCtx(sp_size=4, device="cpu"))
        ring = ParallelCtx(sp_size=4, device=dev)
        y, aux = moe.moe_block(x.to(dev), p_dev, cfg, ring)
        y2, aux2 = moe.moe_block(x.to(dev), p_dev, cfg, ring)
    finally:
        moe._dispatch_indices = orig
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert drops["cuda"] == 2 * drops["cpu"] > 0
    assert ring.ring.stats.hops["moe_dispatch"] == ring.ring.stats.hops["moe_return"] == 2
    scale = float(y_cpu.abs().max())
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_block_rule_matches_plain(dev, dtype):
    """The block op with an autograd rule (what the latent wire's blocks run
    under grad) at minicpm3-4b's expanded heads (40 / 40 of 96): 4 ranks x
    2 rows folded, one striped band a rank, a random cotangent on o and on
    lse.  One forward launch, one dQ and one dK/dV launch a rank; o, lse and
    the gradients against the same rule on the CPU (the plain versions)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(41)
    R, B, S, H, D = 4, 2, 128, 40, 96
    cpu = torch.device("cpu")
    q, k, v, do = (_randn(rng, R * B, S, H, D, dtype=dtype, dev=cpu) for _ in range(4))
    dlse = _randn(rng, R * B, H, S, dtype=torch.float32, dev=cpu)
    band = torch.tensor([(r, (r + 1) % R, 0, INF) for r in range(R) for _ in range(B)],
                        dtype=torch.int32)
    grads = {}
    for where in (cpu, dev):
        leaves = [x.to(where).requires_grad_(True) for x in (q, k, v)]
        fwd0, dq0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq
        o, lse = ops.differentiable_block_attention(*leaves, band.to(where), groups=R,
                                                    stride_q=R, stride_kv=R)
        got = torch.autograd.grad((o.float() * do.to(where).float()).sum()
                                  + (lse * dlse.to(where)).sum(), leaves)
        grads[where.type] = [t.detach().cpu() for t in (o, lse, *got)]
        if where.type == "cuda":
            torch.cuda.synchronize()
            assert fa.flash_attention_fwd.launches == fwd0 + 1
            assert fa.flash_attention_bwd.launches_dq == dq0 + R
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(grads["cuda"][0].float(), grads["cpu"][0].float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(grads["cuda"][1], grads["cpu"][1], atol=LSE_TOL, rtol=0)
    atol, rtol = BWD_TOLS[dtype]
    for name, a, w in zip(("dq", "dk", "dv"), grads["cuda"][2:], grads["cpu"][2:]):
        torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol, msg=name)


def test_latent_wire_grads_bitwise_across_modes(dev):
    """The latent wire's program under autograd on the card, over a virtual
    ring of 4 (mesh a = 2, causal, striped): the gradients of q, the wire
    and the expansion's weights bitwise equal in the three comm_overlap
    modes (overlap and bidir copy on a side stream), and within the
    backward's limits of the CPU's."""
    from repro_torch.core.mesh_attention import MeshAttentionConfig, mesh_attention_wire
    from repro_torch.parallel.ring import VirtualRing

    rng = np.random.default_rng(43)
    R, B, m, H, D, C = 4, 1, 256, 8, 64, 32
    cpu = torch.device("cpu")
    q = _randn(rng, R, B, m, H, D, dtype=torch.float32, dev=cpu)
    wire = _randn(rng, R, B, m, 1, C, dtype=torch.float32, dev=cpu)
    wp = _randn(rng, C, 2 * H * D, dtype=torch.float32, dev=cpu) * C**-0.5
    do = _randn(rng, R, B, m, H, D, dtype=torch.float32, dev=cpu)
    out = {}
    for where, modes in ((cpu, ("overlap",)), (dev, ("serial", "overlap", "bidir"))):
        for mode in modes:
            leaves = [x.to(where).requires_grad_(True) for x in (q, wire, wp)]

            def expand(chunk, w=leaves[2]):
                kv = (chunk[:, :, 0] @ w).reshape(*chunk.shape[:2], 2, H, D)
                return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()

            cfg = MeshAttentionConfig(transport=VirtualRing(R), n=R, a=2, causal=True,
                                      comm_overlap=mode)
            o = mesh_attention_wire(leaves[0], leaves[1], cfg, expand)
            got = torch.autograd.grad((o * do.to(where)).sum(), leaves)
            out[where.type, mode] = [t.detach().cpu() for t in (o, *got)]
    torch.cuda.synchronize()
    base = out["cuda", "overlap"]
    for mode in ("serial", "bidir"):
        for a, b in zip(out["cuda", mode], base):
            assert torch.equal(a, b), mode
    atol, rtol = BWD_TOLS[torch.float32]
    for name, a, w in zip(("o", "dq", "dwire", "dwp"), base, out["cpu", "overlap"]):
        scale = float(w.abs().max())
        torch.testing.assert_close(a, w, atol=atol * max(scale, 1.0), rtol=rtol, msg=name)
