#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env      -- card name and power limit (nvidia-smi), torch/CUDA versions,
                 and the time to build the CUDA kernels from ``src/repro_torch/csrc``
                 (one nvcc per source, all started at once).
  2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
                 at the main paths' shapes (granite-8b heads: H=32, Hkv=8, D=128),
                 in fp32 and bf16: max |delta| against the stated tolerance, the
                 kernel's time, the plain version's time, the library call's time
                 where one PyTorch call computes the same function, and the bound.
                 The flash forward also at granite's speculative verify (B 8,
                 Sq 4) and prefill chunk (B 8, Sq 256) shapes and at hymba-1.5b's
                 heads (25 / 5 of 64: window prefill at S 1024 and 1536, the
                 Sq = 1 decode tick of 8 slots), each case with the body that
                 ran (the fp32 CUDA-core body, or the bf16 tensor-core tile or
                 decode body, checked against the wrapper's plan) and its
                 device time (torch.profiler).  The env line carries ptxas's
                 registers and spills of the tensor-core kernels.
                 The backward cases (dQ and dK/dV, both on the tensor cores;
                 fp32 inputs through the split pre-pass) also check the body
                 the wrapper planned and that two launches give
                 bitwise-identical gradients; the env line's ptxas summary
                 covers the backward library too.
  3. slice    -- granite-8b at full width, depth cut to 2 layers, fp32: the same
                 weights served by the engine on the card (kernels) and on the
                 CPU (plain versions), dense and paged caches; the greedy streams
                 must be identical and the first-token logits within 1e-3.
  4. serve    -- granite-8b at full width and depth in bf16 (seeded random
                 weights): ServeEngine over the paged pool serves eight requests
                 of mixed lengths and arrival ticks, 32 new tokens each.  The
                 kernels' launch counters are set to 0 just before this run and
                 read just after it: the serving kernels must have run, and
                 every flash launch (bf16 prefill) on the tile body.
  4a. slice_quant -- granite-8b at full width cut to 2 layers, fp32: the same
                 weights served on the card and on the CPU from an fp, an int8
                 and an fp8 paged pool, with continuous prefill and speculative
                 verify, on a short trace with a shared prefix: streams
                 identical (a flip only on a near-tie, printed), first-token
                 logits within 1e-3 (fp) / 5e-3 (int8, fp8: see
                 SLICE_LOGIT_TOL), pages and scale entries drained, the
                 decode ticks on the card through the fp or the quantized
                 decode kernel only; how far the pools' codes are apart is
                 printed.
  4b. serve_quant -- the serve phase's model and trace with continuous prefill
                 (chunk 256, budget 512) and speculative verify (spec_k 4), three
                 times: an fp, an int8 and an fp8 pool.  Counters set to 0
                 before each run: a quantized run's decode ticks launch only the
                 quantized decode kernel, 36 times per plain decode launch; the
                 fp pool's bf16 chunks and verifies never reach the fp32 flash
                 body, a quantized pool's (fp32 dequantized views) only it.
  4c. slice_ssm -- mamba2-370m and hymba-1.5b at full width cut to 2 layers,
                 fp32: the same weights served on the card (the SSD scan
                 kernel, and the flash forward for hymba's attention) and on
                 the CPU (plain versions), prompts of 48, 64, 192 and 320
                 tokens, 8 new tokens each: streams identical, first-token
                 logits within 1e-3.
  4d. serve_ssm -- mamba2-370m and hymba-1.5b at full width and depth, bf16,
                 seeded random weights, 8 slots, max_seq 2048, exact-length
                 prefill: eight prompts of 48 ... 1536 tokens arriving at
                 ticks 0 ... 13, 32 greedy tokens each.  Counters set to 0
                 before each run: the SSD kernel must launch once per layer
                 per prefill (384 and 256), and hymba's flash forward once
                 per layer per prefill (tile body) and per decode tick (decode
                 body).
  4e. slice_ring -- serving over a ring of 4 (``ParallelCtx(sp_size=4)``, a
                 virtual ring on the card): slice_quant's weights and trace
                 (2 layers, fp32, chunk 64, budget 128, spec_k 4) at sp_size 4
                 on the card against sp_size 1 on the CPU, over the dense
                 cache and the fp / int8 / fp8 pools: streams identical (a
                 quantized pool: a flip only on a near-tie, printed),
                 first-token logits within SLICE_LOGIT_TOL, pages and scale
                 entries drained; per layer one decode launch per decode tick
                 (#4 / 4q, or #1 for the dense cache), one #1 launch per chunk
                 and verify launch, one combine per step, all fp32 on the fp32
                 body.
  4f. serve_ring -- this slice's main path: the serve phase's model and
                 trace at sp_size 4, bf16, the fp pool: one-shot prefill (the
                 Mesh-Attention forward), then continuous prefill (chunk 256,
                 budget 512) with spec_k 4.  Counters set to 0 before each
                 run: per layer exactly one #4 launch per decode tick (the 4
                 ranks folded, not 4 x 36), one #1 launch per chunk (tile
                 body) and verify (decode body) launch, one lse combine per
                 step, and prefill's #1 launches = layers x the mesh
                 schedule's blocks x 4 (a segment-masked block launches per
                 rank); every request ok with 32 tokens, pages drained, peak
                 memory within RING_PEAK_SLACK_GB of serve's; the streams
                 against serve's (a flip only on a near-tie, RING_NEAR_TIE);
                 decode and prefill rates, TTFT, the combine's bytes, and a
                 profiled decode tick (#4 and combine device ms, idle share).
  5. train_parity -- granite-8b at full width cut to 2 layers, fp32, seq 512:
                 one make_train_step on the card and one on the CPU from the same
                 weights and batch; loss, grad norm, and per leaf the gradients
                 and the updated params held to stated tolerances.
  6. train    -- granite-8b at full width cut to 8 layers, fp32 params, AdamW,
                 remat, seq 4096, batch 1: 4 causal steps, then 2 steps with 4
                 packed documents, through ``repro_torch.train.loop.fit``.  The
                 counters are set to 0 just before and read just after: the
                 forward kernel must have run 2 x 8 x 6 times (all on the fp32
                 body), dQ and dK/dV 8 x 6 times each, every backward on the
                 fp32 tensor-core body (and its pre-pass).  One more step runs
                 under torch.profiler for the device time per kernel class.
                 Then 2 causal steps with bf16 params: losses finite and near
                 ln(vocab), the forward on the tile body and every backward on
                 the bf16 body.
  7. mesh_op -- this slice's path, the paper's Mesh-Attention:
                 ``dispatch.distributed_attention`` over a virtual ring of 4
                 ranks (``parallel/ring.VirtualRing``: all ranks on the card,
                 a hop a device copy) at paper-mha-7b's heads (32 x 128, MHA),
                 S 16384, causal striped and window 1024, fp32 and bf16:
                 mesh (a = 2), ring and mesh (a = 4), each in the serial,
                 overlap and bidir modes (bitwise equal, forward and
                 gradients), held against the local flash call on the
                 unstriped sequence (o and the gradients of sum(sin(o)):
                 MESH_OP_TOLS); kernel launches per call equal the
                 schedules' blocks (forward: the ranks folded into one
                 launch; backward: one dQ and one dK/dV launch per rank), hops
                 per kind equal ``schedule.comm_requirements``, the Q and KV
                 hops' bytes ``CommModel.chunk_bytes`` x count (the O, OdOQ,
                 dQ and dKV bytes printed beside the model's figure); event
                 times of mesh / ring / local flash and device time by class
                 (the copies apart).
  8. train_mesh_parity -- paper-mha-7b at full width, 2 layers, fp32, seq
                 4096: one make_train_step at sp_size 4 on the virtual ring
                 (mesh a = 2, and ring) against one at sp_size 1, on the card,
                 from the same weights and batch (train_parity's limits).
  9. train_mesh -- paper-mha-7b at full width cut to MESH_TRAIN_LAYERS layers,
                 fp32 + AdamW, remat, seq 16384, batch 1, sp_size 4: 2 steps
                 on mesh (a = 2), then 2 on ring, through fit; losses finite
                 and near ln(vocab); launches of #1, #2, #3 per step asserted
                 against the schedules x layers (x 2 for remat's forward);
                 s per step, tokens/s, peak memory, hops and bytes per step,
                 and a profiled mesh step by kernel class.
  10. the kernels line (each kernel's launches now including the mesh_op,
                 train_mesh and serve_ring runs; the ranks' combine a row of
                 its own), the card line, and the final line
     ``{"ok": true, "device": {...}}``.

Each phase line carries the phase's wall ``seconds``.  The kernels phase also
holds the quantized decode (int8 / fp8 pools, fp32 / bf16 queries, windows
None / 512), the paged decode's split combine kernel alone (the main row's
partials, some splits empty, an all-empty row) and the SSD chunked scan
(mamba2-370m and hymba-1.5b heads, fp32, a short chunk, batch 4, a reduced
shape and dt = 3 with A = -1, where a chunk's sum of dt*|A| passes 88;
finite and a bitwise repeat) against their plain versions.  The paged and
SSD cases carry the kernels' device time (``dev_ms``: all kernels of one
call, torch.profiler, L2 flushed) beside the call's event time (``ms``, L2
flushed); the SSD cases also the bound at the fp32 CUDA-core peak beside
the tensor-core one.  The env line's ptxas summary covers the paged and
SSD libraries.  The kernels phase also holds the mesh executor's blocks
(``mesh_block``: paper heads, 4096 rows a chunk, stride 4, the bands of
block (0, 1) of a = 2 for n = 4, causal and window 1024, fp32 and bf16): the
forward with the 4 ranks folded into its batch (one band per row; ranks 0
and 1 hold a q chunk below their kv chunk, so their row 0 sees no key and
must give o = 0, lse = NEG_INF exactly), the backward on rank 0 with one
band (dq of the blind rows exactly 0, dk / dv finite, a repeat bitwise).
And the serving ring's launches: #1 at the chunk (256) and verify (4)
rows with 4 ranks x 8 slots folded (stride 4; the first rows of ranks 1-3
blind), and #4 / 4q over a pool sharded 4 ways (bf16 queries, fp and int8
pools, ``paged_case``'s depths: rows of ranks that see no key must give
o = 0, lse = NEG_INF exactly) followed by the ranks' lse combine.

Any failed check raises: the script then exits non-zero without the final
line.  It exits non-zero at once when CUDA is not available.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch, kv_quant, mesh_attention  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.am import CommModel  # noqa: E402
from repro_torch.core.masking import MaskSpec  # noqa: E402
from repro_torch.core.mesh_attention import MeshAttentionConfig  # noqa: E402
from repro_torch.core.mesh_attention_collective import mesh_attention_collective  # noqa: E402
from repro_torch.core.tiling import stripe_permutation, unstripe_permutation  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pk  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, tree_leaves  # noqa: E402
from repro_torch.parallel.context import ParallelCtx  # noqa: E402
from repro_torch.parallel.ring import VirtualRing  # noqa: E402
from repro_torch.serve.config import ServeConfig  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.testing.chaos import ChaosConfig, ChaosInjector  # noqa: E402
from repro_torch.train.loop import TrainConfig, fit, make_train_step  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores, no TF32
# the backward runs on the tensor cores for either input type: its bounds
# take the bf16 peak (the fp32 inputs' extra term products are the kernel's
# own cost, not the function's)
BWD_PEAK = PEAK_FLOPS[torch.bfloat16]
# the SSD scan's products run on the tensor cores too (fp32 operands as bf16
# terms): its bound takes the bf16 peak, and its record keeps the bound at
# the fp32 CUDA-core peak beside it
SSD_PEAK = PEAK_FLOPS[torch.bfloat16]
# max |delta| of o against the plain version, per kernel and input type.
# bf16 outputs are rounded to bf16 (an ulp is 3.9e-3 at |o| in [0.5, 1)):
# the limits sit a few times above the largest readings on an H100 (flash
# 3.9e-3, paged 2.4e-4), so a skipped tile or page cannot hide under them.
TOLS = {
    ("flash_attention_fwd", torch.float32): 1e-4,
    ("flash_attention_fwd", torch.bfloat16): 1e-2,
    ("paged_flash_decode", torch.float32): 1e-4,
    ("paged_flash_decode", torch.bfloat16): 1e-3,
}
# dq/dk/dv against the plain backward: |delta| <= atol + rtol * |want|.  fp32:
# the JAX kernel tests' own 2e-4 (sums in another order).  bf16: the inputs
# are the same bf16 values on both sides and the arithmetic fp32, but the
# outputs are rounded to bf16, so one ulp (2**-7 of the value at most) on top
BWD_TOLS = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-4, 2**-7 + 2e-4)}
# the split combine alone, |delta| <= atol + rtol * |want| against the plain
# combine over random partials (|o| ~ 1): both merge in fp32 in other orders
# (largest reading on an H100: 0.17 of the fp32 limit); bf16 adds o's own
# rounding, one ulp (2**-7 of the value) where the two fp32 sums straddle a
# rounding boundary
COMBINE_TOLS = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-6, 2**-7)}
# lse is fp32 for either input type (largest reading 1.9e-6); skipping one
# 16-token page at depth ~1500 moves it by ~1e-2
LSE_TOL = 1e-4
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

FLASH_SRC = "src/repro_torch/csrc/flash_fwd.cu"  # the fp32 body
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:153"
BWD_SRC = "src/repro_torch/csrc/flash_bwd.cu"
BWD_BODIES = ("tc_fp32", "tc_bf16")
BWD_DQ_REPLACES = "src/repro/kernels/flash_attention.py:411"
BWD_DKV_REPLACES = "src/repro/kernels/flash_attention.py:461"
PAGED_SRC = "src/repro_torch/csrc/paged_decode.cu"
PAGED_REPLACES = "src/repro/kernels/paged_decode.py:205"
QUANT_REPLACES = "src/repro/kernels/paged_decode.py:205 (quantized branch :161-167)"
QUANT_DTYPES = ("int8", "fp8")
SSD_SRC = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:90"
# the SSD scan against its plain version: both sum fp32 in other orders, so
# y and the final state are held to 1e-4 of the output's scale
SSD_REL_TOL = 1e-4
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
# slice_quant, card vs CPU, first-token logits.  The fp pool on the chunked
# and speculative trace is held to the serving slice's 1e-3 (reading on an
# H100: 1.3e-5).  The quantized pools quantize K/V that card and CPU compute
# ~1e-5 apart, so a value near a rounding boundary takes neighbouring codes
# on the two sides: 529 of 854,508 int8 codes (every one a single step) in
# the first reading, which moved the first-token logits by up to 1.04e-3
# (int8) and 1.58e-3 (fp8) -- the one-shot runs, whose first token reads no
# pool, stayed at 1.1e-5.  Quantization itself moved them by 0.057 (int8)
# and 0.199 (fp8) against the fp pool on the card.  So the quantized pools
# are held to 5e-3: 3x the flip noise, 11-40x below the quantization's own
# effect.  A greedy flip between the two sides is allowed only on a
# near-tie: both score the two candidates within twice the limit
# (dist_check quant_kv's rule).
SLICE_LOGIT_TOL = {"fp": 1e-3, "int8": 5e-3, "fp8": 5e-3}
QMAX = {"int8": 127.0, "fp8": 448.0}

# granite-8b attention geometry
H, HKV, D = 32, 8, 128
# hymba-1.5b's (H, Hkv, D)
HYMBA_HEADS = (25, 5, 64)
FLASH_TC_SRC = "src/repro_torch/csrc/flash_fwd_tc.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_PHASE_T0 = [time.perf_counter()]


def emit(record):
    """Print a phase line with the wall seconds since the previous one."""
    now = time.perf_counter()
    if "phase" in record:
        record = {**record, "seconds": now - _PHASE_T0[0]}
    _PHASE_T0[0] = now
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(lib_path, prefix="flash_fwd_"):
    """Registers and spill bytes per kernel of one library, from the
    ``nvcc -Xptxas -v`` log the build keeps beside it (None when the
    library was not built in this run); a kernel whose wgmma products
    ptxas serialized is marked."""
    log_path = f"{lib_path}.log"
    if not os.path.exists(log_path):
        return None

    def kernel_name(mangled):
        # <length><prefix><word>_kernel[I<template args>E]
        k = re.search(r"\d(" + prefix + r"[a-z]+_kernel)(I(?:Li\d+E)+E)?", mangled)
        if k is None:
            return None
        args = re.findall(r"Li(\d+)E", k.group(2) or "")
        return k.group(1) + (f"<{', '.join(args)}>" if args else "")

    out, name = {}, None
    for line in open(log_path, errors="replace"):
        if "Potential Performance Loss" in line:
            serialized = kernel_name(line)
            if serialized is not None:
                out.setdefault(serialized, {})["serialized_wgmma"] = True
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            if name is not None:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def time_ms(fn, reps=20, warmup=3, flush=None):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls;
    ``flush`` (untimed) runs before each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


FWD_BODIES = ("tile", "decode", "fp32")


def fwd_body_counts():
    return {b: getattr(fa.flash_attention_fwd, f"launches_{b}") for b in FWD_BODIES}


def fwd_body_delta(before):
    return {b: n - before[b] for b, n in fwd_body_counts().items()}


def flash_case(name, S, dtype, gen, heads=(H, HKV, D), ranks=1):
    """One flash-forward case; granite-8b's heads unless ``heads`` (H, Hkv,
    D) says otherwise.  ``verify`` and ``chunk`` are the serving path's
    speculative verify (spec_k 4) and prefill chunk (256) over S cached
    positions, each batch row at its own depth; ``decode`` is a dense-cache
    tick, one band per slot (with hymba's heads, its window of 1024).
    ``ranks`` n > 1: the launch of sequence-sharded serving over a ring of
    n, the ranks folded into the rows -- row b*n + i is rank i's S/n slots
    of slot b, band (pos_b, i, 0, hi), stride n -- and slot 0's chunk starts
    at 0, so the first rows of ranks 1 .. n-1 see no key."""
    INF = ref.BAND_INF
    nh, nkv, hd = heads
    B, Sq, Skv, sq, skv, seg = 1, S, S, 1, 1, None
    band = (0, 0, 0, INF)
    per_row_hi = INF if nh == H else 1023
    if name == "window":
        band = (0, 0, 0, 255 if nh == H else 1023)
    elif name == "striped":
        band, sq, skv = (1, 0, 0, INF), 2, 2
    elif name == "segment":
        cuts = np.sort(np.random.default_rng(S).choice(np.arange(1, S), 5, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)).cuda()
    elif name in ("decode", "verify", "chunk"):
        B, Sq = 8, {"decode": 1, "verify": 4, "chunk": 256}[name]
        pos = torch.from_numpy(
            np.random.default_rng(S).integers(0, S - Sq + 1, B).astype(np.int32)).cuda()
        off = 0 * pos
        if ranks > 1:
            pos[0] = 0
            off = torch.arange(ranks, dtype=torch.int32, device="cuda").repeat(B)
            pos = pos.repeat_interleave(ranks)
            B, Skv, skv = B * ranks, S // ranks, ranks
        band = torch.stack([pos, off, 0 * pos, 0 * pos + per_row_hi], dim=1)
    q = randn(gen, B, Sq, nh, hd, dtype=dtype)
    k = randn(gen, B, Skv, nkv, hd, dtype=dtype)
    v = randn(gen, B, Skv, nkv, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, stride_q=sq, stride_kv=skv, seg_q=seg, seg_kv=seg)
    plain_band = band if not isinstance(band, torch.Tensor) else tuple(band[:, i] for i in range(4))
    run = lambda: fa.flash_attention_fwd(q, k, v, band, **kw)  # noqa: E731
    plain = lambda: ref.attention_ref(q, k, v, band=plain_band, **kw)  # noqa: E731
    before = fwd_body_counts()
    o, lse = run()
    body = [b for b, n in fwd_body_delta(before).items() if n]
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max()) if live.any() else 0.0
    empty_exact = bool(torch.equal(lse[~live], lse_ref[~live])) and bool(
        torch.all(o.transpose(1, 2)[~live] == 0)
    )
    # library yardstick: one SDPA call with the same visibility as a boolean mask
    mask = ref.band_mask(Sq, Skv, plain_band, stride_q=sq, stride_kv=skv, device="cuda")
    if seg is not None:
        mask = mask & (seg[:, None] == seg[None, :])
    rows = 1 if mask.dim() == 3 else B  # a 2-D mask is shared by every batch row
    visible_pairs = int(mask.sum()) * rows
    # keys seen by at least one query of their batch row: the kernel never
    # loads the others (the Sq=1 rows stop at their own pos)
    visible_keys = int(mask.any(dim=-2).sum()) * rows
    attn_mask = mask[:, None] if mask.dim() == 3 else mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if name == "causal":
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=hd**-0.5, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=attn_mask, scale=hd**-0.5, enable_gqa=True)
    item = q.element_size()
    # q read and o written once, the visible keys' K and V read once, lse
    # written, the segment ids read
    nbytes = (2 * q.numel() + 2 * visible_keys * nkv * hd) * item + lse.numel() * 4 \
        + (2 * seg.numel() * 4 if seg is not None else 0)
    flops = 4 * hd * nh * visible_pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    tol = TOLS[("flash_attention_fwd", dtype)]
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_fwd", case=name, S=S, B=B, Sq=Sq, heads=list(heads), ranks=ranks,
        dtype=DTYPE_NAMES[dtype], body=body[0] if len(body) == 1 else body,
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run), device_ms=device_ms.get("flash_attention_fwd", 0.0),
        plain_ms=time_ms(plain), library_ms=time_ms(lib),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=visible_pairs,
        visible_keys=visible_keys,
    )
    want_body = fa._fwd_plan(B, Sq, nh, nkv, hd, dtype)[0]
    check(body == [want_body], f"flash_attention_fwd ran {body}, not the {want_body} body: {rec}")
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"flash_attention_fwd disagrees with its plain version: {rec}")
    check(ranks == 1 or not bool(live.all()), f"the folded ranks left no row blind: {rec}")
    return rec


def paged_case(window, dtype, gen, flush):
    """One paged-decode case at the main path's pool: 8 slots, page 16,
    max_seq 2048; mixed depths, partial last pages, -1 past each row's depth,
    one all-empty row."""
    B, ps, max_seq = 8, 16, 2048
    max_pages = max_seq // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(5)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-depth // ps)
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    bt_t = torch.from_numpy(bt).cuda()
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    k_pool = randn(gen, num_pages, ps, HKV, D, dtype=dtype)
    v_pool = randn(gen, num_pages, ps, HKV, D, dtype=dtype)
    q = randn(gen, B, 1, H, D, dtype=dtype)
    kw = dict(stride_kv=1, window=window)
    run = lambda: pk.paged_flash_decode(q, k_pool, v_pool, bt_t, pos, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q, k_pool, v_pool, bt_t, pos, 0, **kw)  # noqa: E731
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(lse[~live] == ref.NEG_INF)) and bool(torch.all(o[7] == 0))
    check(not bool(live[7].any()), "the all-empty row must have no visible position")
    # bytes this data needs: the visible pages' K/V once, q, o, lse, the
    # block-table rows and pos
    lo = [max(d - 1 - (window - 1), 0) if window else 0 for d in depths]
    visible_tokens = sum(max(d - lo_b, 0) for d, lo_b in zip(depths, lo))
    visible_pages = sum(
        len({p // ps for p in range(lo_b, d)}) for d, lo_b in zip(depths, lo)
    )
    item = q.element_size()
    nbytes = (2 * visible_pages * ps * HKV * D + 2 * q.numel()) * item + lse.numel() * 4 \
        + bt.nbytes + pos.numel() * 4
    flops = 4 * D * H * visible_tokens
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    tol = TOLS[("paged_flash_decode", dtype)]
    rec = dict(
        kernel="paged_flash_decode", case=f"window{window}" if window else "full",
        B=B, page_size=ps, depths=depths, dtype=DTYPE_NAMES[dtype],
        splits=pk.default_num_splits(B, HKV, max_pages),
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_tokens=visible_tokens,
        visible_pages=visible_pages,
    )
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"paged_flash_decode disagrees with its plain version: {rec}")
    return rec


def paged_device_ms(run, flush, reps=5):
    """The paged kernels' device time per call (torch.profiler, an L2 flush
    before each call): main kernel and combine together, and the combine."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            run()
        torch.cuda.synchronize()
    by_class, by_kernel = device_time(prof, per=reps)
    return dict(dev_ms=by_class.get("paged_flash_decode", 0.0),
                dev_ms_combine=sum(ms for k, ms in by_kernel.items()
                                   if "paged_decode_combine_kernel" in k))


def split_combine_case(dtype, gen):
    """The paged decode's combine kernel alone at the main row's partials (8
    slots, granite heads, the default split count), some splits empty and
    one all-empty row, against combine_split_partials."""
    B, S = 8, pk.default_num_splits(8, HKV, 128)
    o_parts = randn(gen, B, S, H, D, dtype=torch.float32)
    lse_parts = 4 * randn(gen, B, S, H, dtype=torch.float32)
    empty = torch.rand(B, S, H, generator=gen, device="cuda") < 0.3
    empty[7] = True
    lse_parts[empty] = ref.NEG_INF
    run = lambda: pk.split_combine(o_parts, lse_parts, dtype)  # noqa: E731
    plain = lambda: pk.combine_split_partials(o_parts, lse_parts)  # noqa: E731
    before = pk.split_combine.launches
    (o, lse), (o_ref, lse_ref) = run(), plain()
    torch.cuda.synchronize()
    launched = pk.split_combine.launches - before
    live = lse_ref > ref.NEG_INF / 2
    diff = (o.float() - o_ref).abs()
    err = float(diff.max())
    atol, rtol = COMBINE_TOLS[dtype]
    ratio = float((diff / (atol + rtol * o_ref.abs())).max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(o[7] == 0)) and bool(torch.all(lse[~live] == ref.NEG_INF))
    nbytes = 4 * (o_parts.numel() + lse_parts.numel() + lse.numel()) + o.numel() * o.element_size()
    bound_ms, bound_by = bound(nbytes, 0, dtype)
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(kernel="paged_decode_combine", B=B, splits=S, dtype=DTYPE_NAMES[dtype],
               max_abs_err=err, max_err_over_tol=ratio, tol_atol=atol, tol_rtol=rtol,
               max_abs_err_lse=err_lse, tol_lse=LSE_TOL,
               empty_rows_exact=empty_exact, launched=launched, ms=time_ms(run),
               dev_ms=device_ms.get("paged_flash_decode", 0.0), plain_ms=time_ms(plain),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    check(launched == 1 and ratio <= 1.0 and err_lse <= LSE_TOL and empty_exact,
          f"the paged decode's combine kernel disagrees with combine_split_partials: {rec}")
    return rec


def quant_paged_case(kv_dtype, window, dtype, gen, flush):
    """The quantized decode (4q) at the main path's pool: 8 slots, page 16,
    max_seq 2048, granite heads; codes and scales quantized on the card from
    random K/V; the same depths as ``paged_case`` (an all-empty row last)."""
    B, ps, max_seq = 8, 16, 2048
    max_pages = max_seq // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(6)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-depth // ps)
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    bt_t = torch.from_numpy(bt).cuda()
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    kq, ks = kv_quant.quantize(randn(gen, num_pages, ps, HKV, D, dtype=torch.float32), kv_dtype)
    vq, vs = kv_quant.quantize(randn(gen, num_pages, ps, HKV, D, dtype=torch.float32), kv_dtype)
    q = randn(gen, B, 1, H, D, dtype=dtype)
    kw = dict(stride_kv=1, window=window, k_scale=ks, v_scale=vs)
    run = lambda: pk.paged_flash_decode(q, kq, vq, bt_t, pos, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q, kq, vq, bt_t, pos, 0, **kw)  # noqa: E731
    before = pk.paged_flash_decode.quant_launches
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    launched = pk.paged_flash_decode.quant_launches - before
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.all(lse[~live] == ref.NEG_INF)) and bool(torch.all(o[7] == 0))
    lo = [max(d - 1 - (window - 1), 0) if window else 0 for d in depths]
    visible_pages = sum(
        len({p // ps for p in range(lo_b, d)}) for d, lo_b in zip(depths, lo)
    )
    # bytes this data needs: the visible pages' K and V codes (1 byte) and
    # their fp32 scales, q read and o written, lse, block table and pos
    nbytes = 2 * visible_pages * ps * HKV * (D * kq.element_size() + 4) \
        + 2 * q.numel() * q.element_size() + lse.numel() * 4 + bt.nbytes + pos.numel() * 4
    visible_tokens = sum(max(d - lo_b, 0) for d, lo_b in zip(depths, lo))
    bound_ms, bound_by = bound(nbytes, 4 * D * H * visible_tokens, dtype)
    tol = TOLS[("paged_flash_decode", dtype)]
    rec = dict(
        kernel="paged_flash_decode_quant", case=f"window{window}" if window else "full",
        kv_dtype=kv_dtype, B=B, page_size=ps, depths=depths, dtype=DTYPE_NAMES[dtype],
        splits=pk.default_num_splits(B, HKV, max_pages),
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact, quant_launches=launched,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_pages=visible_pages, bytes=nbytes,
    )
    check(launched == 1, f"the quantized decode did not go through its kernel: {rec}")
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"quantized paged_flash_decode disagrees with its plain version: {rec}")
    return rec


# the serving ring: sp_size 4, the JAX CLI's --fake-devices 8 mesh axis
RING_N = 4
# one bf16 ulp, relative: at most 2**-7 of the value
RING_ULP = 2.0**-7


def ring_paged_case(kv_dtype, gen, flush):
    """#4 (an fp pool) or 4q (an int8 pool), bf16 queries, as decode over a
    ring of 4 launches it: 8 slots of max_seq 2048 (512 slots a rank), page
    16, the ranks folded into ONE launch -- the pool [P, 4*16] viewed as
    [P*4, 16], the block table bt*4 + i, row b*4 + i at depth pos_b - i --
    with ``paged_case``'s depths (rows whose later ranks see no key, an
    all-empty row).  Then the ranks' lse combine (the split combine kernel
    over [B, 4] partials) against combine_split_partials."""
    from repro_torch.core import decode_attention as da

    n, B, ps, max_seq = RING_N, 8, 16, 2048
    max_pages = max_seq // n // ps
    num_pages = B * max_pages
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(8)
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n_pages = -(-(-(-depth // n)) // ps)  # rank 0 holds ceil(depth / n) positions
        bt[b, :n_pages] = perm[nxt : nxt + n_pages]
        nxt += n_pages
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    if kv_dtype == "fp":
        k_pool = randn(gen, num_pages, n * ps, HKV, D, dtype=torch.bfloat16)
        v_pool = randn(gen, num_pages, n * ps, HKV, D, dtype=torch.bfloat16)
        ks = vs = None
    else:
        k_pool, ks = kv_quant.quantize(randn(gen, num_pages, n * ps, HKV, D, dtype=torch.float32),
                                       kv_dtype)
        v_pool, vs = kv_quant.quantize(randn(gen, num_pages, n * ps, HKV, D, dtype=torch.float32),
                                       kv_dtype)
    fk, fv, fbt, fks, fvs = da._folded_pool(k_pool, v_pool, torch.from_numpy(bt).cuda(), ks, vs, n)
    kv_off, stride = da._rank_offsets(n, max_pages * ps, "striped", "cuda")
    q = randn(gen, B, 1, H, D, dtype=torch.bfloat16)
    q_f = da._fold_rows(q, n)
    pos_r = (da._fold_rows(pos.long(), n) - kv_off.repeat(B)).to(torch.int32)
    kw = dict(stride_kv=stride, k_scale=fks, v_scale=fvs)
    run = lambda: pk.paged_flash_decode(q_f, fk, fv, fbt, pos_r, 0, **kw)  # noqa: E731
    plain = lambda: pk.paged_decode_ref(q_f, fk, fv, fbt, pos_r, 0, **kw)  # noqa: E731
    before = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    launched = pk.paged_flash_decode.launches + pk.paged_flash_decode.quant_launches - before
    blind = pos_r < 0
    live = ~blind[:, None, None] & (lse_ref > ref.NEG_INF / 2)
    diff = (o.float() - o_ref.float()).abs()
    err = float(diff.max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    blind_exact = bool(torch.all(o[blind] == 0)) and bool(torch.all(lse[blind] == ref.NEG_INF))
    # the function's work: each rank row's visible pages once (fp: K and V
    # in bf16; quantized: 1-byte codes and fp32 scales), the folded q read
    # and o written, lse, the folded block table and depths
    slots = [max(-(-(d - i) // n), 0) for d in depths for i in range(n)]
    pages = sum(-(-x // ps) for x in slots)
    per_slot = HKV * (D * k_pool.element_size() + (4 if ks is not None else 0))
    nbytes = 2 * pages * ps * per_slot + 2 * q_f.numel() * 2 + lse.numel() * 4 \
        + fbt.numel() * 4 + pos_r.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * D * H * sum(depths), torch.bfloat16)
    # the ranks' combine over these partials: [B, n, H, D] fp32 -> [B, H, D]
    o_parts = o.float().view(B, n, H, D)
    lse_parts = lse.view(B, n, H).contiguous()
    comb = lambda: pk.split_combine(o_parts, lse_parts, torch.bfloat16)  # noqa: E731
    comb_plain = lambda: pk.combine_split_partials(o_parts, lse_parts)  # noqa: E731
    c_before = pk.split_combine.launches
    (oc, lc), (oc_ref, lc_ref) = comb(), comb_plain()
    torch.cuda.synchronize()
    c_launched = pk.split_combine.launches - c_before
    atol, rtol = COMBINE_TOLS[torch.bfloat16]
    c_diff = (oc.float() - oc_ref).abs()
    c_ratio = float((c_diff / (atol + rtol * oc_ref.abs())).max())
    c_exact = bool(torch.all(oc[7] == 0)) and bool(torch.all(lc[7] == ref.NEG_INF))
    c_bytes = 4 * (o_parts.numel() + lse_parts.numel() + lc.numel()) + oc.numel() * 2
    c_bound_ms, c_bound_by = bound(c_bytes, 0, torch.bfloat16)
    c_dev, _ = device_time(_profiled(comb, 5), per=5)
    # #4's limit plus one bf16 ulp of the value: a rank row over a few keys
    # has |o| near 1 (not the average of hundreds of keys), where the two
    # sides' bf16 roundings of nearly equal fp32 sums can differ by an ulp
    tol = TOLS[("paged_flash_decode", torch.bfloat16)]
    ratio = float((diff / (tol + RING_ULP * o_ref.float().abs())).max())
    rec = dict(
        kernel="paged_flash_decode" + ("" if kv_dtype == "fp" else "_quant"), case="ring",
        ranks=n, kv_dtype=kv_dtype, B=B, rows=B * n, page_size=ps, depths=depths,
        dtype="bf16", splits=pk.default_num_splits(B * n, HKV, max_pages),
        launched=launched, max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_rtol=RING_ULP,
        max_err_over_tol=ratio, tol_lse=LSE_TOL,
        blind_rows=int(blind.sum()), blind_rows_exact=blind_exact,
        ms=time_ms(run, flush=flush), **paged_device_ms(run, flush),
        plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_pages=pages,
        combine=dict(kernel="paged_decode_combine", case="ring", max_abs_err=float(c_diff.max()),
                     max_err_over_tol=c_ratio, empty_row_exact=c_exact, launched=c_launched,
                     ms=time_ms(comb), dev_ms=c_dev.get("paged_flash_decode", 0.0),
                     plain_ms=time_ms(comb_plain), library_ms=None, bound_ms=c_bound_ms,
                     bound_by=c_bound_by),
    )
    check(launched == 1 and c_launched == 1, f"the ring decode did not launch its kernels: {rec}")
    check(int(blind.sum()) > 0 and blind_exact,
          f"a rank that sees no key must give exactly o = 0, lse = NEG_INF: {rec}")
    check(ratio <= 1.0 and err_lse <= LSE_TOL,
          f"the folded paged decode disagrees with its plain version: {rec}")
    check(c_ratio <= 1.0 and c_exact, f"the ranks' combine disagrees with its plain version: {rec}")
    return rec


def ssd_case(name, B, S, H, P, G, N, chunk, gen, flush, dt_value=None):
    """One SSD chunked-scan case, fp32 inputs as the model gives them (dt
    through softplus, A = -exp(.)), against the plain chunked dual form.
    ``dt_value``: dt that value everywhere and A = -1 instead, so a chunk's
    sum of dt*|A| passes ~88 (where exp(-acum) would overflow)."""
    x = randn(gen, B, S, H, P, dtype=torch.float32)
    dt = F.softplus(randn(gen, B, S, H, dtype=torch.float32))
    A = -torch.exp(0.5 * randn(gen, H, dtype=torch.float32))
    if dt_value is not None:
        dt, A = torch.full_like(dt, dt_value), -torch.ones_like(A)
    Bm = randn(gen, B, S, G, N, dtype=torch.float32)
    Cm = randn(gen, B, S, G, N, dtype=torch.float32)
    run = lambda: ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)  # noqa: E731
    plain = lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)  # noqa: E731
    before = ssd.ssd_scan_fwd.launches
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    launched = ssd.ssd_scan_fwd.launches - before
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    tol = SSD_REL_TOL * max(1.0, float(want[0].abs().max()))
    err_y = float((got[0] - want[0]).abs().max())
    err_state = float((got[1] - want[1]).abs().max())
    finite = bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    c = min(chunk, S)
    # inputs read once, y and the final state written once
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + Bm.numel() + Cm.numel()
                  + B * H * P * N)
    # what the function needs (S is a multiple of c): the causal half of each
    # chunk, (c+1)/2 pairs a token, for the group's C.B^T scores (N each) and
    # each head's intra-chunk y (P each), plus each head's inter-chunk term and
    # state update (2*P*N each); or the sequential recurrence's 5*P*N a token
    # and head, whichever is less
    chunked = B * S * (c + 1) * (G * N + H * P) + 4 * B * H * S * P * N
    flops = min(chunked, 5 * B * H * S * P * N)
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, SSD_PEAK)
    bound_ms_fp32, bound_by_fp32 = bound(nbytes, flops, torch.float32)
    by_class, _ = device_time(_profiled(lambda: (flush(), run()), 5), per=5)
    rec = dict(
        kernel="ssd_scan_fwd", case=name, B=B, S=S, H=H, P=P, G=G, N=N, chunk=c, dtype="fp32",
        dt_value=dt_value,
        max_abs_err=max(err_y, err_state), max_abs_err_y=err_y, max_abs_err_state=err_state,
        tol=tol, finite=finite, bitwise_repeat=bitwise, launched=launched,
        ms=time_ms(run, flush=flush), dev_ms=by_class.get("ssd_scan_fwd", 0.0),
        plain_ms=time_ms(plain, reps=5), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, bound_ms_fp32_cores=bound_ms_fp32,
        bound_by_fp32_cores=bound_by_fp32, flops=flops, bytes=nbytes,
    )
    del got, again, want
    check(launched == 2, f"ssd_scan_fwd did not go through its kernel: {rec}")
    check(finite and err_y <= tol and err_state <= tol and bitwise,
          f"ssd_scan_fwd disagrees with its plain version or repeats unequal: {rec}")
    return rec


def device_time(prof, per=1, classify=None):
    """(device ms per kernel class, device ms per kernel name) of a
    torch.profiler run, divided by ``per`` (ticks, steps or calls);
    ``classify`` maps a kernel name to its class (``_kernel_class``)."""
    classify = classify or _kernel_class
    by_class, by_kernel = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / per
        cls = classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_kernel[ev.key[:80]] = by_kernel.get(ev.key[:80], 0.0) + ms
    return by_class, by_kernel


def _profiled(fn, reps):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def bwd_counts():
    """Backward calls per body and the fp32 body's pre-pass launches."""
    return {**{b: getattr(fa.flash_attention_bwd, f"launches_{b}") for b in BWD_BODIES},
            "split": fa.split_terms.launches}


def bwd_case(name, S, dtype, gen):
    """One flash-backward case (dQ and dK/dV kernels) at granite-8b's heads.
    The segment case gives row 0 a document id no key has: a fully masked
    row, whose dq must be exactly 0.  The window and striped cases pass
    delta in; the others derive it from o."""
    INF = ref.BAND_INF
    band, sq, skv, seg_q, seg_kv, given = (0, 0, 0, INF), 1, 1, None, None, False
    if name == "window":
        band, given = (0, 0, 0, 255), True
    elif name == "striped":
        band, sq, skv, given = (1, 0, 0, INF), 2, 2, True
    elif name == "segment":
        cuts = np.sort(np.random.default_rng(S).choice(np.arange(1, S), 5, replace=False))
        ids = np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)
        seg_kv = torch.from_numpy(ids.copy()).cuda()
        ids[0] = -1
        seg_q = torch.from_numpy(ids).cuda()
    q = randn(gen, 1, S, H, D, dtype=dtype)
    k = randn(gen, 1, S, HKV, D, dtype=dtype)
    v = randn(gen, 1, S, HKV, D, dtype=dtype)
    do = randn(gen, 1, S, H, D, dtype=dtype)
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv, seg_q=seg_q, seg_kv=seg_kv)
    o, lse = ref.attention_ref(q, k, v, band=band, **kw)  # the forward's saved state
    delta = (do.float() * o.float()).sum(-1) if given else None
    run = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, None if given else o, lse, do, band, delta=delta, **kw)
    plain = lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)  # noqa: E731
    before = bwd_counts()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    ran = {b: n - before[b] for b, n in bwd_counts().items()}
    body = [b for b in BWD_BODIES if ran[b]]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    atol, rtol = BWD_TOLS[dtype]
    errs, ratio = {}, 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        errs[gname] = float(diff.max())
        ratio = max(ratio, float((diff / (atol + rtol * w.float().abs())).max()))
    masked_row_zero = seg_q is None or bool(torch.all(got[0][:, 0] == 0))
    del got, again, want
    mask = ref.band_mask(S, S, band, stride_q=sq, stride_kv=skv, device="cuda")
    if seg_q is not None:
        mask = mask & (seg_q[:, None] == seg_kv[None, :])
    pairs = int(mask.sum())
    vis_keys = int(mask.any(dim=0).sum())
    vis_rows = int(mask.any(dim=1).sum())
    # library yardstick: the backward of one SDPA call (dq, dk, dv together)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    if name == "causal":
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=D**-0.5,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=D**-0.5,
                                             enable_gqa=True)
    dout = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dout, retain_graph=True)  # noqa: E731
    item = q.element_size()
    seg_bytes = 2 * S * 4 if seg_q is not None else 0
    # dQ: q, dO read and dq written for every row, K/V of the visible keys,
    # lse and delta; dK/dV: q, dO, lse, delta of the rows that see a key,
    # k, v read and dk, dv written
    dq_bytes = 3 * S * H * D * item + 2 * vis_keys * HKV * D * item + 2 * H * S * 4 + seg_bytes
    dkv_bytes = 2 * vis_rows * H * D * item + 4 * S * HKV * D * item + 2 * H * vis_rows * 4 \
        + seg_bytes
    # bounds at the tensor cores' bf16 peak, the kernels' own units; the
    # CUDA cores' fp32 peak (the earlier kernels' units) as a labelled extra
    dq_bound, dq_by = bound(dq_bytes, 6 * D * H * pairs, dtype, BWD_PEAK)
    dkv_bound, dkv_by = bound(dkv_bytes, 8 * D * H * pairs, dtype, BWD_PEAK)
    split, _ = device_time(_profiled(run, 5), per=5)  # the kernels' device ms apart
    rec = dict(
        kernel="flash_attention_bwd", case=name, S=S, dtype=DTYPE_NAMES[dtype],
        body=body[0] if len(body) == 1 else body, pre_pass_launches=ran["split"],
        delta="given" if given else "from_o", max_abs_err=errs, tol_atol=atol, tol_rtol=rtol,
        max_err_over_tol=ratio, bitwise_repeat=bitwise, masked_row_dq_zero=masked_row_zero,
        ms_dq=split.get("flash_bwd_dq", 0.0), ms_dkv=split.get("flash_bwd_dkv", 0.0),
        ms_split=split.get("flash_bwd_split", 0.0),
        ms_pair=time_ms(run, reps=10), plain_ms_pair=time_ms(plain, reps=5),
        library_ms_pair=time_ms(lib, reps=10),
        bound_ms_dq=dq_bound, bound_by_dq=dq_by, bound_ms_dkv=dkv_bound, bound_by_dkv=dkv_by,
        bound_ms_dq_fp32_cores=bound(dq_bytes, 6 * D * H * pairs, torch.float32)[0],
        bound_ms_dkv_fp32_cores=bound(dkv_bytes, 8 * D * H * pairs, torch.float32)[0],
        visible_pairs_per_head=pairs,
    )
    del out, qt, kt, vt, mask
    torch.cuda.empty_cache()
    want_body = fa._bwd_plan(1, S, S, H, HKV, D, dtype)
    check(body == [want_body] and ran["split"] == (2 if want_body == "tc_fp32" else 0),
          f"flash_attention_bwd ran {ran}, not the {want_body} body: {rec}")
    check(ratio <= 1.0 and bitwise and masked_row_zero,
          f"flash_attention_bwd disagrees with its plain version or repeats unequal: {rec}")
    check(rec["ms_dq"] > 0 and rec["ms_dkv"] > 0
          and (rec["ms_split"] > 0) == (want_body == "tc_fp32"),
          f"the profiler saw no device time for the backward kernels: {split}")
    return rec


def split_case(S, gen):
    """The fp32 backward's pre-pass at the training row's operands (granite
    heads, S tokens) against its plain version: bitwise equal terms."""
    xs = [randn(gen, 1, S, h, D, dtype=torch.float32) for h in (H, HKV, HKV, H)]
    run = lambda: fa.split_terms(*xs)  # noqa: E731
    plain = lambda: tuple(fa.split_terms_ref(x) for x in xs)  # noqa: E731
    before = fa.split_terms.launches
    got, want = run(), plain()
    torch.cuda.synchronize()
    launched = fa.split_terms.launches - before
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    n = sum(x.numel() for x in xs)
    bound_ms, bound_by = bound(n * (4 + 2 * 2), 0, torch.float32)  # fp32 in, two bf16 out
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(kernel="flash_bwd_split", S=S, dtype="fp32", max_abs_err=err, exact=exact,
               launched=launched, ms=time_ms(run), device_ms=device_ms.get("flash_bwd_split", 0.0),
               plain_ms=time_ms(plain), library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    del got, want, xs
    check(launched == 1 and exact, f"flash_bwd_split disagrees with its plain version: {rec}")
    return rec


# --------------------------------------------------------------------------
# phases 3 and 4: the engine
# --------------------------------------------------------------------------


def serve_trace(eng, lengths, arrivals, new_tokens, vocab, seed):
    rng = np.random.default_rng(seed)
    rids = [
        eng.submit(rng.integers(0, vocab, (n,), dtype=np.int32), new_tokens, arrival_tick=t)
        for n, t in zip(lengths, arrivals)
    ]
    done = eng.run()
    return [done[r] for r in rids]


def cross_device():
    """Full width, 2 layers, fp32: card (kernels) vs CPU (plain versions)."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    params_cpu = {
        "embed": params["embed"].cpu(), "final_ln": params["final_ln"].cpu(),
        "lm_head": params["lm_head"].cpu(),
        "layers": {g: {n: t.cpu() for n, t in leaves.items()}
                   for g, leaves in params["layers"].items()},
    }
    lengths, arrivals = [64, 137, 200], [0, 0, 1]
    out = {}
    for paged in (False, True):
        serve = ServeConfig(max_seq=256, num_slots=4, paged=paged,
                            page_size=16 if paged else None, cache_dtype=torch.float32)
        streams, first_logits = {}, {}
        launches = {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            fa.flash_attention_fwd.launches = pk.paged_flash_decode.launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            res = serve_trace(eng, lengths, arrivals, 8, cfg.vocab_size, seed=1)
            streams[dev] = [r.generated for r in res]
            first_logits[dev] = [eng.debug_logits[r.rid][0] for r in res]
            launches[dev] = (fa.flash_attention_fwd.launches, pk.paged_flash_decode.launches)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(first_logits["cuda"], first_logits["cpu"]))
        key = "paged" if paged else "dense"
        out[key] = dict(
            streams_identical=streams["cuda"] == streams["cpu"], first_logits_max_abs_err=err,
            cuda_launches={"flash_attention_fwd": launches["cuda"][0],
                           "paged_flash_decode": launches["cuda"][1]},
            cpu_launches=sum(launches["cpu"]),
        )
        check(streams["cuda"] == streams["cpu"], f"{key}: card and CPU streams differ: {streams}")
        check(err <= 1e-3, f"{key}: first-token logits differ by {err} > 1e-3")
        check(launches["cuda"][0] > 0 and launches["cpu"] == (0, 0),
              f"{key}: kernels must run on the card only: {launches}")
        if paged:
            check(launches["cuda"][1] > 0, "paged engine never launched the paged decode kernel")
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": "slice", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          "lengths": lengths, "new_tokens": 8, **out})


# the serve trace: prompt lengths and arrival ticks, 32 greedy tokens each
SERVE_LENGTHS = [96, 200, 333, 512, 640, 777, 1000, 1500]
SERVE_ARRIVALS = [0, 0, 1, 2, 3, 5, 8, 13]


def full_serve(card):
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
    ))
    # warm-up (cuBLAS handles, allocator), outside the measured run
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skip = eng.tick_stats()["ticks"]
    lengths, arrivals = SERVE_LENGTHS, SERVE_ARRIVALS
    fa.flash_attention_fwd.launches = 0
    pk.paged_flash_decode.launches = 0
    bodies0 = fwd_body_counts()
    t0 = time.perf_counter()
    res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "paged_flash_decode": pk.paged_flash_decode.launches}
    bodies = fwd_body_delta(bodies0)
    stats = eng.tick_stats()
    pf_tok = sum(stats["prefill_tokens"][skip:])
    pf_s = sum(stats["prefill_s"][skip:])
    dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
    dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
    # tokens generated by decode launches (the first token of each request
    # comes off its prefill logits)
    dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
    kv = eng.kv_cache_stats()
    rec = {
        "phase": "serve", "arch": "granite-8b", "num_layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "dtype": "bf16", "params": tfm.param_count(params),
        "paged": True, "page_size": 16, "max_seq": 2048, "num_slots": 8,
        "lengths": lengths, "arrival_ticks": arrivals, "new_tokens": 32,
        "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip,
        "wall_s": wall, "init_s": init_s,
        "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
        "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
        "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
        "ttft_ticks": [r.ttft_ticks for r in res],
        "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "flash_attention_fwd_bodies": bodies, "card": card,
    }
    rec["decode_profile"] = profile_decode(eng, cfg)
    emit(rec)
    check(all(r.status == "ok" and len(r.generated) == 32 for r in res),
          f"not every request finished ok: {rec['statuses']}")
    check(kv["pages_in_use"] == 0, f"pages still in use after the drain: {kv['pages_in_use']}")
    check(launches["flash_attention_fwd"] > 0 and launches["paged_flash_decode"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    # bf16 one-shot prefill: every flash launch on the tile body
    check(bodies == {"tile": launches["flash_attention_fwd"], "decode": 0, "fp32": 0},
          f"serve: bf16 prefill launches must all run the tile body: {bodies}")
    return {**launches, "flash_attention_fwd (tile)": bodies["tile"]}, rec, \
        [r.generated for r in res]


def _code_steps(a, b):
    """|a - b| in steps of the codes' own format (int8: 1; fp8-e4m3: the
    spacing at the larger magnitude, 2**(exponent - 3), 2**-9 below the
    normals)."""
    fa, fb = a.float(), b.float()
    if a.dtype == torch.int8:
        return (fa - fb).abs()
    mag = torch.maximum(fa.abs(), fb.abs()).clamp_min(2.0**-6)
    return (fa - fb).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 3)


def _first_flip(a, b):
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def _slice_quant_trace(V):
    """slice_quant's (and slice_ring's) prompts and arrival ticks."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, V, (64,), dtype=np.int32)
    prompts = [
        np.tile(rng.integers(0, V, (12,), dtype=np.int32), 8),  # repetitive: drafts accepted
        rng.integers(0, V, (137,), dtype=np.int32),
        np.concatenate([prefix, rng.integers(0, V, (40,), dtype=np.int32)]),  # shared prefix
        np.concatenate([prefix, rng.integers(0, V, (56,), dtype=np.int32)]),
    ]
    return prompts, [0, 0, 1, 2]


def _slice_serve(kv_dtype, paged=True):
    return ServeConfig(max_seq=256, num_slots=4, paged=paged, page_size=16 if paged else None,
                       cache_dtype=torch.float32, prefill_chunk=64, tick_token_budget=128,
                       spec_k=4, kv_dtype=kv_dtype)


def cross_device_quant():
    """Full width, 2 layers, fp32, int8 and fp8 pools with continuous
    prefill and speculative verify: card (kernels) vs CPU (plain versions).
    Returns the CPU runs per pool, which slice_ring holds the ring to."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    params_cpu = _tree_to(params, "cpu")
    prompts, arrivals = _slice_quant_trace(cfg.vocab_size)
    out, card_first, problems, cpu_runs = {}, {}, [], {}
    for kv_dtype in ("fp",) + QUANT_DTYPES:
        tol = SLICE_LOGIT_TOL[kv_dtype]
        serve = _slice_serve(kv_dtype)
        side, pools = {}, {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            fa.flash_attention_fwd.launches = 0
            pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
            done = eng.run()
            kv = eng.kv_cache_stats()
            # the final pools (freed pages keep their data): card vs CPU
            pools[dev] = {key: eng._cache[key].cpu() for key in ("k", "v", "k_scale", "v_scale")
                          if key in eng._cache}
            side[dev] = dict(
                streams=[done[r].generated for r in rids],
                logits=[eng.debug_logits[r] for r in rids],
                launches={"flash_attention_fwd": fa.flash_attention_fwd.launches,
                          "paged_flash_decode": pk.paged_flash_decode.launches,
                          "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches},
                counters={"chunk_launches": eng.chunk_launches,
                          "verify_launches": eng.verify_launches,
                          "decode_launches": eng.decode_launches,
                          "spec_accepted": eng.spec_accepted, "shared_hits": kv["shared_hits"],
                          "pages_in_use": kv["pages_in_use"],
                          "scale_entries_in_use": kv["scale_entries_in_use"],
                          "dequant_fallbacks": kv["dequant_fallbacks"]},
            )
        card, cpu = side["cuda"], side["cpu"]
        cpu_runs[kv_dtype] = cpu
        err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu["logits"]))
        card_first[kv_dtype] = [x[0] for x in card["logits"]]
        # printed, not gated: how far the card's and CPU's final pools are
        # apart (comparable while both sides served the same tokens).  A
        # layer's flipped codes move its output, so deeper layers' K/V and
        # codes drift further apart than the first layer's
        pool_rec = {}
        if kv_dtype != "fp" and card["streams"] == cpu["streams"]:
            for key in ("k", "v"):
                a, b = pools["cuda"][key], pools["cpu"][key]
                sa, sb = pools["cuda"][f"{key}_scale"], pools["cpu"][f"{key}_scale"]
                apart = a.view(torch.uint8) != b.view(torch.uint8)
                pool_rec[key] = dict(
                    codes_apart=int(apart.sum()), codes=int(apart.numel()),
                    max_code_steps=float(_code_steps(a, b).max()),
                    max_amax_diff=float((sa - sb).abs().max()) * QMAX[kv_dtype],
                )
        flips = []
        for i, (a, b) in enumerate(zip(card["streams"], cpu["streams"])):
            if a != b:
                j = _first_flip(a, b)
                la, lb = card["logits"][i][j], cpu["logits"][i][j]
                flips.append(dict(request=i, token=j, card=a[j], cpu=b[j],
                                  card_gap=float(la[a[j]] - la[b[j]]),
                                  cpu_gap=float(lb[b[j]] - lb[a[j]])))
        out[kv_dtype] = dict(
            streams_identical=card["streams"] == cpu["streams"], near_tie_flips=flips,
            first_logits_max_abs_err=err, logit_tol=tol, pools=pool_rec,
            cuda_launches=card["launches"], cpu_launches=sum(cpu["launches"].values()),
            cuda=card["counters"], cpu=cpu["counters"],
        )
        if kv_dtype != "fp":
            # what quantization itself does to the first token, on the card
            out[kv_dtype]["card_vs_fp_first_logits_max_abs_err"] = max(
                float(np.abs(a - b).max()) for a, b in zip(card_first[kv_dtype], card_first["fp"])
            )
        for f in flips:
            if max(f["card_gap"], f["cpu_gap"]) > 2 * tol:
                problems.append(f"slice_quant {kv_dtype}: streams differ beyond a near-tie: {f}")
        if err > tol:
            problems.append(f"slice_quant {kv_dtype}: first-token logits differ by {err} > {tol}")
        for dev in ("cuda", "cpu"):
            c = side[dev]["counters"]
            if not c["pages_in_use"] == c["scale_entries_in_use"] == c["dequant_fallbacks"] == 0:
                problems.append(f"slice_quant {kv_dtype} on {dev}: pages or scales left, or a "
                                f"fallback: {c}")
        used, unused = (("paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
                        else ("paged_flash_decode_quant", "paged_flash_decode"))
        if not (card["launches"][unused] == 0 and card["launches"][used]
                == cfg.num_layers * card["counters"]["decode_launches"] > 0):
            problems.append(f"slice_quant {kv_dtype}: decode ticks must run {used}: "
                            f"{card['launches']}, {card['counters']}")
        if out[kv_dtype]["cpu_launches"]:
            problems.append("slice_quant: kernels launched on the CPU side")
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": "slice_quant", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          "lengths": [len(x) for x in prompts], "arrivals": arrivals, "new_tokens": 8,
          "page_size": 16, "prefill_chunk": 64, "tick_token_budget": 128, "spec_k": 4,
          **out})
    check(not problems, "; ".join(problems))
    return cpu_runs


def full_serve_quant(card):
    """The serve phase's model and trace with continuous prefill and
    speculative verify, from an fp, an int8 and an fp8 pool."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    lengths, arrivals = SERVE_LENGTHS, SERVE_ARRIVALS
    runs, streams, launches_out, problems = {}, {}, {}, []
    for kv_dtype in ("fp",) + QUANT_DTYPES:
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
            prefill_chunk=256, tick_token_budget=512, spec_k=4, kv_dtype=kv_dtype,
        ))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_fwd.launches = 0
        pk.paged_flash_decode.launches = pk.paged_flash_decode.quant_launches = 0
        bodies0 = fwd_body_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, lengths, arrivals, 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                    "paged_flash_decode": pk.paged_flash_decode.launches,
                    "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches}
        bodies = fwd_body_delta(bodies0)
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"]), sum(stats["prefill_s"])
        dec_ticks = [i for i in range(stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        # tokens committed by decode and verify launches (each request's
        # first token comes off its last chunk's logits)
        dec_tok = sum(stats["decode_tokens"]) - len(res)
        streams[kv_dtype] = [r.generated for r in res]
        rec = {
            "kv_dtype": kv_dtype, "statuses": [r.status for r in res], "ticks": stats["ticks"],
            "wall_s": wall, "prefill_tokens": pf_tok, "prefill_s": pf_s,
            "prefill_tok_per_s": pf_tok / pf_s, "decode_tokens": dec_tok, "decode_s": dec_s,
            "decode_tok_per_s": dec_tok / dec_s, "decode_ticks": len(dec_ticks),
            "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "verify_launches": eng.verify_launches, "decode_launches": eng.decode_launches,
            "chunk_launches": eng.chunk_launches,
            "tokens_per_verify_launch": (eng.verify_tokens / eng.verify_launches
                                         if eng.verify_launches else None),
            "spec_proposed": eng.spec_proposed, "spec_accepted": eng.spec_accepted,
            "ttft_ticks": [r.ttft_ticks for r in res], "chunks": [r.chunks for r in res],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "pool_bytes": kv["cache_bytes"] + kv["scale_table_bytes"],
            "pages_in_use": kv["pages_in_use"], "scale_entries_in_use": kv["scale_entries_in_use"],
            "peak_pages": kv["peak_in_use"], "dequant_fallbacks": kv["dequant_fallbacks"],
            "launches": launches, "flash_attention_fwd_bodies": bodies,
        }
        if kv_dtype != "fp":
            pairs = [(a, b) for x, y in zip(streams[kv_dtype], streams["fp"]) for a, b in zip(x, y)]
            rec["tokens_matching_fp"] = sum(a == b for a, b in pairs) / len(pairs)
        runs[kv_dtype] = rec
        launches_out[kv_dtype] = launches
        del eng
        torch.cuda.empty_cache()
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_quant {kv_dtype}: not every request finished ok")
        if not rec["pages_in_use"] == rec["scale_entries_in_use"] == 0:
            problems.append(f"serve_quant {kv_dtype}: pages or scale entries left after the drain")
        if rec["dequant_fallbacks"]:
            problems.append(f"serve_quant {kv_dtype}: a gather fallback served a decode tick")
        if not (launches["flash_attention_fwd"] > 0 and rec["chunk_launches"] > 0):
            problems.append(f"serve_quant {kv_dtype}: chunks must run the flash forward")
        # bf16 chunks (tile body) and verifies (decode body) over the fp pool;
        # a quantized pool's fp32 dequantized view takes q to fp32
        want = ({"fp32": 0} if kv_dtype == "fp"
                else {"tile": 0, "decode": 0, "fp32": launches["flash_attention_fwd"]})
        if any(bodies[b] != n for b, n in want.items()) \
                or sum(bodies.values()) != launches["flash_attention_fwd"]:
            problems.append(f"serve_quant {kv_dtype}: flash bodies {bodies}, want {want}")
        used, unused = (("paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
                        else ("paged_flash_decode_quant", "paged_flash_decode"))
        if not (launches[unused] == 0
                and launches[used] == cfg.num_layers * rec["decode_launches"] > 0):
            problems.append(f"serve_quant {kv_dtype}: decode ticks must launch {used} 36 times "
                            f"each: {launches}, {rec['decode_launches']} decode launches")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_quant", "arch": "granite-8b", "num_layers": cfg.num_layers,
          "dtype": "bf16", "paged": True, "page_size": 16, "max_seq": 2048, "num_slots": 8,
          "prefill_chunk": 256, "tick_token_budget": 512, "spec_k": 4, "lengths": lengths,
          "arrival_ticks": arrivals, "new_tokens": 32, "runs": runs, "card": card})
    check(not problems, "; ".join(problems))
    return launches_out["int8"], runs, streams


# slice_ring and serve_ring: the engine at sp_size 4 (a virtual ring on the
# card) against sp_size 1.  serve_ring's bf16 streams may differ from the
# serve phase's only where the ring's run scores the two candidates within
# RING_NEAR_TIE of each other (the ranks' partials are rounded to bf16 and
# summed in another order than one rank's flash decode)
RING_NEAR_TIE = 0.25
# the ring's peak device memory may exceed the serve phase's by this much (a
# per-tick copy of the pool would take ~2.4 GB)
RING_PEAK_SLACK_GB = 1.0


def _kernel_counts():
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "paged_flash_decode": pk.paged_flash_decode.launches,
            "paged_flash_decode_quant": pk.paged_flash_decode.quant_launches,
            "paged_decode_combine": pk.split_combine.launches,
            **{f"fwd_{b}": n for b, n in fwd_body_counts().items()}}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _ring_launch_problems(tag, L, launches, decode, chunk, verify, decode_kernel, prefill=0):
    """The folded launches of a ring run of ``decode`` / ``chunk`` /
    ``verify`` engine launches: per layer, one decode launch (#4, 4q, or #1
    for the dense cache) per decode tick, one #1 launch per chunk and verify
    launch (``prefill``: #1 launches of one-shot prefill besides), one
    combine per decode, chunk and verify launch."""
    steps = decode + chunk + verify
    want = {"paged_decode_combine": L * steps,
            "flash_attention_fwd": L * (chunk + verify) + prefill}
    if decode_kernel == "flash_attention_fwd":
        want["flash_attention_fwd"] += L * decode
    else:
        want[decode_kernel] = L * decode
    got = {k: launches[k] for k in want}
    return [] if got == want and decode > 0 else [
        f"{tag}: launches {got}, want {want} (decode {decode}, chunk {chunk}, verify {verify})"]


def _run_ring_slice(cfg, params, kv_dtype, paged, prompts, arrivals):
    """One slice_ring run on the card at sp_size 4."""
    ctx = ParallelCtx(sp_size=RING_N, device="cuda")
    eng = ServeEngine(cfg, params, ctx, serve=_slice_serve(kv_dtype, paged))
    eng.capture_logits = True
    before = _kernel_counts()
    rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
    done = eng.run()
    kv = eng.kv_cache_stats()
    return eng, dict(
        streams=[done[r].generated for r in rids], logits=[eng.debug_logits[r] for r in rids],
        launches=_delta(before, _kernel_counts()),
        counters={"chunk_launches": eng.chunk_launches, "verify_launches": eng.verify_launches,
                  "decode_launches": eng.decode_launches, "spec_accepted": eng.spec_accepted,
                  "pages_in_use": kv.get("pages_in_use", 0),
                  "scale_entries_in_use": kv.get("scale_entries_in_use", 0),
                  "dequant_fallbacks": kv.get("dequant_fallbacks", 0),
                  "combine_hops": ctx.ring.stats.hops.get("combine", 0)},
    )


def slice_ring(cpu_runs):
    """granite-8b at full width, 2 layers, fp32, slice_quant's weights and
    trace (continuous prefill, chunk 64, budget 128, spec_k 4): the engine at
    sp_size 4 on the card against sp_size 1 on the CPU, over the dense cache
    and the fp / int8 / fp8 paged pools (the CPU's paged runs are
    slice_quant's)."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    prompts, arrivals = _slice_quant_trace(cfg.vocab_size)
    out, problems, total = {}, [], {}
    for cache in ("dense", "fp") + QUANT_DTYPES:
        kv_dtype, paged = ("fp", False) if cache == "dense" else (cache, True)
        tol = SLICE_LOGIT_TOL[kv_dtype]
        cpu = cpu_runs.get(cache) if paged else None
        if cpu is None:
            params_cpu = _tree_to(params, "cpu")
            eng = ServeEngine(cfg, params_cpu, ParallelCtx(device="cpu"),
                              serve=_slice_serve(kv_dtype, paged))
            eng.capture_logits = True
            rids = [eng.submit(x, 8, arrival_tick=t) for x, t in zip(prompts, arrivals)]
            done = eng.run()
            cpu = dict(streams=[done[r].generated for r in rids],
                       logits=[eng.debug_logits[r] for r in rids])
            del eng, params_cpu
        eng, card = _run_ring_slice(cfg, params, kv_dtype, paged, prompts, arrivals)
        for k, v in card["launches"].items():
            total[k] = total.get(k, 0) + v
        decode_kernel = ("flash_attention_fwd" if not paged else
                         "paged_flash_decode" if kv_dtype == "fp" else "paged_flash_decode_quant")
        c = card["counters"]
        problems += _ring_launch_problems(f"slice_ring {cache}", cfg.num_layers,
                                          card["launches"], c["decode_launches"],
                                          c["chunk_launches"], c["verify_launches"],
                                          decode_kernel)
        del eng
        err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card["logits"], cpu["logits"]))
        flips = []
        for i, (a, b) in enumerate(zip(card["streams"], cpu["streams"])):
            if a != b:
                j = _first_flip(a, b)
                la, lb = card["logits"][i][j], cpu["logits"][i][j]
                flips.append(dict(request=i, token=j, ring=a[j], one_rank=b[j],
                                  ring_gap=float(la[a[j]] - la[b[j]]),
                                  one_rank_gap=float(lb[b[j]] - lb[a[j]])))
        out[cache] = dict(streams_identical=card["streams"] == cpu["streams"],
                          near_tie_flips=flips, first_logits_max_abs_err=err, logit_tol=tol,
                          cuda_launches=card["launches"], cuda=c)
        if flips and kv_dtype == "fp":
            problems.append(f"slice_ring {cache}: streams differ: {flips}")
        for f in flips:
            if max(f["ring_gap"], f["one_rank_gap"]) > 2 * tol:
                problems.append(f"slice_ring {cache}: streams differ beyond a near-tie: {f}")
        if err > tol:
            problems.append(f"slice_ring {cache}: first-token logits differ by {err} > {tol}")
        if not c["pages_in_use"] == c["scale_entries_in_use"] == c["dequant_fallbacks"] == 0:
            problems.append(f"slice_ring {cache}: pages or scales left, or a fallback: {c}")
        if card["launches"]["fwd_fp32"] != card["launches"]["flash_attention_fwd"]:
            problems.append(f"slice_ring {cache}: an fp32 flash launch off the fp32 body")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "slice_ring", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          "sp_size": RING_N, "lengths": [len(x) for x in prompts], "arrivals": arrivals,
          "new_tokens": 8, "page_size": 16, "prefill_chunk": 64, "tick_token_budget": 128,
          "spec_k": 4, **out})
    check(not problems, "; ".join(problems))
    return total


def _ring_kernel_class(name: str) -> str:
    if "paged_decode_combine" in name:  # #4's split merge and the ranks' combine
        return "combine"
    return _mesh_kernel_class(name)


def _mesh_prefill_launches(bucket: int) -> int:
    """#1 launches of one layer of one-shot prefill over the ring: the
    engine prefills every admission group (one prompt too) as a packed row
    under a segment mask, as JAX's does, and the Mesh-Attention forward
    launches a segment-masked block once per rank (a launch takes one
    segment-id array), so: the blocks of the mesh schedule (a = 2 at n = 4)
    x the ranks."""
    cfg = MeshAttentionConfig(transport=None, n=RING_N, a=2, mask=MaskSpec.segment())
    return len(cfg.schedules(bucket)[0].blocks()) * RING_N


def serve_ring(card, serve_rec, serve_streams):
    """This slice's main path: the serve phase's model (granite-8b at full
    width and depth, bf16) and trace at ParallelCtx(sp_size=4), a virtual
    ring of 4 ranks on the card: one-shot prefill (the Mesh-Attention
    forward), then continuous prefill (chunk 256, budget 512) with spec_k
    4, both over the fp pool."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    L = cfg.num_layers
    runs, problems, total = {}, [], {}
    for name, extra in (("one_shot", {}),
                        ("chunk_spec", dict(prefill_chunk=256, tick_token_budget=512, spec_k=4))):
        ctx = ParallelCtx(sp_size=RING_N, device="cuda")
        eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
            **extra))
        # warm-up (cuBLAS handles, allocator), outside the measured run
        eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skip = eng.tick_stats()["ticks"]
        counts0 = (eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                   eng.prefill_launches)
        eng.capture_logits = True
        ctx.ring.stats.reset()
        before = _kernel_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, SERVE_LENGTHS, [a + skip for a in SERVE_ARRIVALS], 32,
                          cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _delta(before, _kernel_counts())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        decode_l, chunk_l, verify_l, prefill_l = (
            a - b for a, b in zip((eng.decode_launches, eng.chunk_launches, eng.verify_launches,
                                   eng.prefill_launches), counts0))
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"][skip:]), sum(stats["prefill_s"][skip:])
        dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
        streams = [r.generated for r in res]
        flips = []
        for i, (a, b) in enumerate(zip(streams, serve_streams)):
            if a != b:
                j = _first_flip(a, b)
                row = eng.debug_logits[res[i].rid][j]
                top2 = np.sort(row)[-2:]
                flips.append(dict(request=i, token=j, ring=a[j], one_rank=b[j],
                                  top2_gap=float(top2[1] - top2[0]),
                                  ring_gap_to_one_rank=float(row[a[j]] - row[b[j]])))
        combine_bytes = ctx.ring.stats.bytes.get("combine", 0)
        steps = decode_l + chunk_l + verify_l
        bhd = 8 * cfg.num_heads * cfg.hd  # O(B.H.D): one rank's o per layer and decode tick
        rec = {
            "statuses": [r.status for r in res], "ticks": stats["ticks"] - skip, "wall_s": wall,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "ttft_ticks": [r.ttft_ticks for r in res],
            "prefill_launches": prefill_l, "chunk_launches": chunk_l,
            "verify_launches": verify_l, "decode_launches": decode_l,
            "pages_in_use": kv["pages_in_use"], "peak_pages": kv["peak_in_use"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "serve_peak_mem_gb": serve_rec["peak_mem_gb"],
            "launches": launches, "streams_equal_serve": streams == serve_streams,
            "flips_vs_serve": flips,
            "combine_bytes_per_step": combine_bytes / steps if steps else None,
            "combine_bytes_model_per_step": L * bhd * (2 + 4 / cfg.hd),
            "hops": dict(ctx.ring.stats.hops),
        }
        if name == "one_shot":
            rec["decode_profile"] = profile_decode(eng, cfg, classify=_ring_kernel_class)
        runs[name] = rec
        # gates
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_ring {name}: not every request finished ok: {rec['statuses']}")
        if kv["pages_in_use"]:
            problems.append(f"serve_ring {name}: {kv['pages_in_use']} pages left after the drain")
        blocks = (sum(_mesh_prefill_launches(eng.scheduler.bucket_for(n))
                      for n in SERVE_LENGTHS) if name == "one_shot" else 0)
        problems += _ring_launch_problems(f"serve_ring {name}", L, launches, decode_l, chunk_l,
                                          verify_l, "paged_flash_decode", prefill=L * blocks)
        if launches["paged_flash_decode_quant"] or launches["fwd_fp32"]:
            problems.append(f"serve_ring {name}: a quantized decode or an fp32 flash launch")
        if name == "one_shot":
            want = {"fwd_tile": L * blocks, "fwd_decode": 0, "prefill_launches": len(res)}
            got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
                   "prefill_launches": prefill_l}
        else:
            want = {"fwd_tile": L * chunk_l, "fwd_decode": L * verify_l, "prefill_launches": 0}
            got = {"fwd_tile": launches["fwd_tile"], "fwd_decode": launches["fwd_decode"],
                   "prefill_launches": prefill_l}
        if got != want:
            problems.append(f"serve_ring {name}: flash launches by body {got}, want {want}")
        if rec["peak_mem_gb"] > serve_rec["peak_mem_gb"] + RING_PEAK_SLACK_GB:
            problems.append(f"serve_ring {name}: peak {rec['peak_mem_gb']:.2f} GB > the serve "
                            f"phase's {serve_rec['peak_mem_gb']:.2f} + {RING_PEAK_SLACK_GB}")
        for f in flips:
            if f["ring_gap_to_one_rank"] > RING_NEAR_TIE:
                problems.append(f"serve_ring {name}: a flip beyond a near-tie: {f}")
        del eng, ctx
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_ring", "arch": "granite-8b", "num_layers": L, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "dtype": "bf16", "sp_size": RING_N, "paged": True, "page_size": 16, "max_seq": 2048,
          "num_slots": 8, "lengths": SERVE_LENGTHS, "arrival_ticks": SERVE_ARRIVALS,
          "new_tokens": 32, "near_tie": RING_NEAR_TIE, "runs": runs, "card": card})
    check(not problems, "; ".join(problems))
    return total


# --------------------------------------------------------------------------
# phases 4g and 4h: serving under memory pressure
# --------------------------------------------------------------------------

# slice_pressure: JAX's tests/test_robustness.py pool (page 4, 13 pages, chunk
# 8, oversubscribe 2.0, the sweep every tick) at full width, 2 layers, fp32
PRESSURE_SLICE = dict(max_seq=64, num_slots=3, paged=True, page_size=4, num_pages=13,
                      prefill_chunk=8, oversubscribe=2.0, health_every=1,
                      cache_dtype=torch.float32)
PRESSURE_SLICE_CHAOS = dict(seed=6, ticks=16, squeezes=2, squeeze_hold=3, nan_ticks=1,
                            drop_ticks=1)
# serve_pressure: the serve trace's lifetime need is 334 pages of 16 tokens
# (its prompts alone 318).  Admission books lifetimes against 2x the pool but
# needs a prompt's pages (and one more) free at once, so only a pool that
# the admitted prompts fill to within their decode growth preempts: the
# schedule (token-independent: no EOS) preempts at 114-120 pages and at
# none of 100-112 or 124-240 (CPU runs of the same engine on the reduced
# config).  118 preempts once, with or without the chaos seed below
PRESSURE_PAGES = 118
# seed 4 over 64 ticks: a dropped grant (t33), two squeezes, a NaN tick (t55)
PRESSURE_SERVE_CHAOS = dict(seed=4, ticks=64)


def _pressure_trace(V, chaos):
    """slice_pressure's prompts and token budget: JAX's token-identity case
    (3 x 16 tokens, 12 new) or its chaos case (4 x 16, 10 new)."""
    if chaos:
        rng = np.random.default_rng(13)
        return [rng.integers(0, V, (16,), dtype=np.int32) for _ in range(4)], 10
    rng = np.random.default_rng(3)
    return [rng.integers(0, V, (16,), dtype=np.int32) for _ in range(3)], 12


def slice_pressure():
    """granite-8b at full width, 2 layers, fp32: the same weights served on
    the card (kernels) and on the CPU (plain versions) under oversubscription
    (13 pages of 4, preempt-and-recompute), from an fp and an int8 pool,
    plain and with JAX's chaos seed (squeezes, a NaN tick, a dropped grant)."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    params_cpu = _tree_to(params, "cpu")
    out, problems = {}, []
    for kv_dtype in ("fp", "int8"):
        for run in ("pressure", "chaos"):
            prompts, new = _pressure_trace(cfg.vocab_size, run == "chaos")
            side = {}
            for dev, p in (("cuda", params), ("cpu", params_cpu)):
                inj = (ChaosInjector(ChaosConfig(**PRESSURE_SLICE_CHAOS)) if run == "chaos"
                       else None)
                eng = ServeEngine(cfg, p, ParallelCtx(device=dev), chaos=inj,
                                  serve=ServeConfig(**PRESSURE_SLICE, kv_dtype=kv_dtype))
                before = _kernel_counts()
                rids = [eng.submit(x, new) for x in prompts]
                done = eng.run()
                kv = eng.kv_cache_stats()
                eng.health()
                side[dev] = dict(
                    outcome=[(done[r].status, done[r].generated, done[r].preemptions,
                              done[r].recompute_tokens) for r in rids],
                    events=list(inj.events) if inj else [],
                    preemptions=eng.preemptions, recompute_tokens=eng.recompute_tokens,
                    dropped_grants=eng.chaos_dropped_grants, left=(
                        kv["pages_in_use"], kv["scale_entries_in_use"], kv["seized_pages"]),
                    launches=_delta(before, _kernel_counts()),
                    decode_launches=eng.decode_launches, chunk_launches=eng.chunk_launches,
                )
                del eng
            card, cpu = side["cuda"], side["cpu"]
            tag = f"slice_pressure {kv_dtype} {run}"
            statuses = [o[0] for o in card["outcome"]]
            out[f"{kv_dtype}_{run}"] = dict(
                identical=card["outcome"] == cpu["outcome"] and card["events"] == cpu["events"],
                statuses=statuses, preemptions=card["preemptions"],
                recompute_tokens=card["recompute_tokens"], events=card["events"],
                dropped_grants=card["dropped_grants"], cuda_launches=card["launches"],
                cpu_launches=sum(cpu["launches"].values()),
            )
            if card["outcome"] != cpu["outcome"] or card["events"] != cpu["events"]:
                problems.append(f"{tag}: card and CPU differ: {card['outcome']} {card['events']}"
                                f" vs {cpu['outcome']} {cpu['events']}")
            if card["preemptions"] < 1:
                problems.append(f"{tag}: no preemption")
            if card["left"] != (0, 0, 0) or cpu["left"] != (0, 0, 0):
                problems.append(f"{tag}: pages, scales or seized pages left: {card['left']}")
            if run == "chaos" and statuses.count("numeric_error") != 1:
                problems.append(f"{tag}: the NaN tick must retire one request: {statuses}")
            if run == "pressure" and statuses != ["ok"] * len(statuses):
                problems.append(f"{tag}: not every request finished ok: {statuses}")
            decode_kernel = "paged_flash_decode" if kv_dtype == "fp" else "paged_flash_decode_quant"
            L = cfg.num_layers
            if not (card["launches"][decode_kernel] == L * card["decode_launches"] > 0
                    and card["launches"]["fwd_fp32"] == L * card["chunk_launches"] > 0):
                problems.append(f"{tag}: launches {card['launches']} off the decode "
                                f"({card['decode_launches']}) and chunk "
                                f"({card['chunk_launches']}) launches")
            if out[f"{kv_dtype}_{run}"]["cpu_launches"]:
                problems.append(f"{tag}: kernels launched on the CPU side")
    del params, params_cpu
    torch.cuda.empty_cache()
    emit({"phase": "slice_pressure", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
          **{k: (str(v) if k == "cache_dtype" else v) for k, v in PRESSURE_SLICE.items()},
          "chaos": PRESSURE_SLICE_CHAOS, **out})
    check(not problems, "; ".join(problems))


def _poisoned_slot(events):
    hits = [e for e in events if ":nan:slot" in e]
    return int(hits[0].rsplit("slot", 1)[1]) if len(hits) == 1 else None


def serve_pressure(card, quant_runs, quant_streams):
    """granite-8b at full width and depth, bf16, the serve trace over a pool of
    PRESSURE_PAGES pages with oversubscribe 2.0 (chunk 256, budget 512): the
    fp pool, the int8 pool, and the fp pool with a chaos seed, twice.  Held to
    serve_quant's roomy fp and int8 runs of the same call (a flip only where
    the pressure run scores its top two within RING_NEAR_TIE)."""
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    L = cfg.num_layers
    runs, problems, outcomes, main = {}, [], {}, {}
    for name, kv_dtype, chaos in (("fp", "fp", False), ("int8", "int8", False),
                                  ("chaos_1", "fp", True), ("chaos_2", "fp", True)):
        inj = ChaosInjector(ChaosConfig(**PRESSURE_SERVE_CHAOS)) if chaos else None
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), chaos=inj, serve=ServeConfig(
            max_seq=2048, num_slots=8, paged=True, page_size=16, num_pages=PRESSURE_PAGES,
            cache_dtype=torch.bfloat16, prefill_chunk=256, tick_token_budget=512,
            oversubscribe=2.0, health_every=1, kv_dtype=kv_dtype,
        ))
        eng.capture_logits = True  # the flip rule reads the run's logits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _kernel_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, SERVE_LENGTHS, SERVE_ARRIVALS, 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _delta(before, _kernel_counts())
        health = eng.health()
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        pf_tok, pf_s = sum(stats["prefill_tokens"]), sum(stats["prefill_s"])
        dec_ticks = [i for i in range(stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"]) - len(res)
        roomy = quant_streams["int8" if kv_dtype == "int8" else "fp"]
        flips = []
        for i, (r, want) in enumerate(zip(res, roomy)):
            if r.status == "ok" and r.generated != want:
                j = _first_flip(r.generated, want)
                row = eng.debug_logits[r.rid][j]
                top2 = np.sort(row)[-2:]
                flips.append(dict(request=i, token=j, pressure=r.generated[j], roomy=want[j],
                                  top2_gap=float(top2[1] - top2[0]),
                                  gap_to_roomy=float(row[r.generated[j]] - row[want[j]])))
        rec = {
            "kv_dtype": kv_dtype, "chaos": PRESSURE_SERVE_CHAOS if chaos else None,
            "statuses": [r.status for r in res], "ticks": stats["ticks"], "wall_s": wall,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "preemptions": eng.preemptions, "recompute_tokens": eng.recompute_tokens,
            "per_request_preemptions": [r.preemptions for r in res],
            "chunk_launches": eng.chunk_launches, "decode_launches": eng.decode_launches,
            "chaos_events": list(inj.events) if inj else [],
            "chaos_dropped_grants": eng.chaos_dropped_grants,
            "numeric_errors": eng.numeric_errors, "health_sweeps": eng.health_sweeps,
            "ttft_ticks": [r.ttft_ticks for r in res],
            "pool_bytes": kv["cache_bytes"] + kv["scale_table_bytes"],
            "peak_pages": kv["peak_in_use"], "pages_in_use": kv["pages_in_use"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "flips_vs_roomy": flips,
        }
        runs[name] = rec
        outcomes[name] = [(r.status, r.generated, r.preemptions, r.recompute_tokens)
                          for r in res]
        tag = f"serve_pressure {name}"
        if not (rec["preemptions"] >= 1 and rec["recompute_tokens"] > 0):
            problems.append(f"{tag}: no preemption under {PRESSURE_PAGES} pages")
        if not (kv["pages_in_use"] == kv["scale_entries_in_use"] == kv["seized_pages"] == 0
                and health["ok"]):
            problems.append(f"{tag}: pages left or the sweep failed: {kv['pages_in_use']}")
        oks = [r for r in res if r.status == "ok"]
        if not all(len(r.generated) == 32 for r in oks):
            problems.append(f"{tag}: an ok request short of 32 tokens")
        if chaos:
            slot = _poisoned_slot(rec["chaos_events"])
            bad = [r for r in res if r.status != "ok"]
            if not (slot is not None and len(bad) == 1 and bad[0].status == "numeric_error"
                    and bad[0].slot == slot):
                problems.append(f"{tag}: exactly the poisoned slot ({slot}) must end "
                                f"numeric_error: {rec['statuses']}, {rec['chaos_events']}")
        elif len(oks) != len(res):
            problems.append(f"{tag}: not every request finished ok: {rec['statuses']}")
        for f in flips:
            if f["gap_to_roomy"] > RING_NEAR_TIE:
                problems.append(f"{tag}: a flip beyond a near-tie: {f}")
        # per layer one #1 launch per chunk launch (tile body; fp32 body over
        # the int8 pool's view) and one #4 / 4q launch per decode launch
        chunk_body, decode_kernel, other = (
            ("fwd_tile", "paged_flash_decode", "paged_flash_decode_quant") if kv_dtype == "fp"
            else ("fwd_fp32", "paged_flash_decode_quant", "paged_flash_decode"))
        want = {chunk_body: L * rec["chunk_launches"],
                "flash_attention_fwd": L * rec["chunk_launches"],
                decode_kernel: L * rec["decode_launches"], other: 0}
        if {k: launches[k] for k in want} != want or not rec["decode_launches"]:
            problems.append(f"{tag}: launches {launches}, want {want}")
        if name in ("fp", "int8"):
            for k, v in launches.items():
                main[k] = main.get(k, 0) + v
        del eng
        torch.cuda.empty_cache()
    if outcomes["chaos_1"] != outcomes["chaos_2"] or \
            runs["chaos_1"]["chaos_events"] != runs["chaos_2"]["chaos_events"]:
        problems.append("serve_pressure: the two chaos runs differ")
    roomy_fp = quant_runs["fp"]
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_pressure", "arch": "granite-8b", "num_layers": L, "dtype": "bf16",
          "paged": True, "page_size": 16, "num_pages": PRESSURE_PAGES, "lifetime_pages": sum(
              -(-(n + 32) // 16) for n in SERVE_LENGTHS), "oversubscribe": 2.0,
          "max_seq": 2048, "num_slots": 8, "prefill_chunk": 256, "tick_token_budget": 512,
          "lengths": SERVE_LENGTHS, "arrival_ticks": SERVE_ARRIVALS, "new_tokens": 32,
          "near_tie": RING_NEAR_TIE, "chaos_runs_identical": outcomes["chaos_1"] == outcomes[
              "chaos_2"], "runs": runs,
          "serve_quant_fp": {k: roomy_fp[k] for k in (
              "prefill_tok_per_s", "decode_tok_per_s", "ms_per_decode_tick", "pool_bytes",
              "peak_mem_gb", "ticks")},
          "card": card})
    check(not problems, "; ".join(problems))
    return main


def _ssm_state_bytes(eng):
    """Bytes of the engine's SSM cache (conv windows and states, all slots)."""
    return sum(t.numel() * t.element_size() for t in eng._cache["ssm"].values())


def cross_device_ssm():
    """mamba2-370m and hymba-1.5b at full width, 2 layers, fp32: card (the
    SSD kernel; hymba's attention on the flash forward) vs CPU (plain
    versions), exact-length prefill."""
    lengths, arrivals = [48, 64, 192, 320], [0, 0, 1, 2]
    out, problems = {}, []
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        serve = ServeConfig(max_seq=512, num_slots=4, cache_dtype=torch.float32)
        side = {}
        for dev, p in (("cuda", params), ("cpu", _tree_to(params, "cpu"))):
            fa.flash_attention_fwd.launches = ssd.ssd_scan_fwd.launches = 0
            eng = ServeEngine(cfg, p, ParallelCtx(device=dev), serve=serve)
            eng.capture_logits = True
            res = serve_trace(eng, lengths, arrivals, 8, cfg.vocab_size, seed=4)
            side[dev] = dict(
                streams=[r.generated for r in res],
                first=[eng.debug_logits[r.rid][0] for r in res],
                launches={"ssd_scan_fwd": ssd.ssd_scan_fwd.launches,
                          "flash_attention_fwd": fa.flash_attention_fwd.launches},
                prefill_launches=eng.prefill_launches, decode_launches=eng.decode_launches,
                statuses=[r.status for r in res],
            )
        card, cpu = side["cuda"], side["cpu"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card["first"], cpu["first"]))
        want_ssd = cfg.num_layers * card["prefill_launches"]
        want_flash = (cfg.num_layers * (card["prefill_launches"] + card["decode_launches"])
                      if cfg.hybrid else 0)
        out[arch] = dict(
            streams_identical=card["streams"] == cpu["streams"], first_logits_max_abs_err=err,
            cuda_launches=card["launches"], cpu_launches=sum(cpu["launches"].values()),
            prefill_launches=card["prefill_launches"], decode_launches=card["decode_launches"],
        )
        if card["streams"] != cpu["streams"]:
            problems.append(f"slice_ssm {arch}: card and CPU streams differ: {side}")
        if err > 1e-3:
            problems.append(f"slice_ssm {arch}: first-token logits differ by {err} > 1e-3")
        if not all(st == "ok" for st in card["statuses"] + cpu["statuses"]):
            problems.append(f"slice_ssm {arch}: not every request finished ok")
        if card["launches"] != {"ssd_scan_fwd": want_ssd, "flash_attention_fwd": want_flash} \
                or out[arch]["cpu_launches"]:
            problems.append(f"slice_ssm {arch}: launches {card['launches']} (CPU "
                            f"{out[arch]['cpu_launches']}), want ssd {want_ssd}, "
                            f"flash {want_flash}")
        del params
        torch.cuda.empty_cache()
    emit({"phase": "slice_ssm", "num_layers": 2, "dtype": "fp32", "lengths": lengths,
          "arrivals": arrivals, "new_tokens": 8, **out})
    check(not problems, "; ".join(problems))


def full_serve_ssm(card):
    """mamba2-370m and hymba-1.5b at full width and depth, bf16, 8 slots,
    max_seq 2048; every prompt <= 64 or a multiple of 64 (exact mode)."""
    lengths = [48, 64, 128, 256, 384, 640, 1024, 1536]
    arrivals = [0, 0, 1, 2, 3, 5, 8, 13]
    runs, launches_total, problems = {}, 0, []
    decode_body_launches = 0
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
            max_seq=2048, num_slots=8, cache_dtype=torch.bfloat16,
        ))
        # warm-up (cuBLAS handles, allocator), outside the measured run
        eng.generate(np.arange(64, dtype=np.int32)[None], max_new_tokens=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skip = eng.tick_stats()["ticks"]
        prefills0, decodes0 = eng.prefill_launches, eng.decode_launches
        fa.flash_attention_fwd.launches = ssd.ssd_scan_fwd.launches = 0
        bodies0 = fwd_body_counts()
        t0 = time.perf_counter()
        res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ssd_scan_fwd": ssd.ssd_scan_fwd.launches,
                    "flash_attention_fwd": fa.flash_attention_fwd.launches}
        bodies = fwd_body_delta(bodies0)
        prefills = eng.prefill_launches - prefills0
        decodes = eng.decode_launches - decodes0
        stats = eng.tick_stats()
        pf_tok = sum(stats["prefill_tokens"][skip:])
        pf_s = sum(stats["prefill_s"][skip:])
        dec_ticks = [i for i in range(skip, stats["ticks"]) if stats["decode_s"][i] > 0]
        dec_s = sum(stats["decode_s"][i] for i in dec_ticks)
        dec_tok = sum(stats["decode_tokens"][skip:]) - len(res)
        ssm_bytes = _ssm_state_bytes(eng)
        rec = {
            "arch": arch, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "ssm": dataclasses.asdict(cfg.ssm), "vocab": cfg.vocab_size,
            "params": tfm.param_count(params), "statuses": [r.status for r in res],
            "ticks": stats["ticks"] - skip, "wall_s": wall, "init_s": init_s,
            "prefill_tokens": pf_tok, "prefill_s": pf_s, "prefill_tok_per_s": pf_tok / pf_s,
            "decode_tokens": dec_tok, "decode_s": dec_s, "decode_tok_per_s": dec_tok / dec_s,
            "decode_ticks": len(dec_ticks), "ms_per_decode_tick": 1e3 * dec_s / len(dec_ticks),
            "ttft_ticks": [r.ttft_ticks for r in res],
            "ssm_state_bytes": ssm_bytes, "ssm_state_bytes_per_slot": ssm_bytes / 8,
            "kv_cache_bytes": eng.kv_cache_stats()["cache_bytes"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefill_launches": prefills, "decode_launches": decodes, "launches": launches,
            "flash_attention_fwd_bodies": bodies,
        }
        rec["decode_profile"] = profile_decode(eng, cfg)
        runs[arch] = rec
        launches_total += launches["ssd_scan_fwd"]
        want_flash = cfg.num_layers * (prefills + decodes) if cfg.hybrid else 0
        if not all(r.status == "ok" and len(r.generated) == 32 for r in res):
            problems.append(f"serve_ssm {arch}: not every request finished ok: {rec['statuses']}")
        if launches != {"ssd_scan_fwd": cfg.num_layers * len(lengths),
                        "flash_attention_fwd": want_flash} or prefills != len(lengths):
            problems.append(f"serve_ssm {arch}: launches {launches} over {prefills} prefill and "
                            f"{decodes} decode launches; want ssd {cfg.num_layers * len(lengths)}"
                            f", flash {want_flash}")
        # hymba: window prefill on the tile body, each Sq = 1 tick on the decode body
        want_bodies = ({"tile": cfg.num_layers * prefills, "decode": cfg.num_layers * decodes,
                        "fp32": 0} if cfg.hybrid else {"tile": 0, "decode": 0, "fp32": 0})
        if bodies != want_bodies:
            problems.append(f"serve_ssm {arch}: flash bodies {bodies}, want {want_bodies}")
        if cfg.hybrid:
            decode_body_launches = bodies["decode"]
        del eng, params
        torch.cuda.empty_cache()
    emit({"phase": "serve_ssm", "dtype": "bf16", "max_seq": 2048, "num_slots": 8,
          "lengths": lengths, "arrival_ticks": arrivals, "new_tokens": 32, "runs": runs,
          "card": card})
    check(not problems, "; ".join(problems))
    return launches_total, decode_body_launches


def _kernel_class(name: str) -> str:
    if "flash_fwd_" in name:  # the fp32, tile, decode and combine kernels
        return "flash_attention_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if "flash_bwd_split_kernel" in name:  # the fp32 body's pre-pass
        return "flash_bwd_split"
    if "paged_decode_" in name:  # the main kernels and the split combine
        return "paged_flash_decode"
    if "ssd_scan_" in name:  # the chunk (scores and states), pass and y kernels
        return "ssd_scan_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def profile_decode(eng, cfg, ticks=4, classify=None):
    """Where a decode tick's time goes: device time per kernel class
    (``classify``, default ``_kernel_class``) over a few ticks of 8 slots at
    depth ~128 (torch.profiler), against the host wall clock of those
    ticks.  Runs after the measured trace (its launches are not counted) and
    drains the engine again."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    now = eng.tick_stats()["ticks"]
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, (128,), dtype=np.int32), ticks + 2,
                   arrival_tick=now)
    eng.step()  # admission + prefill + the first decode, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    device_ms, by_kernel = device_time(prof, per=ticks, classify=classify)
    busy = sum(device_ms.values())
    per_tick_wall = wall_ms / ticks
    return {
        "ticks": ticks, "slots": 8, "depth": 128, "wall_ms_per_tick": per_tick_wall,
        "device_ms_per_tick": device_ms or None,
        "top_kernels_ms_per_tick": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]),
        # the profiler's own host cost inflates this window's wall clock
        "device_idle_share": (1 - busy / per_tick_wall) if device_ms else None,
    }


# --------------------------------------------------------------------------
# phases 5 and 6: training
# --------------------------------------------------------------------------

# card vs CPU after one train step, fp32 (granite-8b width, 2 layers, seq 512).
# The two sides sum the same fp32 products in other orders (cuBLAS vs the
# CPU's BLAS over K = 4096 / 14336).  Readings on an H100: loss 9.5e-7, grad
# norm equal, per-leaf gradient 4.7e-6 of the leaf's max |g|, params 7.0e-7;
# the loss, grad-norm and gradient limits sit a few times above them.
# params: one AdamW step from zero moments moves a weight by lr_1 * (~1 +
# wd*|p|) with lr_1 = 3e-6 (warmup 1/100), so two sides that disagree on the
# sign of a near-zero gradient may differ by ~6e-6: the limit allows that.
PARITY_TOLS = {"loss": 1e-5, "grad_norm_rel": 1e-5, "grad_rel": 5e-5, "param": 1e-5}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def train_parity():
    """One make_train_step on the card and on the CPU from the same weights."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    opt = AdamWConfig()
    params = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    sides = {"cuda": params, "cpu": _tree_to(params, "cpu")}
    out, launches = {}, {}
    for dev, p in sides.items():
        ctx = ParallelCtx(device=dev)
        state = init_opt_state(p)
        batch = make_batch(cfg, 512, 1, seed=0, step=0, ctx=ctx)
        before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq,
                  fa.flash_attention_bwd.launches_dkv)
        t0 = time.perf_counter()
        p, state, _, metrics = make_train_step(cfg, ctx, opt)(p, state, {}, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches_dq,
                 fa.flash_attention_bwd.launches_dkv)
        launches[dev] = [a - b for a, b in zip(after, before)]
        out[dev] = dict(loss=loss, grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                        params=p, m=state.m)
    card, cpu = out["cuda"], out["cpu"]
    leaves = {}
    # the gradient the step applied (after clipping), read back from the first
    # moment: m = (1 - b1) * g after one step from zero moments
    m_cpu = dict(tree_leaves(cpu["m"]))
    p_cpu = dict(tree_leaves(cpu["params"]))
    p_card = dict(tree_leaves(card["params"]))
    for path, m_card in tree_leaves(card["m"]):
        g_card = m_card.cpu() / (1 - opt.b1)
        g_cpu = m_cpu[path] / (1 - opt.b1)
        gmax = float(g_cpu.abs().max())
        leaves[path] = dict(
            grad_max_abs_err=float((g_card - g_cpu).abs().max()), grad_max_abs=gmax,
            param_max_abs_err=float((p_card[path].detach().cpu()
                                     - p_cpu[path].detach()).abs().max()),
        )
    rec = {
        "phase": "train_parity", "arch": "granite-8b", "num_layers": 2, "dtype": "fp32",
        "seq": 512, "batch": 1, "loss": {"cuda": card["loss"], "cpu": cpu["loss"]},
        "grad_norm": {"cuda": card["grad_norm"], "cpu": cpu["grad_norm"]},
        "wall_s": {"cuda": card["wall_s"], "cpu": cpu["wall_s"]},
        "launches": {dev: dict(zip(("flash_attention_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n))
                     for dev, n in launches.items()},
        "leaves": leaves, "tols": PARITY_TOLS,
    }
    emit(rec)
    del sides, out, card, cpu, params
    torch.cuda.empty_cache()
    check(abs(rec["loss"]["cuda"] - rec["loss"]["cpu"]) <= PARITY_TOLS["loss"],
          "train_parity: loss differs")
    check(abs(rec["grad_norm"]["cuda"] - rec["grad_norm"]["cpu"])
          <= PARITY_TOLS["grad_norm_rel"] * rec["grad_norm"]["cpu"], "train_parity: grad norm differs")
    for path, leaf in leaves.items():
        check(leaf["grad_max_abs_err"] <= PARITY_TOLS["grad_rel"] * leaf["grad_max_abs"],
              f"train_parity: gradient of {path} differs: {leaf}")
        check(leaf["param_max_abs_err"] <= PARITY_TOLS["param"],
              f"train_parity: updated {path} differs: {leaf}")
    check(launches["cuda"] == [2 * 2, 2, 2] and launches["cpu"] == [0, 0, 0],
          f"train_parity: kernels must run on the card only, with remat: {launches}")


def full_train(card):
    """granite-8b at full width, 8 layers, fp32 + AdamW, remat, seq 4096."""
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=8)
    ctx = ParallelCtx(device="cuda")
    seq, steps, steps_docs = 4096, 4, 2
    grad_norms = []
    hooks = {"on_step": lambda s, m: grad_norms.append(float(m["grad_norm"]))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
    bodies0, bwd0 = fwd_body_counts(), bwd_counts()
    runs, last = [], None
    for n, docs in ((steps, None), (steps_docs, 4)):
        last = None  # the previous run's params go before the next run starts
        t0 = time.perf_counter()
        last = fit(cfg, ctx, TrainConfig(steps=n, seq=seq, batch=1, seed=0, docs=docs),
                   hooks=hooks)
        runs.append(dict(docs=docs, losses=last["history"], step_s=last["step_seconds"],
                         fit_s=time.perf_counter() - t0, params=tfm.param_count(last["params"])))
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv}
    bodies = fwd_body_delta(bodies0)
    bwd_bodies = {b: n - bwd0[b] for b, n in bwd_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_train_step(cfg, ctx, last.pop("params"), seq)
    del last
    torch.cuda.empty_cache()
    losses = [x for r in runs for x in r["losses"]]
    step_s = [x for r in runs for x in r["step_s"]]
    total = steps + steps_docs
    rec = {
        "phase": "train", "arch": "granite-8b", "num_layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "params": runs[0]["params"], "param_dtype": "fp32",
        "optimizer": "adamw", "remat": True, "seq": seq, "batch": 1,
        "runs": [{k: v for k, v in r.items() if k != "params"} for r in runs],
        "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
        "tokens_per_s": [seq / t for t in step_s], "peak_mem_gb": peak_gb,
        "launches": launches, "flash_attention_fwd_bodies": bodies,
        "flash_attention_bwd_bodies": bwd_bodies,
        "ln_vocab": float(np.log(cfg.vocab_size)),
        "profile": profile, "bf16": full_train_bf16(cfg, ctx, seq), "card": card,
    }
    emit(rec)
    check(len(losses) == total and all(np.isfinite(losses)), f"train: losses not finite: {losses}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) < 1.5,
          f"train: first loss {losses[0]} is not near ln(vocab) = {np.log(cfg.vocab_size)}")
    check(launches == {"flash_attention_fwd": 2 * cfg.num_layers * total,
                       "flash_bwd_dq": cfg.num_layers * total,
                       "flash_bwd_dkv": cfg.num_layers * total},
          f"train: launch counts off the remat schedule: {launches}")
    check(bodies == {"tile": 0, "decode": 0, "fp32": launches["flash_attention_fwd"]},
          f"train: the fp32 forward must run the fp32 body: {bodies}")
    n_bwd = cfg.num_layers * total
    check(bwd_bodies == {"tc_fp32": n_bwd, "tc_bf16": 0, "split": n_bwd},
          f"train: every fp32 backward must run the fp32 tensor-core body: {bwd_bodies}")
    bf = rec["bf16"]
    check(len(bf["losses"]) == 2 and all(np.isfinite(bf["losses"]))
          and abs(bf["losses"][0] - np.log(cfg.vocab_size)) < 1.5,
          f"train (bf16): losses not finite or not near ln(vocab): {bf}")
    n_bf = cfg.num_layers * 2
    check(bf["launches"] == {"flash_attention_fwd": 2 * n_bf, "flash_bwd_dq": n_bf,
                             "flash_bwd_dkv": n_bf}
          and bf["flash_attention_fwd_bodies"] == {"tile": 2 * n_bf, "decode": 0, "fp32": 0}
          and bf["flash_attention_bwd_bodies"] == {"tc_fp32": 0, "tc_bf16": n_bf, "split": 0},
          f"train (bf16): launches off the remat schedule or off the bf16 bodies: {bf}")
    return {**{k: launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")},
            "flash_attention_fwd (fp32)": bodies["fp32"], "flash_bwd_split": bwd_bodies["split"]}


def full_train_bf16(cfg, ctx, seq):
    """2 causal steps of the train phase's model with bf16 params (the JAX
    package's ``param_dtype`` option); counters set to 0 just before."""
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
    bodies0, bwd0 = fwd_body_counts(), bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fit(cfg, ctx, TrainConfig(steps=2, seq=seq, batch=1, seed=0,
                                    param_dtype=torch.bfloat16))
    fit_s = time.perf_counter() - t0
    rec = {
        "param_dtype": "bf16", "steps": 2, "losses": out["history"],
        "step_s": out["step_seconds"], "fit_s": fit_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                     "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
                     "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv},
        "flash_attention_fwd_bodies": fwd_body_delta(bodies0),
        "flash_attention_bwd_bodies": {b: n - bwd0[b] for b, n in bwd_counts().items()},
    }
    del out
    torch.cuda.empty_cache()
    return rec


def profile_train_step(cfg, ctx, params, seq):
    """Device time per kernel class of one more train step (4 packed
    documents) under torch.profiler; after the counted run."""
    from torch.profiler import ProfilerActivity, profile

    state = init_opt_state(params)
    step_fn = make_train_step(cfg, ctx, AdamWConfig(total_steps=2))
    batch = make_batch(cfg, seq, 1, seed=0, step=2, ctx=ctx, docs=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, metrics = step_fn(params, state, {}, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, by_kernel = device_time(prof)
    busy = sum(device_ms.values())
    del state, params
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "device_busy_ms": busy,
        "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]),
        # the profiler's own host cost inflates this window's wall clock
        "device_idle_share": (1 - busy / wall_ms) if device_ms else None,
    }


# --------------------------------------------------------------------------
# phases 7-9: the paper's Mesh-Attention over a virtual ring of 4 ranks
# --------------------------------------------------------------------------

# paper-mha-7b's attention (configs/paper_mha_7b.py: 32 heads x 128, MHA)
PAPER_HEADS = (32, 32, 128)
MESH_N = 4
MESH_S = 16384  # S / n = 4096 rows per rank's chunk
MESH_WINDOW = 1024
MESH_BACKENDS = (("mesh", 2), ("ring", 1), ("mesh", 4))
# mesh_op against the local flash call on the unstriped sequence: o within
# the limit, the q/k/v gradients of sum(sin(o)) within the limit times their
# max |g|.  fp32: JAX's dist_check mesh_fwd / mesh_bwd limits.  bf16: every
# block's o (and dq, dk, dv) leaves the kernel rounded to bf16 before the
# fp32 merge (as in JAX), so a row carries up to b + 1 <= 5 roundings of
# half an ulp (2**-9 of the value) where the local call has one: the limit is
# 2**-6 of the output's max for o and of each gradient's max.
MESH_OP_TOLS = {torch.float32: (2e-5, 5e-5), torch.bfloat16: (2**-6, 2**-6)}
MESH_OP_O_RELATIVE = {torch.float32: False, torch.bfloat16: True}
# the most layers that fit the card: 8 layers peaked at 42.0 GB, and each
# more layer adds ~4.3 GB (fp32 params, grads, the clipped grads, m, v: 20 B
# per weight, and its remat input), so 14 (~68 GB) leave room for the
# allocator's fragmentation
MESH_TRAIN_LAYERS = 14


def _mesh_cfg_for(kind, a, transport=None):
    spec = MaskSpec.causal(window=MESH_WINDOW if kind == "window" else None)
    return MeshAttentionConfig(transport=transport, n=MESH_N, a=a, mask=spec)


def _mesh_kernel_class(name: str) -> str:
    cls = _kernel_class(name)
    if cls != "other":
        return cls
    low = name.lower()
    if "index" in low or "copy" in low or "memcpy" in low:
        return "copy"  # the virtual ring's hops, the layout's splits and joins
    return "other"  # the online-softmax merges and the dq / dkv sums


def _mesh_device_time(prof, per=1):
    return device_time(prof, per, classify=_mesh_kernel_class)[0]


def mesh_block_case(kind, dtype, gen):
    """One AM block (u, v) = (0, 1) of a = 2 on all 4 ranks at once, as the
    executor's forward launches it: the ranks folded into the batch, one band
    per rank ([4, 4]), stride 4, paper heads, 4096 rows per chunk.  Ranks 0
    and 1 hold q chunk < kv chunk: their row 0 sees no key."""
    nh, nkv, hd = PAPER_HEADS
    R, m = MESH_N, MESH_S // MESH_N
    cfg = _mesh_cfg_for(kind, 2)
    blocks = [mesh_attention._band_for_block(cfg, i, 0, 1, m, m) for i in range(R)]
    bands = [b for b, _, _ in blocks]
    sq, skv = blocks[0][1], blocks[0][2]
    q = randn(gen, R, m, nh, hd, dtype=dtype)
    k = randn(gen, R, m, nkv, hd, dtype=dtype)
    v = randn(gen, R, m, nkv, hd, dtype=dtype)
    band_t = torch.tensor(bands, dtype=torch.int32, device="cuda")
    kw = dict(scale=hd**-0.5, stride_q=sq, stride_kv=skv)
    run = lambda: fa.flash_attention_fwd(q, k, v, band_t, **kw)  # noqa: E731

    def plain():
        outs = [ref.attention_ref(q[r:r + 1], k[r:r + 1], v[r:r + 1], band=bands[r], **kw)
                for r in range(R)]
        return torch.cat([o for o, _ in outs]), torch.cat([lse for _, lse in outs])

    before = fwd_body_counts()
    o, lse = run()
    body = [b for b, n in fwd_body_delta(before).items() if n]
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    live = lse_ref > ref.NEG_INF / 2
    err = float((o.float() - o_ref.float()).abs().max())
    err_lse = float((lse - lse_ref)[live].abs().max())
    empty_exact = bool(torch.equal(lse[~live], lse_ref[~live])) and bool(
        torch.all(o.transpose(1, 2)[~live] == 0))
    mask = torch.stack([ref.band_mask(m, m, bands[r], stride_q=sq, stride_kv=skv, device="cuda")
                        for r in range(R)])
    empty_rows = int((~mask.any(-1)).sum())
    visible_pairs = int(mask.sum())
    visible_keys = int(mask.any(dim=-2).sum())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None], scale=hd**-0.5)
    item = q.element_size()
    nbytes = (2 * q.numel() + 2 * visible_keys * nkv * hd) * item + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * hd * nh * visible_pairs, dtype)
    tol = TOLS[("flash_attention_fwd", dtype)]
    device_ms, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_fwd", case=f"mesh_block_{kind}", S=MESH_S, rows=m, B=R,
        heads=list(PAPER_HEADS), bands=bands, stride=sq, dtype=DTYPE_NAMES[dtype],
        body=body[0] if len(body) == 1 else body, max_abs_err=err, max_abs_err_lse=err_lse,
        tol=tol, tol_lse=LSE_TOL, empty_rows=empty_rows, empty_rows_exact=empty_exact,
        ms=time_ms(run), device_ms=device_ms.get("flash_attention_fwd", 0.0),
        plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib), bound_ms=bound_ms,
        bound_by=bound_by, visible_pairs=visible_pairs,
    )
    del q, k, v, o, lse, o_ref, lse_ref, mask, qt, kt, vt
    torch.cuda.empty_cache()
    want_body = fa._fwd_plan(R, m, nh, nkv, hd, dtype)[0]
    check(body == [want_body], f"mesh block forward ran {body}, not the {want_body} body: {rec}")
    check(empty_rows > 0, f"the mesh block case must hold rows that see no key: {rec}")
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"mesh block forward disagrees with its plain version: {rec}")
    return rec


def mesh_block_bwd_case(kind, dtype, gen):
    """The backward of block (0, 1) of a = 2 on rank 0 (q chunk 0, kv chunk
    2: row 0 sees no key), one band ([4]) as the executor launches it per
    rank; dq of the rows that see nothing must be exactly 0, dk / dv finite,
    and a second launch bitwise equal."""
    nh, nkv, hd = PAPER_HEADS
    m = MESH_S // MESH_N
    band, sq, skv = mesh_attention._band_for_block(_mesh_cfg_for(kind, 2), 0, 0, 1, m, m)
    band_t = torch.tensor(band, dtype=torch.int32, device="cuda")
    q = randn(gen, 1, m, nh, hd, dtype=dtype)
    k = randn(gen, 1, m, nkv, hd, dtype=dtype)
    v = randn(gen, 1, m, nkv, hd, dtype=dtype)
    do = randn(gen, 1, m, nh, hd, dtype=dtype)
    kw = dict(scale=hd**-0.5, stride_q=sq, stride_kv=skv)
    o, lse = ref.attention_ref(q, k, v, band=band, **kw)
    delta = (do.float() * o.float()).sum(-1)
    run = lambda: fa.flash_attention_bwd(q, k, v, None, lse, do, band_t, delta=delta, **kw)  # noqa: E731
    plain = lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, band=band, delta=delta, **kw)  # noqa: E731
    before = bwd_counts()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    ran = {b: n - before[b] for b, n in bwd_counts().items()}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    mask = ref.band_mask(m, m, band, stride_q=sq, stride_kv=skv, device="cuda")
    blind = ~mask.any(dim=1)
    blind_dq_zero = bool(torch.all(got[0][0][blind] == 0))
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    atol, rtol = BWD_TOLS[dtype]
    errs, ratio = {}, 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        errs[gname] = float(diff.max())
        ratio = max(ratio, float((diff / (atol + rtol * w.float().abs())).max()))
    pairs = int(mask.sum())
    vis_keys, vis_rows = int(mask.any(dim=0).sum()), int(mask.any(dim=1).sum())
    item = q.element_size()
    # as bwd_case: dQ reads q, dO and writes dq for every row, K/V of the
    # visible keys, lse and delta; dK/dV the rows that see a key, all of k, v
    dq_bytes = 3 * m * nh * hd * item + 2 * vis_keys * nkv * hd * item + 2 * nh * m * 4
    dkv_bytes = 2 * vis_rows * nh * hd * item + 4 * m * nkv * hd * item + 2 * nh * vis_rows * 4
    split, _ = device_time(_profiled(run, 5), per=5)
    rec = dict(
        kernel="flash_attention_bwd", case=f"mesh_block_{kind}", S=MESH_S, rows=m,
        heads=list(PAPER_HEADS), band=list(band), stride=sq, dtype=DTYPE_NAMES[dtype],
        ran=ran, max_abs_err=errs, tol_atol=atol, tol_rtol=rtol, max_err_over_tol=ratio,
        bitwise_repeat=bitwise, blind_rows=int(blind.sum()), blind_rows_dq_zero=blind_dq_zero,
        finite=finite, ms_dq=split.get("flash_bwd_dq", 0.0), ms_dkv=split.get("flash_bwd_dkv", 0.0),
        ms_split=split.get("flash_bwd_split", 0.0), ms_pair=time_ms(run, reps=10),
        plain_ms_pair=time_ms(plain, reps=5), visible_pairs_per_head=pairs,
        bound_ms_dq=bound(dq_bytes, 6 * hd * nh * pairs, dtype, BWD_PEAK)[0],
        bound_ms_dkv=bound(dkv_bytes, 8 * hd * nh * pairs, dtype, BWD_PEAK)[0],
    )
    del got, again, want, q, k, v, do, o, lse, delta, mask
    torch.cuda.empty_cache()
    check(ratio <= 1.0 and bitwise and finite and blind_dq_zero and int(blind.sum()) > 0,
          f"mesh block backward disagrees with its plain version or repeats unequal: {rec}")
    return rec


def mesh_counts():
    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
        "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv,
        "flash_bwd_split": fa.split_terms.launches,
        **{f"fwd_{b}": n for b, n in fwd_body_counts().items()},
    }


def _schedules_of(backend, a, kind, seq):
    fwd = S.ring_forward_schedule(MESH_N) if backend == "ring" else None
    cfg = dataclasses.replace(_mesh_cfg_for(kind, a), fwd_schedule=fwd)
    return cfg.schedules(seq)


def _expected_hops(fwd, bwd):
    hops = {}
    for sched in (fwd, bwd):
        for kind, c in S.comm_requirements(sched.a, sched.b, sched.direction, sched.skip).items():
            if c:
                hops[kind] = hops.get(kind, 0) + c
    return hops


def mesh_op_case(kind, dtype, gen):
    """dispatch.distributed_attention over the virtual ring at S 16384, paper
    heads: mesh (a = 2), ring, mesh (a = 4), each in the three comm_overlap
    modes, forward and the gradients of sum(sin(o)), against the local flash
    call on the unstriped sequence."""
    nh, nkv, hd = PAPER_HEADS
    window = MESH_WINDOW if kind == "window" else None
    q = randn(gen, 1, MESH_S, nh, hd, dtype=dtype)
    k = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    v = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    order = torch.from_numpy(stripe_permutation(MESH_S, MESH_N)).cuda()
    inv = torch.from_numpy(unstripe_permutation(MESH_S, MESH_N)).cuda()

    def local():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True, window=window)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    o_ref, g_ref = local()
    o_ref, g_ref = o_ref.detach(), [g.float() for g in g_ref]
    o_max, g_max = float(o_ref.float().abs().max()), [float(g.abs().max()) for g in g_ref]
    tol_o, tol_g = MESH_OP_TOLS[dtype]
    lim_o = tol_o * o_max if MESH_OP_O_RELATIVE[dtype] else tol_o
    comm = CommModel(seq=MESH_S, hidden=nh * hd, n=MESH_N, kv_hidden=nkv * hd,
                     bytes_per_elem=q.element_size())
    xs_striped = [t[:, order].contiguous() for t in (q, k, v)]
    runs, main_counts = [], None
    for backend, a in MESH_BACKENDS:
        fwd_s, bwd_s = _schedules_of(backend, a, kind, MESH_S)
        want_hops = _expected_hops(fwd_s, bwd_s)
        first = None
        for mode in S.COMM_OVERLAP_MODES:
            ring = VirtualRing(MESH_N)
            cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=MESH_N, a=a,
                                               causal=True, window=window, comm_overlap=mode)

            def call():
                xs = [t.detach().requires_grad_(True) for t in xs_striped]
                o = dispatch.distributed_attention(*xs, cfg=cfg)
                return o, torch.autograd.grad(o.float().sin().sum(), xs)

            torch.cuda.synchronize()
            c0 = mesh_counts()
            o, g = call()
            torch.cuda.synchronize()
            counts = {key: n - c0[key] for key, n in mesh_counts().items()}
            hops, nbytes = dict(ring.stats.hops), dict(ring.stats.bytes)
            if first is None:
                o_err = float((o[:, inv].float() - o_ref.float()).abs().max())
                g_err = [float((gg[:, inv].float() - gr).abs().max()) for gg, gr in zip(g, g_ref)]
                first = dict(o=o.detach(), g=[gg.detach() for gg in g])
                rec = dict(backend=backend, a=a, b=MESH_N // a, o_err=o_err, o_limit=lim_o,
                           g_err=g_err, g_limit=[tol_g * x for x in g_max],
                           fwd_blocks=len(fwd_s.blocks()), bwd_blocks=len(bwd_s.blocks()),
                           launches=counts, hops=hops, bytes=nbytes,
                           model_bytes={kk: comm.chunk_bytes(ck) * hops.get(kk, 0)
                                        for kk, ck in (("recv_q", "q"), ("recv_kv", "kv"),
                                                       ("send_o", "o"), ("recv_odoq", "odoq"),
                                                       ("send_dq", "dq"), ("send_dkv", "dkv"))
                                        if hops.get(kk)},
                           bitwise_modes={})
                if backend == "mesh" and a == 2:
                    main_counts = counts
                check(o_err <= lim_o and all(e <= lim for e, lim in zip(g_err, rec["g_limit"])),
                      f"mesh_op: {backend} a={a} disagrees with the local flash call: {rec}")
                n_fwd, n_bwd = len(fwd_s.blocks()), len(bwd_s.blocks()) * MESH_N
                check(counts["flash_attention_fwd"] == n_fwd and counts["flash_bwd_dq"] == n_bwd
                      and counts["flash_bwd_dkv"] == n_bwd,
                      f"mesh_op: launches off the schedules ({n_fwd} forward, {n_bwd} per "
                      f"backward kernel): {rec}")
                check(hops == want_hops, f"mesh_op: hops off comm_requirements {want_hops}: {rec}")
                for kk, ck in (("recv_q", "q"), ("recv_kv", "kv")):
                    check(nbytes.get(kk, 0) == hops.get(kk, 0) * comm.chunk_bytes(ck),
                          f"mesh_op: {kk} bytes off CommModel.chunk_bytes: {rec}")
            else:
                same = bool(torch.equal(o, first["o"])) and all(
                    torch.equal(x, y) for x, y in zip(g, first["g"]))
                rec["bitwise_modes"][mode] = same
                check(same and hops == rec["hops"] and nbytes == rec["bytes"],
                      f"mesh_op: {backend} a={a} {mode} is not bitwise the serial mode: {rec}")
            del o, g
        ring = VirtualRing(MESH_N)
        cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=MESH_N, a=a,
                                           causal=True, window=window)
        fwd_only = lambda: dispatch.distributed_attention(*xs_striped, cfg=cfg)  # noqa: E731

        def fwd_bwd():
            xs = [t.detach().requires_grad_(True) for t in xs_striped]
            o = dispatch.distributed_attention(*xs, cfg=cfg)
            torch.autograd.grad(o.float().sin().sum(), xs)

        rec["ms_fwd"] = time_ms(fwd_only, reps=5, warmup=1)
        rec["ms_fwd_bwd"] = time_ms(fwd_bwd, reps=3, warmup=1)
        rec["device_ms_fwd_bwd"] = _mesh_device_time(_profiled(fwd_bwd, 2), per=2)
        runs.append(rec)
        del first
        torch.cuda.empty_cache()

    def local_fwd():
        return ops.flash_attention(q, k, v, causal=True, window=window)

    out = dict(kind=kind, window=window, dtype=DTYPE_NAMES[dtype], S=MESH_S, n=MESH_N,
               heads=list(PAPER_HEADS), o_max=o_max, g_max=g_max, runs=runs,
               local_ms_fwd=time_ms(local_fwd, reps=5, warmup=1),
               local_ms_fwd_bwd=time_ms(local, reps=3, warmup=1),
               local_device_ms_fwd_bwd=_mesh_device_time(_profiled(local, 2), per=2))
    del q, k, v, xs_striped, o_ref, g_ref
    torch.cuda.empty_cache()
    return out, main_counts


def mesh_op(card):
    """Phase mesh_op: the dispatch seam over the virtual ring (see
    ``mesh_op_case``); the launches of mesh (a = 2) in overlap mode are the
    main path's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases, launches = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            rec, counts = mesh_op_case(kind, dtype, gen)
            cases.append(rec)
            for key, n in counts.items():
                launches[key] = launches.get(key, 0) + n
    emit({"phase": "mesh_op", "card": card, "tols": {DTYPE_NAMES[d]: t
                                                      for d, t in MESH_OP_TOLS.items()},
          "cases": cases, "launches_main": launches})
    return launches


# Algorithm 1's collective form on a 2 x 2 grid of the same 4 ranks
COLLECTIVE_GRID = (2, 2)


def collective_case(kind, dtype, gen):
    """mesh_attention_collective over a virtual ring of 4 (a = b = 2) at S
    16384, paper heads, in the three comm_overlap modes, forward and the
    gradients of sum(sin(o)), against the local flash call and the executor
    (dispatch, mesh a = 2: mesh_op's main call)."""
    nh, nkv, hd = PAPER_HEADS
    a, b = COLLECTIVE_GRID
    window = MESH_WINDOW if kind == "window" else None
    mask = MaskSpec.causal(window=window)
    q = randn(gen, 1, MESH_S, nh, hd, dtype=dtype)
    k = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    v = randn(gen, 1, MESH_S, nkv, hd, dtype=dtype)
    order = torch.from_numpy(stripe_permutation(MESH_S, MESH_N)).cuda()
    inv = torch.from_numpy(unstripe_permutation(MESH_S, MESH_N)).cuda()
    xs_striped = [t[:, order].contiguous() for t in (q, k, v)]

    def local():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True, window=window)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    mesh_cfg = dispatch.AttentionPlanConfig(backend="mesh", transport=VirtualRing(MESH_N),
                                            n=MESH_N, a=a, causal=True, window=window)

    def mesh():
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = dispatch.distributed_attention(*xs, cfg=mesh_cfg)
        return o, torch.autograd.grad(o.float().sin().sum(), xs)

    o_ref, g_ref = local()
    o_ref, g_ref = o_ref.detach().float(), [g.float() for g in g_ref]
    o_mesh, g_mesh = mesh()
    o_mesh, g_mesh = o_mesh[:, inv].detach().float(), [g[:, inv].float() for g in g_mesh]
    o_max, g_max = float(o_ref.abs().max()), [float(g.abs().max()) for g in g_ref]
    tol_o, tol_g = MESH_OP_TOLS[dtype]
    lim_o = tol_o * o_max if MESH_OP_O_RELATIVE[dtype] else tol_o
    lim_g = [tol_g * x for x in g_max]
    elem = q.element_size()
    m = MESH_S // MESH_N
    want_bytes = {"gather_q": (a - 1) * m * nh * hd * elem,
                  "gather_kv": (b - 1) * 2 * m * nkv * hd * elem,
                  "gather_lse": (a - 1) * a * nh * m * 4,
                  "scatter_o": (a - 1) * m * nh * hd * 4}
    rec = dict(kind=kind, window=window, dtype=DTYPE_NAMES[dtype], S=MESH_S, n=MESH_N, a=a, b=b,
               heads=list(PAPER_HEADS), o_limit=lim_o, g_limit=lim_g, bitwise_modes={},
               want_bytes=want_bytes)
    first, main_counts = None, None
    for mode in S.COMM_OVERLAP_MODES:
        ring = VirtualRing(MESH_N)
        torch.cuda.synchronize()
        c0 = mesh_counts()
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = ring.join(mesh_attention_collective(*(ring.split(t) for t in xs), ring, a, b,
                                                mask=mask, comm_overlap=mode))
        g = torch.autograd.grad(o.float().sin().sum(), xs)
        torch.cuda.synchronize()
        counts = {key: n - c0[key] for key, n in mesh_counts().items()}
        if first is None:
            first = dict(o=o.detach(), g=[x.detach() for x in g])
            ou, gu = o.detach()[:, inv].float(), [x[:, inv].float() for x in g]
            rec.update(
                o_err_local=float((ou - o_ref).abs().max()),
                g_err_local=[float((x - y).abs().max()) for x, y in zip(gu, g_ref)],
                o_err_mesh=float((ou - o_mesh).abs().max()),
                g_err_mesh=[float((x - y).abs().max()) for x, y in zip(gu, g_mesh)],
                launches=counts, hops=dict(ring.stats.hops), bytes=dict(ring.stats.bytes),
                messages=dict(ring.stats.messages))
            main_counts = counts
            check(rec["o_err_local"] <= lim_o and rec["o_err_mesh"] <= lim_o
                  and all(e <= lim for e, lim in zip(rec["g_err_local"], lim_g))
                  and all(e <= lim for e, lim in zip(rec["g_err_mesh"], lim_g)),
                  f"collective: disagrees with local flash or mesh a = 2: {rec}")
            check(rec["bytes"] == want_bytes and rec["hops"] == {kk: 1 for kk in want_bytes},
                  f"collective: bytes per kind off (group size - 1) x the chunk: {rec}")
            blocks = a * b
            check(counts["flash_attention_fwd"] == blocks
                  and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == blocks * MESH_N,
                  f"collective: #1 must launch once per (u, w) block ({blocks}), #2 / #3 once "
                  f"per block and rank: {counts}")
        else:
            same = bool(torch.equal(o, first["o"])) and all(
                torch.equal(x, y) for x, y in zip(g, first["g"]))
            rec["bitwise_modes"][mode] = same
            check(same and dict(ring.stats.bytes) == rec["bytes"],
                  f"collective: {mode} is not bitwise the serial mode: {rec}")
        del o, g
    ring = VirtualRing(MESH_N)

    def coll_fwd():
        with torch.no_grad():
            mesh_attention_collective(*(ring.split(t) for t in xs_striped), ring, a, b, mask=mask)

    def coll_fwd_bwd():
        xs = [t.detach().requires_grad_(True) for t in xs_striped]
        o = mesh_attention_collective(*(ring.split(t) for t in xs), ring, a, b, mask=mask)
        torch.autograd.grad(o.float().sin().sum(), xs)

    def mesh_fwd():
        with torch.no_grad():
            dispatch.distributed_attention(*xs_striped, cfg=mesh_cfg)

    rec["ms_fwd"] = time_ms(coll_fwd, reps=5, warmup=1)
    rec["ms_fwd_bwd"] = time_ms(coll_fwd_bwd, reps=3, warmup=1)
    rec["mesh_ms_fwd"] = time_ms(mesh_fwd, reps=5, warmup=1)
    rec["mesh_ms_fwd_bwd"] = time_ms(mesh, reps=3, warmup=1)
    del q, k, v, xs_striped, o_ref, g_ref, o_mesh, g_mesh, first
    torch.cuda.empty_cache()
    return rec, main_counts


def collective(card):
    """Phase collective: Algorithm 1's collective form (see
    ``collective_case``); the serial mode's launches are the main path's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases, launches = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            rec, counts = collective_case(kind, dtype, gen)
            cases.append(rec)
            for key, n in counts.items():
                launches[key] = launches.get(key, 0) + n
    emit({"phase": "collective", "card": card, "tols": {DTYPE_NAMES[d]: t
                                                         for d, t in MESH_OP_TOLS.items()},
          "cases": cases, "launches_main": launches})
    return launches


def train_mesh_parity():
    """paper-mha-7b at full width, 2 layers, fp32, seq 4096: one train step at
    sp_size 4 on the virtual ring (mesh a = 2, and ring) against one at
    sp_size 1, all on the card, from the same weights and batch."""
    cfg = dataclasses.replace(get_config("paper-mha-7b"), num_layers=2)
    opt = AdamWConfig()
    seq = 4096
    params0 = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    ctxs = {
        "sp1": ParallelCtx(device="cuda"),
        "mesh": ParallelCtx(sp_size=MESH_N, attn_impl="mesh", mesh_a=2, device="cuda"),
        "ring": ParallelCtx(sp_size=MESH_N, attn_impl="ring", device="cuda"),
    }
    out, ref_side = {}, None
    for name, ctx in ctxs.items():
        p = _clone_tree(params0)
        state = init_opt_state(p)
        batch = make_batch(cfg, seq, 1, seed=0, step=0, ctx=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, _, metrics = make_train_step(cfg, ctx, opt)(p, state, {}, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        side = dict(loss=loss, grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                    hops=dict(ctx.ring.stats.hops) if ctx.ring is not None else {})
        if ref_side is None:
            ref_side = dict(params=dict(tree_leaves(p)), m=dict(tree_leaves(state.m)), **side)
        else:
            leaves, p_now = {}, dict(tree_leaves(p))
            for path, m_card in tree_leaves(state.m):
                g = m_card / (1 - opt.b1)
                g_ref = ref_side["m"][path] / (1 - opt.b1)
                leaves[path] = dict(
                    grad_max_abs_err=float((g - g_ref).abs().max()),
                    grad_max_abs=float(g_ref.abs().max()),
                    param_max_abs_err=float((p_now[path] - ref_side["params"][path])
                                            .abs().max()),
                )
            side["leaves"] = leaves
            del p_now
        out[name] = side
        del p, state, batch
        torch.cuda.empty_cache()
    rec = {"phase": "train_mesh_parity", "arch": "paper-mha-7b", "num_layers": 2,
           "dtype": "fp32", "seq": seq, "batch": 1, "n": MESH_N, "tols": PARITY_TOLS,
           "sides": {k: {kk: vv for kk, vv in v.items() if kk not in ("params", "m")}
                     for k, v in out.items()}}
    emit(rec)
    del params0, ref_side
    torch.cuda.empty_cache()
    base = out["sp1"]
    for name in ("mesh", "ring"):
        side = out[name]
        check(abs(side["loss"] - base["loss"]) <= PARITY_TOLS["loss"],
              f"train_mesh_parity: {name} loss differs: {side['loss']} vs {base['loss']}")
        check(abs(side["grad_norm"] - base["grad_norm"])
              <= PARITY_TOLS["grad_norm_rel"] * base["grad_norm"],
              f"train_mesh_parity: {name} grad norm differs")
        for path, leaf in side["leaves"].items():
            check(leaf["grad_max_abs_err"] <= PARITY_TOLS["grad_rel"] * leaf["grad_max_abs"],
                  f"train_mesh_parity: {name} gradient of {path} differs: {leaf}")
            check(leaf["param_max_abs_err"] <= PARITY_TOLS["param"],
                  f"train_mesh_parity: {name} updated {path} differs: {leaf}")
        check(side["hops"].get("recv_kv", 0) > 0, f"train_mesh_parity: {name} made no KV hop")


def train_mesh(card):
    """paper-mha-7b at full width cut to MESH_TRAIN_LAYERS layers, fp32 + AdamW,
    remat, seq 16384, batch 1, sp_size 4 on the virtual ring: 2 steps on mesh
    (a = 2), then 2 on ring, through fit; one more mesh step under the
    profiler."""
    cfg = dataclasses.replace(get_config("paper-mha-7b"), num_layers=MESH_TRAIN_LAYERS)
    seq, steps = MESH_S, 2
    runs, launches_main = [], {}
    for impl, a in (("mesh", 2), ("ring", 1)):
        ctx = ParallelCtx(sp_size=MESH_N, attn_impl=impl, mesh_a=a if impl == "mesh" else None,
                          device="cuda")
        fwd_s, bwd_s = _schedules_of(impl, a, "causal", seq)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c0 = mesh_counts()
        t0 = time.perf_counter()
        out = fit(cfg, ctx, TrainConfig(steps=steps, seq=seq, batch=1, seed=0))
        fit_s = time.perf_counter() - t0
        counts = {key: n - c0[key] for key, n in mesh_counts().items()}
        for key, n in counts.items():
            launches_main[key] = launches_main.get(key, 0) + n
        L = cfg.num_layers
        want = {"flash_attention_fwd": 2 * L * len(fwd_s.blocks()) * steps,
                "flash_bwd_dq": L * len(bwd_s.blocks()) * MESH_N * steps}
        want["flash_bwd_dkv"] = want["flash_bwd_split"] = want["flash_bwd_dq"]
        run = dict(attn=impl, a=a, losses=out["history"], step_s=out["step_seconds"],
                   tokens_per_s=[seq / t for t in out["step_seconds"]], fit_s=fit_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches_per_step={k: n / steps for k, n in counts.items()},
                   want_launches_per_step={k: n / steps for k, n in want.items()},
                   hops_per_step={k: n / steps for k, n in ctx.ring.stats.hops.items()},
                   bytes_per_step={k: n / steps for k, n in ctx.ring.stats.bytes.items()},
                   params=tfm.param_count(out["params"]))
        if impl == "mesh":
            run["profile"] = _profile_mesh_step(cfg, ctx, out.pop("params"), seq)
        runs.append((run, counts, want))
        del out
        torch.cuda.empty_cache()
    rec = {"phase": "train_mesh", "arch": "paper-mha-7b", "num_layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "param_dtype": "fp32", "optimizer": "adamw", "remat": True,
           "seq": seq, "batch": 1, "n": MESH_N, "ring": "VirtualRing",
           "reduced": {"num_layers": f"{get_config('paper-mha-7b').num_layers} -> "
                                     f"{cfg.num_layers} (fp32 params + AdamW at seq 16384)"},
           "ln_vocab": float(np.log(cfg.vocab_size)), "runs": [r for r, _, _ in runs],
           "card": card}
    emit(rec)
    for run, counts, want in runs:
        losses = run["losses"]
        check(len(losses) == steps and all(np.isfinite(losses))
              and abs(losses[0] - np.log(cfg.vocab_size)) < 1.5,
              f"train_mesh: {run['attn']} losses not finite or not near ln(vocab): {losses}")
        check(all(counts[k] == n for k, n in want.items()),
              f"train_mesh: {run['attn']} launches off the schedules x layers x remat: "
              f"{counts} vs {want}")
        check(counts["fwd_fp32"] == counts["flash_attention_fwd"],
              f"train_mesh: the fp32 forward must run the fp32 body: {counts}")
    return launches_main


def _profile_mesh_step(cfg, ctx, params, seq):
    """Device time per kernel class (the hops' and layout's copies apart) of
    one more mesh train step under torch.profiler; after the counted run."""
    from torch.profiler import ProfilerActivity, profile

    state = init_opt_state(params)
    step_fn = make_train_step(cfg, ctx, AdamWConfig(total_steps=2))
    batch = make_batch(cfg, seq, 1, seed=0, step=2, ctx=ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, metrics = step_fn(params, state, {}, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = _mesh_device_time(prof)
    busy = sum(device_ms.values())
    del state, params
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if device_ms else None}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {**(ptxas_summary(libs["flash_fwd_tc"]) or {}),
             **(ptxas_summary(libs["flash_bwd"], prefix="flash_bwd_") or {}),
             **(ptxas_summary(libs["paged_decode"], prefix="paged_decode_") or {}),
             **(ptxas_summary(libs["ssd_scan"], prefix="ssd_scan_") or {})}
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "build_s": build_s,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas})

    check(not any(k.get("serialized_wgmma") for k in ptxas.values()),
          f"ptxas serialized the wgmma products of a tensor-core kernel: {ptxas}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash, paged, bwd = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1024, 2048):
            for name in ("causal", "window", "striped", "segment", "decode", "verify", "chunk"):
                flash.append(flash_case(name, S, dtype, gen))
        # hymba-1.5b's attention: window prefill, and the dense-cache decode
        # tick of its 8 slots over max_seq 2048
        for S in (1024, 1536):
            flash.append(flash_case("window", S, dtype, gen, heads=HYMBA_HEADS))
        flash.append(flash_case("decode", 2048, dtype, gen, heads=HYMBA_HEADS))
    # the ring's chunk and verify launches: 4 ranks x 8 slots folded, stride 4
    ring_flash = [flash_case(name, 2048, torch.bfloat16, gen, ranks=RING_N)
                  for name in ("chunk", "verify")]
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = lambda: scratch.add_(1)  # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 512):
            paged.append(paged_case(window, dtype, gen, flush))
    quant = []
    for kv_dtype in QUANT_DTYPES:
        for dtype in (torch.float32, torch.bfloat16):
            for window in (None, 512):
                quant.append(quant_paged_case(kv_dtype, window, dtype, gen, flush))
    # sequence-sharded decode over a ring of 4: the ranks folded into one
    # launch, beside the n = 1 rows above
    ring_paged = [ring_paged_case(kv_dtype, gen, flush) for kv_dtype in ("fp", "int8")]
    del scratch
    combine = [split_combine_case(dtype, gen) for dtype in (torch.float32, torch.bfloat16)]
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ssd_cases = [
        ssd_case("mamba2", 1, 2048, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("mamba2", 1, 1536, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("mamba2_short_chunk", 1, 48, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("hymba", 1, 1024, 50, 64, 1, 16, 64, gen, flush),
        ssd_case("mamba2_batch4", 4, 512, 32, 64, 1, 128, 64, gen, flush),
        ssd_case("reduced", 1, 256, 16, 16, 1, 16, 8, gen, flush),
        ssd_case("mamba2_large_dt", 1, 2048, 32, 64, 1, 128, 64, gen, flush, dt_value=3.0),
    ]
    del scratch
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1024, 2048, 4096):
            for name in ("causal", "window", "striped", "segment"):
                if S != 2048 or name == "causal":
                    bwd.append(bwd_case(name, S, dtype, gen))
    split = split_case(4096, gen)
    # the mesh executor's blocks: 4 ranks folded into the forward's batch,
    # the backward per rank; row 0 of some ranks sees no key
    mesh_blocks = []
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("causal", "window"):
            mesh_blocks.append(mesh_block_case(kind, dtype, gen))
            mesh_blocks.append(mesh_block_bwd_case(kind, dtype, gen))
    emit({"phase": "kernels", "card": card,
          "cases": flash + paged + quant + combine + ssd_cases + bwd + [split] + mesh_blocks
          + ring_flash + ring_paged})

    cross_device()
    launches, serve_rec, serve_streams = full_serve(card)
    cpu_runs = cross_device_quant()
    quant_launches, quant_runs, quant_streams = full_serve_quant(card)
    launches["paged_flash_decode_quant"] = quant_launches["paged_flash_decode_quant"]
    # serving over a ring of 4 ranks on the card
    ring_slice = slice_ring(cpu_runs)
    ring = serve_ring(card, serve_rec, serve_streams)
    # serving under memory pressure: preempt-and-recompute and the chaos
    # injector, card vs CPU at 2 layers, then granite-8b in full
    slice_pressure()
    pressure = serve_pressure(card, quant_runs, quant_streams)
    cross_device_ssm()
    launches["ssd_scan_fwd"], launches["flash_attention_fwd (decode)"] = full_serve_ssm(card)
    # serve_ring's launches join the serving rows
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (decode)", "fwd_decode"),
                      ("paged_flash_decode", "paged_flash_decode")):
        launches[key] += ring[part]
    train_parity()
    launches.update(full_train(card))
    # slice_ring's fp32 chunks and verifies, and its quantized decode ticks
    launches["flash_attention_fwd (fp32)"] += ring_slice["fwd_fp32"]
    launches["paged_flash_decode_quant"] += ring_slice["paged_flash_decode_quant"]
    # serve_pressure's fp and int8 runs (the chaos runs are gates, not counted)
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (fp32)", "fwd_fp32"),
                      ("paged_flash_decode", "paged_flash_decode"),
                      ("paged_flash_decode_quant", "paged_flash_decode_quant")):
        launches[key] += pressure[part]
    # the Mesh-Attention path: the dispatch seam and paper-mha-7b training
    # over a virtual ring of 4 ranks; their main runs' launches join the counts
    mesh = [mesh_op(card), collective(card)]
    train_mesh_parity()
    mesh.append(train_mesh(card))
    for key, part in (("flash_attention_fwd (tile)", "fwd_tile"),
                      ("flash_attention_fwd (fp32)", "fwd_fp32"),
                      ("flash_bwd_dq", "flash_bwd_dq"), ("flash_bwd_dkv", "flash_bwd_dkv"),
                      ("flash_bwd_split", "flash_bwd_split")):
        launches[key] += sum(m[part] for m in mesh)

    main_flash = next(r for r in flash
                      if r["case"] == "causal" and r["S"] == 2048 and r["dtype"] == "bf16")
    # the decode body's main path: hymba's dense-cache ticks
    main_flash_decode = next(r for r in flash if r["case"] == "decode" and r["dtype"] == "bf16"
                             and r["heads"] == list(HYMBA_HEADS))
    # the fp32 body's main path: the training forward
    main_flash_fp32 = next(r for r in flash
                           if r["case"] == "causal" and r["S"] == 2048 and r["dtype"] == "fp32")
    main_paged = next(r for r in paged if r["case"] == "full" and r["dtype"] == "bf16")
    main_quant = next(r for r in quant if r["case"] == "full" and r["dtype"] == "bf16"
                      and r["kv_dtype"] == "int8")
    main_ssd = next(r for r in ssd_cases if r["case"] == "mamba2" and r["S"] == 2048)
    # the ranks' combine on the ring's decode path: the split combine kernel
    # over the folded fp pool's partials
    ring_combine = next(r for r in ring_paged if r["kv_dtype"] == "fp")["combine"]
    # the training path runs the backward in fp32 at 4096 causal tokens
    main_bwd = next(r for r in bwd
                    if r["case"] == "causal" and r["S"] == 4096 and r["dtype"] == "fp32")
    kernels = []
    for name, key, src, replaces, rec in (
        ("flash_attention_fwd", "flash_attention_fwd (tile)", FLASH_TC_SRC, FLASH_REPLACES,
         main_flash),
        ("flash_attention_fwd (decode body)", "flash_attention_fwd (decode)", FLASH_TC_SRC,
         FLASH_REPLACES, main_flash_decode),
        ("flash_attention_fwd (fp32 body)", "flash_attention_fwd (fp32)", FLASH_SRC,
         FLASH_REPLACES, main_flash_fp32),
        ("paged_flash_decode", "paged_flash_decode", PAGED_SRC, PAGED_REPLACES, main_paged),
        ("paged_flash_decode (quantized branch)", "paged_flash_decode_quant", PAGED_SRC,
         QUANT_REPLACES, main_quant),
        ("ssd_scan_fwd", "ssd_scan_fwd", SSD_SRC, SSD_REPLACES, main_ssd),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    # plain_ms and library_ms of the backward pair are the pair's: both the
    # plain backward and the SDPA backward compute dq, dk and dv together
    for name, replaces, part, err in (
        ("flash_bwd_dq", BWD_DQ_REPLACES, "dq", main_bwd["max_abs_err"]["dq"]),
        ("flash_bwd_dkv", BWD_DKV_REPLACES, "dkv",
         max(main_bwd["max_abs_err"]["dk"], main_bwd["max_abs_err"]["dv"])),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": BWD_SRC, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": main_bwd[f"ms_{part}"],
            "plain_ms": main_bwd["plain_ms_pair"], "bound_ms": main_bwd[f"bound_ms_{part}"],
            "bound_by": main_bwd[f"bound_by_{part}"],
            "library_ms": main_bwd["library_ms_pair"],
        })
    kernels.append({
        "name": "paged_decode_combine (the ring's lse combine)", "route": "cuda",
        "source": PAGED_SRC, "replaces": PAGED_REPLACES,
        "launches": ring["paged_decode_combine"], "max_abs_err": ring_combine["max_abs_err"],
        "ms": ring_combine["ms"], "plain_ms": ring_combine["plain_ms"],
        "bound_ms": ring_combine["bound_ms"], "bound_by": ring_combine["bound_by"],
        "library_ms": None,
    })
    # the fp32 body's pre-pass: part of #2 and #3 on the training path
    kernels.append({
        "name": "flash_bwd_split (fp32 pre-pass of #2, #3)", "route": "cuda", "source": BWD_SRC,
        "replaces": f"{BWD_DQ_REPLACES}, {BWD_DKV_REPLACES}", "launches": launches["flash_bwd_split"],
        "max_abs_err": split["max_abs_err"], "ms": split["device_ms"], "plain_ms": split["plain_ms"],
        "bound_ms": split["bound_ms"], "bound_by": split["bound_by"], "library_ms": None,
    })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
