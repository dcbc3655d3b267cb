#!/usr/bin/env python3
"""Device time of the flash forward's two bodies at small packed-row counts,
bf16 and fp32: where the decode body should take over from the tile body.

    python3 tools/fwd_body_sweep.py

For granite-8b's heads (32 / 8 of 128) and hymba-1.5b's (25 / 5 of 64), 8
batch rows over 2,048 cached keys, each row at its own depth (seeded), and
Sq from 1 up to past ``DECODE_MAX_ROWS`` packed rows (Sq x H / Hkv), it
launches the tile body and the decode body (at the key splits the wrapper's
``_fwd_plan`` would pick for that shape, and with one split) straight
through their C entry points and prints one JSON line per shape and type
with each one's device ms (torch.profiler, mean of 10 launches).  fp32 inputs
go in as the pre-pass's two bf16 terms, split once before the timing (the
pre-pass is the same for both bodies).  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def device_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps


def main():
    if not torch.cuda.is_available():
        print("fwd_body_sweep: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lib = _build.load("flash_fwd_tc")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, Skv = 8, 2048
    stream = torch.cuda.current_stream().cuda_stream
    for (H, Hkv, D), dtype in ((h, t) for h in ((32, 8, 128), (25, 5, 64))
                               for t in (torch.bfloat16, torch.float32)):
        G = H // Hkv
        for Sq in range(1, fa.DECODE_MAX_ROWS // G + 3):
            q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
            k = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").to(dtype)
            v = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").to(dtype)
            plan = fa._fwd_plan(B, Sq, H, Hkv, D, dtype)
            terms = fa.FWD_TERMS[plan[0]]
            operands = fa.fwd_split_terms(q, k, v) if terms > 1 else (q, k, v)
            pos = np.random.default_rng(Sq).integers(0, Skv - Sq + 1, B).astype(np.int32)
            band = torch.tensor([[p, 0, 0, ref.BAND_INF] for p in pos], dtype=torch.int32,
                                device="cuda")
            o = torch.empty_like(q)
            lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
            ptrs = (*(t.data_ptr() for t in operands), band.data_ptr(), 4, None, None,
                    o.data_ptr(), lse.data_ptr())
            dims = (B, Sq, Skv, H, Hkv, D, float(D**-0.5), 1, 1, terms)
            rec = {"H": H, "Hkv": Hkv, "D": D, "B": B, "Skv": Skv, "Sq": Sq, "packed_rows": Sq * G,
                   "dtype": "fp32" if dtype == torch.float32 else "bf16", "plan": list(plan),
                   "card": card}
            rec["tile_ms"] = device_ms(lambda: _build.check(
                lib.flash_fwd_tile(*ptrs, *dims, stream), "flash_fwd_tile"))
            if Sq * G <= fa.DECODE_MAX_ROWS:
                plan_splits = plan[1]
                for splits in sorted({1, plan_splits}):
                    o_parts = torch.empty((splits, B, Sq, H, D), device="cuda")
                    lse_parts = torch.empty((splits, B, H, Sq), device="cuda")
                    rec[f"decode_ms_splits{splits}"] = device_ms(lambda: _build.check(
                        lib.flash_fwd_decode(*ptrs[:9], o_parts.data_ptr(), lse_parts.data_ptr(),
                                             splits, *dims, stream), "flash_fwd_decode"))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
