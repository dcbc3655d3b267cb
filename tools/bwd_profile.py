#!/usr/bin/env python3
"""The flash backward's device time at the training row, one tree at a time.

    python3 tools/bwd_profile.py [--src DIR] [--seq 4096] [--reps 5] [--heads H,HKV,D]

Calls ``flash_attention_bwd`` of the ``repro_torch`` package found under
``--src`` (default: this checkout's ``src``) at granite-8b's heads (32 / 8 of
128; ``--heads 16,16,256`` for gemma-7b's), batch 1, causal, ``--seq``
tokens, in fp32 and in bf16 (seeded random
inputs; the forward's saved state from the plain version).  Prints one JSON
line per type: the device ms of each backward kernel (dQ, dK/dV, and the
fp32 pre-pass where the tree has one) under torch.profiler, the call's ms by
CUDA events, SDPA's backward in the same process (one PyTorch call, the
yardstick), and the card's name and power limit.  Giving ``--src`` the
parent commit's tree times the kernels before a change; one call with both
trees, in turns, compares them on one card.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name: str) -> str:
    for part in ("dq", "dkv", "split"):
        if f"flash_bwd_{part}_kernel" in name:
            return f"flash_bwd_{part}"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--heads", default="32,8,128", help="query heads, kv heads, head dim")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("bwd_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    (H, HKV, D), S = (int(x) for x in args.heads.split(",")), args.seq
    band = (0, 0, 0, ref.BAND_INF)

    def events_ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(0)
        q, k, v, do = (
            torch.from_numpy(rng.standard_normal((1, S, h, D)).astype(np.float32)).cuda().to(dtype)
            for h in (H, HKV, HKV, H)
        )
        o, lse = ref.attention_ref(q, k, v, scale=D**-0.5, band=band)
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, band, scale=D**-0.5)  # noqa: E731
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                run()
            torch.cuda.synchronize()
        device_ms = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / args.reps
            cls = kernel_class(ev.key)
            device_ms[cls] = device_ms.get(cls, 0.0) + ms
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=D**-0.5,
                                             enable_gqa=True)
        dout = do.transpose(1, 2)
        sdpa = lambda: torch.autograd.grad(out, (qt, kt, vt), dout, retain_graph=True)  # noqa: E731
        print(json.dumps({
            "src": os.path.relpath(os.path.abspath(args.src), ROOT), "card": card,
            "dtype": "fp32" if dtype == torch.float32 else "bf16", "seq": S,
            "heads": [H, HKV, D], "device_ms": device_ms,
            "kernels_ms": sum(v for k, v in device_ms.items() if k != "other"),
            "events_ms": events_ms(run), "sdpa_bwd_ms": events_ms(sdpa),
        }), flush=True)
        del q, k, v, do, o, lse, qt, kt, vt, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
