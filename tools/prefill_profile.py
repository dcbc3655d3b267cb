#!/usr/bin/env python3
"""Where one granite-8b prefill launch spends its device time.

    python3 tools/prefill_profile.py [--src DIR] [--lengths 512,1500] [--reps 3]

Serves granite-8b at full width and depth in bf16 (seeded random weights)
through the ``repro_torch`` package found under ``--src`` (default: this
checkout's ``src``), on the paged pool the smoke's ``serve`` phase uses (page
16, max_seq 2048, 8 slots).  After a warm-up request, each prompt length is
prefilled ``--reps`` times, one request at a time, under torch.profiler: one
engine step admits the request and runs its one-shot prefill launch (the
request asks for one token, which comes off the prefill's logits).  Prints
one JSON line per length: device ms per kernel class (the flash forward,
matmuls, the rest), the flash forward's share, and the step's host wall
time.  Giving ``--src`` the parent commit's tree times the kernels before a
change; one call with both trees compares them on one card.  Needs a CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_attention_fwd"
    if "paged_decode" in name:
        return "paged_flash_decode"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--lengths", default="512,1500")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("prefill_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
    ))
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    for n in (int(x) for x in args.lengths.split(",")):
        device, walls = {}, []
        for _ in range(args.reps):
            eng.submit(rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), 1,
                       arrival_tick=eng.tick_stats()["ticks"])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / args.reps
                cls = kernel_class(ev.key)
                device[cls] = device.get(cls, 0.0) + ms
            eng.run()  # drain
        busy = sum(device.values())
        print(json.dumps({
            "src": os.path.relpath(os.path.abspath(args.src), ROOT), "prompt": n,
            "reps": args.reps, "device_ms": device, "device_busy_ms": busy,
            "flash_share": device.get("flash_attention_fwd", 0.0) / busy if busy else None,
            "step_wall_ms": walls, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
