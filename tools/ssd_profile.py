#!/usr/bin/env python3
"""The SSD chunked scan's device time at the main rows and in a prefill, one tree at a time.

    python3 tools/ssd_profile.py [--src DIR] [--reps 10] [--prefill 1536] [--prefill-reps 2]

Calls ``ssd_scan_fwd`` of the ``repro_torch`` package found under ``--src``
(default: this checkout's ``src``) at mamba2-370m's main row (B 1, S 2048,
H 32, P 64, N 128, chunk 64) and hymba-1.5b's (B 1, S 1024, H 50, P 64, N 16),
fp32 inputs as the model gives them (seeded random data).  For each it
prints one JSON line: the device ms per call of the SSD kernels under
torch.profiler with the L2 cache flushed before each call (in all and by
kernel), and the call's ms by CUDA events, also L2 flushed.  The same for
the scan's backward ``ssd_scan_bwd`` (#5b) at those rows, at the train rows
(mamba2 B 4 x 4096, hymba B 2 x 4096) and at the sharded scan's folded
ranks (mamba2, 4 x 384 rows, with a random gradient of the final state),
with a random dy; a tree without the backward prints one line that says
so.  Kernels are named by their ``ssd_scan_*_kernel`` / ``ssd_bwd_*_kernel``
stem.  ``--prefill 0`` stops there; otherwise it serves
mamba2-370m at full width and depth (bf16, seeded random weights, dense
cache, max_seq 2048, 8 slots) and profiles ``--prefill-reps`` prefill launches
of ``--prefill`` tokens, one request at a time: device ms per kernel class
(the SSD scan, matmuls, the rest), the SSD scan's share of the device time,
and the step's host wall ms.  Every line carries the card's name and power
limit.  Giving ``--src`` the parent commit's tree times the kernel before a
change; one call with both trees, in turns, compares them on one card.
Needs a CUDA device.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name: str) -> str:
    if "ssd_bwd_" in name:  # the backward's four kernels
        return "ssd_scan_bwd"
    if "ssd_scan" in name:  # this tree's four kernels; the parent's one
        return "ssd_scan_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--prefill", type=int, default=1536)
    ap.add_argument("--prefill-reps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ssd_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    src = os.path.relpath(os.path.abspath(args.src), ROOT)

    def device_ms(prof, per):
        by_class, by_kernel = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / per
            cls = kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            if cls.startswith("ssd_scan"):
                stem = re.search(r"ssd_(?:scan|bwd)_[a-z]+_kernel", ev.key)
                key = stem.group(0) if stem else ev.key[:60]
                by_kernel[key] = by_kernel.get(key, 0.0) + ms
        return by_class, by_kernel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    rows = {"mamba2": (1, 2048, 32, 64, 1, 128, 64), "hymba": (1, 1024, 50, 64, 1, 16, 64)}
    train_rows = {"mamba2_train": (4, 4096, 32, 64, 1, 128, 64),
                  "hymba_train": (2, 4096, 50, 64, 1, 16, 64),
                  "mamba2_ring4": (4, 384, 32, 64, 1, 128, 64)}  # with d(final state)
    has_bwd = hasattr(ssd, "ssd_scan_bwd")
    if not has_bwd:
        print(json.dumps({"src": src, "card": card, "ssd_scan_bwd": "absent in this tree"}),
              flush=True)
    cases = [("ssd_scan_fwd", row, shape) for row, shape in rows.items()]
    if has_bwd:
        cases += [("ssd_scan_bwd", row, shape) for row, shape in {**rows, **train_rows}.items()]
    for kernel, row, (B, S, H, P, G, N, chunk) in cases:
        rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        x, Bm, Cm = rn(B, S, H, P), rn(B, S, G, N), rn(B, S, G, N)
        dt, A = F.softplus(rn(B, S, H)), -torch.exp(0.5 * rn(H))
        if kernel == "ssd_scan_fwd":
            run = lambda: ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)  # noqa: E731
        else:
            dy = rn(B, S, H, P)
            ds = rn(B, H, P, N) if row.endswith("ring4") else None
            run = lambda: ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, ds, chunk=chunk)  # noqa: E731
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                scratch.add_(1)
                run()
            torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            scratch.add_(1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        by_class, by_kernel = device_ms(prof, args.reps)
        print(json.dumps({
            "src": src, "card": card, "kernel": kernel, "row": row, "B": B, "S": S, "H": H,
            "P": P, "G": G, "N": N, "chunk": chunk, "ssd_device_ms": by_class.get(kernel, 0.0),
            "ssd_device_ms_by_kernel": by_kernel, "events_ms": float(np.median(times)),
        }), flush=True)
    del scratch
    torch.cuda.empty_cache()
    if args.prefill == 0:
        return 0

    # prefill launches of mamba2-370m at full width and depth
    cfg = get_config("mamba2-370m")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=2048, num_slots=8, cache_dtype=torch.bfloat16,
    ))
    eng.generate(np.arange(64, dtype=np.int32)[None], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    device, walls = {}, []
    launches0 = ssd.ssd_scan_fwd.launches
    for _ in range(args.prefill_reps):
        eng.submit(rng.integers(0, cfg.vocab_size, (args.prefill,), dtype=np.int32), 1,
                   arrival_tick=eng.tick_stats()["ticks"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()  # admission and the one-shot prefill launch
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        for cls, ms in device_ms(prof, args.prefill_reps)[0].items():
            device[cls] = device.get(cls, 0.0) + ms
        eng.run()  # drain
    busy = sum(device.values())
    print(json.dumps({
        "src": src, "card": card, "prefill": args.prefill, "arch": "mamba2-370m",
        "num_layers": cfg.num_layers, "reps": args.prefill_reps, "device_ms": device,
        "device_busy_ms": busy,
        "ssd_share": device.get("ssd_scan_fwd", 0.0) / busy if busy else None,
        "ssd_calls": ssd.ssd_scan_fwd.launches - launches0, "step_wall_ms": walls,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
