#!/usr/bin/env python3
"""The paged decode's device time at the main rows and in a decode tick, one tree at a time.

    python3 tools/paged_profile.py [--src DIR] [--reps 10] [--ticks 4]

Calls ``paged_flash_decode`` of the ``repro_torch`` package found under
``--src`` (default: this checkout's ``src``) at the serving pool's main row:
8 slots at depths 1 ... 2047 (one empty), page 16, max_seq 2048,
granite-8b's heads (32 / 8 of 128), bf16 queries, over a bf16, an int8 and
an fp8 pool (seeded random data).  For each it prints one JSON line: the
device ms per call of the paged kernels (main and combine) under
torch.profiler with the L2 cache flushed before each call, and the call's
ms by CUDA events.  Then it serves granite-8b at full width and depth (bf16,
seeded random weights, paged pool of page 16) and profiles ``--ticks``
decode ticks of 8 slots at depth ~128: device ms per tick by kernel class
(paged decode, flash forward, matmuls, other), top-level aten calls per
tick and the host's wall ms per tick.  Every line carries the card's name
and power limit.  Giving ``--src`` the parent commit's tree times the kernels
before a change; one call with both trees, in turns, compares them on one
card.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name: str) -> str:
    if "paged_decode_" in name:  # this tree's main kernels and combine; the parent's kernel
        return "paged"
    if "flash_fwd_" in name:
        return "flash"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("paged_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import kv_quant
    from repro_torch.kernels import paged_decode as pk
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    src = os.path.relpath(os.path.abspath(args.src), ROOT)

    def device_ms(prof, per):
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            ms = (ev.self_cuda_time_total if us is None else us) / 1e3 / per
            cls = kernel_class(ev.key)
            out[cls] = out.get(cls, 0.0) + ms
        return out

    # the main rows: chip_smoke.py's paged cases
    B, ps, max_pages, H, HKV, D = 8, 16, 128, 32, 8, 128
    depths = [1, 17, 250, 777, 1000, 1500, 2047, 0]
    rng = np.random.default_rng(5)
    num_pages = B * max_pages
    perm = rng.permutation(num_pages)
    bt = np.full((B, max_pages), -1, np.int32)
    nxt = 0
    for b, depth in enumerate(depths):
        n = -(-depth // ps)
        bt[b, :n] = perm[nxt:nxt + n]
        nxt += n
    bt = torch.from_numpy(bt).cuda()
    pos = torch.tensor([d - 1 for d in depths], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    for pool in ("bf16", "int8", "fp8"):
        kv = [torch.randn(num_pages, ps, HKV, D, generator=gen, device="cuda") for _ in range(2)]
        if pool == "bf16":
            (k, v), kw = [t.to(torch.bfloat16) for t in kv], {}
        else:
            (k, ks), (v, vs) = (kv_quant.quantize(t, pool) for t in kv)
            kw = dict(k_scale=ks, v_scale=vs)
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        run = lambda: pk.paged_flash_decode(q, k, v, bt, pos, 0, stride_kv=1, **kw)  # noqa: E731
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
        print(json.dumps({
            "src": src, "card": card, "row": "main", "pool": pool, "q": "bf16",
            "depths": depths, "page_size": ps,
            "paged_device_ms": device_ms(prof, args.reps).get("paged", 0.0),
            "events_ms": float(np.median(times)),
        }), flush=True)
        del k, v, kv, kw
    del scratch
    torch.cuda.empty_cache()

    # one decode tick of granite-8b at depth ~128
    cfg = get_config("granite-8b")
    params = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = ServeEngine(cfg, params, ParallelCtx(device="cuda"), serve=ServeConfig(
        max_seq=2048, num_slots=8, paged=True, page_size=16, cache_dtype=torch.bfloat16,
    ))
    eng.generate(np.arange(32, dtype=np.int32)[None], max_new_tokens=2)  # warm-up
    rng = np.random.default_rng(3)
    now = eng.tick_stats()["ticks"]
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, (128,), dtype=np.int32), args.ticks + 3,
                   arrival_tick=now)
    eng.step()  # admission and prefill, outside the window
    eng.step()  # one decode tick, outside the window
    torch.cuda.synchronize()
    launches0 = pk.paged_flash_decode.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
    launches = (pk.paged_flash_decode.launches - launches0) / args.ticks
    eng.run()
    aten = sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    by_class = device_ms(prof, args.ticks)
    print(json.dumps({
        "src": src, "card": card, "row": "decode_tick", "arch": "granite-8b", "slots": 8,
        "depth": 128, "ticks": args.ticks, "device_ms_per_tick": by_class,
        "paged_launches_per_tick": launches, "aten_calls_per_tick": aten / args.ticks,
        "wall_ms_per_tick": wall_ms,
        "device_idle_share": 1 - sum(by_class.values()) / wall_ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
