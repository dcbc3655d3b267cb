#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env      -- card name and power limit (nvidia-smi), torch/CUDA versions,
                 and the time to build the CUDA kernels from ``src/repro_torch/csrc``
                 (one nvcc per source, all started at once).
  2. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
                 at the main path's shapes (granite-8b heads: H=32, Hkv=8, D=128),
                 in fp32 and bf16: max |delta| against the stated tolerance, the
                 kernel's time, the plain version's time, the library call's time
                 where one PyTorch call computes the same function, and the bound.
  3. slice    -- granite-8b at full width, depth cut to 2 layers, fp32: the same
                 weights served by the engine on the card (kernels) and on the
                 CPU (plain versions), dense and paged caches; the greedy streams
                 must be identical and the first-token logits within 1e-3.
  4. serve    -- granite-8b at full width and depth in bf16 (seeded random
                 weights): ServeEngine over the paged pool serves eight requests
                 of mixed lengths and arrival ticks, 32 new tokens each.  The
                 kernels' launch counters are set to 0 just before this run and
                 read just after it: both kernels must have run.
  5. the kernels line, the card line, and the final line
     ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero without the final
line.  It exits non-zero at once when CUDA is not available.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_decode as pk  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.context import ParallelCtx  # noqa: E402
from repro_torch.serve.config import ServeConfig  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores, no TF32
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
# lse is fp32 for either input type (largest reading 1.9e-6); skipping one
# 16-token page at depth ~1500 moves it by ~1e-2
LSE_TOL = 1e-4
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

FLASH_SRC = "src/repro_torch/csrc/flash_fwd.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:153"
PAGED_SRC = "src/repro_torch/csrc/paged_decode.cu"
PAGED_REPLACES = "src/repro/kernels/paged_decode.py:205"

# granite-8b attention geometry
H, HKV, D = 32, 8, 128


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(record):
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def flash_case(name, S, dtype, gen):
    """One flash-forward case at granite-8b's heads."""
    INF = ref.BAND_INF
    B, Sq, Skv, sq, skv, seg = 1, S, S, 1, 1, None
    band = (0, 0, 0, INF)
    if name == "window":
        band = (0, 0, 0, 255)
    elif name == "striped":
        band, sq, skv = (1, 0, 0, INF), 2, 2
    elif name == "segment":
        cuts = np.sort(np.random.default_rng(S).choice(np.arange(1, S), 5, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(S), side="right").astype(np.int32)).cuda()
    elif name == "decode":
        B, Sq = 8, 1
        pos = torch.from_numpy(np.random.default_rng(S).integers(0, S, B).astype(np.int32)).cuda()
        band = torch.stack([pos, 0 * pos, 0 * pos, 0 * pos + INF], dim=1)
    q = randn(gen, B, Sq, H, D, dtype=dtype)
    k = randn(gen, B, Skv, HKV, D, dtype=dtype)
    v = randn(gen, B, Skv, HKV, D, dtype=dtype)
    kw = dict(scale=D**-0.5, stride_q=sq, stride_kv=skv, seg_q=seg, seg_kv=seg)
    plain_band = band if not isinstance(band, torch.Tensor) else tuple(band[:, i] for i in range(4))
    run = lambda: fa.flash_attention_fwd(q, k, v, band, **kw)  # noqa: E731
    plain = lambda: ref.attention_ref(q, k, v, band=plain_band, **kw)  # noqa: E731
    o, lse = run()
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
            qt, kt, vt, is_causal=True, scale=D**-0.5, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=attn_mask, scale=D**-0.5, enable_gqa=True)
    item = q.element_size()
    # q read and o written once, the visible keys' K and V read once, lse
    # written, the segment ids read
    nbytes = (2 * q.numel() + 2 * visible_keys * HKV * D) * item + lse.numel() * 4 \
        + (2 * seg.numel() * 4 if seg is not None else 0)
    flops = 4 * D * H * visible_pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    tol = TOLS[("flash_attention_fwd", dtype)]
    rec = dict(
        kernel="flash_attention_fwd", case=name, S=S, B=B, Sq=Sq, dtype=DTYPE_NAMES[dtype],
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run), plain_ms=time_ms(plain), library_ms=time_ms(lib),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=visible_pairs,
        visible_keys=visible_keys,
    )
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"flash_attention_fwd disagrees with its plain version: {rec}")
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
        max_abs_err=err, max_abs_err_lse=err_lse, tol=tol, tol_lse=LSE_TOL,
        empty_rows_exact=empty_exact,
        ms=time_ms(run, flush=flush), plain_ms=time_ms(plain, flush=flush), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, visible_tokens=visible_tokens,
        visible_pages=visible_pages,
    )
    check(err <= tol and err_lse <= LSE_TOL and empty_exact,
          f"paged_flash_decode disagrees with its plain version: {rec}")
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
    lengths = [96, 200, 333, 512, 640, 777, 1000, 1500]
    arrivals = [0, 0, 1, 2, 3, 5, 8, 13]
    fa.flash_attention_fwd.launches = 0
    pk.paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    res = serve_trace(eng, lengths, [a + skip for a in arrivals], 32, cfg.vocab_size, seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "paged_flash_decode": pk.paged_flash_decode.launches}
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
        "launches": launches, "card": card,
    }
    rec["decode_profile"] = profile_decode(eng, cfg)
    emit(rec)
    check(all(r.status == "ok" and len(r.generated) == 32 for r in res),
          f"not every request finished ok: {rec['statuses']}")
    check(kv["pages_in_use"] == 0, f"pages still in use after the drain: {kv['pages_in_use']}")
    check(launches["flash_attention_fwd"] > 0 and launches["paged_flash_decode"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    return launches


def _kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "paged_decode_kernel" in name:
        return "paged_flash_decode"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def profile_decode(eng, cfg, ticks=4):
    """Where a decode tick's time goes: device time per kernel class over a
    few ticks of 8 slots at depth ~128 (torch.profiler), against the host
    wall clock of those ticks.  Runs after the measured trace (its launches
    are not counted) and drains the engine again."""
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
    device_ms, by_kernel = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        ms = us / 1e3 / ticks
        cls = _kernel_class(ev.key)
        device_ms[cls] = device_ms.get(cls, 0.0) + ms
        by_kernel[ev.key[:80]] = by_kernel.get(ev.key[:80], 0.0) + ms
    busy = sum(device_ms.values())
    per_tick_wall = wall_ms / ticks
    return {
        "ticks": ticks, "slots": 8, "depth": 128, "wall_ms_per_tick": per_tick_wall,
        "device_ms_per_tick": device_ms or None,
        "top_kernels_ms_per_tick": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]),
        # the profiler's own host cost inflates this window's wall clock
        "device_idle_share": (1 - busy / per_tick_wall) if device_ms else None,
    }


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
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "build_s": build_s,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash, paged = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1024, 2048):
            for name in ("causal", "window", "striped", "segment", "decode"):
                flash.append(flash_case(name, S, dtype, gen))
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = lambda: scratch.add_(1)  # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 512):
            paged.append(paged_case(window, dtype, gen, flush))
    del scratch
    emit({"phase": "kernels", "card": card, "cases": flash + paged})

    cross_device()
    launches = full_serve(card)

    main_flash = next(r for r in flash
                      if r["case"] == "causal" and r["S"] == 2048 and r["dtype"] == "bf16")
    main_paged = next(r for r in paged if r["case"] == "full" and r["dtype"] == "bf16")
    kernels = []
    for name, src, replaces, rec in (
        ("flash_attention_fwd", FLASH_SRC, FLASH_REPLACES, main_flash),
        ("paged_flash_decode", PAGED_SRC, PAGED_REPLACES, main_paged),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
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
