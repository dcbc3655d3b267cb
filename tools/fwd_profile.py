#!/usr/bin/env python3
"""The fp32 flash forward's time at the main paths' rows, one tree at a time.

    python3 tools/fwd_profile.py [--src DIR]

Calls ``flash_attention_fwd`` of the ``repro_torch`` package found under
``--src`` (default: this checkout's ``src``) with fp32 inputs (seeded random)
at the rows the main paths launch: granite-8b's heads (32 / 8 of 128) causal
at 2,048 and 4,096 tokens (the training forward), qwen2.5-32b's heads (40 /
8 of 128) at a 256-token chunk and a spec_k 4 verify of 8 slots over 2,048
cached positions (the int8 pool's dequantized view), granite's decode tick
of 8 slots, the mesh executor's block (0, 1) of a = 2 with 4 ranks folded
(paper heads, 4,096 rows a rank, stride 4) and local flash at 16,384 tokens
(the mesh op's yardstick).  Prints one JSON line per row: the call's ms by
CUDA events, the device ms of the forward's kernels under torch.profiler
(the fp32 pre-pass included where the tree has one), SDPA's fp32 time on
the same inputs and mask (one PyTorch call, the yardstick), the bound at
the tensor cores' bf16 peak and at the fp32 CUDA cores', and the card's name
and power limit.  The training rows and local flash at 16,384 tokens also
carry o's and lse's largest |delta| against the plain version (at 16,384:
over the rows 4,096-4,351 and the last 256, which see the most keys).
Times are means over REPS calls.  Giving ``--src`` the parent commit's tree
times the body before a change; one call with both trees, in turns,
compares them on one card.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"bf16_tensor_cores": 989e12, "fp32_cuda_cores": 67e12}
REPS = 5


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("fwd_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import mesh_attention
    from repro_torch.core.masking import MaskSpec
    from repro_torch.core.mesh_attention import MeshAttentionConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    INF = ref.BAND_INF

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def events_ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and "flash_fwd" in ev.key) / 1e3 / REPS

    def per_row(B, Sq, S):
        pos = np.random.default_rng(S + Sq).integers(0, S - Sq + 1, B).astype(np.int32)
        return [(int(p), 0, 0, INF) for p in pos]

    # name: (B, Sq, Skv, (H, Hkv, D), bands (one per batch row or one), stride)
    paper = (32, 32, 128)
    cfg = MeshAttentionConfig(transport=None, n=4, a=2, mask=MaskSpec.causal(), layout="striped")
    m = 16384 // 4
    blocks = [mesh_attention._band_for_block(cfg, i, 0, 1, m, m) for i in range(4)]
    rows = {
        "granite_causal_2048": (1, 2048, 2048, (32, 8, 128), (0, 0, 0, INF), 1),
        "granite_causal_4096": (1, 4096, 4096, (32, 8, 128), (0, 0, 0, INF), 1),
        "qwen_chunk": (8, 256, 2048, (40, 8, 128), per_row(8, 256, 2048), 1),
        "qwen_verify": (8, 4, 2048, (40, 8, 128), per_row(8, 4, 2048), 1),
        "granite_decode": (8, 1, 2048, (32, 8, 128), per_row(8, 1, 2048), 1),
        "mesh_block_causal": (4, m, m, paper, [b for b, _, _ in blocks], blocks[0][1]),
        "paper_causal_16384": (1, 16384, 16384, paper, (0, 0, 0, INF), 1),
    }
    for name, (B, Sq, Skv, (H, Hkv, D), band, stride) in rows.items():
        q, k, v = randn(B, Sq, H, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        band_arg = torch.tensor(band, dtype=torch.int32, device="cuda") \
            if isinstance(band, list) else band
        kw = dict(scale=D**-0.5, stride_q=stride, stride_kv=stride)
        run = lambda: fa.flash_attention_fwd(q, k, v, band_arg, **kw)  # noqa: E731
        if isinstance(band, list):
            mask = torch.stack([ref.band_mask(Sq, Skv, b, stride_q=stride, stride_kv=stride,
                                              device="cuda") for b in band])
        else:
            mask = ref.band_mask(Sq, Skv, band, stride_q=stride, stride_kv=stride, device="cuda")
        pairs = int(mask.sum()) * (1 if mask.dim() == 3 else B)
        keys = int(mask.any(dim=-2).sum()) * (1 if mask.dim() == 3 else B)
        nbytes = (2 * q.numel() + 2 * keys * Hkv * D) * 4 + B * H * Sq * 4
        flops = 4 * D * H * pairs
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        attn_mask = mask[:, None] if mask.dim() == 3 else mask
        if band == (0, 0, 0, INF) and Sq == Skv:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, scale=D**-0.5, enable_gqa=Hkv != H)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=attn_mask, scale=D**-0.5, enable_gqa=Hkv != H)
        if name.startswith(("granite_causal", "paper_causal")):
            o, lse = run()
            rec_err = {"max_abs_err": 0.0, "max_abs_err_lse": 0.0}
            for r0 in ((0,) if Sq <= 4096 else (4096, Sq - 256)):
                rows_ = slice(r0, r0 + (Sq if Sq <= 4096 else 256))
                o_ref, lse_ref = ref.attention_ref(q[:, rows_], k, v, scale=D**-0.5,
                                                   band=(r0, *band[1:]))
                rec_err["max_abs_err"] = max(rec_err["max_abs_err"],
                                             float((o[:, rows_] - o_ref).abs().max()))
                rec_err["max_abs_err_lse"] = max(
                    rec_err["max_abs_err_lse"], float((lse[:, :, rows_] - lse_ref).abs().max()))
                del o_ref, lse_ref
            del o, lse
        else:
            rec_err = {}
        rec = {"row": name, "B": B, "Sq": Sq, "Skv": Skv, "heads": [H, Hkv, D], "dtype": "fp32",
               "src": os.path.relpath(os.path.abspath(args.src), ROOT),
               "plan": list(fa._fwd_plan(B, Sq, H, Hkv, D, torch.float32)),
               "ms": events_ms(run), "device_ms": device_ms(run), "sdpa_ms": events_ms(lib),
               "visible_pairs": pairs, **rec_err, "card": card}
        for unit, peak in PEAKS.items():
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
            rec[f"bound_ms_{unit}"] = max(t_bytes, t_ops) * 1e3
            rec[f"bound_by_{unit}"] = "bytes" if t_bytes >= t_ops else "operations"
        print(json.dumps(rec), flush=True)
        del q, k, v, qt, kt, vt, mask, attn_mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
