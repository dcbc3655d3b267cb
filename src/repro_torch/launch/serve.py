"""Serving entry point of the port: static-batch generation or streaming
continuous batching over the slot-pool engine (the CLI of
``repro/launch/serve.py``).

    # static batch
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
        [--batch 4] [--prompt-len 16] [--new-tokens 8]

    # streaming: replay a mixed-length arrival trace through the scheduler
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --stream \
        [--trace 16:0,32:1,64:2,16:4] [--slots 4] [--paged --page-size 4] \
        [--kv-dtype int8] [--prefill-chunk 64 --tick-token-budget 128] \
        [--spec-k 4 --check-spec-identical]

``--kv-dtype int8|fp8`` stores the paged pool quantized; ``--prefill-chunk``
(with ``--tick-token-budget``) ingests prompts through continuous prefill;
``--spec-k`` verifies prompt-lookup drafts, and ``--check-spec-identical``
replays the trace with ``spec_k=0`` and exits 1 unless every stream matches.
``--arch mamba2-370m`` / ``hymba-1.5b`` serve SSM and hybrid models with
exact-length prefill (each prompt at most the SSD chunk or a multiple of
it); ``--paged``, ``--prefill-chunk`` and ``--spec-k`` raise the engine's
``ValueError`` for them.  ``--fake-devices N`` (N >= 8) serves over a
sequence-parallel ring of 4 ranks (``ParallelCtx(sp_size=4)``, a
``VirtualRing``: every rank on the one device), as JAX's CLI builds a
(N/4, 4) mesh with a sequence axis of 4; the port builds the sequence axis
only.  ``--device`` defaults to ``cuda`` (the CUDA kernels); ``cpu`` runs
their plain PyTorch versions.  Weights are random, from seed 0.

Robustness knobs, as in JAX's CLI: ``--oversubscribe 1.5`` admits against
1.5x the physical page pool (preempt-and-recompute under pressure; needs
``--paged`` and ``--prefill-chunk``), ``--deadline-ticks`` / ``--cancel
idx:tick`` exercise the lifecycle paths, ``--chaos-seed N`` replays a seeded
fault trace (pool squeezes, NaN ticks, dropped grants; ``--chaos-ticks`` its
horizon), and ``--check-deterministic`` reruns everything with a fresh engine
and injector and exits 1 unless statuses, streams and chaos events reproduce
exactly.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --stream \
        --paged --page-size 4 --num-pages 13 --prefill-chunk 8 --oversubscribe 2.0 \
        --chaos-seed 3 --health-every 1 --check-deterministic
"""

import argparse
import json
import sys


def _parse_trace(spec: str):
    items = []
    for part in spec.split(","):
        if ":" in part:
            ln, tick = part.split(":")
        else:
            ln, tick = part, 0
        items.append((int(ln), int(tick)))
    return items


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain PyTorch versions")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="weights, activations and KV cache")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching: replay --trace through the scheduler")
    ap.add_argument("--trace", default="16:0,32:1,64:2,16:4",
                    help="comma list of prompt_len[:arrival_tick]")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (block tables + prefix sharing)")
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--decode-kernel", default="auto", choices=("auto", "native", "gather"),
                    help="auto (paged -> split-K native kernel), native, or gather")
    ap.add_argument("--deadline-ticks", type=int, default=None)
    ap.add_argument("--health-every", type=int, default=0)
    ap.add_argument("--cancel", default=None,
                    help="comma list of request_index:tick cancellations (--stream)")
    ap.add_argument("--kv-dtype", default="fp", choices=("fp", "int8", "fp8"),
                    help="paged-pool storage: fp keeps --dtype; int8/fp8 store codes + "
                         "per-(token, kv-head) fp32 scales (requires --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous prefill: ingest prompts in chunks of this many tokens")
    ap.add_argument("--tick-token-budget", type=int, default=None,
                    help="cap decode + chunk tokens per tick (requires --prefill-chunk)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: verify up to this many tokens per slot per "
                         "tick (0 disables; needs >= 2)")
    ap.add_argument("--spec-draft", default="ngram", choices=("ngram", "off"))
    ap.add_argument("--spec-max-misses", type=int, default=4,
                    help="suspend a slot's drafting after this many consecutive missed "
                         "verify ticks (0 = never)")
    ap.add_argument("--check-spec-identical", action="store_true",
                    help="replay the --stream trace with spec_k=0; exit 1 unless every "
                         "token stream matches")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help=">= 8: serve over a sequence-parallel ring of 4 ranks on the device")
    ap.add_argument("--oversubscribe", type=float, default=1.0,
                    help="admit against this multiple of the physical page pool; > 1.0 "
                         "preempts and recomputes under pressure (requires --paged and "
                         "--prefill-chunk)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded deterministic fault trace (pool squeezes, NaN "
                         "ticks, dropped grants) from testing/chaos.py")
    ap.add_argument("--chaos-ticks", type=int, default=24,
                    help="horizon the chaos event schedule is drawn over")
    ap.add_argument("--check-deterministic", action="store_true",
                    help="replay the whole --stream run (fresh engine and injector); exit 1 "
                         "unless statuses, token streams and chaos events all match")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    dtype = getattr(torch, args.dtype)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.fake_devices >= 8:
        ctx = ParallelCtx(sp_size=4, block_q=16, block_kv=16, device=args.device,
                          decode_kernel=args.decode_kernel)
    else:
        ctx = ParallelCtx(device=args.device, decode_kernel=args.decode_kernel)
    params = tfm.init_params(cfg, seed=0, dtype=dtype, device=args.device)

    def make_serve(spec_k):
        return ServeConfig(
            max_seq=args.max_seq, num_slots=args.slots, cache_dtype=dtype, paged=args.paged,
            page_size=args.page_size, num_pages=args.num_pages, kv_dtype=args.kv_dtype,
            prefill_chunk=args.prefill_chunk, tick_token_budget=args.tick_token_budget,
            spec_k=spec_k, spec_draft=args.spec_draft,
            spec_max_misses=args.spec_max_misses or None, health_every=args.health_every,
            oversubscribe=args.oversubscribe,
        )

    def make_chaos():
        if args.chaos_seed is None:
            return None
        from repro_torch.testing.chaos import ChaosConfig, ChaosInjector
        return ChaosInjector(ChaosConfig(seed=args.chaos_seed, ticks=args.chaos_ticks))

    chaos = make_chaos()
    eng = ServeEngine(cfg, params, ctx=ctx, serve=make_serve(args.spec_k), chaos=chaos)
    rng = np.random.default_rng(0)

    if args.stream:
        trace = _parse_trace(args.trace)
        prompts = [rng.integers(0, cfg.vocab_size, (ln,), dtype=np.int32) for ln, _ in trace]
        cancels = {}
        if args.cancel:
            for part in args.cancel.split(","):
                idx, t = part.split(":")
                cancels.setdefault(int(t), []).append(int(idx))

        def replay(engine, quiet=False):
            rids = [
                engine.submit(p, max_new_tokens=args.new_tokens, arrival_tick=tick,
                              deadline_ticks=args.deadline_ticks)
                for p, (_, tick) in zip(prompts, trace)
            ]
            ticks = 0
            while engine.has_work:
                for idx in cancels.get(engine._tick, []):
                    engine.cancel(rids[idx])
                for req in engine.step():
                    if not quiet:
                        print(
                            f"rid={req.rid} len={len(req.prompt)} slot={req.slot} "
                            f"arrived@{req.arrival_tick} admitted@{req.admit_tick} "
                            f"finished@{req.finish_tick} status={req.status}: {req.generated}"
                        )
                ticks += 1
            return rids, ticks

        rids, ticks = replay(eng)
        stats = eng.tick_stats()
        kv = eng.kv_cache_stats()
        summary = {
            "device": str(eng.device),
            "ring": repr(ctx.ring),
            "requests": len(trace),
            "ticks": ticks,
            "prefill_launches": eng.prefill_launches,
            "prefill_tokens": int(sum(stats["prefill_tokens"])),
            "decode_tokens": int(sum(stats["decode_tokens"])),
        }
        if args.prefill_chunk:
            summary["chunk_launches"] = eng.chunk_launches
        if eng._spec_on:
            summary["speculative"] = {
                key: kv[key] for key in (
                    "verify_launches", "spec_proposed", "spec_accepted", "spec_accept_rate",
                    "spec_rolled_back_pages",
                )
            }
        if args.paged:
            summary["kv_cache"] = kv
        if (args.oversubscribe > 1.0 or args.chaos_seed is not None
                or args.deadline_ticks is not None or args.cancel):
            statuses = {}
            for rid in rids:
                st = eng._finished[rid].status
                statuses[st] = statuses.get(st, 0) + 1
            summary["robustness"] = {
                "oversubscribe": args.oversubscribe,
                "statuses": statuses,
                **{key: kv[key] for key in (
                    "preemptions", "recompute_tokens", "cancelled", "deadline_expired",
                    "numeric_errors", "rejected_requests", "health_sweeps",
                    "chaos_dropped_grants",
                )},
                "chaos_events": chaos.events if chaos is not None else [],
            }
        print(json.dumps(summary))
        if args.check_deterministic:
            # a fresh engine and a fresh injector replaying the same (seed,
            # trace, faults) must reproduce every outcome
            chaos2 = make_chaos()
            ref = ServeEngine(cfg, params, ctx=ctx, serve=make_serve(args.spec_k), chaos=chaos2)
            ref_rids, _ = replay(ref, quiet=True)
            for rid, ref_rid in zip(rids, ref_rids):
                a, b = eng._finished[rid], ref._finished[ref_rid]
                if a.status != b.status or a.generated != b.generated:
                    print(f"check-deterministic: rid={rid} run1 ({a.status}, {a.generated}) "
                          f"!= run2 ({b.status}, {b.generated})", file=sys.stderr)
                    return 1
            if chaos is not None and chaos.events != chaos2.events:
                print(f"check-deterministic: chaos traces diverged:\n  run1 {chaos.events}\n"
                      f"  run2 {chaos2.events}", file=sys.stderr)
                return 1
            print(f"check-deterministic: {len(rids)} outcomes and "
                  f"{len(chaos.events) if chaos is not None else 0} chaos events "
                  "reproduced exactly")
        if args.check_spec_identical:
            if not eng._spec_on:
                print("check-spec-identical needs --spec-k >= 2", file=sys.stderr)
                return 1
            ref = ServeEngine(cfg, params, ctx=ctx, serve=make_serve(0))
            ref_rids, _ = replay(ref, quiet=True)
            for rid, ref_rid in zip(rids, ref_rids):
                got, want = eng._finished[rid].generated, ref._finished[ref_rid].generated
                if got != want:
                    print(f"check-spec-identical: rid={rid} speculative stream {got} != "
                          f"vanilla {want}", file=sys.stderr)
                    return 1
            print(f"check-spec-identical: {len(rids)} streams match vanilla greedy")
        return 0

    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    out = eng.generate(prompts, max_new_tokens=args.new_tokens)
    for i, row in enumerate(out):
        print(f"request {i}: {row.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
