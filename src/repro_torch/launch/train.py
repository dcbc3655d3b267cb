"""Training entry point of the port (the CLI of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        [--device cpu] [--reduced] [--steps 100] [--seq 128] [--batch 8] \
        [--ckpt-dir DIR] [--docs N] [--fake-devices 8 --attn mesh --tile-a 2]

Every arch of ``configs`` trains: the dense and MoE decoders, the SSM and
hybrid ones (mamba2-370m, hymba-1.5b: the SSD scan's forward #5 and
backward #5b on the card), pixtral-12b (its batches carry the stub's
patches), whisper-base (its batches carry mel frames; the encoder
trains with the decoder) and minicpm3-4b (MLA: its expanded heads through
the flash forward and backward at head dim 96).  pixtral-12b and
whisper-base train at one rank: with ``--fake-devices`` they raise
``NotImplementedError``; minicpm3-4b trains on one rank and over the ring
(its expanded heads on the KV ring: JAX's CLI has no latent-wire flag, and
``ParallelCtx(mla_latent_wire=True)`` is the library's switch).

``--device`` defaults to ``cuda`` (the CUDA kernels); ``cpu`` runs their
plain PyTorch versions.  ``--fake-devices N`` is JAX's emulated device
count: with N >= 8 JAX builds a (data 2, model 4) mesh, and the port builds
its sequence axis -- a virtual ring of 4 ranks in this process, with
``block_q = block_kv = 16`` -- and keeps the batch whole (data parallelism
is not ported).  ``--attn`` (mesh | ring | ulysses) and ``--tile-a`` then
configure that ring's attention; with N < 8 there is no ring and attention
runs local flash, as in JAX.  The SSM and hybrid archs shard their sequence
contiguously over the ring (the sharded SSD scan), the others striped; the
"ep" MoE arch (qwen2-moe-a2.7b) sends each rank's tokens to the experts'
ranks by all-to-all (``models/moe.py``).  ``--compress`` and
``--multi-pod`` need several processes and raise.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="family-preserving small config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain PyTorch versions")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--docs", type=int, default=None,
                    help="pack N documents per row (segment-masked attention)")
    ap.add_argument("--compress", action="store_true", help="int8+EF cross-pod grad compression")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help=">= 8: a virtual sequence-parallel ring of 4 ranks")
    ap.add_argument("--tile-a", type=int, default=None)
    ap.add_argument("--attn", default="mesh", choices=["mesh", "ring", "ulysses"])
    args = ap.parse_args(argv)

    flags = [flag for flag, on in (("--compress", args.compress),
                                   ("--multi-pod", args.multi_pod)) if on]
    if flags:
        raise NotImplementedError(
            f"{', '.join(flags)}: not ported yet; they need multi-process training"
        )

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.context import ParallelCtx
    from repro_torch.train.loop import TrainConfig, fit

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if args.fake_devices >= 8:
        ctx = ParallelCtx(sp_size=4, mesh_a=args.tile_a, attn_impl=args.attn,
                          block_q=16, block_kv=16, device=dev)
        ring = f"{ctx.ring!r} attn={args.attn} a={ctx.tile_a() if args.attn == 'mesh' else 1}"
    else:
        ctx = ParallelCtx(device=dev)
        ring = "none"
    print(f"device={dev} ring={ring}")

    tcfg = TrainConfig(steps=args.steps, seq=args.seq, batch=args.batch,
                       ckpt_dir=args.ckpt_dir, docs=args.docs)
    out = fit(cfg, ctx, tcfg, AdamWConfig(total_steps=args.steps),
              hooks={"on_step": lambda s, m: (s % 10 == 0) and print(
                  f"step {s}: loss {float(m['loss']):.4f}")})
    print(f"done: step={out['step']} final_loss={out.get('final_loss')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
