"""Training entry point of the port (the CLI of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        [--device cpu] [--reduced] [--steps 100] [--seq 128] [--batch 8] \
        [--ckpt-dir DIR] [--docs N]

``--device`` defaults to ``cuda`` (the CUDA kernels); ``cpu`` runs their
plain PyTorch versions.  The port trains on one card: the flags that need a
mesh (``--compress``, ``--multi-pod``, ``--fake-devices``, ``--tile-a``,
``--attn ring|ulysses``) are accepted for parity and raise.  On one device
JAX's default ``--attn mesh`` runs local flash attention, as the port does.
"""

import argparse
import sys


def _not_ported(args) -> list:
    return [
        flag for flag, on in (
            ("--compress", args.compress),
            ("--multi-pod", args.multi_pod),
            ("--fake-devices", args.fake_devices),
            ("--tile-a", args.tile_a is not None),
            (f"--attn {args.attn}", args.attn != "mesh"),
        ) if on
    ]


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
    # parity with the JAX CLI; they need a mesh
    ap.add_argument("--compress", action="store_true", help="int8+EF cross-pod grad compression")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fake-devices", type=int, default=0)
    ap.add_argument("--tile-a", type=int, default=None)
    ap.add_argument("--attn", default="mesh", choices=["mesh", "ring", "ulysses"])
    args = ap.parse_args(argv)

    flags = _not_ported(args)
    if flags:
        raise NotImplementedError(
            f"{', '.join(flags)}: not ported yet; they need a mesh, which comes with the "
            "mesh/ring executor slice of the port"
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
    ctx = ParallelCtx(device=dev)
    print(f"device={dev} mesh=none")

    tcfg = TrainConfig(steps=args.steps, seq=args.seq, batch=args.batch,
                       ckpt_dir=args.ckpt_dir, docs=args.docs)
    out = fit(cfg, ctx, tcfg, AdamWConfig(total_steps=args.steps),
              hooks={"on_step": lambda s, m: (s % 10 == 0) and print(
                  f"step {s}: loss {float(m['loss']):.4f}")})
    print(f"done: step={out['step']} final_loss={out.get('final_loss')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
