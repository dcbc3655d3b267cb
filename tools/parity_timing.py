#!/usr/bin/env python3
"""The seconds of chip_smoke.py's CPU-heavy train-step parity phases, or of
its MoE phases, one tree at a time.

    python3 tools/parity_timing.py [--tree DIR] [--moe | --mla] [--log FILE]

Imports ``chip_smoke.py`` and the ``repro_torch`` package of ``--tree``
(default: this checkout), builds the flash libraries, and runs the phases
whose CPU side (a make_train_step on the host over 0.4e9-1.8e9 fp32
weights, and the comparison of every leaf) takes most of their time, each as
``chip_smoke.py`` runs it: ``train_parity`` (granite-8b), ``train_gemma_parity``,
``train_moe_parity``, ``train_ssm_parity`` (mamba2-370m) and, where the
tree has it, ``train_minicpm_parity``'s card-vs-CPU step.  Prints one line
per phase: its seconds, the card's and the CPU's step wall time, and the
worst gradient and parameter errors against the phase's limits.  Giving
``--tree`` the parent commit's tree times the phases before a change; one
call with both trees, in turns (parent, change, change, parent), compares
them on one host.  ``--moe`` times the MoE family's phases instead, as
``chip_smoke.py``'s main runs them, those the tree has: ``slice_moe``,
(``slice_moe_ring``), ``serve_moe``, (``serve_moe_ring``,
``train_moe_ring_parity``); one line per phase with its seconds (each
phase's own line is dropped).  ``--mla`` times minicpm3-4b's phases the
same way: ``slice_minicpm``, (``slice_mla_ring``), ``serve_minicpm``,
(``serve_minicpm_ring``) and ``train_minicpm_parity``'s sp_size 4 half (with
``train_minicpm_wire_parity`` where the tree has it).  ``--log`` appends
the phases' own lines to FILE.  Needs a CUDA device.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--moe", action="store_true", help="time the MoE phases instead")
    ap.add_argument("--mla", action="store_true", help="time minicpm3-4b's phases instead")
    ap.add_argument("--log", default=None, help="append the phases' own lines here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]

    import torch

    if not torch.cuda.is_available():
        print("parity_timing: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs._build.build(["flash_fwd_tc", "flash_fwd_mla", "flash_bwd", "ssd_scan", "ssd_scan_bwd"]
                    + (["paged_decode"] if args.moe or args.mla else []))
    if args.moe:
        return _moe_phases(cs, tree, args.log)
    if args.mla:
        return _mla_phases(cs, tree, args.log)
    phases = [("granite-8b", cs.TRAIN_PARITY_SEQ, "train_parity", 2),
              (cs.GEMMA_ARCH, cs.GEMMA_PARITY_SEQ, "train_gemma_parity", cs.GEMMA_PARITY_LAYERS),
              ("qwen2-moe-a2.7b", cs.MOE_PARITY_SEQ, "train_moe_parity", cs.MOE_PARITY_LAYERS),
              ("mamba2-370m", 512, "train_ssm_parity", 2)]
    if hasattr(cs, "MINICPM_PARITY_SEQ"):
        phases.append((cs.MINICPM_ARCH, cs.MINICPM_PARITY_SEQ, "train_minicpm_parity",
                       cs.MINICPM_PARITY_LAYERS))
    for arch, seq, phase, layers in phases:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):  # the phase's own (long) line
            cs.train_parity(arch, seq=seq, phase=phase, layers=layers)
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        print(json.dumps({
            "tree": tree, "phase": phase, "arch": arch, "seconds": time.perf_counter() - t0,
            "wall_s": rec["wall_s"],
            "grad_err_over_max": max(v["grad_max_abs_err"] / v["grad_max_abs"]
                                     for v in rec["leaves"].values()),
            "param_max_abs_err": max(v["param_max_abs_err"] for v in rec["leaves"].values()),
            "tols": rec["tols"],
        }), flush=True)
    return 0


def _timed(phases, tree, log):
    """Runs each (name, function), printing its seconds; the phase's own
    lines go to ``log`` (appended) or nowhere."""
    for phase, run in phases:
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):  # the phase's own (long) line
                run()
        finally:
            if log:
                with open(log, "a") as f:
                    f.write(out.getvalue())
        print(json.dumps({"tree": tree, "phase": phase, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


def _mla_phases(cs, tree, log):
    """chip_smoke's minicpm3-4b phases in main's order, each timed (the ring
    phases where the tree has them)."""
    card = cs.card_line()
    ring = hasattr(cs, "serve_minicpm_ring")
    state = {"slice": {}, "whole": {}}

    def slice_minicpm():
        kw = {"keep": state["slice"]} if ring else {}
        cs.cross_device(cs.MINICPM_ARCH, phase="slice_minicpm", quant_run=True,
                        loop_prompt=True, **kw)

    def serve_minicpm():
        cs.serve_minicpm(card, **({"keep": state["whole"]} if ring else {}))

    def parity():
        kw = {"wire_phase": "train_minicpm_wire_parity"} if ring else {}
        cs.train_mesh_parity(cs.MINICPM_ARCH, layers=cs.MINICPM_PARITY_LAYERS,
                             seq=cs.MINICPM_MESH_SEQ, impls=(("mesh", 2),),
                             phase="train_minicpm_parity", **kw)

    phases = [("slice_minicpm", slice_minicpm)]
    if ring:
        phases.append(("slice_mla_ring", lambda: cs.slice_mla_ring(state["slice"])))
    phases.append(("serve_minicpm", serve_minicpm))
    if ring:
        phases.append(("serve_minicpm_ring", lambda: cs.serve_minicpm_ring(card, state["whole"])))
    phases.append(("train_minicpm_parity (sp_size 4)", parity))
    return _timed(phases, tree, log)


def _moe_phases(cs, tree, log=None):
    """chip_smoke's MoE phases in main's order, each timed (the ring phases
    where the tree has them)."""
    card = cs.card_line()
    state = {}

    def slice_moe():
        state["weights"] = cs.cross_device_moe()

    def serve_moe():
        out = cs.serve_moe(card)
        state["sp1"] = out[1] if isinstance(out, tuple) else None

    ring = hasattr(cs, "serve_moe_ring")
    phases = [("slice_moe", slice_moe)]
    if ring:
        phases.append(("slice_moe_ring", lambda: cs.slice_moe_ring(state["weights"])))
    phases.append(("serve_moe", serve_moe))
    if ring:
        phases += [("serve_moe_ring", lambda: cs.serve_moe_ring(card, state["sp1"])),
                   ("train_moe_ring_parity", cs.train_moe_ring_parity)]
    return _timed(phases, tree, log)


if __name__ == "__main__":
    sys.exit(main())
