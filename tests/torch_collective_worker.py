"""Cases for Algorithm 1's collective form over the port's two transports,
and the worker process that runs them on one rank of a gloo group.

``run_cases(ring, inputs)`` runs ``mesh_attention_collective`` forward and
backward on a 2 x 2 grid of n = 4 ranks (causal striped, a window over the
contiguous layout, a document mask, full attention; the three
comm_overlap modes): on a ``VirtualRing`` it returns every rank's results
([n, ...]); on a ``ProcessGroupRing`` this rank's ([1, ...]), plus the
transport's hop / message / byte counts per case.  The test
(tests/test_torch_collective.py) runs it both ways and compares.

    python tests/torch_collective_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.masking import MaskSpec  # noqa: E402
from repro_torch.core.mesh_attention_collective import mesh_attention_collective  # noqa: E402
from repro_torch.core.tiling import stripe_permutation  # noqa: E402

N, A, GB = 4, 2, 2  # ranks and the (a, b) grid
B, M, H, HKV, D = 2, 8, 4, 2, 16  # S = N * M = 32
S = N * M
DOC_LENS = (12, 20)

# (name, mask, layout, comm_overlap)
CASES = [
    ("causal_striped", MaskSpec.causal(), "striped", "overlap"),
    ("causal_striped_bidir", MaskSpec.causal(), "striped", "bidir"),
    ("window_contiguous_serial", MaskSpec.causal(window=9), "contiguous", "serial"),
    ("document_striped", MaskSpec.document(DOC_LENS), "striped", "bidir"),
    ("full_contiguous", MaskSpec.full(), "contiguous", "overlap"),
]


def make_inputs(seed: int = 8):
    rng = np.random.default_rng(seed)
    return {
        "q": rng.standard_normal((B, S, H, D)).astype(np.float32),
        "k": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        "v": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
    }


def order(layout: str) -> np.ndarray:
    return stripe_permutation(S, N) if layout == "striped" else np.arange(S)


def run_cases(ring, inputs):
    """-> {key: np.ndarray}: per case o, dq, dk, dv over the ring's local
    ranks (gradients of sum(sin(o))), and the transport's counts."""
    out = {}
    for name, mask, layout, mode in CASES:
        perm = torch.from_numpy(order(layout))
        q, k, v = (ring.split(torch.from_numpy(inputs[t])[:, perm]).detach().requires_grad_(True)
                   for t in ("q", "k", "v"))
        seg = None
        if mask.needs_segments:
            seg = ring.split(torch.from_numpy(mask.segment_array(S))[perm], axis=0)
        ring.stats.reset()
        o = mesh_attention_collective(q, k, v, ring, A, GB, mask=mask, layout=layout, seg=seg,
                                      comm_overlap=mode)
        grads = torch.autograd.grad(o.sin().sum(), (q, k, v))
        for key, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            out[f"{name}::{key}"] = t.detach().numpy()
        for stat, kinds in vars(ring.stats).items():
            for kind, count in kinds.items():
                out[f"{name}::{stat}::{kind}"] = np.asarray(count)
    return out


def main(argv):
    import torch.distributed as dist

    from repro_torch.parallel.ring import ProcessGroupRing

    rank, world, port, inputs_path, out_dir = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        inputs = dict(np.load(inputs_path))
        out = run_cases(ProcessGroupRing(), inputs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
