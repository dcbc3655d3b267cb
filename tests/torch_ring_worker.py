"""Cases for the port's two ring transports, and the worker process that runs
them on one rank of a gloo group.

``run_cases(ring, inputs)`` runs the executor (mesh, ring and ulysses), the
latent wire's forward, the dispatch seam and the sequence-sharded SSD block
over any transport: on a
``VirtualRing`` it returns every rank's results ([n, ...]); on a
``ProcessGroupRing`` this rank's ([1, ...]), plus the transport's hop /
message / byte counts per case.  The test
(tests/test_torch_ring_p2p.py) runs it both ways and compares.  Each gloo
rank also checks that the latent wire raises ``NotImplementedError`` naming
ROADMAP A.9 where a gradient would have to cross its hops (plain P2P calls),
and runs it in the default grad mode on tensors that need no gradient.

    python tests/torch_ring_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.masking import MaskSpec  # noqa: E402
from repro_torch.core.mesh_attention import (  # noqa: E402
    MeshAttentionConfig,
    mesh_attention,
    mesh_attention_wire,
    mesh_attention_with_lse,
)
from repro_torch.core.ring_attention import ring_config  # noqa: E402
from repro_torch.core.tiling import stripe_permutation  # noqa: E402
from repro_torch.core.ulysses import ulysses_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.parallel.context import ParallelCtx  # noqa: E402

N = 4
B, M, H, HKV, D = 2, 8, 4, 4, 8  # S = N * M = 32
S = N * M
DOC_LENS = (12, 20)

# (name, a, mask, layout, bwd_wire, comm_overlap)
EXEC_CASES = [
    ("mesh2_causal", 2, MaskSpec.causal(), "striped", "qdod", "overlap"),
    ("mesh2_causal_bidir", 2, MaskSpec.causal(), "striped", "odoq", "bidir"),
    ("mesh4_window_serial", 4, MaskSpec.causal(window=9), "contiguous", "qdod", "serial"),
    ("mesh1_doc", 1, MaskSpec.document(DOC_LENS), "striped", "odoq", "overlap"),
    ("mesh2_full", 2, MaskSpec.full(), "contiguous", "qdod", "bidir"),
]
# (backend, a): every factorization of n = 4 on the mesh backend
DISPATCH_BACKENDS = (("mesh", 1), ("mesh", 2), ("mesh", 4), ("ring", 1), ("ulysses", None))
# the sequence-sharded SSD block (reduced configs): (arch, S); S 8 leaves each
# rank 2 rows, fewer than the conv halo's 3
SSM_CASES = (("mamba2-370m", S), ("mamba2-370m", 8), ("hymba-1.5b", S))
WIRE_C = 6  # the latent wire's width: one "head" a token, expanded to H heads of k and v


def make_inputs(seed: int = 7):
    rng = np.random.default_rng(seed)
    out = {
        "q": rng.standard_normal((B, S, H, D)).astype(np.float32),
        "k": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        "v": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        "wire": rng.standard_normal((B, S, 1, WIRE_C)).astype(np.float32),
        "wire_params": rng.standard_normal((WIRE_C, 2 * H * D)).astype(np.float32),
    }
    for arch, length in SSM_CASES:
        cfg = get_config(arch).reduced()
        out[f"ssm_{arch}_{length}::x"] = rng.standard_normal(
            (B, length, cfg.d_model)).astype(np.float32)
    return out


def _ssm_layer(cfg, seed: int = 5):
    """One layer's SSD params, the same in every process; nonzero A_log,
    dt_bias and D_skip."""
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0] for k, v in ssm_mod.init_ssm_params(gen, cfg, 1, torch.float32, "cpu").items()}
    rng = np.random.default_rng(seed)
    for name in ("A_log", "dt_bias", "D_skip"):
        p[name] = torch.from_numpy(rng.uniform(-0.5, 0.5, p[name].shape).astype(np.float32))
    return p


def run_ssm_cases(ring, inputs):
    """The sharded SSD block (``models/ssm.ssm_block`` at sp_size n): each
    local rank's chunk of y, the global state and conv tail once per local
    rank, and the counts per comm kind."""
    out = {}
    for arch, length in SSM_CASES:
        name = f"ssm_{arch}_{length}"
        cfg = get_config(arch).reduced()
        ring.stats.reset()
        y, st = ssm_mod.ssm_block(torch.from_numpy(inputs[f"{name}::x"]), _ssm_layer(cfg), cfg,
                                  ParallelCtx(sp_size=N, ring=ring, device="cpu"),
                                  return_state=True)
        R = len(ring.ranks)
        out[f"{name}::y"] = ring.split(y).detach().numpy()
        for key in ("state", "conv"):
            out[f"{name}::{key}"] = st[key].detach().expand(R, *st[key].shape).numpy()
        for stat, kinds in vars(ring.stats).items():
            for kind, count in kinds.items():
                out[f"{name}::fwd_{stat}::{kind}"] = np.asarray(count)
    return out


def _wire_case(ring, inputs, weights_grad=False):
    """-> (mesh a = 2, causal, striped: the wire's config, this process's
    chunks of q and of the wire, its kv_transform, whose weights require
    grad if ``weights_grad``)."""
    order = torch.from_numpy(_layout_order("striped"))
    q = ring.split(torch.from_numpy(inputs["q"])[:, order])
    wire = ring.split(torch.from_numpy(inputs["wire"])[:, order])
    wp = torch.from_numpy(inputs["wire_params"]).requires_grad_(weights_grad)

    def expand(chunk):  # [b, m, 1, C] -> per-head k, v [b, m, H, D]
        kv = (chunk[:, :, 0] @ wp).reshape(*chunk.shape[:2], 2, H, D)
        return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()

    return MeshAttentionConfig(transport=ring, n=N, a=2, causal=True), q, wire, expand


def check_wire_grad_raises(ring, inputs) -> np.ndarray:
    """On a ProcessGroupRing the latent wire raises, naming ROADMAP A.9,
    where autograd would have to follow its hops: q or the wire requiring
    grad, or the expansion's weights.  A forward in the default grad mode on
    tensors that need no gradient runs; -> its o, this rank's (equal to the
    no-grad forward's, bitwise)."""
    cfg, q, wire, expand = _wire_case(ring, inputs)
    assert torch.is_grad_enabled()
    o = mesh_attention_wire(q, wire, cfg, expand).numpy()
    for weights_grad in (False, True):
        cfg, q, wire, expand = _wire_case(ring, inputs, weights_grad)
        try:
            mesh_attention_wire(q.requires_grad_(not weights_grad), wire, cfg, expand)
        except NotImplementedError as e:
            assert "ROADMAP A.9" in str(e), e
        else:
            raise AssertionError("the latent wire under autograd did not raise on a "
                                 f"ProcessGroupRing (weights_grad={weights_grad})")
    return o


def _layout_order(layout: str) -> np.ndarray:
    return stripe_permutation(S, N) if layout == "striped" else np.arange(S)


def run_cases(ring, inputs):
    """-> {key: np.ndarray}: per case o, lse, dq, dk, dv over the ring's
    local ranks, the transport's counts, and the dispatch seam's global o
    and gradients."""
    out = {}
    qkv = {k: inputs[k] for k in ("q", "k", "v")}
    for name, a, mask, layout, wire, mode in EXEC_CASES:
        order = torch.from_numpy(_layout_order(layout))
        x = {k: ring.split(torch.from_numpy(v)[:, order]).detach() for k, v in qkv.items()}
        seg = None
        if mask.needs_segments:
            seg = ring.split(torch.from_numpy(mask.segment_array(S))[order], axis=0)
        cfg = MeshAttentionConfig(transport=ring, n=N, a=a, mask=mask, layout=layout,
                                  bwd_wire=wire, comm_overlap=mode)
        ring.stats.reset()
        o, lse = mesh_attention_with_lse(x["q"], x["k"], x["v"], cfg, seg=seg)
        fwd = {k: dict(v) for k, v in vars(ring.stats).items()}
        q, k, v = (x[t].clone().requires_grad_(True) for t in ("q", "k", "v"))
        ring.stats.reset()
        o2 = mesh_attention(q, k, v, cfg, seg=seg)
        grads = torch.autograd.grad(o2.sin().sum(), (q, k, v))
        for key, t in zip(("o", "lse", "o_autograd", "dq", "dk", "dv"), (o, lse, o2, *grads)):
            out[f"{name}::{key}"] = t.detach().numpy()
        for stat, kinds in fwd.items():
            for kind, count in kinds.items():
                out[f"{name}::fwd_{stat}::{kind}"] = np.asarray(count)
        for stat, kinds in vars(ring.stats).items():
            for kind, count in kinds.items():
                out[f"{name}::all_{stat}::{kind}"] = np.asarray(count)
    # the latent wire's forward: the wire on the KV ring, expanded at first use
    cfg, q, wire, expand = _wire_case(ring, inputs)
    ring.stats.reset()
    with torch.no_grad():
        out["wire::o"] = mesh_attention_wire(q, wire, cfg, expand).numpy()
    for stat, kinds in vars(ring.stats).items():
        for kind, count in kinds.items():
            out[f"wire::fwd_{stat}::{kind}"] = np.asarray(count)
    # the ring schedule (a = 1) and Ulysses straight from their modules
    x = {k: ring.split(torch.from_numpy(v)[:, torch.from_numpy(_layout_order("striped"))])
         for k, v in qkv.items()}
    out["ring_attention::o"] = mesh_attention(
        x["q"], x["k"], x["v"], ring_config(ring, N, causal=True)).detach().numpy()
    x = {k: ring.split(torch.from_numpy(v)) for k, v in qkv.items()}
    out["ulysses::o"] = ulysses_attention(
        x["q"], x["k"], x["v"], ring, N, causal=True).detach().numpy()
    # the dispatch seam on the global view, with gradients
    for backend, a in DISPATCH_BACKENDS:
        layout = "contiguous" if backend == "ulysses" else "striped"
        order = torch.from_numpy(_layout_order(layout))
        q, k, v = (torch.from_numpy(inputs[t])[:, order].clone().requires_grad_(True)
                   for t in ("q", "k", "v"))
        cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=N, causal=True,
                                           layout=layout, a=a)
        o = dispatch.distributed_attention(q, k, v, cfg=cfg)
        grads = torch.autograd.grad(o.sin().sum(), (q, k, v))
        for key, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            out[f"dispatch_{backend}{a or ''}::{key}"] = t.detach().numpy()
    out.update(run_ssm_cases(ring, inputs))
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
        ring = ProcessGroupRing()
        out = run_cases(ring, inputs)
        o_grad_mode = check_wire_grad_raises(ring, inputs)
        assert np.array_equal(o_grad_mode, out["wire::o"]), "the wire's o in grad mode"
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
