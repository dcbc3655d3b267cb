"""The port's P2P transport: 4 gloo processes on the CPU, one rank each
(``ProcessGroupRing``), run tests/torch_ring_worker.py's cases -- the mesh
executor (a = 1, 2, 4; causal, window, document and full masks; striped and
contiguous layouts; both backward wires; the three comm_overlap modes),
Ring-Attention, Ulysses, the latent wire's forward (each rank also checks
that the wire raises, naming ROADMAP A.9, where a gradient would cross its
hops, and runs in the default grad mode where none would), the dispatch seam
with gradients (mesh at
every factorization of n = 4, ring, ulysses), and the sequence-sharded SSD
block (mamba2-370m and hymba-1.5b reduced; ranks shorter than the conv
halo too) -- and must give the virtual ring's per-rank results within 1e-6
(the SSD block's bit for bit) and the same hop, message and byte counts.  Each run has its own time limit, so a hang fails
instead of eating the suite's."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ring_worker as W
from repro_torch.parallel.ring import VirtualRing

P2P_TOL = 1e-6
TIME_LIMIT_S = 120


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p2p")
    inputs = W.make_inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, W.__file__, str(r), str(W.N), str(port), str(tmp / "inputs.npz"),
             str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(W.N)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIME_LIMIT_S)
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo ranks did not finish within {TIME_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W.N)]
    virtual = W.run_cases(VirtualRing(W.N), inputs)
    return ranks, virtual


def test_p2p_per_rank_results_match_the_virtual_ring(results):
    ranks, virtual = results
    keys = [k for k in virtual if "_hops::" not in k and "_bytes::" not in k
            and "_messages::" not in k and not k.startswith("dispatch_")]
    assert keys and all(sorted(r) == sorted(virtual) for r in ranks)
    for key in keys:
        for r, got in enumerate(ranks):
            assert got[key].shape[0] == 1, key
            np.testing.assert_allclose(got[key][0], virtual[key][r], atol=P2P_TOL, rtol=0,
                                       err_msg=f"{key} rank {r}")


def test_p2p_sharded_ssd_block_is_bitwise_the_virtual_rings(results):
    ranks, virtual = results
    keys = [k for k in virtual if k.startswith("ssm_") and "_hops::" not in k
            and "_bytes::" not in k and "_messages::" not in k]
    assert len(keys) == 3 * len(W.SSM_CASES)
    for key in keys:
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[key][0], virtual[key][r], err_msg=f"{key} rank {r}")
    assert any("::fwd_hops::ssd_halo" in k for k in virtual)


def test_p2p_counts_match_the_virtual_ring(results):
    ranks, virtual = results
    keys = [k for k in virtual if "_hops::" in k or "_bytes::" in k or "_messages::" in k]
    assert any("::all_hops::send_dq" in k for k in keys)
    for key in keys:
        for got in ranks:
            assert int(got[key]) == int(virtual[key]), key


def test_p2p_dispatch_global_view_and_grads(results):
    """Every process returns the whole output and the whole gradient of the
    replicated global view, equal to the virtual ring's."""
    ranks, virtual = results
    for backend, a in W.DISPATCH_BACKENDS:
        for key in ("o", "dq", "dk", "dv"):
            name = f"dispatch_{backend}{a or ''}::{key}"
            for got in ranks:
                np.testing.assert_allclose(got[name], virtual[name], atol=P2P_TOL, rtol=0,
                                           err_msg=name)


def test_p2p_latent_wire_forward_matches_the_virtual_ring(results):
    """The latent wire's forward over gloo: each rank's o and the KV hops'
    bytes (the wire's, not k and v) as on the virtual ring, and the wire
    differentiable there.  Each gloo rank checks itself that the wire raises
    where a gradient would cross its hops, and that a forward in the default
    grad mode on tensors that need no gradient gives the no-grad o."""
    ranks, virtual = results
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["wire::o"][0], virtual["wire::o"][r], atol=P2P_TOL, rtol=0)
        assert int(got["wire::fwd_bytes::recv_kv"]) == int(virtual["wire::fwd_bytes::recv_kv"]) \
            == W.B * W.M * W.WIRE_C * 4 * int(virtual["wire::fwd_hops::recv_kv"]) > 0
    cfg, q, wire, expand = W._wire_case(VirtualRing(W.N), W.make_inputs())
    q.requires_grad_(True)
    o = W.mesh_attention_wire(q, wire.requires_grad_(True), cfg, expand)
    dq, dwire = torch.autograd.grad(o.sin().sum(), (q, wire))
    np.testing.assert_allclose(o.detach().numpy(), virtual["wire::o"], atol=P2P_TOL, rtol=0)
    assert float(dwire.abs().max()) > 0 and float(dq.abs().max()) > 0
