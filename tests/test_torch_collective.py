"""Algorithm 1's collective form in the port (``core/mesh_attention_collective``)
on the CPU (kernel #1 and its backward run their plain versions), against
the JAX package's single-device ``repro.kernels.ref.attention_ref`` on the
same numpy inputs (JAX's own collective cannot run here: its dist_check
``collective_mode`` fails inside the reference) and against the port's ring
decomposition ``mesh_attention``.  As ``dist_check.check_collective_mode``:
grids n 8 = (2, 4) and n 4 = (2, 2), D 16, 16 tokens a rank; here also a
window, the contiguous layout and a document mask.

Limits: o within 2e-5 (dist_check's); gradients of sum(sin(o)) within 5e-5
of their largest magnitude, against JAX's ``jax.grad`` of the reference and
the port's local flash; the three comm_overlap modes bitwise equal; the
transport's bytes per kind exactly (group size - 1) x the chunk each rank
sends; 4 gloo processes (``ProcessGroupRing``) equal the virtual ring's
per-rank results and counts.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_collective_worker as W
from repro.kernels import ref as jref
from repro_torch.core.masking import MaskSpec
from repro_torch.core.mesh_attention import MeshAttentionConfig, mesh_attention
from repro_torch.core.mesh_attention_collective import mesh_attention_collective
from repro_torch.core.tiling import stripe_permutation
from repro_torch.kernels import ops
from repro_torch.parallel.ring import Grid, VirtualRing

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
B, M, H, HKV, D = 2, 16, 4, 2, 16
TIME_LIMIT_S = 120

# name: (a, b, mask, layout)
CASES = {
    "n4_causal_striped": (2, 2, MaskSpec.causal(), "striped"),
    "n4_full": (2, 2, MaskSpec.full(), "contiguous"),
    "n8_causal_striped": (2, 4, MaskSpec.causal(), "striped"),
    "n8_full": (2, 4, MaskSpec.full(), "striped"),
    "n8_window_striped": (2, 4, MaskSpec.causal(window=21), "striped"),
    "n8_window_contiguous": (2, 4, MaskSpec.causal(window=21), "contiguous"),
    "n4_document": (2, 2, MaskSpec.document((23, 41)), "striped"),
}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    S = n * M
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, HKV, D)).astype(np.float32),
            rng.standard_normal((B, S, HKV, D)).astype(np.float32))


def _order(layout, S, n):
    return np.asarray(stripe_permutation(S, n)) if layout == "striped" else np.arange(S)


def _collective(ring, a, b, mask, layout, x, mode="overlap"):
    """Global-view inputs (natural order, numpy) -> (o, dq, dk, dv) in the
    natural order, gradients of sum(sin(o))."""
    n = a * b
    S = x[0].shape[1]
    perm = _order(layout, S, n)
    inv = np.argsort(perm)
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in x]
    parts = [ring.split(t[:, perm]) for t in qkv]
    seg = None
    if mask.needs_segments:
        seg = ring.split(torch.from_numpy(mask.segment_array(S))[perm], axis=0)
    o = ring.join(mesh_attention_collective(*parts, ring, a, b, mask=mask, layout=layout,
                                            seg=seg, comm_overlap=mode))[:, inv]
    grads = torch.autograd.grad(o.sin().sum(), qkv)
    return [t.detach().numpy() for t in (o, *grads)]


def _band(mask):
    lo, hi = mask.band()
    return (0, 0, lo, hi)


def _jax_ref(mask, x):
    """JAX's single-device reference and its autodiff gradients."""
    S = x[0].shape[1]
    seg = jnp.asarray(mask.segment_array(S)) if mask.needs_segments else None

    def f(q, k, v):
        return jref.attention_ref(q, k, v, band=_band(mask), seg_q=seg, seg_kv=seg)[0]

    jx = [jnp.asarray(t) for t in x]
    o = f(*jx)
    grads = jax.grad(lambda *t: jnp.sum(jnp.sin(f(*t))), argnums=(0, 1, 2))(*jx)
    return [np.asarray(t) for t in (o, *grads)]


def _local_flash(mask, x):
    S = x[0].shape[1]
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in x]
    seg = torch.from_numpy(mask.segment_array(S)) if mask.needs_segments else None
    o = ops.flash_attention(*qkv, band=_band(mask), seg_q=seg, seg_kv=seg)
    grads = torch.autograd.grad(o.sin().sum(), qkv)
    return [t.detach().numpy() for t in (o, *grads)]


def _mesh(a, b, mask, layout, x):
    """The port's ring decomposition (mesh_attention at tile height a)."""
    n = a * b
    S = x[0].shape[1]
    ring = VirtualRing(n)
    perm = _order(layout, S, n)
    inv = np.argsort(perm)
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in x]
    parts = [ring.split(t[:, perm]) for t in qkv]
    seg = None
    if mask.needs_segments:
        seg = ring.split(torch.from_numpy(mask.segment_array(S))[perm], axis=0)
    cfg = MeshAttentionConfig(transport=ring, n=n, a=a, mask=mask, layout=layout)
    o = ring.join(mesh_attention(*parts, cfg, seg=seg))[:, inv]
    grads = torch.autograd.grad(o.sin().sum(), qkv)
    return [t.detach().numpy() for t in (o, *grads)]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_collective_matches_jax_reference_and_mesh(case):
    """Forward and gradients against JAX's reference, the port's local
    flash, and the port's mesh_attention at the same tile height."""
    a, b, mask, layout = CASES[case]
    x = _inputs(a * b, seed=len(case))
    got = _collective(VirtualRing(a * b), a, b, mask, layout, x)
    _close(got, _jax_ref(mask, x))
    _close(got, _local_flash(mask, x))
    _close(got, _mesh(a, b, mask, layout, x))


@pytest.mark.parametrize("case", ["n4_causal_striped", "n8_window_contiguous", "n4_document"])
def test_comm_overlap_modes_bitwise_equal(case):
    """serial, overlap and bidir move the same values: outputs and
    gradients bitwise equal; bidir moves each leaf of the Q and KV gathers
    in two messages, and the bytes are the same."""
    a, b, mask, layout = CASES[case]
    x = _inputs(a * b, seed=3)
    runs, stats = [], []
    for mode in ("serial", "overlap", "bidir"):
        ring = VirtualRing(a * b)
        runs.append(_collective(ring, a, b, mask, layout, x, mode))
        stats.append(ring.stats)
    for run in runs[1:]:
        for g, w in zip(run, runs[0]):
            np.testing.assert_array_equal(g, w)
    assert stats[0].bytes == stats[1].bytes == stats[2].bytes
    assert stats[0].messages == stats[1].messages
    for kind in ("gather_q", "gather_kv"):
        assert stats[2].messages[kind] == 2 * stats[1].messages[kind]
    for kind in ("gather_lse", "scatter_o"):  # reductions are never split
        assert stats[2].messages[kind] == stats[1].messages[kind] == 1


@pytest.mark.parametrize("batch", [1, B])
@pytest.mark.parametrize("case", ["n4_causal_striped", "n8_full", "n4_document"])
def test_byte_counters_match_the_formula(case, batch, monkeypatch):
    """Per call, one hop per collective; each rank sends (group size - 1)
    x its chunk: Q (and its segment ids) to the a - 1 others of its column,
    K and V to the b - 1 others of its row, its lse slots and its fp32
    output slots for the a - 1 others.  The flash forward launches once per
    (u, w) block for all ranks (per rank with segment ids)."""
    from repro_torch.kernels import flash_attention as fa

    a, b, mask, layout = CASES[case]
    n = a * b
    x = [t[:batch] for t in _inputs(n, seed=5)]
    calls = []
    real = fa.flash_attention_fwd

    def fwd(q, k, v, *args, **kw):
        # the kernels take contiguous operands
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        calls.append(q.shape[0])
        return real(q, k, v, *args, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    ring = VirtualRing(n)
    ring.stats.reset()
    with torch.no_grad():
        perm = _order(layout, n * M, n)
        parts = [ring.split(torch.from_numpy(t)[:, perm]) for t in x]
        seg = None
        if mask.needs_segments:
            seg = ring.split(torch.from_numpy(mask.segment_array(n * M))[perm], axis=0)
        mesh_attention_collective(*parts, ring, a, b, mask=mask, layout=layout, seg=seg)
    seg_bytes = 4 * M if mask.needs_segments else 0
    want = {
        "gather_q": (a - 1) * (batch * M * H * D * 4 + seg_bytes),
        "gather_kv": (b - 1) * (2 * batch * M * HKV * D * 4 + seg_bytes),
        "gather_lse": (a - 1) * a * batch * H * M * 4,
        "scatter_o": (a - 1) * batch * M * H * D * 4,
    }
    assert ring.stats.bytes == want
    assert ring.stats.hops == {kind: 1 for kind in want}
    if mask.needs_segments:
        assert calls == [batch] * (a * b * n)
    else:
        assert calls == [n * batch] * (a * b)


def test_group_collectives_are_adjoint_and_checked():
    """The grid's groups, the gather / reduce-scatter pair as each other's
    gradients, and the argument checks."""
    grid = Grid(2, 4)
    assert grid.members("aq", 5) == [1, 5] and grid.index("aq", 5) == 1
    assert grid.members("akv", 5) == [4, 5, 6, 7] and grid.index("akv", 5) == 1
    assert sorted(sum(grid.groups("aq"), [])) == list(range(8))
    ring = VirtualRing(8)
    x = torch.randn(8, 3, 5, dtype=torch.float64, requires_grad=True)
    y = torch.randn(8, 4, 3, 5, dtype=torch.float64, requires_grad=True)
    gx = ring.group_all_gather([x], grid, "akv", kind="t")[0]
    assert torch.equal(gx[5], x[[4, 5, 6, 7]])
    sy = ring.group_reduce_scatter(y, grid, "akv", kind="t")
    assert torch.allclose(sy[5], y[4, 1] + y[5, 1] + y[6, 1] + y[7, 1])
    # <gather(x), y> == <x, scatter(y)>: each is the other's adjoint
    assert torch.allclose((gx * y).sum(), (x * sy).sum())
    assert torch.autograd.gradcheck(
        lambda t: ring.group_all_gather([t], grid, "aq", kind="t", mode="bidir")[0],
        (x,))
    assert torch.autograd.gradcheck(lambda t: ring.group_reduce_scatter(t, grid, "akv", kind="t"),
                                    (y,))
    with pytest.raises(ValueError, match="grid"):
        ring.group_all_gather([x], Grid(2, 2), "aq", kind="t")
    with pytest.raises(ValueError, match="axis"):
        grid.members("sp", 0)
    q = torch.zeros(8, 1, 4, 2, 8)
    with pytest.raises(ValueError, match="ranks"):
        mesh_attention_collective(q, q, q, ring, 2, 2)
    with pytest.raises(ValueError, match="segment"):
        mesh_attention_collective(q, q, q, ring, 2, 4, mask=MaskSpec.document((16, 16)))
    with pytest.raises(ValueError):
        mesh_attention_collective(q, q, q, ring, 2, 4, comm_overlap="eager")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_ranks_match_the_virtual_ring(tmp_path):
    """4 gloo processes, one rank each over ``dist.new_group`` subgroups:
    every rank's o and gradients equal the virtual ring's bit for bit (the
    sums run in the same member order), and so do the hop, message and byte
    counts."""
    inputs = W.make_inputs()
    np.savez(tmp_path / "inputs.npz", **inputs)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, W.__file__, str(r), str(W.N), str(port),
             str(tmp_path / "inputs.npz"), str(tmp_path)],
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
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(W.N)]
    virtual = W.run_cases(VirtualRing(W.N), inputs)
    assert all(sorted(r) == sorted(virtual) for r in ranks)
    counts = [k for k in virtual if "::hops::" in k or "::bytes::" in k or "::messages::" in k]
    assert any(k.endswith("::bytes::scatter_o") for k in counts)
    for key in virtual:
        for r, got in enumerate(ranks):
            if key in counts:
                assert int(got[key]) == int(virtual[key]), key
            else:
                assert got[key].shape[0] == 1, key
                np.testing.assert_array_equal(got[key][0], virtual[key][r],
                                              err_msg=f"{key} rank {r}")
    # and the virtual ring's own result is attention: the causal case
    # against the port's local flash
    perm = W.order("striped")
    q, k, v = (torch.from_numpy(inputs[t]) for t in ("q", "k", "v"))
    o_ref = ops.flash_attention(q, k, v, causal=True)[:, perm]
    got = VirtualRing(W.N).join(torch.from_numpy(virtual["causal_striped::o"]))
    np.testing.assert_allclose(got.numpy(), o_ref.numpy(), atol=FWD_TOL, rtol=0)
