"""The port's Mesh-Attention executor (``repro_torch.core.mesh_attention``
over a ``VirtualRing``) against the JAX package's executor run rank by rank
under ``jax.vmap(..., axis_name="sp")`` on the CPU, with JAX's default
backend there (its jnp reference).

Inputs come from ``numpy.random.default_rng`` with the seed each case
states.  Cases cover (n, a) in {(4,1), (4,2), (4,4), (8,2)}; full, causal,
window, document, segment and block-sparse masks; striped and contiguous
layouts; GQA (H 4, Hkv 2); both backward wires; D 8-16; S/n 8-16.  Limits:
per-rank o and lse within 2e-5 and the gradients of ``sum(sin(o))`` within
5e-5 (JAX's dist_check ``mesh_fwd`` / ``mesh_bwd``), also against the
single-device ``ref.attention_ref`` on the unstriped sequence.  The three
comm_overlap modes must be bitwise equal, and a mask-pruned schedule must
give the unpruned one's o and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmask
from repro.core import mesh_attention as jma
from repro.core import schedule as jS
from repro.core import ulysses as jul
from repro_torch.core import dispatch
from repro_torch.core import masking as tmask
from repro_torch.core import mesh_attention as tma
from repro_torch.core import schedule as tS
from repro_torch.core.ring_attention import ring_config
from repro_torch.core.tiling import factorizations, stripe_permutation, unstripe_permutation
from repro_torch.core.ulysses import ulysses_attention
from repro_torch.kernels import ref as tref
from repro_torch.parallel.ring import VirtualRing

FWD_TOL = 2e-5
GRAD_TOL = 5e-5


@dataclasses.dataclass(frozen=True)
class Case:
    n: int
    a: int
    mask: tuple  # (kind, kwargs)
    layout: str = "striped"
    heads: tuple = (2, 2)  # (H, Hkv)
    D: int = 16
    m: int = 16  # S / n
    B: int = 1
    wire: str = "qdod"
    seed: int = 0
    ring_schedule: bool = False  # the ring backend's schedule (a = 1)

    @property
    def S(self):
        return self.n * self.m

    def spec(self, mod):
        kind, kw = self.mask
        if kind == "block_sparse":
            n = self.n
            return mod.MaskSpec.block_sparse(
                [[i == j or (i + 3 * j) % 4 == 1 for j in range(n)] for i in range(n)])
        if kind == "document":
            return mod.MaskSpec.document([self.S * 3 // 8, self.S // 8, self.S // 2])
        if kind == "full":
            return mod.MaskSpec.full()
        return getattr(mod.MaskSpec, kind)(**kw)

    def id(self):
        kind, kw = self.mask
        w = f"w{kw['window']}" if kw.get("window") else ""
        return (f"n{self.n}a{self.a}-{kind}{w}-{self.layout}-H{self.heads[0]}kv{self.heads[1]}"
                f"-D{self.D}m{self.m}-{self.wire}" + ("-ringsched" if self.ring_schedule else ""))


CASES = [
    Case(4, 2, ("causal", {})),
    Case(4, 2, ("causal", {}), heads=(4, 2), D=8, m=8, wire="odoq", seed=1),
    Case(4, 1, ("causal", {}), seed=2),
    Case(4, 1, ("causal", {}), seed=3, ring_schedule=True, wire="odoq"),
    Case(4, 4, ("causal", {}), heads=(4, 2), seed=4),
    Case(8, 2, ("causal", {}), heads=(4, 2), D=8, m=8, seed=5),
    Case(4, 2, ("full", {}), layout="contiguous", seed=6),
    Case(4, 4, ("causal", {"window": 12}), D=8, seed=7),
    Case(8, 2, ("causal", {"window": 20}), layout="contiguous", D=8, m=8, wire="odoq", seed=8),
    Case(4, 2, ("document", {}), heads=(4, 2), seed=9),
    Case(4, 4, ("document", {}), layout="contiguous", D=8, wire="odoq", seed=10),
    Case(4, 2, ("segment", {}), D=8, m=8, seed=11),
    Case(4, 2, ("block_sparse", {}), layout="contiguous", D=8, seed=12),
    Case(8, 2, ("block_sparse", {}), D=8, m=8, wire="odoq", seed=13),
]


def _order(case):
    return stripe_permutation(case.S, case.n) if case.layout == "striped" else np.arange(case.S)


def _inverse(case):
    return unstripe_permutation(case.S, case.n) if case.layout == "striped" else np.arange(case.S)


def _chunks(x, n):
    """[B, S, ...] in the layout's order -> [n, B, S/n, ...]."""
    return np.ascontiguousarray(np.moveaxis(x.reshape(x.shape[0], n, -1, *x.shape[2:]), 1, 0))


def _global(y):
    """[n, B, m, ...] -> [B, n*m, ...]."""
    y = np.moveaxis(np.asarray(y), 0, 1)
    return y.reshape(y.shape[0], -1, *y.shape[3:])


def _inputs(case):
    rng = np.random.default_rng(case.seed)
    H, Hkv = case.heads
    q = rng.standard_normal((case.B, case.S, H, case.D)).astype(np.float32)
    k = rng.standard_normal((case.B, case.S, Hkv, case.D)).astype(np.float32)
    v = rng.standard_normal((case.B, case.S, Hkv, case.D)).astype(np.float32)
    seg = None
    kind = case.mask[0]
    if kind == "document":
        seg = case.spec(tmask).segment_array(case.S)
    elif kind == "segment":
        seg = np.repeat(np.arange(3, dtype=np.int32), [case.S // 4, case.S // 2, case.S // 4])
    return q, k, v, seg


def _port_cfg(case, ring, **kw):
    if case.ring_schedule:
        cfg = ring_config(ring, case.n, causal=True)
        return dataclasses.replace(cfg, bwd_wire=case.wire, **kw)
    return tma.MeshAttentionConfig(transport=ring, n=case.n, a=case.a, mask=case.spec(tmask),
                                   layout=case.layout, bwd_wire=case.wire, **kw)


def _jax_cfg(case):
    kw = dict(axis_name="sp", n=case.n, a=case.a, layout=case.layout, bwd_wire=case.wire)
    if case.ring_schedule:
        return jma.MeshAttentionConfig(causal=True, fwd_schedule=jS.ring_forward_schedule(case.n),
                                       **kw)
    return jma.MeshAttentionConfig(mask=case.spec(jmask), **kw)


def _jax_run(case, qs, ks, vs, segs):
    cfg = _jax_cfg(case)

    def fwd(q, k, v, s):
        return jma.mesh_attention_with_lse(q, k, v, cfg, seg=s)

    def loss(q, k, v, s):
        return jnp.sum(jnp.sin(jma.mesh_attention(q, k, v, cfg, seg=s)))

    args = [jnp.asarray(x) for x in (qs, ks, vs)]
    if segs is None:
        o, lse = jax.vmap(lambda q, k, v: fwd(q, k, v, None), axis_name="sp")(*args)
        grads = jax.vmap(jax.grad(lambda q, k, v: loss(q, k, v, None), argnums=(0, 1, 2)),
                         axis_name="sp")(*args)
    else:
        args.append(jnp.asarray(segs))
        o, lse = jax.vmap(fwd, axis_name="sp")(*args)
        grads = jax.vmap(jax.grad(loss, argnums=(0, 1, 2)), axis_name="sp")(*args)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port_run(cfg, qs, ks, vs, segs):
    x = [torch.from_numpy(t) for t in (qs, ks, vs)]
    seg = None if segs is None else torch.from_numpy(segs)
    o, lse = tma.mesh_attention_with_lse(*x, cfg, seg=seg)
    xg = [t.clone().requires_grad_(True) for t in x]
    o2 = tma.mesh_attention(*xg, cfg, seg=seg)
    grads = torch.autograd.grad(o2.sin().sum(), xg)
    assert torch.equal(o2.detach(), o)
    return o.numpy(), lse.numpy(), [g.numpy() for g in grads]


def _prepare(case):
    q, k, v, seg = _inputs(case)
    order = _order(case)
    qs, ks, vs = (_chunks(x[:, order], case.n) for x in (q, k, v))
    segs = None if seg is None else seg[order].reshape(case.n, case.m)
    return (q, k, v, seg), (qs, ks, vs, segs)


@pytest.mark.parametrize("case", CASES, ids=Case.id)
def test_executor_matches_jax_rank_by_rank(case):
    (q, k, v, seg), (qs, ks, vs, segs) = _prepare(case)
    ring = VirtualRing(case.n)
    o, lse, grads = _port_run(_port_cfg(case, ring), qs, ks, vs, segs)
    jo, jlse, jgrads = _jax_run(case, qs, ks, vs, segs)
    np.testing.assert_allclose(o, jo, atol=FWD_TOL, rtol=0)
    live = jlse > tref.NEG_INF / 2
    np.testing.assert_allclose(lse[live], jlse[live], atol=FWD_TOL, rtol=0)
    assert np.array_equal(lse[~live], jlse[~live])
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")
    # against the single-device reference on the unstriped sequence (a
    # block-sparse bitmap names the chunks of the layout's own order)
    mask = torch.from_numpy(case.spec(tmask).dense_mask(case.S, segments=seg))
    inv = _inverse(case)
    if case.mask[0] == "block_sparse":
        q, k, v = (x[:, _order(case)] for x in (q, k, v))
        inv = np.arange(case.S)
    xt = [torch.from_numpy(np.ascontiguousarray(t)).requires_grad_(True) for t in (q, k, v)]
    want, _ = tref.masked_attention(*xt, mask, case.D**-0.5)
    gwant = torch.autograd.grad(want.sin().sum(), xt)
    np.testing.assert_allclose(_global(o)[:, inv], want.detach().numpy(), atol=FWD_TOL, rtol=0)
    for g, gw in zip(grads, gwant):
        np.testing.assert_allclose(_global(g)[:, inv], gw.numpy(), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("case", [c for c in CASES if c.n == 4][:6], ids=Case.id)
def test_comm_overlap_modes_bitwise_equal(case):
    _, (qs, ks, vs, segs) = _prepare(case)
    runs = {}
    for mode in tS.COMM_OVERLAP_MODES:
        ring = VirtualRing(case.n)
        runs[mode] = _port_run(_port_cfg(case, ring, comm_overlap=mode), qs, ks, vs, segs)
        runs[mode] += (dict(ring.stats.bytes), dict(ring.stats.hops))
    base = runs["serial"]
    for mode, got in runs.items():
        assert np.array_equal(got[0], base[0]) and np.array_equal(got[1], base[1]), mode
        for g, b in zip(got[2], base[2]):
            assert np.array_equal(g, b), mode
        assert got[3] == base[3] and got[4] == base[4], mode  # the same hops and bytes


# the cases whose masks prove blocks empty on every rank: contiguous
# documents and windows, and the bitmaps (striped documents interleave)
PRUNABLE = [c for c in CASES if c.mask[0] == "block_sparse"
            or (c.mask[0] in ("document", "causal") and c.layout == "contiguous")]
PRUNABLE += [Case(8, 4, ("causal", {"window": 10}), layout="contiguous", D=8, m=8, seed=14)]


@pytest.mark.parametrize("case", PRUNABLE, ids=Case.id)
def test_pruned_schedule_matches_unpruned(case):
    _, (qs, ks, vs, segs) = _prepare(case)
    ring = VirtualRing(case.n)
    cfg = _port_cfg(case, ring)
    pruned_fwd, pruned_bwd = cfg.schedules(case.S)
    assert pruned_fwd.skip, "the case must prune blocks"
    full = dataclasses.replace(
        cfg, fwd_schedule=tS.greedy_forward_schedule(case.a, case.n // case.a),
        bwd_schedule=tS.greedy_backward_schedule(case.a, case.n // case.a))
    o, lse, grads = _port_run(cfg, qs, ks, vs, segs)
    fo, flse, fgrads = _port_run(full, qs, ks, vs, segs)
    np.testing.assert_allclose(o, fo, atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse, flse, atol=1e-6, rtol=0)
    for g, fg in zip(grads, fgrads):
        np.testing.assert_allclose(g, fg, atol=1e-6, rtol=0)


def test_transport_counts_match_the_schedules_and_comm_model():
    """Hops per kind equal ``comm_requirements``; the Q and KV hops' bytes
    equal ``CommModel.chunk_bytes`` x count (fp32 payloads)."""
    from repro_torch.core.am import CommModel

    case = Case(8, 2, ("causal", {}), heads=(4, 2), D=8, m=8, seed=5)
    _, (qs, ks, vs, segs) = _prepare(case)
    for a, b in factorizations(case.n):
        ring = VirtualRing(case.n)
        cfg = dataclasses.replace(_port_cfg(case, ring), a=a)
        fwd, bwd = cfg.schedules(case.S)
        tma.mesh_attention_with_lse(*(torch.from_numpy(t) for t in (qs, ks, vs)), cfg)
        want = {k: c for k, c in tS.comm_requirements(a, b, "fwd", fwd.skip).items() if c}
        assert ring.stats.hops == want
        comm = CommModel(seq=case.S, hidden=4 * 8, n=case.n, kv_hidden=2 * 8, bytes_per_elem=4)
        assert ring.stats.bytes.get("recv_q", 0) == want.get("recv_q", 0) * comm.chunk_bytes("q")
        assert ring.stats.bytes.get("recv_kv", 0) == want.get("recv_kv", 0) * comm.chunk_bytes("kv")
        ring.stats.reset()
        x = [torch.from_numpy(t).requires_grad_(True) for t in (qs, ks, vs)]
        tma.mesh_attention(*x, cfg).sum().backward()
        both = {}
        for d, s in (("fwd", fwd), ("bwd", bwd)):
            for kind, c in tS.comm_requirements(a, b, d, s.skip).items():
                if c:
                    both[kind] = both.get(kind, 0) + c
        assert ring.stats.hops == both


@pytest.mark.parametrize("n", [4, 8])
def test_dispatch_runs_every_factorization(n):
    """``dispatch.distributed_attention`` with ``mesh`` at every a of n, and
    ``ring``, on the global striped view = the local causal result."""
    rng = np.random.default_rng(20 + n)
    B, S, H, Hkv, D = 1, 8 * n, 4, 2, 8
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, Hkv, Hkv))
    want, _ = tref.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), scale=D**-0.5,
                                 band=(0, 0, 0, tref.BAND_INF))
    order = torch.from_numpy(stripe_permutation(S, n))
    inv = torch.from_numpy(unstripe_permutation(S, n))
    ring = VirtualRing(n)
    for backend, a in [("mesh", a) for a, _ in factorizations(n)] + [("ring", 1)]:
        cfg = dispatch.AttentionPlanConfig(backend=backend, transport=ring, n=n, a=a, causal=True)
        o = dispatch.distributed_attention(*(torch.from_numpy(x)[:, order] for x in (q, k, v)),
                                           cfg=cfg)
        np.testing.assert_allclose(o[:, inv].numpy(), want.numpy(), atol=FWD_TOL, rtol=0,
                                   err_msg=f"{backend} a={a}")


def test_dispatch_autotune_and_document_segments(tmp_path):
    """Autotuned mesh plans come through the plan cache; a document mask's
    segment ids are synthesized and striped by the seam, as in JAX."""
    n, m, H, D = 4, 8, 2, 8
    S = n * m
    rng = np.random.default_rng(30)
    q, k, v = (rng.standard_normal((1, S, H, D)).astype(np.float32) for _ in range(3))
    spec = tmask.MaskSpec.document([12, 20])
    want, _ = tref.masked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    torch.from_numpy(spec.dense_mask(S)), D**-0.5)
    order = torch.from_numpy(stripe_permutation(S, n))
    inv = torch.from_numpy(unstripe_permutation(S, n))
    cfg = dispatch.AttentionPlanConfig(backend="mesh", transport=VirtualRing(n), n=n, mask=spec,
                                       autotune=True, plan_cache_dir=str(tmp_path))
    dispatch.clear_plan_cache(cfg)
    o = dispatch.distributed_attention(*(torch.from_numpy(x)[:, order] for x in (q, k, v)), cfg=cfg)
    np.testing.assert_allclose(o[:, inv].numpy(), want.numpy(), atol=FWD_TOL, rtol=0)
    assert len(list(tmp_path.glob("*.json"))) == 1
    dispatch.clear_plan_cache(cfg)


@pytest.mark.parametrize("seg", [False, True], ids=["causal", "segments"])
def test_ulysses_matches_jax(seg):
    n, m, H, Hkv, D, B = 4, 8, 8, 4, 8, 2
    S = n * m
    rng = np.random.default_rng(40 + seg)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    s = np.repeat(np.arange(2, dtype=np.int32), [S // 4, 3 * S // 4]) if seg else None
    qs, ks, vs = (_chunks(x, n) for x in (q, k, v))
    segs = None if s is None else s.reshape(n, m)
    args = [jnp.asarray(x) for x in (qs, ks, vs)]
    if segs is None:
        jo = jax.vmap(lambda q, k, v: jul.ulysses_attention(q, k, v, "sp", n, causal=True),
                      axis_name="sp")(*args)
    else:
        jo = jax.vmap(lambda q, k, v, s: jul.ulysses_attention(q, k, v, "sp", n, causal=True,
                                                               seg=s),
                      axis_name="sp")(*args, jnp.asarray(segs))
    x = [torch.from_numpy(t).requires_grad_(True) for t in (qs, ks, vs)]
    o = ulysses_attention(*x, VirtualRing(n), n, causal=True,
                          seg=None if segs is None else torch.from_numpy(segs))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=FWD_TOL, rtol=0)
    # gradients through the all-to-alls = the local op's
    grads = torch.autograd.grad(o.sin().sum(), x)
    xl = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    mask = None
    if s is not None:
        mask = torch.from_numpy(tmask.MaskSpec.segment().dense_mask(S, segments=s))
    else:
        mask = torch.from_numpy(tmask.MaskSpec.causal().dense_mask(S))
    want, _ = tref.masked_attention(*xl, mask, D**-0.5)
    gw = torch.autograd.grad(want.sin().sum(), xl)
    for g, w in zip(grads, gw):
        np.testing.assert_allclose(_global(g.numpy()), w.numpy(), atol=GRAD_TOL, rtol=0)
