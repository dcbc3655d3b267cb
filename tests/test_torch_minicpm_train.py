"""minicpm3-4b (Multi-head Latent Attention) trained in the port against the
JAX package, on the CPU, fp32.

The model variants are ``tests/test_torch_minicpm.py``'s: "reduced" (JAX's
reduced MLA, v_head_dim = qk = 32) and "v16" (v_head_dim 16 < qk 24: V
padded from 16 to 24 and o sliced back), with JAX's ``init_params``
converted by ``params_from_jax``.  The training forward expands the latent
per head, so its attention runs the flash forward and backward at the qk
width (96 in the full config).  Held to JAX here:

  * the flash backward's plain version at head dim 96 (40 / 40 heads, and a
    group of 2) against JAX's Pallas backward in interpret mode (blocks of
    32), to ``BWD_TOL``, with the body the card would take;
  * ``loss_fn`` and its gradients against ``jax.value_and_grad`` (causal
    and packed documents; remat on and off bitwise equal), and three train
    steps, with ``tests/test_torch_train.py``'s limits (loss 1e-5, every
    gradient leaf 1e-4, params 1e-4);
  * the loss and gradients at sp_size 4 on a ``VirtualRing`` (mesh a = 2,
    and ring; causal and documents) against JAX at sp_size 1, with
    ``tests/test_torch_mesh_train.py``'s limits;
  * the train CLI at the reduced config, alone and over the ring.

Over a ring the engine serves MLA and ``mla_latent_wire`` trains (JAX at
sp_size 4 holds both in tests/test_torch_mla_ring.py).  Inputs come from
numpy with fixed seeds.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_train as tmesh
import test_torch_minicpm as tmini
import test_torch_train as ttrain
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.config import ServeConfig as TServe
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import loop as tloop

ARCH = tmini.ARCH
INF = jref.BAND_INF
TCTX = TCtx(device="cpu")
# tests/test_torch_gemma.py's backward tolerance against the Pallas backward
BWD_TOL = 2e-4
VARIANTS = ("reduced", "v16")


@pytest.fixture(scope="module", params=VARIANTS)
def model(request):
    """(jcfg, JAX params, tcfg, the port's params) of one variant."""
    return tmini._converted(request.param)


# name -> (S, H, Hkv, band, segments): causal MHA at minicpm's 40 / 40
# heads, a window with packed documents at a group of 2, and a ragged S
# (not a multiple of the kernels' 64-row tiles)
BWD_CASES = {
    "causal_mha": (64, 40, 40, (0, 0, 0, INF), False),
    "window_segments_gqa2": (64, 4, 2, (0, 0, 0, 23), True),
    "ragged": (40, 4, 4, (0, 0, 0, INF), False),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_flash_bwd_plain_d96_matches_pallas(name):
    """The backward's plain version (and the wrapper on CPU tensors) at head
    dim 96 against JAX's Pallas backward in interpret mode, with the body
    the card would take."""
    S, H, Hkv, band, seg = BWD_CASES[name]
    B, D = 1, 96
    block = 32 if S % 32 == 0 else S  # Pallas tiles must divide S
    rng = np.random.default_rng(zlib.crc32(f"bwd96{name}".encode()))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
    jkw, tkw = {}, {}
    if seg:
        ids = np.sort(rng.integers(0, 3, S)).astype(np.int32)
        jkw = dict(seg_q=jnp.asarray(ids), seg_kv=jnp.asarray(ids))
        tkw = dict(seg_q=torch.from_numpy(ids), seg_kv=torch.from_numpy(ids))
    scale = D**-0.5
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    oj, lsej = jref.attention_ref(qj, kj, vj, scale=scale, band=band, **jkw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    ot, lset = torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lsej))
    plain = tref.attention_bwd_ref(qt, kt, vt, ot, lset, dot, scale=scale, band=band, **tkw)
    wrapped = tfa.flash_attention_bwd(qt, kt, vt, ot, lset, dot, band, scale=scale, **tkw)
    pallas = jfa.flash_attention_bwd(qj, kj, vj, oj, lsej, doj, jnp.asarray(band, jnp.int32),
                                     scale=scale, block_q=block, block_kv=block, interpret=True,
                                     **jkw)
    for g, w, p in zip(plain, wrapped, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=BWD_TOL, rtol=BWD_TOL)
        assert torch.equal(g, w)
    assert tfa._bwd_plan(B, S, S, H, Hkv, D, torch.float32) == "tc_fp32"
    assert tfa._bwd_plan(B, S, S, H, Hkv, D, torch.bfloat16) == "tc_bf16"


@pytest.mark.parametrize("docs", [None, 3], ids=["causal", "docs"])
def test_loss_and_grads_match_jax(model, docs):
    """loss_fn and its gradients (the latent projections, the expanded heads,
    V's padding and o's slice, the flash backward's plain version) against
    jax.value_and_grad; remat on and off bitwise equal."""
    ttrain.test_loss_and_grads_match_jax(model[:3], docs)


@pytest.mark.parametrize("variant", VARIANTS)
def test_three_train_steps_match_jax(variant):
    jcfg, _, tcfg, _ = tmini._converted(variant)
    ttrain.three_train_steps_match_jax(jcfg, tcfg)


@pytest.mark.parametrize("impl", ["mesh", "ring"])
@pytest.mark.parametrize("docs", [None, 2], ids=["causal", "docs"])
def test_ring_loss_and_grads_match_jax(model, impl, docs):
    """sp_size 4 on a VirtualRing (the expanded heads through the
    Mesh-Attention executor, striped) against JAX at sp_size 1; KV hops in
    every layer's forward (twice with remat) and backward."""
    assert model[2].causal_layout == "striped"
    tmesh.test_ring_loss_and_grads_match_jax(model[:3], impl, docs)


@pytest.mark.parametrize("fake_devices", [0, 8], ids=["one_rank", "ring"])
def test_launch_train_cpu(fake_devices, capsys):
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2", "--seq", "32",
            "--batch", "1"]
    if fake_devices:
        argv += ["--fake-devices", str(fake_devices), "--tile-a", "2"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    ring = "VirtualRing(n=4) attn=mesh a=2" if fake_devices else "none"
    assert f"ring={ring}" in out and "done: step=2 final_loss=" in out


def test_serving_and_the_latent_wire_over_a_ring_raise(model):
    """Nothing of MLA raises over a ring any more (ROADMAP A.9's MLA bullet
    is done): at sp_size 4 the engine serves from the sharded latent cache
    (the streams of sp_size 1), and ``mla_latent_wire`` trains -- the step
    builds and runs, and (v16: V padded under the wire, which the reduced
    config of tests/test_torch_mla_ring.py does not reach) loss_fn through
    the wire gives the expanded heads' loss and gradients; at sp_size 1 the
    wire flag changes nothing, as in JAX.  JAX at sp_size 4 holds both in
    tests/test_torch_mla_ring.py."""
    _, _, tcfg, tparams = model
    ring = TCtx(sp_size=4, device="cpu")
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 12), dtype=np.int32)
    streams = [TEngine(tcfg, tparams, ctx, serve=TServe(max_seq=64, num_slots=2))
               .generate(prompts, 4) for ctx in (TCTX, ring)]
    assert np.array_equal(*streams)
    wire = TCtx(sp_size=4, device="cpu", mla_latent_wire=True)
    batch = tpipe.make_batch(tcfg, 32, 1, ctx=wire)
    params = tadamw.tree_map(torch.clone, tparams)
    _, _, _, metrics = tloop.make_train_step(tcfg, wire, tadamw.AdamWConfig())(
        params, tadamw.init_opt_state(params), {}, batch)
    assert np.isfinite(float(metrics["loss"])) and wire.ring.stats.bytes["recv_kv"] > 0
    m = tcfg.mla
    if m.v_head_dim < m.qk_nope_head_dim + m.qk_rope_head_dim:  # V padded under the wire
        leaves = [leaf for _, leaf in tadamw.tree_leaves(tparams)]
        grads = {}
        for name, ctx in (("expanded", ring), ("wire", wire)):
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, _ = ttfm.loss_fn(tparams, tcfg, ctx, batch)
            grads[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
            for leaf in leaves:
                leaf.requires_grad_(False)
        torch.testing.assert_close(grads["wire"][0], grads["expanded"][0], atol=1e-5, rtol=0)
        for g, e in zip(grads["wire"][1], grads["expanded"][1]):
            torch.testing.assert_close(g, e, atol=5e-5 * float(e.abs().max()), rtol=0)
    one = tpipe.make_batch(tcfg, 16, 1, ctx=TCTX)
    loss, _ = ttfm.loss_fn(tparams, tcfg, TCTX, one)
    loss_wire, _ = ttfm.loss_fn(tparams, tcfg, TCtx(device="cpu", mla_latent_wire=True), one)
    assert torch.equal(loss, loss_wire)
