"""The port's dense decoder against the JAX package on reduced configs, fp32,
CPU, with the same weights (JAX init converted by ``params_from_jax``):
granite-8b, paper-mha-7b and qwen2.5-32b (QKV biases, drawn nonzero;
rope_theta 1e6).

Logits are held to atol 1e-4: fp32 sums run in another order in XLA and in
PyTorch on the CPU.  Cache contents the two write must agree to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.parallel.context import ParallelCtx as JCtx
from repro.serve.kv_pool import PagedLayout as JLayout
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import MLAConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.parallel.context import ParallelCtx as TCtx
from repro_torch.serve.kv_pool import PagedLayout as TLayout

LOGIT_TOL = 1e-4
JCTX = JCtx()
TCTX = TCtx(device="cpu")


def converted_weights(arch: str):
    """(jcfg, JAX params, tcfg, the port's params) of the reduced ``arch``.
    QKV biases (qwen2.5-32b), zeros at init in both packages, are drawn
    nonzero here so the bias branch counts."""
    jcfg = jget_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = dict(jparams["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(0.5 * rng.standard_normal(attn[name].shape), jnp.float32)
        jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=["granite-8b", "paper-mha-7b", "qwen2.5-32b"])
def model(request):
    return converted_weights(request.param)


def _close(t, j, tol=LOGIT_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def test_forward_logits_match_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    pos = np.arange(24, dtype=np.int32)
    jl, _ = jtfm.forward(jp, jcfg, JCTX, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)})
    tl = ttfm.forward(tp, tcfg, TCTX, {"tokens": torch.from_numpy(tokens),
                                      "positions": torch.from_numpy(pos)})
    _close(tl, jl)


def test_forward_packed_segments_match_jax(model):
    """Packed row: causal over the row index within each document, RoPE at
    per-document positions."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    lens = [7, 12, 5]
    tokens = rng.integers(0, jcfg.vocab_size, (1, sum(lens))).astype(np.int32)
    seg = np.repeat(np.arange(3), lens).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    jl, _ = jtfm.forward(jp, jcfg, JCTX, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
                                          "segments": jnp.asarray(seg)})
    tl = ttfm.forward(tp, tcfg, TCTX, {"tokens": torch.from_numpy(tokens),
                                      "positions": torch.from_numpy(pos),
                                      "segments": torch.from_numpy(seg)})
    _close(tl, jl)


def _jax_decode(jp, jcfg, jcache, first, steps):
    """Greedy JAX decode; returns per-step logits and the token feed."""
    toks, logits = [first], []
    for _ in range(steps):
        nxt, jcache, lg = jtfm.decode_step(jp, jcache, jnp.asarray(toks[-1]), jcfg, JCTX)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
    return toks, logits, jcache


def test_prefill_and_decode_match_jax_dense(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    B, S, cap = 2, 16, 32
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    length = np.array([11, 16], np.int32)
    pos = np.arange(S, dtype=np.int32)
    jcache = jtfm.init_cache(jcfg, B, cap, dtype=jnp.float32)
    jl, jcache = jtfm.prefill(jp, jcfg, JCTX, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
                                               "length": jnp.asarray(length)}, jcache)
    tcache = ttfm.init_cache(tcfg, B, cap, dtype=torch.float32, ctx=TCTX)
    tl, tcache = ttfm.prefill(tp, tcfg, TCTX, {"tokens": torch.from_numpy(tokens),
                                              "positions": torch.from_numpy(pos),
                                              "length": torch.from_numpy(length)}, tcache)
    _close(tl, jl)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for b, n in enumerate(length):
        _close(tcache["k"][:, b, :n], jcache["k"][:, b, :n], 1e-5)
        _close(tcache["v"][:, b, :n], jcache["v"][:, b, :n], 1e-5)
    first = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)  # [B, 1]
    toks, jlogits, _ = _jax_decode(jp, jcfg, jcache, first, 4)
    for step in range(4):
        _, tcache, tlg = ttfm.decode_step(tp, tcache, torch.from_numpy(np.array(toks[step])), tcfg, TCTX)
        _close(tlg, jlogits[step])
    assert tcache["pos"].tolist() == (length + 4).tolist()


def test_prefill_and_decode_match_jax_paged(model):
    """Paged pool: two slots with shuffled block tables (-1 past depth),
    prefilled one at a time, then decoded together at mixed depths."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    ps, max_pages, num_pages = 4, 8, 20
    lens = [9, 14]
    bt = np.full((2, max_pages), -1, np.int32)
    bt[0, :4] = [7, 2, 11, 0]
    bt[1, :5] = [5, 19, 3, 8, 13]
    jcache = jtfm.init_cache(jcfg, 2, ps * max_pages, dtype=jnp.float32,
                             paged=JLayout(num_pages, ps, max_pages, 1))
    jcache["bt"] = jnp.asarray(bt)
    tcache = ttfm.init_cache(tcfg, 2, ps * max_pages, dtype=torch.float32, ctx=TCTX,
                             paged=TLayout(num_pages, ps, max_pages, 1))
    tcache["bt"] = torch.from_numpy(bt)
    firsts = []
    for slot, n in enumerate(lens):
        bucket = 16
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = rng.integers(0, jcfg.vocab_size, n)
        pos = np.arange(bucket, dtype=np.int32)
        jl, jcache = jtfm.prefill(jp, jcfg, JCTX, {
            "tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
            "length": jnp.asarray([n], jnp.int32), "slot": jnp.int32(slot),
            "shared_len": jnp.int32(0)}, jcache)
        tl, tcache = ttfm.prefill(tp, tcfg, TCTX, {
            "tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos),
            "length": torch.tensor([n]), "slot": slot, "shared_len": 0}, tcache)
        _close(tl, jl)
        firsts.append(np.asarray(jnp.argmax(jl[0], axis=-1)).astype(np.int32))
    assert tcache["pos"].tolist() == lens
    _close(tcache["k"], jcache["k"], 1e-5)  # unwritten pages stay zero in both
    toks, jlogits, _ = _jax_decode(jp, jcfg, jcache, np.stack(firsts), 3)
    for step in range(3):
        _, tcache, tlg = ttfm.decode_step(tp, tcache, torch.from_numpy(np.array(toks[step])), tcfg, TCTX)
        _close(tlg, jlogits[step])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_packed_matches_jax(model, paged):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    lens, slots, bucket, cap = [5, 9, 3], [2, 0, 1], 32, 32
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, : sum(lens)] = rng.integers(0, jcfg.vocab_size, sum(lens))
    seg = np.full(bucket, len(lens), np.int32)
    seg[: sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    pos = np.zeros(bucket, np.int32)
    pos[: sum(lens)] = np.concatenate([np.arange(n) for n in lens])
    if paged:
        layout = dict(num_pages=16, page_size=4, max_pages=8, n=1)
        bt = np.full((3, 8), -1, np.int32)
        bt[0, :3], bt[1, :1], bt[2, :2] = [4, 9, 1], [12], [0, 15]
        jcache = jtfm.init_cache(jcfg, 3, cap, dtype=jnp.float32, paged=JLayout(**layout))
        jcache["bt"] = jnp.asarray(bt)
        tcache = ttfm.init_cache(tcfg, 3, cap, dtype=torch.float32, ctx=TCTX,
                                 paged=TLayout(**layout))
        tcache["bt"] = torch.from_numpy(bt)
    else:
        jcache = jtfm.init_cache(jcfg, 3, cap, dtype=jnp.float32)
        tcache = ttfm.init_cache(tcfg, 3, cap, dtype=torch.float32, ctx=TCTX)
    jbatch = {"tokens": tokens, "positions": pos, "segments": seg,
              "doc_lens": np.asarray(lens, np.int32), "slots": np.asarray(slots, np.int32)}
    jl, jcache = jtfm.prefill_packed(jp, jcfg, JCTX, {k: jnp.asarray(v) for k, v in jbatch.items()},
                                     jcache)
    tl, tcache = ttfm.prefill_packed(tp, tcfg, TCTX, {k: torch.from_numpy(v) for k, v in jbatch.items()},
                                     tcache)
    _close(tl, jl)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    _close(tcache["k"], jcache["k"], 1e-5)
    _close(tcache["v"], jcache["v"], 1e-5)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    for positions in (np.arange(6), rng.integers(0, 500, (2, 6))):
        positions = positions.astype(np.int32)
        _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(positions)),
               jlayers.rope(jnp.asarray(x), jnp.asarray(positions)), 1e-5)


def test_init_params_mirrors_jax_pytree(model):
    jcfg, jp, tcfg, _ = model
    mine = ttfm.init_params(tcfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert tshapes == jshapes
    # truncated normal at 1/sqrt(fan_in), cut at 2 std; norm gains start at 0
    w = mine["layers"]["mlp"]["w1"]
    std = jcfg.d_model**-0.5
    assert abs(float(w.std()) / std - 0.88) < 0.05 and float(w.abs().max()) <= 2 * std + 1e-6
    assert torch.count_nonzero(mine["final_ln"]) == 0
    # QKV biases start at zero, as JAX's do
    for name in ("bq", "bk", "bv"):
        assert (name in mine["layers"]["attn"]) == tcfg.qkv_bias
        if tcfg.qkv_bias:
            assert torch.count_nonzero(mine["layers"]["attn"][name]) == 0
    again = ttfm.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], mine["embed"])


def test_params_from_jax_keeps_bf16_and_layout(model):
    jcfg, jp, _, tp = model
    # every leaf carries over as it is, the QKV biases included
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jleaves:
        got = tp
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    wq = np.asarray(jp["layers"]["attn"]["wq"].astype(jnp.bfloat16))
    got = params_from_jax({"wq": wq}, device="cpu")["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == wq.shape
    np.testing.assert_array_equal(got.float().numpy(), wq.astype(np.float32))


def test_other_families_raise():
    """The MoE, VLM and audio families are ported (their archs resolve, and
    a decoder given an encoder builds its encoder and cross-attention), and
    so is MLA in the dense family: minicpm3-4b resolves and a reduced MLA
    config builds its latent projections.  A config off its family still
    raises."""
    assert tget_config("mixtral-8x7b").family == "moe"
    assert tget_config("qwen2-moe-a2.7b").moe.num_shared == 4
    assert tget_config("pixtral-12b").family == "vlm"
    assert tget_config("whisper-base").family == "audio"
    assert tget_config("minicpm3-4b").mla.kv_lora_rank == 256
    base = tget_config("granite-8b").reduced()
    params = ttfm.init_params(dataclasses.replace(base, encoder_layers=2), device="cpu")
    assert params["encoder"]["layers"]["attn"]["wq"].shape[0] == 2
    assert params["layers"]["xattn"]["wk"].shape[0] == base.num_layers
    mla = ttfm.init_params(dataclasses.replace(base, mla=MLAConfig(32, 16, 16, 16, 32)),
                           device="cpu")
    assert mla["layers"]["attn"]["wkv_b"].shape == (base.num_layers, 16, 4 * (16 + 32))
    for cfg, what in (
        (dataclasses.replace(base, family="moe", mla=MLAConfig(32, 16, 16, 16, 32)),
         "MLA off the dense family"),
        (dataclasses.replace(base, family="moe"), "MoE config off its family"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            ttfm.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("minicpm3-8b")


@pytest.mark.parametrize("shared_coords", [False, True], ids=["per_call", "per_tick"])
def test_paged_cache_update_drops_like_jax(shared_coords):
    """Decode append through the block table: rows on unallocated pages and
    rows past virtual capacity write nothing (JAX drops them), every other
    row lands at (page, offset); coordinates computed once per tick give the
    same pool."""
    from repro.core import decode_attention as jda
    from repro_torch.core import decode_attention as tda

    rng = np.random.default_rng(4)
    num_pages, ps, max_pages, hkv, d = 9, 4, 3, 2, 8
    bt = np.array([[3, -1, -1], [0, 5, -1], [7, 1, 2], [4, 6, 8]], np.int32)
    # row 0 writes page 3; row 1 points at an unallocated page; row 2 writes
    # its last slot; row 3 sits past the virtual capacity of 12
    pos = np.array([2, 9, 11, 12], np.int32)
    pool = rng.standard_normal((2, num_pages, ps, hkv, d)).astype(np.float32)
    new = rng.standard_normal((2, 4, 1, hkv, d)).astype(np.float32)
    jk, jv = jda.paged_cache_update(jnp.asarray(pool[0]), jnp.asarray(pool[1]), jnp.asarray(new[0]),
                                    jnp.asarray(new[1]), jnp.asarray(bt), jnp.asarray(pos), None, 1)
    tk, tv = torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy())
    tbt, tpos = torch.from_numpy(bt), torch.from_numpy(pos)
    coords = tda.paged_write_coords(tbt, tpos, ps, None, 1) if shared_coords else None
    tda.paged_cache_update(tk, tv, torch.from_numpy(new[0]), torch.from_numpy(new[1]), tbt, tpos,
                           None, 1, coords=coords)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    changed = np.nonzero((tk.numpy() != pool[0]).any(axis=(1, 2, 3)))[0].tolist()
    assert changed == [2, 3]  # only rows 0 and 2 wrote
