"""JAX's MoE over a sequence axis of 4: ``repro.models.moe.moe_block``
(which takes ``_moe_ep_segmented`` for an "ep" arch when the experts and S
divide by 4) and ``_moe_ep_manual``, ``transformer.loss_fn`` with its
gradients, and ``ServeEngine``, on a (2, 4) mesh of fake CPU devices with
Auto axes (``with_sharding_constraint`` in the segmented form needs them).
The device count is set before JAX starts, so this runs in its own process.

    python tests/jax_moe_ep_worker.py INPUTS.npz OUT.npz

INPUTS.npz holds the cases, keyed ``{kind}::{case}::...``:

  * ``block::{case}``: ``arch``, ``cf``, ``experts`` (the config's count),
    ``x`` [B, S, D] and ``p::{leaf}`` (one layer's MoE params).  Writes
    ``y``, ``aux``, ``drops`` (capacity-dropped entries of the segmented
    dispatch, 0 on the global path) and, for the "ep" cases, ``manual_y``
    and ``manual_aux``;
  * ``model::{case}``: ``arch``, ``cf``, ``seq``, ``batch``.  JAX's weights
    from ``PRNGKey(0)`` and ``make_batch`` at the mesh (striped).  Writes
    the batch (``tokens``, ``positions``, ``labels``), ``logits``, ``loss``,
    ``ce``, ``aux`` and ``g::{leaf path}``;
  * ``engine::{case}``: ``arch``, ``cf``, ``serve`` (a JSON ServeConfig),
    ``prompts`` [R, max len] with ``lengths`` [R] and ``arrivals`` [R],
    ``new_tokens``.  Writes ``streams`` [R, new_tokens], ``ticks`` (each
    token's tick), ``drops`` (entries dropped by the engine's calls).
"""

import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.models.layers import rms_norm  # noqa: E402
from repro.parallel.context import ParallelCtx  # noqa: E402
from repro.serve.config import ServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine  # noqa: E402

N = 4
_DROPS = [0]


def _count_drops(valid):
    _DROPS[0] += int(np.size(valid) - np.count_nonzero(np.asarray(valid)))


_dispatch = moe._dispatch_indices


def _counting_dispatch(idx, E, C):
    """``_dispatch_indices`` reporting its dropped entries to the host."""
    slot, valid = _dispatch(idx, E, C)
    jax.debug.callback(_count_drops, valid)
    return slot, valid


def _config(inputs, key):
    cfg = get_config(str(inputs[f"{key}::arch"])).reduced()
    m = dataclasses.replace(cfg.moe, capacity_factor=float(inputs[f"{key}::cf"]))
    if f"{key}::experts" in inputs:
        m = dataclasses.replace(m, num_experts=int(inputs[f"{key}::experts"]))
    return dataclasses.replace(cfg, moe=m)


def _segment_drops(x, p, cfg, E):
    """Entries the segmented dispatch drops: JAX's router over the global
    h, then ``_dispatch_indices`` per (row, segment) at C_loc."""
    B, S, _ = x.shape
    C = int(np.ceil(S // N * cfg.moe.top_k * cfg.moe.capacity_factor / E))
    idx = moe._route(rms_norm(x, p["ln"]), p["router"], cfg, E)[0]
    seg = idx.reshape(B * N, S // N, cfg.moe.top_k)
    valid = jax.vmap(lambda i: _dispatch(i, E, C)[1])(seg)
    return int(valid.size - jnp.count_nonzero(valid))


def _block(inputs, key, ctx, out):
    cfg = _config(inputs, key)
    prefix = f"{key}::p::"
    p = {k[len(prefix):]: jnp.asarray(v) for k, v in inputs.items() if k.startswith(prefix)}
    x = jnp.asarray(inputs[f"{key}::x"])
    E = p["router"].shape[-1]
    y, aux = jax.jit(lambda x, p: moe.moe_block(x, p, cfg, ctx))(x, p)
    out[f"{key}::y"], out[f"{key}::aux"] = np.asarray(y), np.asarray(aux)
    segmented = cfg.moe.mode == "ep" and E % N == 0 and x.shape[1] % N == 0
    out[f"{key}::drops"] = np.asarray(_segment_drops(x, p, cfg, E) if segmented else 0)
    if segmented:
        my, maux = jax.jit(lambda x, p: moe._moe_ep_manual(x, p, cfg, ctx))(x, p)
        out[f"{key}::manual_y"], out[f"{key}::manual_aux"] = np.asarray(my), np.asarray(maux)


def _model(inputs, key, ctx, out):
    cfg = _config(inputs, key)
    params = tfm.init_params(cfg, jax.random.PRNGKey(0), ctx=ctx)
    batch = make_batch(cfg, int(inputs[f"{key}::seq"]), int(inputs[f"{key}::batch"]), seed=3,
                       ctx=ctx)

    def loss_and_logits(p):
        l, metrics = tfm.loss_fn(p, cfg, ctx, batch)
        return l, (metrics, tfm.forward(p, cfg, ctx, batch)[0])

    # one compile: the forward's logits ride along as an aux output
    (l, (metrics, logits)), grads = jax.jit(jax.value_and_grad(loss_and_logits,
                                                               has_aux=True))(params)
    for name in ("tokens", "positions", "labels"):
        out[f"{key}::{name}"] = np.asarray(batch[name])
    out[f"{key}::logits"] = np.asarray(logits)
    out[f"{key}::loss"] = np.asarray(l)
    out[f"{key}::ce"], out[f"{key}::aux"] = np.asarray(metrics["ce"]), np.asarray(metrics["aux"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{key}::g::" + "/".join(str(e.key) for e in path)] = np.asarray(leaf)


def _engine(inputs, key, ctx, out):
    cfg = _config(inputs, key)
    params = tfm.init_params(cfg, jax.random.PRNGKey(0), ctx=ctx)
    eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(**json.loads(str(
        inputs[f"{key}::serve"]))))
    new = int(inputs[f"{key}::new_tokens"])
    rids = [eng.submit(np.asarray(row[:n], np.int32), new, arrival_tick=int(t))
            for row, n, t in zip(inputs[f"{key}::prompts"], inputs[f"{key}::lengths"],
                                 inputs[f"{key}::arrivals"])]
    _DROPS[0] = 0
    done = eng.run()
    jax.effects_barrier()
    assert all(done[r].status == "ok" for r in rids), [done[r].status for r in rids]
    out[f"{key}::streams"] = np.asarray([done[r].generated for r in rids], np.int32)
    out[f"{key}::ticks"] = np.asarray([done[r].token_ticks for r in rids], np.int32)
    out[f"{key}::drops"] = np.asarray(_DROPS[0])


def main(argv):
    inputs_path, out_path = argv
    inputs = dict(np.load(inputs_path))
    mesh = jax.make_mesh((2, N), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ctx = ParallelCtx(mesh=mesh, batch_axes=("data",), sp_axis="model", block_q=8, block_kv=8)
    moe._dispatch_indices = _counting_dispatch
    out = {}
    cases = sorted({tuple(k.split("::")[:2]) for k in inputs})
    run = {"block": _block, "model": _model, "engine": _engine}
    for kind, case in cases:
        run[kind](inputs, f"{kind}::{case}", ctx, out)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
