"""JAX's MLA over a sequence axis of 4: ``transformer.forward`` over the
expanded heads and through the latent wire (``ParallelCtx(mla_latent_wire=
True)``: ``dispatch.latent_wire_attention``), ``loss_fn`` with its gradients
through the wire, and ``ServeEngine`` with the wire off and on, on a (2, 4)
mesh of fake CPU devices with Auto axes (JAX's default Explicit axes make
its own ``mla_wire`` and ``serve_dist`` checks fail).  The device count is
set before JAX starts, so this runs in its own process.

    python tests/jax_mla_ring_worker.py INPUTS.npz OUT.npz

INPUTS.npz holds JAX's weights of the reduced config, ``params::{leaf
path}`` (``init_params`` at ``PRNGKey(0)``, drawn by the caller), and the
cases, keyed ``{kind}::{case}::...``, each with ``arch`` (that config's
name) and ``wire`` (0 / 1):

  * ``model::{case}``: ``seq``, ``batch``, ``docs`` (0: causal rows) and
    ``grad`` (0 / 1).  ``make_batch`` at the mesh (striped).  Writes the batch (``tokens``, ``positions``,
    ``labels``, and ``segments`` / ``mask`` with documents) and ``logits``;
    with ``grad`` also ``loss``, ``ce`` and ``g::{leaf path}``;
  * ``engine::{case}``: ``serve`` (a JSON ServeConfig), ``prompts`` [R, max
    len] with ``lengths`` [R] and ``arrivals`` [R], ``new_tokens``.  Writes
    ``streams`` [R, new_tokens] and ``ticks`` (each token's tick).
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.parallel.context import ParallelCtx  # noqa: E402
from repro.serve.config import ServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine  # noqa: E402

N = 4


_PARAMS = {}


def _setup(inputs, key, ctx):
    """(the reduced config, the ctx with the case's wire flag, the weights
    of INPUTS.npz in ``init_params``' pytree)."""
    cfg = get_config(str(inputs[f"{key}::arch"])).reduced()
    if "tree" not in _PARAMS:
        shapes = jax.eval_shape(lambda: tfm.init_params(cfg, jax.random.PRNGKey(0)))
        paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        _PARAMS["tree"] = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(inputs["params::" + "/".join(str(e.key) for e in path)])
            for path, _ in paths])
    ctx = dataclasses.replace(ctx, mla_latent_wire=bool(int(inputs[f"{key}::wire"])))
    return cfg, ctx, _PARAMS["tree"]


def _model(inputs, key, ctx, out):
    cfg, ctx, params = _setup(inputs, key, ctx)
    docs = int(inputs[f"{key}::docs"]) or None
    batch = make_batch(cfg, int(inputs[f"{key}::seq"]), int(inputs[f"{key}::batch"]), seed=3,
                       ctx=ctx, docs=docs)
    for name in ("tokens", "positions", "labels", "segments", "mask"):
        if batch.get(name) is not None:
            out[f"{key}::{name}"] = np.asarray(batch[name])
    if not int(inputs[f"{key}::grad"]):
        out[f"{key}::logits"] = np.asarray(jax.jit(
            lambda p: tfm.forward(p, cfg, ctx, batch)[0])(params))
        return

    def loss_and_logits(p):
        l, metrics = tfm.loss_fn(p, cfg, ctx, batch)
        return l, (metrics, tfm.forward(p, cfg, ctx, batch)[0])

    # one compile: the forward's logits ride along as an aux output
    (l, (metrics, logits)), grads = jax.jit(jax.value_and_grad(loss_and_logits,
                                                               has_aux=True))(params)
    out[f"{key}::logits"] = np.asarray(logits)
    out[f"{key}::loss"], out[f"{key}::ce"] = np.asarray(l), np.asarray(metrics["ce"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{key}::g::" + "/".join(str(e.key) for e in path)] = np.asarray(leaf)


def _engine(inputs, key, ctx, out):
    cfg, ctx, params = _setup(inputs, key, ctx)
    eng = ServeEngine(cfg, params, ctx, serve=ServeConfig(**json.loads(str(
        inputs[f"{key}::serve"]))))
    new = int(inputs[f"{key}::new_tokens"])
    rids = [eng.submit(np.asarray(row[:n], np.int32), new, arrival_tick=int(t))
            for row, n, t in zip(inputs[f"{key}::prompts"], inputs[f"{key}::lengths"],
                                 inputs[f"{key}::arrivals"])]
    done = eng.run()
    assert all(done[r].status == "ok" for r in rids), [done[r].status for r in rids]
    out[f"{key}::streams"] = np.asarray([done[r].generated for r in rids], np.int32)
    out[f"{key}::ticks"] = np.asarray([done[r].token_ticks for r in rids], np.int32)


def main(argv):
    inputs_path, out_path = argv
    inputs = dict(np.load(inputs_path))
    mesh = jax.make_mesh((2, N), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ctx = ParallelCtx(mesh=mesh, batch_axes=("data",), sp_axis="model", block_q=8, block_kv=8)
    out = {}
    cases = sorted({tuple(k.split("::")[:2]) for k in inputs if not k.startswith("params::")})
    run = {"model": _model, "engine": _engine}
    for kind, case in cases:
        run[kind](inputs, f"{kind}::{case}", ctx, out)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
