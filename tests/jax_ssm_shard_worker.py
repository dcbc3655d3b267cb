"""JAX's sequence-sharded SSD block (``repro.models.ssm.ssm_block`` under
``shard_map``) over a (2, 4) mesh of fake CPU devices, for the cases the
caller writes into INPUTS.npz: ``{case}::x`` [B, S, D], ``{case}::arch``
and ``{case}::p::{leaf}`` (one layer's SSD params).  Writes ``{case}::y``,
``{case}::state`` and ``{case}::conv`` to OUT.npz.  The device count is set
before JAX starts, so this runs in its own process.

    python tests/jax_ssm_shard_worker.py INPUTS.npz OUT.npz
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import ssm  # noqa: E402
from repro.parallel.context import ParallelCtx  # noqa: E402


def main(argv):
    inputs_path, out_path = argv
    inputs = dict(np.load(inputs_path))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    ctx = ParallelCtx(mesh=mesh, batch_axes=("data",), sp_axis="model")
    out = {}
    for case in sorted({k.split("::")[0] for k in inputs}):
        cfg = get_config(str(inputs[f"{case}::arch"])).reduced()
        prefix = f"{case}::p::"
        p = {k[len(prefix):]: jnp.asarray(v) for k, v in inputs.items() if k.startswith(prefix)}
        block = jax.jit(lambda x, p, cfg=cfg: ssm.ssm_block(x, p, cfg, ctx, return_state=True))
        y, st = block(jnp.asarray(inputs[f"{case}::x"]), p)
        out[f"{case}::y"] = np.asarray(y)
        out[f"{case}::state"] = np.asarray(st["state"])
        out[f"{case}::conv"] = np.asarray(st["conv"])
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
