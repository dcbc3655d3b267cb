"""The port stands alone: with ``jax`` blocked, every ``repro_torch`` module
and ``chip_smoke`` import, and no ``repro`` module gets loaded.  Entry points
called without ``device=`` on a host without CUDA raise instead of quietly
running on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
missing = {{
    "repro_torch.core.kv_quant", "repro_torch.serve.speculative",
    "repro_torch.core.mesh_attention", "repro_torch.core.schedule", "repro_torch.parallel.ring",
    "repro_torch.testing.chaos", "repro_torch.core.mesh_attention_collective",
    "repro_torch.models.moe", "repro_torch.configs.qwen2_moe_a2_7b",
    "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.qwen2_5_32b",
    "repro_torch.configs.gemma_7b", "repro_torch.configs.minicpm3_4b",
}} - set(names)
assert not missing, missing
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jax" not in [m.split(".")[0] for m, v in sys.modules.items() if v is not None]
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module of the slice was imported


def test_chip_smoke_refuses_to_run_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": torch.zeros(2).numpy()})
    params = tfm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)  # ParallelCtx() defaults to the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_cache(cfg, 1, 16)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_launch_serve_cpu_tour_and_unported_flags(capsys, monkeypatch):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--reduced", "--stream", "--paged",
                       "--page-size", "4", "--trace", "8:0,12:1", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert '"pages_in_use": 0.0' in out and "status=ok" in out
    # the robustness flags run, and the schedule they drive -- admissions,
    # preemptions, chaos events, statuses -- is JAX's CLI's to the letter
    # (no EOS: it does not depend on the random weights, which differ)
    flags = ["--reduced", "--stream", "--paged", "--page-size", "4", "--num-pages", "13",
             "--prefill-chunk", "8", "--oversubscribe", "2.0", "--chaos-seed", "3",
             "--health-every", "1", "--trace", "16:0,16:0,16:1,20:2", "--new-tokens", "12",
             "--max-seq", "64"]
    assert serve.main(["--device", "cpu", *flags]) == 0
    got = _summary(capsys.readouterr().out)
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    assert jserve.main() == 0
    want = _summary(capsys.readouterr().out)
    assert got["robustness"] == want["robustness"]
    assert got["robustness"]["preemptions"] > 0 and got["robustness"]["chaos_events"]
    for key in ("pages_in_use", "peak_in_use", "fresh_allocs", "virtual_pages", "seized_pages"):
        assert got["kv_cache"][key] == want["kv_cache"][key], key
    # JAX's ServeConfig checks: oversubscription needs the paged pool
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--device", "cpu", "--reduced", "--oversubscribe", "1.5"])


def _summary(out: str) -> dict:
    import json

    return json.loads(next(line for line in out.splitlines() if line.startswith("{")))
