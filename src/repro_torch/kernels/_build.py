"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  A library is built at first
use into ``build/repro_torch/`` at the root of the checkout, under a name
keyed by a hash of its source, the shared headers and the flags, so an
edited kernel rebuilds and an unchanged one is reused.  ``build()`` starts
one ``nvcc`` per missing source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd_tc", "flash_fwd_mla", "flash_bwd", "paged_decode", "ssd_scan",
           "ssd_scan_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the port's CUDA kernels are compiled on the machine with the card"
        )
    return found


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, every header under ``csrc/``
    (``*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once; returns {name: library path}.  The compiler's output
    (register and shared-memory use per kernel) is kept next to each library
    as ``<library>.log``."""
    names = tuple(names or SOURCES)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        Path(f"{out}.log").write_bytes(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    if name in ("flash_fwd_tc", "flash_fwd_mla"):
        # the tile body: q k v band band_stride seg_q seg_kv o lse B Sq Skv H
        # Hkv D scale stride_q stride_kv terms stream
        lib.flash_fwd_tile.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
        lib.flash_fwd_tile.restype = i
    if name == "flash_fwd_tc":
        # the decode body: q k v band band_stride seg_q seg_kv o lse o_parts
        # lse_parts splits B Sq Skv H Hkv D scale stride_q stride_kv terms
        # stream
        lib.flash_fwd_decode.argtypes = [
            p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p
        ]
        lib.flash_fwd_decode.restype = i
        # the fp32 pre-pass: src[] dst[] n[] count stream
        lib.flash_fwd_split.argtypes = [p, p, p, i, p]
        lib.flash_fwd_split.restype = i
    elif name == "flash_fwd_mla":
        pass  # the tile body alone, declared above
    elif name == "flash_bwd":
        # q k v do lse delta band seg_q seg_kv dq B Sq Skv H Hkv D scale
        # stride_q stride_kv terms stream
        lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
        lib.flash_bwd_dq.restype = i
        # as flash_bwd_dq with dk dv in place of dq
        lib.flash_bwd_dkv.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, p
        ]
        lib.flash_bwd_dkv.restype = i
        # the fp32 pre-pass: src[] dst[] n[] count stream
        lib.flash_bwd_split.argtypes = [p, p, p, i, p]
        lib.flash_bwd_split.restype = i
    elif name == "paged_decode":
        # q k_pool v_pool k_scale v_scale bt pos pos_stride pos_value o lse
        # o_parts lse_parts B H Hkv D page_size max_pages splits kv_off
        # stride_kv hi scale dtype pool_type stream
        lib.paged_decode.argtypes = [p] * 7 + [i, i] + [p] * 4 + [i] * 10 + [f, i, i, p]
        lib.paged_decode.restype = i
        # o_parts lse_parts o lse B S H D dtype stream
        lib.paged_decode_combine.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.paged_decode_combine.restype = i
    elif name == "ssd_scan":
        # x dt A Bm Cm y state scores decay states B S H P G N chunk, the
        # (batch, seq, head) strides of x, dt, Bm, Cm, terms, stream
        lib.ssd_scan.argtypes = [p] * 10 + [i] * 7 + [ll] * 12 + [i, p]
        lib.ssd_scan.restype = i
    elif name == "ssd_scan_bwd":
        # x dt A Bm Cm dy dstate dx ddt dA dBm dCm hin gst dBp dCp dAp B S H
        # P G N chunk hps, the (batch, seq, head) strides of x, dt, Bm, Cm,
        # stream
        lib.ssd_scan_bwd.argtypes = [p] * 17 + [i] * 8 + [ll] * 12 + [p]
        lib.ssd_scan_bwd.restype = i
    else:
        raise ValueError(f"unknown kernel library {name!r}")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
