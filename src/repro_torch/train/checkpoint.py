"""Fault-tolerant checkpointing: atomic, content-hashed, keep-k, async (copy
of ``repro/train/checkpoint.py`` over nested dicts of tensors).

Layout (one directory per step), the same as the JAX package's, so either
package restores the other's checkpoints:
    <dir>/step_000000123/
        arrays.npz          flattened tree ("/"-joined paths)
        manifest.json       {step, keys, shapes, dtypes, sha256(arrays.npz)}
    <dir>/step_000000123.tmp-* during write; os.replace() makes publish atomic.

Restores verify the manifest hash and skip corrupt or partial checkpoints.
bfloat16 leaves are stored as float32 (numpy has no bfloat16) and cast back
on restore, which is exact.  ``AsyncCheckpointer`` copies the tree to the
host on the calling thread and writes it on a background thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_SEP = "/"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            flat.update(_flatten(tree[key], f"{prefix}{key}{_SEP}"))
        return flat
    if isinstance(tree, (list, tuple)):
        for idx, node in enumerate(tree):
            flat.update(_flatten(node, f"{prefix}{idx}{_SEP}"))
        return flat
    return {prefix[: -len(_SEP)]: _to_numpy(tree)}


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=directory)
    try:
        arrays = _flatten(tree)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **arrays)
        with open(npz_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "sha256": digest,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int) -> None:
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)


def _list_steps(directory: str) -> List[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if _valid(os.path.join(directory, name)):
                out.append(int(name[5:]))
    return out


def _valid(path: str) -> bool:
    man = os.path.join(path, "manifest.json")
    npz = os.path.join(path, "arrays.npz")
    if not (os.path.isfile(man) and os.path.isfile(npz)):
        return False
    try:
        with open(man) as f:
            manifest = json.load(f)
        with open(npz, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest() == manifest["sha256"]
    except (OSError, ValueError, KeyError):
        return False


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, tree_like, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (a nested dict whose leaves
    are tensors): each leaf gets the like-leaf's shape check, dtype and
    device.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    if not _valid(path):
        raise IOError(f"checkpoint {path} corrupt")
    arrays = np.load(os.path.join(path, "arrays.npz"))

    def build(node, prefix: str):
        if isinstance(node, dict):
            return {key: build(val, f"{prefix}{key}{_SEP}") for key, val in node.items()}
        name = prefix[: -len(_SEP)]
        arr = arrays[name]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(node.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=node.device, dtype=node.dtype)

    return build(tree_like, ""), step


class AsyncCheckpointer:
    """Serialize checkpoints on a background thread; at most one in flight
    (the next save waits), and ``wait()`` blocks until published."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = _flatten(tree)  # device -> host on the caller's thread

        def run():
            try:
                save(self.directory, step, host_tree, keep=self.keep)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
