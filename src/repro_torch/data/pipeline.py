"""Deterministic synthetic training batches (copy of
``repro/data/pipeline.py``).

Batch ``step`` of a run is a pure function of ``(seed, step)``, so a run
restarted from a checkpoint replays the identical stream.  The tokens come
from numpy's generator seeded with ``(seed, step)``: deterministic as in JAX,
but not JAX's numbers (tests hand JAX's batches to the port where the tokens
must agree).  ``doc_lengths`` is numpy in both packages and copied bit for
bit, so ``segments``, ``positions`` and ``mask`` equal JAX's exactly.

With ``ctx.sp_size > 1`` and a striped-layout arch the batch comes in the
striped order of ``core.tiling.stripe_permutation`` (paper §3.7): tokens,
labels, positions, and with packed documents the segment ids and the loss
mask, as JAX permutes them.

Frontend archs add their stub's side input, standard normal fp32 from a
numpy stream of its own (JAX's shapes, not JAX's numbers): whisper's mel
``frames`` [batch, encoder_seq, frontend_dim], pixtral's ``patches``
[batch, num_patches, frontend_dim].  They are not striped: the encoder's
rows and the patches are gathered by true position.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.masking import positions_from_doc_lens, segment_ids_from_doc_lens
from repro_torch.core.tiling import stripe_permutation
from repro_torch.device import resolve_device
from repro_torch.parallel.context import ParallelCtx

__all__ = ["make_batch", "batch_spec_shapes", "doc_lengths"]

_TOKEN_STREAM = 0x70C5  # keeps the token draws apart from doc_lengths' stream
_FRONTEND_STREAM = 0xF2A3  # and the frontend stub's features apart from both


def batch_spec_shapes(
    cfg: ModelConfig, seq: int, batch: int, docs: Optional[int] = None
) -> Dict[str, tuple]:
    """Shapes/dtypes of one training batch."""
    shapes = {
        "tokens": ((batch, seq), np.int32),
        "labels": ((batch, seq), np.int32),
        "positions": ((seq,), np.int32),
    }
    if docs and docs > 1:
        shapes["segments"] = ((seq,), np.int32)
        shapes["mask"] = ((batch, seq), np.float32)
    if cfg.frontend == "audio_stub":
        shapes["frames"] = ((batch, cfg.encoder_seq, cfg.frontend_dim), np.float32)
    if cfg.frontend == "vision_stub":
        shapes["patches"] = ((batch, cfg.num_patches, cfg.frontend_dim), np.float32)
    return shapes


def doc_lengths(seq: int, docs: int, *, seed: int = 0, step: int = 0) -> np.ndarray:
    """Deterministic pseudo-random partition of ``seq`` into ``docs`` document
    lengths (each >= 2) -- a pure function of (seed, step) like the batch."""
    if docs < 1 or docs * 2 > seq:
        raise ValueError(f"cannot pack {docs} documents (>=2 tokens each) into seq={seq}")
    rng = np.random.default_rng([seed, step, 0xD0C5])
    cuts = np.sort(rng.choice(np.arange(1, seq // 2), size=docs - 1, replace=False)) * 2
    bounds = np.concatenate([[0], cuts, [seq]])
    return np.diff(bounds).astype(np.int64)


def make_batch(
    cfg: ModelConfig,
    seq: int,
    batch: int,
    *,
    seed: int = 0,
    step: int = 0,
    ctx: Optional[ParallelCtx] = None,
    docs: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """tokens / labels [batch, seq] int32, positions [seq] int32 on
    ``ctx.device``.  ``docs=N`` packs N synthetic documents into every row:
    ``segments`` carries per-token document ids (the attention mask becomes
    causal-within-document), ``positions`` restart at each document start,
    and the loss ``mask`` zeroes the label that would cross a document
    boundary.  Boundaries are shared across rows.  Frontend archs add
    ``frames`` (audio) or ``patches`` (vlm), fp32."""
    ctx = ctx or ParallelCtx()
    dev = resolve_device(ctx.device)
    rng = np.random.default_rng([seed, step, _TOKEN_STREAM])
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if docs and docs > 1:
        lens = doc_lengths(seq, docs, seed=seed, step=step)
        out["segments"] = segment_ids_from_doc_lens(lens, seq)
        out["positions"] = positions_from_doc_lens(lens)
        # the label of a document's last token is the next document's first
        boundary = np.zeros(seq, np.float32)
        boundary[np.cumsum(lens)[:-1] - 1] = 1.0
        out["mask"] = np.broadcast_to(1.0 - boundary, (batch, seq)).copy()
    else:
        out["positions"] = np.arange(seq, dtype=np.int32)
    n = ctx.sp_size
    if n > 1 and cfg.causal_layout == "striped":
        perm = stripe_permutation(seq, n)
        out = {k: v[..., perm] for k, v in out.items()}
    shapes = batch_spec_shapes(cfg, seq, batch)
    for key in ("frames", "patches"):
        if key in shapes:
            frng = np.random.default_rng([seed, step, _FRONTEND_STREAM])
            out[key] = frng.standard_normal(shapes[key][0], dtype=np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}
