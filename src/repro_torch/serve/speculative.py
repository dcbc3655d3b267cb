"""Self-speculative draft proposal: prompt-lookup n-gram continuation (copy
of ``repro/serve/speculative.py``, host numpy).

The draft source is the request's own history (prompt + everything generated
so far): the longest suffix n-gram is matched against earlier occurrences
and the continuation after the most recent match is proposed.  No second
model and no device work.  Correctness never depends on the draft: verify
accepts a drafted token only where it equals the model's own greedy output.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["propose_ngram"]


def propose_ngram(
    prompt: Sequence[int],
    generated: Sequence[int],
    k: int,
    *,
    max_ngram: int = 3,
) -> List[int]:
    """Draft up to ``k`` tokens expected to FOLLOW ``prompt + generated``
    (whose last element is the token about to be fed to decode).

    Longest match first: for n from ``max_ngram`` down to 1, the first size
    whose suffix occurs earlier gives the draft, copied from after the MOST
    RECENT occurrence (a loop the model just entered beats a stale prompt
    match).  Returns ``[]`` when the history never repeats."""
    if k <= 0:
        return []
    hist = np.concatenate([
        np.asarray(prompt, np.int64).reshape(-1),
        np.asarray(generated, np.int64).reshape(-1),
    ])
    size = int(hist.size)
    for n in range(min(max_ngram, size - 1), 0, -1):
        suffix = hist[size - n:]
        # every window start at once (n vectorized compares); starts stop
        # strictly before the suffix's own start, overlap with it is fine:
        # that is how loops shorter than n are predicted
        mask = hist[: size - n] == suffix[0]
        for i in range(1, n):
            mask &= hist[i : size - n + i] == suffix[i]
        hits = np.flatnonzero(mask)
        if hits.size:
            j = int(hits[-1])
            return [int(t) for t in hist[j + n : j + n + k]]
    return []
