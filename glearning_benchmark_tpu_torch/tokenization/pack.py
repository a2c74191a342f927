"""Padding of token-id sequences into fixed-shape batches.

Port of ``glearning_benchmark_tpu/tokenization/pack.py``: ``pad_sequences``
only (copied). Sequence packing (``pack_examples``) comes with the training
slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def pad_sequences(
    seqs: Sequence[np.ndarray],
    pad_id: int,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad variable-length id sequences. Returns (ids [B, L], mask [B, L])."""
    b = len(seqs)
    lens = [min(len(s), max_len) if max_len else len(s) for s in seqs]
    l = max(lens, default=0)
    ids = np.full((b, l), pad_id, dtype=np.int32)
    mask = np.zeros((b, l), dtype=bool)
    for i, s in enumerate(seqs):
        k = lens[i]
        ids[i, :k] = s[:k]
        mask[i, :k] = True
    return ids, mask
