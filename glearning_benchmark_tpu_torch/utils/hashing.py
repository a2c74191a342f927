"""Stable (process-invariant) hashing.

Port of ``glearning_benchmark_tpu/utils/hashing.py`` (copied):
``stable_hash``, which keys the dataset cache, and ``stable_token_hash``.
"""

from __future__ import annotations

import hashlib

import numpy as np


def stable_hash(s: str, bits: int = 64) -> int:
    """Deterministic non-negative integer hash of a string (blake2b-based)."""
    h = hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest()
    v = int.from_bytes(h, "little")
    return v & ((1 << bits) - 1)


def stable_token_hash(tokens: list[str]) -> np.ndarray:
    """Vectorizable stable uint64 hash of many tokens (for histogramming)."""
    return np.array([stable_hash(t) for t in tokens], dtype=np.uint64)
