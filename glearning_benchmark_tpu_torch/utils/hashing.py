"""Stable (process-invariant) hashing.

Port of ``glearning_benchmark_tpu/utils/hashing.py``: ``stable_hash``
(copied), which keys the dataset cache.
"""

from __future__ import annotations

import hashlib


def stable_hash(s: str, bits: int = 64) -> int:
    """Deterministic non-negative integer hash of a string (blake2b-based)."""
    h = hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest()
    v = int.from_bytes(h, "little")
    return v & ((1 << bits) - 1)
