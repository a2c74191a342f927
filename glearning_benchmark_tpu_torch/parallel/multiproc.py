"""Multi-process vocab builds over corpus shards, on torch.distributed.

Port of ``glearning_benchmark_tpu/parallel/multiproc.py``: each process
holds ONLY its contiguous corpus shard (:mod:`.data` ordering); candidate
tokens are all-gathered in rank-major order (equal to the global
first-occurrence order, because the shards are contiguous), counts are
all-reduced, and every process derives the identical id table. Byte
strings travel as padded uint8 ``all_gather``s, as the reference pads its
XLA all-gathers. With no process group (or one process) every function is
the host build.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .dist import comm_device, local_counts, rank_vocab


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte string per process: the lengths
    first, then every payload padded to the longest."""
    size = _world_size()
    if size == 1:
        return [payload]
    dev = comm_device()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lens = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(lens, n)
    lens = [int(t.item()) for t in lens]
    buf = np.zeros(max(max(lens), 1), dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    buf = torch.from_numpy(buf).to(dev)
    gathered = [torch.zeros_like(buf) for _ in range(size)]
    dist.all_gather(gathered, buf)
    return [g[:m].cpu().numpy().tobytes() for g, m in zip(gathered, lens)]


def _merge_lines(chunks: List[bytes]) -> Dict[str, None]:
    merged: Dict[str, None] = {}
    for chunk in chunks:
        if chunk:
            for tok in chunk.decode("utf-8").split("\n"):
                merged.setdefault(tok, None)
    return merged


def allgather_candidate_tokens(shard_texts: Sequence[str]) -> List[str]:
    """Global candidate-token table in global first-occurrence order: each
    process's unique tokens in local first-occurrence order, concatenated
    rank-major and deduplicated."""
    local: Dict[str, None] = {}
    for text in shard_texts:
        for tok in text.split():
            local.setdefault(tok, None)
    return list(_merge_lines(_allgather_bytes("\n".join(local).encode("utf-8"))))


def allreduce_counts(local: np.ndarray) -> np.ndarray:
    """Sum an int64 count vector across processes."""
    if _world_size() == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local, dtype=np.int64)).to(comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def multiprocess_zinc_vocab(mols_shard, flat=None) -> Dict[str, int]:
    """Distributed ZINC vocab: the fixed 22-id block, then the dynamic
    tokens in GLOBAL first-occurrence order, each process holding one
    contiguous molecule shard. Local discovery runs the numeric fast path
    (``tokenization/ibtt_fast.build_zinc_vocab_fast``); the per-shard
    dynamic lists are all-gathered rank-major and deduplicated. Id-identical
    to the single-process build."""
    from ..tokenization.ibtt_fast import build_zinc_vocab_fast
    from ..tokenization.vocab import build_fixed_zinc_vocab, extend_vocab_with_dynamic_tokens

    fixed, _ = build_fixed_zinc_vocab()
    local_vocab = build_zinc_vocab_fast(mols_shard, flat=flat)
    dyn_local = [t for t, _ in sorted(local_vocab.items(), key=lambda kv: kv[1])
                 if t not in fixed]
    merged = _merge_lines(_allgather_bytes("\n".join(dyn_local).encode("utf-8")))
    return extend_vocab_with_dynamic_tokens(fixed, merged)


def multiprocess_vocab_build(
    shard_texts: Sequence[str],
    max_tokens: int | None = None,
    min_freq: int = 1,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Build the vocab across the processes; id-identical to
    ``build_vocab_from_texts`` on the concatenated global corpus (same
    ranking contract as :mod:`.dist`)."""
    slots = allgather_candidate_tokens(shard_texts)
    total = allreduce_counts(local_counts(shard_texts, slots))
    return rank_vocab(slots, total, max_tokens, min_freq)
