"""Distributed reductions: vocab-count histograms and metric aggregation.

Port of ``glearning_benchmark_tpu/parallel/dist.py`` over a process group
instead of a virtual mesh: each rank holds ONE contiguous shard of the
corpus (:mod:`.data` ordering). The candidate-token table is all-gathered
in rank-major first-occurrence order (equal to the global first-occurrence
order, because the shards are contiguous), each rank counts its shard over
that table, the counts are all-reduced over the 'data' axis, and the
ranking (count desc, first occurrence breaking ties) gives every rank the
id table ``build_vocab_from_texts`` builds on the concatenated corpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..tokenization.vocab import SPECIAL
from .mesh import Mesh


def comm_device() -> torch.device:
    """Where a collective's tensors must lie: the card for NCCL, else the
    host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(t: torch.Tensor, shard) -> torch.Tensor:
    """``t`` summed over the ranks of ``shard`` (a ``mesh.BatchShard``)
    with autograd through the reduction: its backward all-reduces the
    gradient, so each rank's inputs get the gradient of every rank's use of
    the sum. Without a shard, ``t`` itself."""
    if shard is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def psum_histogram(local_counts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce (sum) a count vector over the 'data' axis of ``mesh``."""
    if mesh.size == 1:
        return local_counts.clone()
    out = local_counts.to(comm_device(), copy=True)
    dist.all_reduce(out)
    return out.to(local_counts.device)


def local_counts(shard_texts: Sequence[str], slots: Sequence[str]) -> np.ndarray:
    """Whitespace-token counts of ``shard_texts`` over the table ``slots``."""
    slot_of = {tok: i for i, tok in enumerate(slots)}
    counts = np.zeros(len(slots), dtype=np.int64)
    for text in shard_texts:
        for tok in text.split():
            slot = slot_of.get(tok)
            if slot is not None:
                counts[slot] += 1
    return counts


def rank_vocab(slots: List[str], total: np.ndarray, max_tokens: int | None,
               min_freq: int) -> Tuple[Dict[str, int], Dict[int, str]]:
    """The id table from global counts: SPECIAL first, then count desc with
    the global first occurrence breaking ties, down to ``min_freq``, capped
    at ``max_tokens`` ids."""
    order = sorted(range(len(slots)), key=lambda i: (-int(total[i]), i))
    vocab = {tok: i for i, tok in enumerate(SPECIAL)}
    idx = len(vocab)
    for i in order:
        tok = slots[i]
        if tok in vocab:
            continue
        if int(total[i]) < min_freq:
            break
        vocab[tok] = idx
        idx += 1
        if max_tokens and idx >= max_tokens:
            break
    return vocab, {i: t for t, i in vocab.items()}


def distributed_vocab_counts(
    shard_texts: Sequence[str],
    mesh: Mesh,
    max_tokens: int | None = None,
    min_freq: int = 1,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Build the vocab from this rank's contiguous corpus shard with one
    all-reduce of the counts over 'data'. Every rank gets the same table,
    id-identical to ``build_vocab_from_texts`` on the concatenated corpus."""
    from .multiproc import allgather_candidate_tokens

    slots = allgather_candidate_tokens(shard_texts)
    total = psum_histogram(torch.from_numpy(local_counts(shard_texts, slots)), mesh)
    return rank_vocab(slots, total.numpy(), max_tokens, min_freq)


def all_reduce_metrics(stats: Dict[str, torch.Tensor], mesh
                       ) -> Dict[str, torch.Tensor]:
    """Sum a dict of metric sufficient statistics over the 'data' axis of
    ``mesh`` (a ``Mesh``, or a ``BatchShard`` of its ranks): one all-reduce
    of their concatenation, in f32."""
    if mesh.size == 1 or not stats:
        return dict(stats)
    keys = list(stats)
    flat = torch.cat([stats[k].detach().reshape(-1).to(torch.float32) for k in keys])
    dev = flat.device
    flat = flat.to(comm_device())
    dist.all_reduce(flat)
    flat = flat.to(dev)
    out, at = {}, 0
    for k in keys:
        v = stats[k]
        out[k] = flat[at:at + v.numel()].reshape(v.shape).to(v.dtype)
        at += v.numel()
    return out
