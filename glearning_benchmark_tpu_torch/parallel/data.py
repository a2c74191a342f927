"""Multi-process data sharding and the process group, on torch.distributed.

Port of ``glearning_benchmark_tpu/parallel/data.py``. Each process takes a
*contiguous* slice of the (stable-ordered) corpus; contiguity is what makes
the distributed vocab builds id-identical to the host build
(:mod:`.dist`, :mod:`.multiproc`). Rank and world size come from
``torch.distributed`` (one process when no group is initialised).

``initialize_distributed`` reads torchrun's environment. Unlike the
reference, which swallows every exception of ``jax.distributed.initialize``,
a failed initialisation raises: a run that was asked for several processes
never goes on as one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_bounds(n: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> tuple[int, int]:
    """[start, end) of this process's contiguous slice of ``n`` items.
    Remainder items go to the leading processes, keeping sizes within one
    of each other."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    base, rem = divmod(n, pc)
    start = pi * base + min(pi, rem)
    end = start + base + (1 if pi < rem else 0)
    return start, end


def shard_for_host(items: Sequence[T], process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Sequence[T]:
    start, end = host_shard_bounds(len(items), process_index, process_count)
    return items[start:end]


def initialize_distributed(device: Optional[str] = None,
                           backend: Optional[str] = None,
                           init_method: str = "env://") -> Optional[torch.device]:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for the default
    ``init_method``; a ``file://`` path rendezvous through a shared file)
    and return this rank's device; return None, and do nothing, when
    ``WORLD_SIZE`` is unset or 1.

    ``device="cpu"`` runs every rank on the CPU over gloo. Otherwise rank
    ``LOCAL_RANK`` runs on ``cuda:LOCAL_RANK`` over NCCL. ``backend="gloo"``
    with CUDA lets several ranks share a card (``cuda:LOCAL_RANK % count``):
    NCCL refuses two ranks on one device, so that layout needs gloo, whose
    all-reduce takes CUDA tensors. Any failure raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} does not run on the CPU; use gloo")
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        backend = backend or "nccl"
        count = torch.cuda.device_count()
        if backend == "nccl" and local >= count:
            raise RuntimeError(f"local rank {local} has no card of its own ({count} "
                               "visible) and NCCL refuses two ranks on one card; "
                               "use backend 'gloo' to share one")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError("a process group of another layout is already "
                               "initialised")
        return dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev
