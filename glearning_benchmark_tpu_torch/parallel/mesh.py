"""The 'data' axis of the device mesh, over a torch.distributed process group.

Port of ``glearning_benchmark_tpu/parallel/mesh.py``, the data axis only.
In the JAX package a mesh is an array of devices with named axes: batches
shard over 'data' and GSPMD inserts the gradient, metric and vocab-count
all-reduces. Here a mesh is a process group, one rank a device, of shape
``{"data": world_size}``; a rank holds its contiguous block of every
minibatch's rows (the block ``P("data")`` gives device *r*), and the
trainer makes the all-reduces explicit. The 'model' (TP), 'seq' (SP),
'pipe' (PP) and 'expert' (EP) axes come with the next slice: asking for
one raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

_NEXT_SLICE = ("the next slice of the port (ROADMAP queue A, item 9: TP, the "
               "SP ring, PP GPipe, EP)")


@dataclass(frozen=True)
class Mesh:
    """A 'data' axis over the ``size`` ranks of the process group, whose
    collectives run on its default group; this process is ``rank``."""

    rank: int
    size: int

    @property
    def shape(self) -> dict:
        return {"data": self.size}

    @property
    def axis_names(self) -> tuple:
        return ("data",)


@dataclass(frozen=True)
class BatchShard:
    """Rows ``[start, stop)`` of a global batch of ``total`` rows, held by
    one of the ``size`` ranks: what the models and the trainer need to draw
    the rank's rows of the global dropout masks and to reduce batch
    statistics, counts and gradients over the global batch."""

    start: int
    stop: int
    total: int
    size: int


def make_mesh(model_axis: int = 1, seq_shards: int = 1, pipe_stages: int = 1,
              expert_shards: int = 1) -> Mesh:
    """The 'data' mesh over every rank of the initialised process group
    (one rank when there is none)."""
    for name, n in (("model_axis", model_axis), ("seq_shards", seq_shards),
                    ("pipe_stages", pipe_stages), ("expert_shards", expert_shards)):
        if n > 1:
            raise NotImplementedError(f"{name} > 1 is not ported yet: {_NEXT_SLICE}")
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size())
    return Mesh(0, 1)


def shard_batch_spec(mesh: Mesh, rows: int) -> BatchShard:
    """This rank's contiguous block of a batch of ``rows`` rows: the block
    that ``P("data")`` gives device ``mesh.rank``. ``rows`` must divide by
    the data axis."""
    if rows % mesh.size:
        raise ValueError(f"{rows} rows do not divide over a data axis of "
                         f"{mesh.size}")
    per = rows // mesh.size
    return BatchShard(mesh.rank * per, (mesh.rank + 1) * per, rows, mesh.size)


def replicated_spec(mesh: Mesh) -> None:
    """A tensor every rank holds whole (``P()``): no shard, which the models
    and the trainer read as "compute it all here, reduce nothing"."""
    return None


def param_shard_spec(mesh: Mesh, path, leaf):
    """Tensor-parallel sharding of one parameter: not ported yet."""
    raise NotImplementedError(f"tensor parallelism (param_shard_spec) is not "
                              f"ported yet: {_NEXT_SLICE}")


def shard_params(mesh: Mesh, params):
    """Place a parameter tree by :func:`param_shard_spec`: not ported yet."""
    raise NotImplementedError(f"tensor parallelism (shard_params) is not "
                              f"ported yet: {_NEXT_SLICE}")
