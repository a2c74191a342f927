"""The device mesh over a torch.distributed process group, and the sharding
rule of parameters.

Port of ``glearning_benchmark_tpu/parallel/mesh.py``. In the JAX package a
mesh is an array of devices with named axes, and GSPMD or ``shard_map``
insert the collectives. Here a mesh is the process group, one rank a
device, laid out as the JAX package lays its devices out: rank ``r`` takes
the place of device ``r`` in ``np.array(devices).reshape(shape)``, so a
rank's coordinates are the coordinates of the JAX device of the same index.
The axis sets are the JAX package's:

- ``('data', 'model')``: data parallelism (DP) and tensor parallelism (TP);
- ``('data', 'model', 'seq')``: sequence parallelism (SP, the ring of
  ``ops/ring_attention.py``);
- ``('data', 'pipe')``: the GPipe pipeline of ``parallel/pipeline.py`` (PP);
- ``('data', 'expert')``: expert parallelism of the Switch MoE FFN (EP).

Every rank creates, in the same order, one process group for each set of
axes and each slice of the mesh along them (``dist.new_group``); a rank's
:class:`Axis` over some axes names its group, its size, the rank's index in
it and the global ranks of its members. The collectives over an axis are
in :mod:`.comm`; the trainer makes every reduction explicit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Axis:
    """One or more mesh axes as seen by one rank: the ranks that share this
    rank's coordinates on every other axis. ``group`` is their process group
    (None when ``size`` is 1), ``index`` this rank's place among them
    (row-major over ``names`` in mesh order), ``ranks`` their global ranks
    by index."""

    names: Tuple[str, ...]
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """Rank ``rank`` of ``size`` ranks laid out over ``axes`` ((name, size)
    pairs in mesh order; default ``(("data", size), ("model", 1))``).
    ``groups`` holds this rank's :class:`Axis` for every set of axes
    (:func:`make_mesh` fills it in)."""

    rank: int
    size: int
    axes: Tuple[Tuple[str, int], ...] = ()
    groups: Dict[Tuple[str, ...], Axis] = field(default_factory=dict, compare=False,
                                                repr=False)

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (("data", self.size), ("model", 1)))
        if int(np.prod([n for _, n in self.axes])) != self.size:
            raise ValueError(f"mesh axes {self.axes} do not hold {self.size} ranks")

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    @property
    def coords(self) -> dict:
        """This rank's coordinate on every axis."""
        at = np.unravel_index(self.rank, [n for _, n in self.axes])
        return {name: int(i) for (name, _), i in zip(self.axes, at)}

    def axis(self, *names: str) -> Axis:
        """This rank's :class:`Axis` over ``names`` (mesh axes this mesh
        lacks count as size 1; no names: the whole mesh)."""
        names = tuple(n for n in (names or self.axis_names)
                      if self.shape.get(n, 1) > 1)
        key = tuple(n for n in self.axis_names if n in names)
        if key in self.groups:
            return self.groups[key]
        members = _members(self, key)
        return Axis(key, len(members), members.index(self.rank), members)

    def but(self, name: Optional[str]) -> Axis:
        """The :class:`Axis` over every mesh axis except ``name``."""
        return self.axis(*(n for n in self.axis_names if n != name))


@dataclass(frozen=True)
class BatchShard:
    """Rows ``[start, stop)`` of a global batch of ``total`` rows, held by
    one of the ``size`` row blocks: what the models and the trainer need to
    draw the rows of the global dropout masks and to reduce batch
    statistics over the global batch. ``axis`` is the :class:`Axis` of the
    ranks that hold the other blocks (None: the whole process group)."""

    start: int
    stop: int
    total: int
    size: int
    axis: Optional[Axis] = None


def _members(mesh: Mesh, names: Tuple[str, ...]) -> Tuple[int, ...]:
    """Global ranks sharing ``mesh.rank``'s coordinates off ``names``,
    row-major over ``names``."""
    grid = np.arange(mesh.size).reshape([n for _, n in mesh.axes])
    coords = mesh.coords
    index = tuple(slice(None) if name in names else coords[name]
                  for name in mesh.axis_names)
    return tuple(int(r) for r in grid[index].reshape(-1))


def _build_groups(mesh: Mesh) -> None:
    """One process group per set of axes and slice of the mesh along it,
    created by every rank in the same order; keep this rank's."""
    names = [n for n, size in mesh.axes if size > 1]
    grid = np.arange(mesh.size).reshape([n for _, n in mesh.axes])
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(names, k):
            keep = [mesh.axis_names.index(n) for n in subset]
            rest = [i for i in range(len(mesh.axes)) if i not in keep]
            slices = np.transpose(grid, rest + keep).reshape(
                -1, int(np.prod([grid.shape[i] for i in keep])))
            for ranks in slices.tolist():
                if len(ranks) == mesh.size:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(ranks)
                if mesh.rank in ranks:
                    mesh.groups[subset] = Axis(subset, len(ranks), ranks.index(mesh.rank),
                                               tuple(ranks), group)


def make_mesh(model_axis: int = 1, seq_shards: int = 1, pipe_stages: int = 1,
              expert_shards: int = 1) -> Mesh:
    """The JAX package's mesh over every rank of the initialised process
    group (one rank when there is none): 'data' takes the ranks the other
    axes leave, and must come out whole. Raises the JAX package's error when
    pipe or expert is asked for with another axis."""
    exclusive = [x for x in (("pipe_stages", pipe_stages),
                             ("expert_shards", expert_shards)) if x[1] > 1]
    if exclusive and (model_axis > 1 or seq_shards > 1 or len(exclusive) > 1):
        raise ValueError(f"{exclusive[0][0]} composes with DP only "
                         "(no TP/SP/other axes on the same mesh yet)")
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    other = model_axis * seq_shards * pipe_stages * expert_shards
    if other < 1 or size % other:
        raise ValueError(f"{size} rank(s) do not divide over model_axis="
                         f"{model_axis} x seq_shards={seq_shards} x pipe_stages="
                         f"{pipe_stages} x expert_shards={expert_shards}")
    data = size // other
    if pipe_stages > 1:
        axes = (("data", data), ("pipe", pipe_stages))
    elif expert_shards > 1:
        axes = (("data", data), ("expert", expert_shards))
    elif seq_shards > 1:
        axes = (("data", data), ("model", model_axis), ("seq", seq_shards))
    else:
        axes = (("data", data), ("model", model_axis))
    mesh = Mesh(rank, size, axes)
    if size > 1:
        _build_groups(mesh)
    return mesh


def shard_batch_spec(mesh: Mesh, rows: int, axis: Optional[Axis] = None) -> BatchShard:
    """This rank's contiguous block of a batch of ``rows`` rows over
    ``axis`` (default: 'data'): the block that ``P("data")`` (or
    ``P(("data", "expert"))``) gives the device of this rank. ``rows`` must
    divide by the axis."""
    axis = axis if axis is not None else mesh.axis("data")
    if rows % axis.size:
        raise ValueError(f"{rows} rows do not divide over a data axis of "
                         f"{axis.size}")
    per = rows // axis.size
    return BatchShard(axis.index * per, (axis.index + 1) * per, rows, axis.size, axis)


def replicated_spec(mesh: Mesh) -> tuple:
    """A tensor every rank holds whole: ``P()``."""
    return ()


# ---------------------------------------------------------------------------
# the parameter rule (tensor and expert parallelism)
# ---------------------------------------------------------------------------

def param_shard_spec(mesh: Mesh, path: Sequence[str], leaf) -> tuple:
    """The JAX package's sharding of one parameter, as the tuple a
    ``PartitionSpec`` holds (``()`` = replicated), for the port's tensor
    ``leaf`` of the flax path ``path`` (``("layer_0", "qkv", "kernel")``, as
    ``convert.flax_path`` names it).

    The rule reads the flax layout: the Switch MoE expert stacks
    ``moe/{w1,b1,w2,b2}`` shard their leading (expert) axis over 'expert'
    when it divides; every ``embedding`` or ``kernel`` leaf of two or more
    dims shards its last (feature) axis over 'model' when that divides;
    everything else is replicated. The answer is in the port's layout: a
    flax ``kernel`` [in, out] is ``Linear.weight`` [out, in], so its last
    axis is the weight's dim 0."""
    shape = mesh.shape
    tp = shape.get("model", 1)
    ep = shape.get("expert", 1)
    names = list(path)
    transposed = names[-1] == "kernel"
    dims = tuple(reversed(leaf.shape)) if transposed else tuple(leaf.shape)
    spec = ()
    if (ep > 1 and "moe" in names and names[-1] in ("w1", "w2", "b1", "b2")
            and dims[0] % ep == 0):
        spec = ("expert",) + (None,) * (len(dims) - 1)
    elif (tp > 1 and len(dims) >= 2 and ("embedding" in names or "kernel" in names)
            and dims[-1] % tp == 0):
        spec = (None,) * (len(dims) - 1) + ("model",)
    return tuple(reversed(spec)) if transposed else spec


@dataclass(frozen=True)
class ParamShard:
    """How one torch parameter is split: along ``dim`` over ``axis``."""

    axis: Axis
    dim: int


def param_shards(mesh: Mesh, model: nn.Module) -> Dict[str, ParamShard]:
    """{``state_dict`` key: its split} for every parameter of ``model`` that
    :func:`param_shard_spec` shards."""
    from ..convert import flax_path

    out = {}
    if mesh.shape.get("model", 1) == 1 and mesh.shape.get("expert", 1) == 1:
        return out
    for key, p in model.named_parameters():
        for dim, name in enumerate(param_shard_spec(mesh, flax_path(key)[0], p)):
            if name is not None:
                out[key] = ParamShard(mesh.axis(name), dim)
    return out


def shard_params(mesh: Mesh, model: nn.Module) -> Dict[str, ParamShard]:
    """Keep this rank's block of every parameter :func:`param_shard_spec`
    shards, in place, and turn the modules that hold them into their
    sharded kind (``parallel.tp``: a 'model'-sharded ``Linear`` computes its
    output columns and all-gathers them, a sharded ``Embedding`` its feature
    columns; an 'expert'-sharded MoE FFN computes its experts). Returns the
    splits, by ``state_dict`` key."""
    from .tp import mark_sharded

    shards = param_shards(mesh, model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, sh in shards.items():
            p = params[key]
            p.data = shard_tensor(p.data, sh).clone()
    mark_sharded(model, shards)
    return shards


def shard_tensor(t: torch.Tensor, sh: ParamShard) -> torch.Tensor:
    """This rank's block of a whole tensor split as ``sh`` says."""
    per = t.shape[sh.dim] // sh.axis.size
    return t.narrow(sh.dim, sh.axis.index * per, per)


def gather_tensor(t: torch.Tensor, sh: ParamShard) -> torch.Tensor:
    """The whole tensor from every rank's block (a collective over the
    shard's axis)."""
    from .comm import all_gather

    with torch.no_grad():
        return all_gather(t.detach(), sh.axis, sh.dim)
