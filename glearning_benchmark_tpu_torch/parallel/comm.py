"""Differentiable collectives over one axis of the mesh.

No JAX counterpart module: in the JAX package GSPMD inserts these
exchanges, or ``shard_map`` bodies call ``lax.psum``, ``lax.all_gather``,
``lax.ppermute`` and ``lax.all_to_all`` (``ops/ring_attention.py``,
``parallel/pipeline.py``, ``models/moe.py``). Each function here stands for
the ``lax`` op of the same name over a :class:`.mesh.Axis`; on an axis of
size 1 each is the identity.

**Gradients.** On every axis, a rank's cotangent is its share: the sum
over the axis of the ranks' cotangents is the cotangent of the one global
program. This is how ``shard_map`` transposes when it does not track
replication (``check_vma=False``, as ``pipeline.py:120`` and
``ring_attention.py:137`` run it): the cotangent of an output that every
rank holds whole (``out_specs=P()``) is divided by the axis size, and
``psum`` is transposed to ``psum``. The backward of each op follows:

- ``psum`` (all-reduce): the all-reduce of the cotangents. A value that
  every rank holds after the sum gets, on each rank, the whole cotangent
  (the sum of the shares), never the axis size times it;
- ``all_gather`` along a tensor dim: the sum of the ranks' cotangents of
  the whole, this rank's block of it (a reduce-scatter);
- ``ppermute``: the cotangent travels the reverse permutation; a rank that
  received nothing passed nothing back;
- ``all_to_all``: the exchange with the split and concat dims swapped.

A computation that every rank of an axis repeats (the readout after the
SP gather, TP's replicated layers, PP's readout, the EP router) therefore
counts once only if its copies' cotangents are shares: the trainer makes
each rank's loss ``1/R`` of the loss of the rows it holds, with ``R`` the
ranks that hold the same rows (``train/trainer.py``), and sums every
gradient over each axis its parameter is not split over.

**gloo and CUDA tensors.** gloo exchanges host memory: under gloo every
exchange of this module copies a CUDA tensor to the host, runs there and
copies the result back (:func:`_on_comm_device`, the one place that does
so). NCCL takes the CUDA tensors as they are. The choice follows the
group's backend, never a failed attempt.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis


def _on_comm_device(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` where the axis's backend exchanges it: a contiguous copy on the
    host for gloo, ``t`` itself (contiguous) for NCCL."""
    if t.is_cuda and dist.get_backend(axis.group) == "gloo":
        return t.detach().contiguous().cpu()
    return t.detach().contiguous()


def _all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    buf = _on_comm_device(t, axis)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.device)


def _gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    buf = _on_comm_device(t, axis)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def _permute(t: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]],
             out_shape=None) -> torch.Tensor:
    dst = dict(perm).get(axis.index)
    src = {d: s for s, d in perm}.get(axis.index)
    buf = _on_comm_device(t, axis)
    out = buf.new_zeros(buf.shape if out_shape is None else out_shape)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, buf, axis.ranks[dst], axis.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[src], axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(t.device)


def _exchange(t: torch.Tensor, axis: Axis, split: int, concat: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: block j of ``split`` goes to rank j;
    the blocks received, in rank order, concatenate along ``concat``."""
    n = axis.size
    if t.shape[split] % n:
        raise ValueError(f"dim {split} of size {t.shape[split]} does not split "
                         f"over {n} ranks")
    blocks = torch.stack(t.chunk(n, dim=split))            # [n, ...block]
    buf = _on_comm_device(blocks, axis)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=axis.group)
    return torch.cat(out.to(t.device).unbind(0), dim=concat)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        whole = _all_reduce(g, ctx.axis)
        return whole.narrow(ctx.dim, ctx.axis.index * ctx.width, ctx.width), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, out_shape):
        ctx.axis, ctx.perm, ctx.shape = axis, perm, x.shape
        return _permute(x, axis, perm, out_shape)

    @staticmethod
    def backward(ctx, g):
        return (_permute(g, ctx.axis, [(d, s) for s, d in ctx.perm], ctx.shape),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _exchange(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis, ctx.concat, ctx.split), None, None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum``: ``x`` summed over the axis, on every rank."""
    return x if axis.size == 1 else _PSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the ranks' blocks of ``x``
    concatenated along ``dim`` in rank order."""
    return x if axis.size == 1 else _AllGather.apply(x, axis, dim % x.dim())


def ppermute(x: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]],
             out_shape=None) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` sends ``x`` to rank ``dst`` for every
    (src, dst) of ``perm`` (indices along the axis); a rank that receives
    nothing gets zeros. ``out_shape``: the shape this rank receives, where
    it differs from the one it sends (a pipeline's uneven microbatches).

    Every rank of the axis must run the backward of every exchange it ran,
    as it must run the exchange: a rank whose input needs no gradient, or
    whose output reaches no loss, would leave its partners waiting. The
    callers keep both ends connected (``parallel/pipeline.py``)."""
    if axis.size == 1:
        return x if (0, 0) in perm else x.new_zeros(out_shape or x.shape)
    return _PPermute.apply(x, axis, tuple(perm), out_shape)


def all_to_all(x: torch.Tensor, axis: Axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` split in ``axis.size`` blocks
    along ``split_axis``, block j sent to rank j, the received blocks
    concatenated along ``concat_axis`` in rank order."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_axis % x.dim(), concat_axis % x.dim())
