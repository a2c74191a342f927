"""Pipeline parallelism (PP) of the token transformers over the 'pipe' axis.

Port of ``glearning_benchmark_tpu/parallel/pipeline.py``: a GPipe schedule
over S stages and M microbatches. Stage s runs layers
[s L/S, (s+1) L/S) of the model's own parameter tree; there is no stacked
copy (the reference's stacking is "a pure restructuring",
``pipeline.py:39-45``). The schedule runs T = M + S - 1 ticks: at tick t
stage s runs microbatch t - s, stage 0 reading it from the embedded input,
every later stage the activations that stage s - 1 passed it through
:func:`.comm.ppermute` at the tick before. The reference computes clamped
garbage in the bubble ticks (t - s outside [0, M)) and never selects it
(``pipeline.py:92-111``); here those ticks compute nothing, since no output
depends on them. The last stage's outputs, zeros on every other stage, are
summed over 'pipe' (:func:`.comm.psum`, ``pipeline.py:115-120``), so every
stage holds the whole batch's final hidden states; the embedding and the
readout stay outside the pipeline and replicated (``:162-216``; the
embedding is computed where it is read, on stage 0).

Gradients: ``ppermute`` passes each microbatch's cotangent back a stage;
the sum's backward gives the last stage the cotangent of its outputs. A
stage's layers get their gradients on that stage only (the trainer sums
every gradient over 'pipe', which hands each stage the others' layers' and
the embedding's gradients), and the readout's copies each take their
share of the loss.

Dropout: microbatch m's layers draw the seeds of the one-process forward
(the same host draw from the caller's generator) at ``batch_offset`` = the
global index of m's first row, so a pipelined run drops what one process
drops. The reference folds a key per (tick, stage) (``pipeline.py:107``),
a stream of its own (ROADMAP §C).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .comm import ppermute, psum
from .mesh import BatchShard, Mesh


def check_pipeline(model, stages: int, batch: int, n_micro: int) -> None:
    """The reference's guards (``pipeline.py:171-183``): no SP ring, no MoE
    FFN, layers that divide over the stages, a batch that divides into
    microbatches."""
    if getattr(model, "sp_mesh", None) is not None:
        raise ValueError("pipeline parallelism does not compose with "
                         "sequence-parallel ring attention (model.sp_mesh)")
    if getattr(model, "moe_experts", 0):
        raise ValueError("pipeline parallelism does not compose with "
                         "MoE FFNs (model.moe_experts)")
    if model.nlayers % stages != 0:
        raise ValueError(f"model.nlayers={model.nlayers} must divide over "
                         f"pipe_stages={stages}")
    if batch % n_micro != 0:
        raise ValueError(f"batch {batch} not divisible by "
                         f"pipe microbatches {n_micro}")


def pp_transformer_forward(mesh: Mesh, model, x: torch.Tensor, attn_mask: torch.Tensor, *,
                           q_token_id: Optional[int] = None,
                           n_micro: Optional[int] = None,
                           seg: Optional[torch.Tensor] = None,
                           pos: Optional[torch.Tensor] = None,
                           pos_bos: Optional[torch.Tensor] = None,
                           pos_u: Optional[torch.Tensor] = None,
                           pos_v: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           shard: Optional[BatchShard] = None,
                           global_batch: Optional[int] = None) -> torch.Tensor:
    """The pipelined forward of a ``SimpleTransformer`` on a mesh with a
    'pipe' axis: the arguments and the outputs of ``model(...)``, the
    execution schedule of the module docstring. ``x`` holds this rank's
    rows (``shard`` places them in the global batch); ``global_batch`` is
    the batch the microbatch guard reads (default: these rows). A training
    forward (``model.training`` with dropout) draws its seeds from
    ``generator``."""
    from ..models.transformer import transformer_embed, transformer_readout

    axis = mesh.axis("pipe")
    stages, stage = axis.size, axis.index
    n_micro = int(n_micro or stages)
    check_pipeline(model, stages, x.shape[0] if global_batch is None else global_batch,
                   n_micro)
    seeds = [None] * model.nlayers
    if model.training and model.has_dropout:
        if generator is None:
            raise ValueError("a training forward with dropout needs the "
                             "generator its seeds are drawn from")
        # the one-process forward's draw, whatever this stage runs
        seeds = torch.randint(0, 2**31 - 1, (model.nlayers, 4),
                              generator=generator).tolist()
    per = model.nlayers // stages
    mine = range(stage * per, (stage + 1) * per)
    seg_ids = (attn_mask if seg is None else seg).to(torch.int32)
    rows = torch.arange(x.shape[0]).tensor_split(n_micro)
    row0 = 0 if shard is None else shard.start
    h = transformer_embed(model.embed, model.pos, x, pos) if stage == 0 else None

    def run(act, m):
        lo, hi = int(rows[m][0]) if len(rows[m]) else 0, len(rows[m])
        mb_seg = seg_ids[lo:lo + hi].contiguous()
        mb_shard = BatchShard(row0 + lo, row0 + lo + hi,
                              row0 + x.shape[0] if shard is None else shard.total,
                              1 if shard is None else shard.size,
                              None if shard is None else shard.axis)
        for i in mine:
            layer = getattr(model, f"layer_{i}")
            if model.remat and torch.is_grad_enabled():
                act, _ = checkpoint(layer, act, mb_seg, seeds[i], mb_shard,
                                    use_reentrant=False)
            else:
                act, _ = layer(act, mb_seg, seeds[i], mb_shard)
        return act

    # Autograd runs an exchange's backward on a rank only if its input
    # leads to the parameters and its output to the loss, and every rank
    # of the exchange must run it: a bubble tick sends zeros tied to this
    # stage's parameters (``tie``, exactly 0), and a received tensor that no
    # layer reads is added to the output times 0 (``unread``).
    shape = (x.shape[1], model.d_model)
    size = [len(r) for r in rows]
    tie = sum(getattr(model, f"layer_{i}").norm2.bias.sum() for i in mine) * 0.0
    unread = torch.zeros((), device=x.device)
    received, outs = None, []
    forward = [(i, i + 1) for i in range(stages - 1)]
    for t in range(n_micro + stages - 1):
        m = t - stage
        live = 0 <= m < n_micro
        if live:
            out = run(h[rows[m]] if stage == 0 else received, m)
            if stage == stages - 1:
                outs.append(out)
        elif received is not None and torch.is_grad_enabled():
            unread = unread + received.sum() * 0.0
        if stages > 1 and t < n_micro + stages - 2:
            # stage s sends microbatch t - s on; stage s receives t + 1 - s
            clamp = lambda j: min(max(j, 0), n_micro - 1)  # noqa: E731
            send = out if live else x.new_zeros((size[clamp(m)],) + shape,
                                                dtype=torch.float32) + tie
            received = ppermute(send, axis, forward,
                                out_shape=(size[clamp(m + 1)],) + shape)
            if stage == 0 and torch.is_grad_enabled():
                unread = unread + received.sum() * 0.0
                received = None
    if stage == stages - 1:
        hid = torch.cat(outs, dim=0)
    else:
        hid = x.new_zeros((x.shape[0],) + shape, dtype=torch.float32)
    hid = psum(hid + unread, axis)
    return transformer_readout(
        lambda t: model.norm(t.float()), model.cls, hid, x, attn_mask,
        task=model.task, use_query_nodes=model.use_query_nodes, bos_id=model.bos_id,
        query_offsets=model.query_offsets, q_token_id=q_token_id, seg=seg,
        pos_bos=pos_bos, pos_u=pos_u, pos_v=pos_v)
