"""The training engine of all four model families (``ibtt``, ``agtt``,
``mpnn``, ``ggps``).

Port of ``glearning_benchmark_tpu/train/trainer.py``: ``build_model``,
``build_dataset``, the loss and its sufficient statistics, ``make_batches``,
the epoch loop with exact best-epoch selection, ``RunLogger``, checkpoints
(written and read in the JAX package's layout, optimizer state included),
resume, eval-only, the final test-split evaluation and ``TrainResult``.

What stays from the reference: the splits are assembled once into
fixed-shape arrays and moved to the device once; every batch is an index
gather on the device; an epoch's metrics are statistics summed on the
device and read once per epoch; AdamW with global-norm clip 1.0
(``train/optim.py``); L1 loss for zinc, cross-entropy otherwise; the best
checkpoint is the epoch with the strictly best validation metric and is
reloaded before the test pass; the per-epoch stdout lines and the log keys.
What differs: PyTorch runs eagerly, so ``epochs_per_dispatch`` is a plain
loop over whole blocks of K epochs (same rounding of the epoch count, same
block-best rule) and nothing is compiled; the dropout seeds come from a
``torch.Generator`` seeded with ``train.seed``, not from a JAX key, so a
run with dropout is reproducible from its seed but does not share the JAX
trainer's masks. On a CUDA device every encoder layer's attention, forward
and backward, runs in the hand-written kernels of ``ops/flash_attention.py``.
The graph models (MPNN, GPS) take dense padded batches (the uint8
adjacency cast to f32 per gathered batch, the bond-type matrix ``eadj``
with ``model.edge_features``); their BatchNorm running statistics are
updated by every train step, used by every eval pass, snapshotted with the
parameters at the best epoch and saved as the checkpoint's
``batch_stats``. With ``model.moe_experts`` the token models' FFNs are
Switch MoE FFNs, and a training step adds their load-balance loss, weighted
by ``model.moe_aux_weight`` (default 0.01), as the reference does.

Data parallelism, as the JAX trainer runs on a 'data' mesh: when a process
group of several ranks is initialised (``parallel.initialize_distributed``,
e.g. under torchrun), every rank builds the same model from the same seed,
draws the same shuffles and dropout seeds, and takes its contiguous block
of every minibatch's rows (a packed row batch is first rounded to a
multiple of the 'data' axis). Dropout masks are the rank's rows of the
global masks, BatchNorm statistics and the MoE loss are reduced over the
global batch, and the epoch's train, val and test statistics are
all-reduced over the rows, so every rank picks the same best epoch. A
minibatch that does not divide over 'data' runs unsharded, as in the
reference: every rank of the axis computes all of it. Only rank 0 writes
the dataset cache, the log and the checkpoints; the others wait for it at
a barrier.

The other ``parallel.*`` axes run on the JAX package's mesh
(``parallel/mesh.py``), under its guards, with the same messages:
``model_axis`` (TP: the parameter rule splits features over 'model'),
``seq_shards`` (SP: the ring, unpacked rows only), ``pipe_stages`` with
``pipe_microbatches`` (PP: ``parallel/pipeline.py``), ``expert_shards``
(EP: the expert stacks over 'expert') and ``ep_manual`` (rows over data x
expert, the all-to-all dispatch). Asking for an axis the ranks cannot
hold raises; nothing falls back to one process.

Gradients: a rank's loss is its share of the global loss, its sum over the
examples it holds divided by the valid count summed over EVERY rank. The
ranks that hold the same rows (the 'model', 'seq', 'pipe' and, auto,
'expert' ranks, and all ranks of an unsharded minibatch) each take an equal
share, and the collectives' backwards pass shares on (``parallel/comm.py``).
So each gradient is summed over every mesh axis its parameter is not split
over: the replicated parameters over the whole mesh, the 'model'-split
ones over every axis but 'model', the expert stacks over every axis but
'expert'. A computation that several ranks repeat is summed too (its
copies' shares add up to one gradient), so every rank applies the same
update bit for bit even where the card's sums are not deterministic (the
atomic adds of an embedding's backward), and one rule, read off the
parameter rule, serves every axis. The global norm is clipped (and reported) after those sums,
counting a split parameter's squares over its axis. The best epoch's
parameters and optimizer state are gathered whole before each checkpoint,
so checkpoints keep the one-process layout (``convert.py``, serving and
``--resume`` are unchanged; a resumed run takes its shards again), and
``TrainResult.model`` is the whole model on one process.

Observability, as the reference has it: ``train.profile_epochs`` traces the
listed epochs with ``torch.profiler`` (CPU, and CUDA on the card) into a
Chrome trace under ``{out_dir}/{run_name}_trace/``; a classification run
writes its test confusion matrix as ``{run_name}_test_cm.png`` and, with
wandb, logs it as an image and (up to 30 classes) a table; with wandb, every
block of epochs ends with per-parameter histograms of the parameters and of
the gradients of one train batch (the grad probe, whose dropout seeds come
from a generator of its own, seeded from (seed, epoch), and which leaves the
BatchNorm statistics as it found them, so that a run with wandb trains bit
for bit as one without). Under torchrun rank 0 alone writes the trace, the
image and the log.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..convert import (batch_stats_to_flax, flax_path, load_flax_params,
                       opt_state_from_torch, opt_state_to_torch, params_to_flax)
from ..models.gps import GPSModel
from ..models.mpnn import MPNN
from ..models.transformer import SimpleTransformer
from ..parallel.comm import psum
from ..parallel.dist import all_reduce_metrics
from ..parallel.mesh import (Axis, BatchShard, Mesh, ParamShard, gather_tensor, make_mesh,
                             shard_batch_spec, shard_params, shard_tensor)
from ..parallel.pipeline import pp_transformer_forward
from ..tokenization.vocab import SPECIAL
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint, serving_meta
from .datasets import QUERY_OFFSETS, QUERY_TASKS, DatasetBundle, build_dataset
from .metrics import (class_names, classification_metrics_from_cm,
                      format_confusion_matrix, regression_metrics_from_sums)
from .optim import ClippedAdamW, warmup_cosine_decay_schedule

__all__ = ["TrainResult", "build_model", "build_dataset", "build_optimizer",
           "make_batches", "train_batch_size", "RunLogger", "train"]


@dataclass
class TrainResult:
    best_val: float
    test_metrics: Dict[str, Any]
    history: List[Dict[str, Any]]
    params: Any = None                  # flax-layout tree of CPU tensors
    bundle: Optional[DatasetBundle] = None
    model: Optional[nn.Module] = None
    batch_stats: Any = None             # flax-layout tree (graph models)
    # per-step training losses of every epoch run, one array per epoch
    step_losses: List[np.ndarray] = field(default_factory=list)


# ---------------------------------------------------------------------------
# model construction
# ---------------------------------------------------------------------------

def attention_dropout_rate(p_drop: float, use_flash: bool) -> float:
    """The rate the JAX package drops attention probabilities at: its
    default XLA attention (``use_flash`` false or unset) quantises it to
    round(p*256)/256 in ``hash_keep_mask`` (26/256 at p = 0.1); its Pallas
    kernel (``use_flash`` true) drops at the exact p."""
    return p_drop if use_flash else round(p_drop * 256.0) / 256.0


def build_model(model_name: str, config: dict, bundle: DatasetBundle,
                generator: Optional[torch.Generator] = None,
                sp_mesh: Optional[Mesh] = None, ep_mesh: Optional[Mesh] = None
                ) -> nn.Module:
    """Build the model a checkpoint of ``model_name`` was trained as, with
    the JAX package's config defaults. ``generator`` seeds the initial
    parameters. For the token models, ``model.remat`` recomputes encoder
    layers in the backward pass (default: rows of 1024 tokens and longer).
    Attention always runs through the flash-attention kernels (their plain
    versions on the CPU); ``model.use_flash`` only sets the rate they drop
    attention probabilities at (:func:`attention_dropout_rate`). GPS reads
    its widths from the config's ``gt:`` block. ``sp_mesh`` and ``ep_mesh``
    make a token model sequence-parallel or give it the manual EP dispatch
    (``models/transformer.py``)."""
    model_cfg = config.get("model", {})
    task = bundle.task
    if model_name == "mpnn":
        return MPNN(
            in_dim=bundle.in_dim,
            hidden_dim=int(model_cfg.get("hidden_dim", 64)),
            num_layers=int(model_cfg.get("num_layers", 5)),
            dropout=float(model_cfg.get("dropout", 0.1)),
            pooling=model_cfg.get("pooling", "mean"),
            num_classes=bundle.num_classes,
            task=task,
            compute_dtype=model_cfg.get("compute_dtype", "bfloat16"),
            # edge types exist only in ZINC bundles (``eadj``)
            edge_features=bool(model_cfg.get("edge_features", False)) and task == "zinc",
            generator=generator,
        )
    if model_name == "ggps":
        gt = config.get("gt", {})
        return GPSModel(
            in_dim=bundle.in_dim,
            dim=int(gt.get("dim_hidden", model_cfg.get("dim_hidden", 32))),
            num_layers=int(gt.get("layers", model_cfg.get("num_layers", 4))),
            n_heads=int(gt.get("n_heads", model_cfg.get("n_heads", 4))),
            dropout=float(gt.get("dropout", 0.0)),
            attn_dropout=float(gt.get("attn_dropout", 0.1)),
            pooling=model_cfg.get("graph_pooling", "mean"),
            num_classes=bundle.num_classes,
            task=task,
            compute_dtype=model_cfg.get("compute_dtype", "bfloat16"),
            edge_features=bool(model_cfg.get("edge_features", False)) and task == "zinc",
            generator=generator,
        )
    if model_name not in ("ibtt", "agtt"):
        raise ValueError(f"unknown model {model_name!r}")
    if model_name == "ibtt":
        # from the dataset's vocab: the fixed ZINC vocab pins '<bos>' at 0,
        # the synthetic SPECIAL table at 1
        bos_id = (bundle.vocab or {}).get("<bos>", SPECIAL.index("<bos>"))
        offsets = QUERY_OFFSETS.get(task, (1, 2))
    else:
        bos_id = bundle.meta.get("bos_id", 0)
        offsets = (1, 2)  # trail-appended '<q> u v'
    seq_len = bundle.meta.get("max_len", 0)
    p_drop = float(model_cfg.get("dropout", 0.1))
    return SimpleTransformer(
        vocab_size=bundle.vocab_size,
        d_model=int(model_cfg.get("d_model", 32)),
        nhead=int(model_cfg.get("nhead", 4)),
        nlayers=int(model_cfg.get("nlayers", 4)),
        d_ff=int(model_cfg.get("d_ff", 128)),
        p_drop=p_drop,
        attn_p_drop=attention_dropout_rate(p_drop, bool(model_cfg.get("use_flash", False))),
        max_pos=max(int(model_cfg.get("max_pos", 600)), seq_len),
        num_classes=bundle.num_classes,
        use_query_nodes=task in QUERY_TASKS,
        task=task,
        bos_id=bos_id,
        query_offsets=offsets,
        compute_dtype=model_cfg.get("compute_dtype", "bfloat16"),
        # recompute encoder layers in the backward pass at long rows
        remat=bool(model_cfg.get("remat", seq_len >= 1024)),
        moe_experts=int(model_cfg.get("moe_experts", 0)),
        moe_capacity=float(model_cfg.get("moe_capacity", 1.25)),
        sp_mesh=sp_mesh, ep_mesh=ep_mesh,
        generator=generator,
    )


# ---------------------------------------------------------------------------
# one batch: forward, loss, statistics
# ---------------------------------------------------------------------------

def _apply_model(model, batch: Dict[str, torch.Tensor], bundle: DatasetBundle,
                 generator: Optional[torch.Generator] = None,
                 shard: Optional[BatchShard] = None,
                 aux: Optional[list] = None, pp: Optional[dict] = None) -> torch.Tensor:
    """Logits of one gathered batch: [B] / [B, C] for unpacked rows and
    graphs, [B, K] / [B, K, C] for packed rows. ``shard``: the rows' place
    in the global batch; a token model's MoE aux losses go to ``aux``;
    ``pp`` ({"mesh", "n_micro"}) runs the pipelined forward."""
    if pp is not None:
        packed = ({k: batch[k] for k in ("seg", "pos", "pos_bos", "pos_u", "pos_v")}
                  if "seg" in batch else {})
        mask = batch["seg"] > 0 if "seg" in batch else batch["mask"]
        return pp_transformer_forward(
            pp["mesh"], model, batch["ids"], mask, q_token_id=bundle.q_token_id,
            n_micro=pp["n_micro"], generator=generator, shard=shard,
            global_batch=None if shard is None else shard.total, **packed)
    if bundle.kind == "graphs":
        adj = batch["adj"].to(torch.float32)   # stored uint8
        return model(batch["node_feat"], adj, batch["mask"], etype=batch.get("eadj"),
                     generator=generator, shard=shard)
    if "seg" in batch:
        return model(batch["ids"], batch["seg"] > 0,
                     q_token_id=bundle.q_token_id, seg=batch["seg"],
                     pos=batch["pos"], pos_bos=batch["pos_bos"],
                     pos_u=batch["pos_u"], pos_v=batch["pos_v"],
                     generator=generator, shard=shard, aux=aux)
    return model(batch["ids"], batch["mask"], q_token_id=bundle.q_token_id,
                 generator=generator, shard=shard, aux=aux)


def _loss_inputs(logits, batch, bvalid):
    """Flatten packed-row outputs to per-example vectors.

    Packed train batches carry labels [B, K] plus a per-slot ``ex_valid``;
    the loss/metric machinery is per-example, so flatten to [B*K] with
    validity = row-valid AND slot-valid. Unpacked batches pass through."""
    y = batch["y"]
    if y.dim() >= 2 and "ex_valid" in batch:
        valid = bvalid[:, None] & batch["ex_valid"]
        return (logits.reshape((-1,) + logits.shape[y.dim():]),
                y.reshape(-1), valid.reshape(-1))
    return logits, y, bvalid


def _loss_and_stats(logits, y, valid, task: str, num_classes: int):
    """(mean loss over valid examples, sufficient statistics as 0-dim or
    [C, C] f32 tensors on the logits' device)."""
    vf = valid.to(torch.float32)
    count = vf.sum()
    logits = logits.float()
    if task == "zinc":
        err = logits - y
        loss_sum = (err.abs() * vf).sum()  # L1
        stats = {"loss_sum": loss_sum, "count": count,
                 "abs_sum": (err.abs() * vf).sum(),
                 "sq_sum": (err ** 2 * vf).sum()}
        return loss_sum / count.clamp(min=1.0), stats
    y = y.long()
    loss_vec = F.cross_entropy(logits, y, reduction="none")
    loss_sum = (loss_vec * vf).sum()
    preds = logits.argmax(dim=-1)
    lh = F.one_hot(y, num_classes).to(torch.float32) * vf[:, None]
    ph = F.one_hot(preds, num_classes).to(torch.float32)
    stats = {"loss_sum": loss_sum, "count": count, "cm": lh.T @ ph}
    return loss_sum / count.clamp(min=1.0), stats


def make_batches(n: int, batch_size: int, rng: np.random.Generator | None,
                 pad_to_nb: int | None = None):
    """[nb, bs] index matrix + [nb, bs] validity mask (last batch padded
    with index 0, marked invalid). ``pad_to_nb`` pads the batch count with
    fully-invalid batches."""
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    nb = max(1, (n + batch_size - 1) // batch_size)
    if pad_to_nb is not None:
        nb = max(nb, pad_to_nb)
    padded = np.zeros(nb * batch_size, dtype=np.int32)
    padded[:n] = idx
    valid = np.zeros(nb * batch_size, dtype=bool)
    valid[:n] = True
    return padded.reshape(nb, batch_size), valid.reshape(nb, batch_size)


def train_batch_size(bundle: DatasetBundle, batch_size: int) -> int:
    """Rows per train step. A packed train split counts ROWS, each holding
    several examples: the row batch is scaled so that a step still sees
    about ``batch_size`` examples."""
    if "seg" not in bundle.splits["train"]:
        return batch_size
    n_rows = bundle.n("train")
    n_examples = int(bundle.meta.get("n_examples_train", n_rows))
    return max(1, round(batch_size * n_rows / max(n_examples, 1)))


def data_parallel_rows(ranks: int, batch_size: int, train_bs: int,
                       packed: bool) -> Tuple[int, bool]:
    """(train row batch, whether minibatches shard) on a data axis of
    ``ranks``, as the reference decides them: a packed split's derived row
    batch is rounded down to a multiple of the ranks, and a minibatch
    shards only when both ``batch_size`` and the row batch divide by the
    ranks (otherwise every rank computes the whole of it)."""
    if ranks == 1:
        return train_bs, False
    if packed:
        train_bs = max(ranks, (train_bs // ranks) * ranks)
    return train_bs, batch_size % ranks == 0 and train_bs % ranks == 0


def build_optimizer(model: nn.Module, train_cfg: dict, steps_per_epoch: int,
                    shards: Optional[Dict[str, ParamShard]] = None):
    """(``ClippedAdamW`` over the model's parameters, schedule or None) as
    ``train_cfg`` asks: ``scheduler: cosine_with_warmup`` warms up over
    ``num_warmup_epochs`` (default 5) epochs, then decays over the rest of
    ``epochs``; the AdamW first moment is stored in bf16 by default, f32 on
    request (``mu_dtype``). ``shards``: the split parameters, whose squares
    the global norm sums over their axes."""
    lr = float(train_cfg.get("lr", 1e-3))
    schedule = None
    if train_cfg.get("scheduler", "none") == "cosine_with_warmup":
        epochs = int(train_cfg.get("epochs", 100))
        warm = int(train_cfg.get("num_warmup_epochs", 5)) * steps_per_epoch
        schedule = warmup_cosine_decay_schedule(
            0.0, lr, warm, max(epochs * steps_per_epoch, warm + 1))
    named = dict(model.named_parameters())
    opt = ClippedAdamW(list(named), list(named.values()), schedule or lr,
                       weight_decay=float(train_cfg.get("weight_decay", 1e-4)),
                       mu_dtype=train_cfg.get("mu_dtype", "bfloat16"),
                       split_axes=[shards[k].axis if k in (shards or {}) else None
                                   for k in named])
    return opt, schedule


def _gather(arrays: Dict[str, torch.Tensor], idx: torch.Tensor):
    return {k: v[idx] for k, v in arrays.items()}


def _rows(t: torch.Tensor, shard: Optional[BatchShard]) -> torch.Tensor:
    """This rank's block of a minibatch's index or validity row."""
    return t if shard is None else t[shard.start:shard.stop]


def _all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` summed in place over ``axis``."""
    with torch.no_grad():
        t.copy_(psum(t, axis))
    return t


@dataclass
class Layout:
    """How a run lies on the mesh: ``mesh`` (None: one process), the rows'
    ``train_shard``/``eval_shard`` (None: every rank computes all rows), the
    split parameters ``shards`` (by ``state_dict`` key) and the pipeline
    ``pp`` ({"mesh", "n_micro"} or None)."""

    mesh: Optional[Mesh] = None
    train_shard: Optional[BatchShard] = None
    eval_shard: Optional[BatchShard] = None
    shards: Dict[str, ParamShard] = field(default_factory=dict)
    pp: Optional[dict] = None

    def grad_groups(self, names: List[str]) -> List[Tuple[Axis, List[int]]]:
        """(axis, parameter indices) pairs: each gradient is summed over
        every mesh axis its parameter is not split over (module docstring)."""
        groups: Dict[tuple, Tuple[Axis, List[int]]] = {}
        for i, name in enumerate(names):
            sh = self.shards.get(name)
            axis = self.mesh.but(sh.axis.names[0]) if sh else self.mesh.axis()
            groups.setdefault(axis.names, (axis, []))[1].append(i)
        return [g for g in groups.values() if g[0].size > 1]


def _sum_grads(grads, groups: List[Tuple[Axis, List[int]]]) -> List[torch.Tensor]:
    """Sum each group's gradients over its axis, one flat all-reduce a
    group."""
    grads = list(grads)
    for axis, idx in groups:
        flat = psum(torch.cat([grads[i].reshape(-1) for i in idx]), axis)
        at = 0
        for i in idx:
            grads[i] = flat[at:at + grads[i].numel()].view_as(grads[i])
            at += grads[i].numel()
    return grads


def _add_stats(total: Optional[dict], stats: dict) -> dict:
    stats = {k: v.detach() for k, v in stats.items()}
    if total is None:
        return stats
    return {k: total[k] + v for k, v in stats.items()}


def _to_host(*stat_dicts: dict) -> List[Dict[str, np.ndarray]]:
    """Read several statistics dicts from the device in one transfer."""
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for d in stat_dicts for v in d.values()]).cpu().numpy()
    out, at = [], 0
    for d in stat_dicts:
        host = {}
        for k, v in d.items():
            host[k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
            at += v.numel()
        out.append(host)
    return out


def _epoch_metrics(stats: Dict[str, np.ndarray], task: str) -> Dict[str, Any]:
    if task == "zinc":
        m = regression_metrics_from_sums(
            float(stats["abs_sum"]), float(stats["sq_sum"]),
            float(stats["loss_sum"]), float(stats["count"]))
    else:
        m = classification_metrics_from_cm(
            stats["cm"], task, float(stats["loss_sum"]), float(stats["count"]))
    if "gn_sum" in stats:  # mean per-step gradient global norm (train only)
        m["grad_norm"] = float(stats["gn_sum"]) / max(float(stats["gn_cnt"]), 1.0)
    return m


def _batch_loss(model, arrays, idx_b, valid_b, bundle: DatasetBundle,
                generator: Optional[torch.Generator], layout: Layout,
                moe_aux_weight: float):
    """(this rank's share of one training minibatch's loss, its statistics,
    the valid count over every rank) of a training forward."""
    mesh, shard = layout.mesh, layout.train_shard
    batch = _gather(arrays, _rows(idx_b, shard))
    aux: List[torch.Tensor] = []
    logits = _apply_model(model, batch, bundle, generator, shard, aux, layout.pp)
    lg, y, lvalid = _loss_inputs(logits, batch, _rows(valid_b, shard))
    loss, stats = _loss_and_stats(lg, y, lvalid, bundle.task, bundle.num_classes)
    count = stats["count"]
    if mesh is not None:
        # this rank's share: its sum over the count of every rank (the
        # ranks holding the same rows each count them once)
        count = _all_reduce_(count.detach().clone(), mesh.axis())
        loss = stats["loss_sum"] / count.clamp(min=1.0)
    if aux:
        # the mean of the layers' Switch losses; every rank holds the
        # same global value, so each adds its share
        loss = loss + moe_aux_weight * (sum(aux) / len(aux)) / (
            1 if mesh is None else mesh.size)
    return loss, stats, count


def _batch_grads(loss, opt: ClippedAdamW, layout: Layout) -> List[torch.Tensor]:
    """The gradients of ``loss`` in the optimizer's parameters, each summed
    over the mesh axes its parameter is not split over."""
    groups = layout.grad_groups(opt.names) if layout.mesh is not None else []
    # a pipeline stage leaves the other stages' layers unused: zeros
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        opt.params, torch.autograd.grad(loss, opt.params, allow_unused=True))]
    return _sum_grads(grads, groups)


def grad_probe(model, opt: ClippedAdamW, arrays, idx_b, valid_b, bundle: DatasetBundle,
               generator: torch.Generator, layout: Layout,
               moe_aux_weight: float) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} of one training minibatch at the current
    parameters, for the gradient histograms (the reference's ``grad_probe``).
    Nothing of the run changes: no update, the dropout seeds drawn from
    ``generator`` (the caller's, out of the run's stream), and the BatchNorm
    statistics the forward updates put back."""
    buffers = {k: b.detach().clone() for k, b in model.named_buffers()}
    model.train()     # a training forward: dropout on, batch statistics
    loss, _, _ = _batch_loss(model, arrays, idx_b, valid_b, bundle, generator, layout,
                             moe_aux_weight)
    grads = _batch_grads(loss, opt, layout)
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(buffers[k])
    return dict(zip(opt.names, grads))


def train_epoch(model, opt: ClippedAdamW, arrays, idx, valid,
                bundle: DatasetBundle, generator: Optional[torch.Generator],
                max_steps: Optional[int] = None, layout: Optional[Layout] = None,
                moe_aux_weight: float = 0.01):
    """One pass over the minibatches ``idx``/``valid`` ([nb, bs] device
    tensors). Returns (summed statistics, per-step losses [steps]), both on
    the device: nothing is read back here. On a mesh (``layout``) this rank
    runs its rows of every minibatch, its loss is its share of the global
    batch's and its gradients are summed as the module docstring says; the
    returned statistics and losses are the global batch's."""
    model.train()
    layout = layout or Layout()
    mesh, shard = layout.mesh, layout.train_shard
    total, losses = None, []
    steps = idx.shape[0] if max_steps is None else min(max_steps, idx.shape[0])
    for b in range(steps):
        loss, stats, count = _batch_loss(model, arrays, idx[b], valid[b], bundle,
                                         generator, layout, moe_aux_weight)
        grads = _batch_grads(loss, opt, layout)
        # the gradient norm BEFORE clipping, as a per-epoch mean
        has = (count > 0).to(torch.float32)
        stats["gn_sum"] = opt.step(grads) * has
        stats["gn_cnt"] = has
        total = _add_stats(total, stats)
        losses.append(loss.detach())
    losses = torch.stack(losses)
    if mesh is not None:
        losses = _all_reduce_(losses, mesh.axis())   # the shares sum to each step's loss
    if shard is not None:
        gn = {k: total.pop(k) for k in ("gn_sum", "gn_cnt")}
        total = all_reduce_metrics(total, shard) | gn
    return total, losses


@torch.no_grad()
def eval_epoch(model, arrays, idx, valid, bundle: DatasetBundle,
               layout: Optional[Layout] = None):
    """Summed statistics of a deterministic pass, on the device; on a mesh,
    over this rank's rows of every batch, then all-reduced over the rows."""
    model.eval()
    layout = layout or Layout()
    shard = layout.eval_shard
    total = None
    for b in range(idx.shape[0]):
        batch = _gather(arrays, _rows(idx[b], shard))
        logits = _apply_model(model, batch, bundle, shard=shard, pp=layout.pp)
        lg, y, lvalid = _loss_inputs(logits, batch, _rows(valid[b], shard))
        _, stats = _loss_and_stats(lg, y, lvalid, bundle.task,
                                   bundle.num_classes)
        total = _add_stats(total, stats)
    return total if shard is None else all_reduce_metrics(total, shard)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _device_memory_mb(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / (1024 ** 2)


def _wandb_module(wandb_cfg: dict):
    """The wandb module when ``wandb.use`` is set and it imports, else None.
    Every rank asks, so all of them run the collectives of the histograms
    alike."""
    if not wandb_cfg.get("use"):
        return None
    try:
        import wandb  # noqa: PLC0415
    except ImportError:
        return None
    return wandb


class RunLogger:
    """stdout + JSONL metrics log with the reference W&B key schema; uses
    wandb when ``wandb.use`` is set and the package imports. The image,
    table and histogram calls are no-ops without wandb."""

    def __init__(self, out_dir: str, run_name: str, wandb_cfg: dict, config: dict,
                 wandb_name: Optional[str] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "w")  # fresh log per run
        self.wandb = _wandb_module(wandb_cfg)
        if wandb_cfg.get("use") and not self.wandb:
            print("[warn] wandb.use is set but wandb does not import; "
                  "logging to the JSONL file only")
        if self.wandb:
            self.wandb.init(project=wandb_cfg.get("project", "graph-token"),
                            name=wandb_name or run_name, config=config)

    def log(self, d: Dict[str, Any]):
        clean = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in d.items()}
        self._f.write(json.dumps(clean) + "\n")
        self._f.flush()
        if self.wandb:
            self.wandb.log(d)

    def log_image(self, key: str, img, caption: str = ""):
        """W&B image (the reference logs the test confusion-matrix heatmap);
        the PNG is on disk either way."""
        if self.wandb:
            self.wandb.log({key: self.wandb.Image(img, caption=caption)})

    def log_table(self, key: str, columns, data):
        """W&B table (the reference logs the confusion matrix as one)."""
        if self.wandb:
            self.wandb.log({key: self.wandb.Table(columns=columns, data=data)})

    def _log_histograms(self, tensors: Dict[str, torch.Tensor], prefix: str,
                        step: Optional[int]):
        if not self.wandb:
            return
        hists = {f"{prefix}/{'/'.join(flax_path(name)[0])}":
                 self.wandb.Histogram(t.detach().float().cpu().numpy().ravel())
                 for name, t in tensors.items()}
        if hists:
            self.wandb.log(hists if step is None else {**hists, "epoch": step})

    def log_param_histograms(self, params: Dict[str, torch.Tensor],
                             step: Optional[int] = None):
        """Per-parameter weight histograms under the flax names (the
        parameter half of the reference's ``wandb.watch(log="all")``). No-op,
        and no device sync, without wandb."""
        self._log_histograms(params, "parameters", step)

    def log_grad_histograms(self, grads: Dict[str, torch.Tensor],
                            step: Optional[int] = None):
        """Per-parameter gradient histograms under the flax names (the
        gradient half of ``wandb.watch(log="all")``), from the grad probe.
        No-op without wandb."""
        self._log_histograms(grads, "gradients", step)

    def finish(self):
        self._f.close()
        if self.wandb:
            self.wandb.finish()


class _NoLog:
    """The logger of a rank other than 0: rank 0 writes the run's log."""

    wandb = None

    def log(self, d: Dict[str, Any]):
        pass

    def log_param_histograms(self, params, step=None):
        pass

    def log_grad_histograms(self, grads, step=None):
        pass

    def finish(self):
        pass


def _log_confusion_matrix(logger, cm: np.ndarray, task: str, path: str) -> None:
    """The test confusion matrix as a heatmap PNG at ``path``, and with
    wandb as an image and, up to 30 classes, a table (the reference's keys).
    Skipped with a warning where matplotlib or PIL does not import."""
    try:
        import matplotlib  # noqa: F401, PLC0415
        import PIL  # noqa: F401, PLC0415
    except ImportError:
        print("[warn] matplotlib or PIL does not import: no confusion-matrix image")
        return
    from .viz import create_confusion_matrix_heatmap

    img = create_confusion_matrix_heatmap(cm, task, title="Test Confusion Matrix")
    img.save(path)
    logger.log_image("test/confusion_matrix_heatmap", img, caption="Confusion Matrix")
    if cm.shape[0] <= 30:      # a W&B table of C x (C + 1) cells
        labels = class_names(task, cm.shape[0])
        logger.log_table("test/confusion_matrix", ["True/Pred"] + labels,
                         [[lab] + cm[i].tolist() for i, lab in enumerate(labels)])


def _check_parallel(config: dict, model_name: str) -> dict:
    """The JAX trainer's guards on the ``parallel`` block that read only the
    config (``train/trainer.py:586-631``), with its messages; returns the
    block's values."""
    parallel = config.get("parallel", {}) or {}
    tokens = model_name in ("ibtt", "agtt")
    seq_shards = int(parallel.get("seq_shards", 1))
    if seq_shards > 1 and not tokens:
        raise ValueError("parallel.seq_shards applies to the token "
                         "transformers (ibtt/agtt); graph-native models "
                         "have no sequence axis")
    pipe_stages = int(parallel.get("pipe_stages", 1))
    if pipe_stages > 1 and not tokens:
        raise ValueError("parallel.pipe_stages applies to the token "
                         "transformers (ibtt/agtt); graph-native models "
                         "have no layer pipeline")
    expert_shards = int(parallel.get("expert_shards", 1))
    moe_experts = int(config.get("model", {}).get("moe_experts", 0))
    if expert_shards > 1:
        if not tokens:
            raise ValueError("parallel.expert_shards applies to the token "
                             "transformers (ibtt/agtt); the graph-native "
                             "models have no MoE FFN")
        if moe_experts <= 0:
            raise ValueError("parallel.expert_shards requires model.moe_experts")
        if moe_experts % expert_shards != 0:
            raise ValueError(
                f"model.moe_experts={moe_experts} must divide over "
                f"parallel.expert_shards={expert_shards} (otherwise the "
                "expert stacks stay replicated while the mesh still gives "
                "up data-parallel width)")
    ep_manual = bool(parallel.get("ep_manual", False))
    if ep_manual and expert_shards <= 1:
        raise ValueError("parallel.ep_manual requires parallel.expert_shards")
    if pipe_stages > 1 and moe_experts > 0:
        raise ValueError("parallel.pipe_stages with model.moe_experts is "
                         "unsupported (the pipeline's layer scan cannot "
                         "capture the MoE aux-loss sow)")
    return {"model_axis": int(parallel.get("model_axis", 1)), "seq_shards": seq_shards,
            "pipe_stages": pipe_stages, "expert_shards": expert_shards,
            "ep_manual": ep_manual,
            "n_micro": int(parallel.get("pipe_microbatches", pipe_stages))}


def _layout(mesh: Optional[Mesh], par: dict, model, batch_size: int, train_bs: int,
            packed_train: bool) -> Tuple[int, Layout]:
    """(train row batch, Layout) of a run, with the JAX trainer's guards on
    the mesh and the batches (``train/trainer.py:638-640``, ``:670-680``,
    ``:687-701``)."""
    if mesh is None:
        return train_bs, Layout()
    data = mesh.shape["data"]
    train_bs, sharded = data_parallel_rows(data, batch_size, train_bs, packed_train)
    rows = mesh.axis("data")
    if par["ep_manual"]:
        # every batch shards over data x expert, which both must divide
        width = data * mesh.shape["expert"]
        for bs_check, what in ((train_bs, "train batch"), (batch_size, "eval batch")):
            if bs_check % width != 0:
                raise ValueError(f"{what} {bs_check} not divisible by "
                                 f"data*expert mesh width {width} "
                                 "(parallel.ep_manual)")
        rows, sharded = mesh.axis("data", "expert"), True
    pp = None
    if par["pipe_stages"] > 1:
        n_micro = par["n_micro"]
        if model.nlayers % par["pipe_stages"] != 0:
            raise ValueError(f"model.nlayers={model.nlayers} must divide over "
                             f"pipe_stages={par['pipe_stages']}")
        for bs_check, what in ((train_bs, "train batch"), (batch_size, "eval batch")):
            if bs_check % n_micro != 0:
                raise ValueError(f"{what} {bs_check} not divisible by "
                                 f"pipe_microbatches={n_micro}")
        pp = {"mesh": mesh, "n_micro": n_micro}
    return train_bs, Layout(
        mesh, shard_batch_spec(mesh, train_bs, rows) if sharded else None,
        shard_batch_spec(mesh, batch_size, rows) if sharded else None, {}, pp)


def _example_graphs(dataset_cfg: dict, task: str, seed: int) -> str:
    """The text log of one example graph of the first train algorithm."""
    from ..data.loader import load_graphs_multi_algorithm
    from .viz import log_graph_examples

    gs = load_graphs_multi_algorithm(
        dataset_cfg.get("graph_token_root", "graph-token"), task,
        dataset_cfg.get("train_algorithms", [])[:1], "train",
        num_graphs=1, num_pairs_per_graph=1, seed=seed)
    return log_graph_examples(gs, task=task, num_examples=1)


def _snapshot(model, opt: ClippedAdamW) -> dict:
    return {"params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "opt": opt.state()}


def _gathered(tensors: Dict[str, torch.Tensor],
              shards: Dict[str, ParamShard]) -> Dict[str, torch.Tensor]:
    """``tensors`` with every split one gathered whole (a collective: every
    rank calls it)."""
    return {k: gather_tensor(v, shards[k]) if k in shards else v
            for k, v in tensors.items()}


def _whole(snapshot: dict, names: List[str], shards: Dict[str, ParamShard]) -> dict:
    """A snapshot with every split tensor gathered whole (a collective:
    every rank calls it), in the one-process layout."""
    if not shards:
        return snapshot
    params = _gathered(snapshot["params"], shards)
    opt = dict(snapshot["opt"])
    for which in ("mu", "nu"):
        opt[which] = [gather_tensor(t, shards[k]) if k in shards else t
                      for k, t in zip(names, opt[which])]
    return {"params": params, "opt": opt}


def start_profile(device: torch.device):
    """A running ``torch.profiler`` profile of CPU and, on the card, CUDA
    activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, path: str) -> None:
    """Stop ``prof`` and write its Chrome trace to ``path``."""
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def train(config: dict, model_name: str, limit: Optional[int] = None,
          verbose: bool = True,
          device: Optional[str | torch.device] = None) -> TrainResult:
    """Train ``model_name`` as ``config`` says. ``device=None`` means cuda
    and raises when there is no GPU; pass ``"cpu"`` to train on the CPU.
    With an initialised process group of several ranks, the run is
    data-parallel over them (module docstring)."""
    device = resolve_device(device)
    dataset_cfg = config["dataset"]
    train_cfg = config.get("train", {})
    output_cfg = config.get("output", {})
    wandb_cfg = config.get("wandb", {"use": False})
    par = _check_parallel(config, model_name)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    main = world == 1 or dist.get_rank() == 0
    verbose = verbose and main

    seed = int(train_cfg.get("seed", 0))
    epochs = int(train_cfg.get("epochs", 100))
    batch_size = int(train_cfg.get("batch_size", 128))
    lr = float(train_cfg.get("lr", 1e-3))
    task = dataset_cfg["task"]

    if main:   # generates a missing corpus and writes the bundle cache
        bundle = build_dataset(model_name, dataset_cfg, seed, limit=limit)
    if world > 1:
        dist.barrier()
    if not main:
        bundle = build_dataset(model_name, dataset_cfg, seed, limit=limit)
    n_train = bundle.n("train")
    if n_train == 0:
        raise RuntimeError("No training examples found. Did you run the task generator?")
    # packed train split: n_train counts ROWS (each holding ~K sequences);
    # scale the row batch so examples-per-step stays ~batch_size, and report
    # throughput in examples
    packed_train = "seg" in bundle.splits["train"]
    n_train_examples = int(bundle.meta.get("n_examples_train", n_train))
    if par["seq_shards"] > 1 and packed_train:
        raise ValueError("parallel.seq_shards requires dataset.pack: "
                         "false (ring attention has no segment mask)")
    mesh = make_mesh(par["model_axis"], par["seq_shards"], par["pipe_stages"],
                     par["expert_shards"])
    mesh = None if mesh.size == 1 else mesh

    generator = torch.Generator().manual_seed(seed)  # init, then dropout seeds
    model = build_model(model_name, config, bundle, generator=generator,
                        sp_mesh=mesh if par["seq_shards"] > 1 else None,
                        ep_mesh=mesh if par["ep_manual"] else None).to(device)
    train_bs, layout = _layout(mesh, par, model, batch_size,
                               train_batch_size(bundle, batch_size), packed_train)
    if verbose:
        print(f"#train: {n_train} | #val: {bundle.n('val')} | #test: {bundle.n('test')}")
        if packed_train:
            print(f"packed train split: {n_train_examples} examples in "
                  f"{n_train} rows (x{n_train_examples / max(n_train, 1):.2f} "
                  f"density), row batch {train_bs}")
        if task != "zinc" and bundle.kind == "graphs":
            print(_example_graphs(dataset_cfg, task, seed))
    num_params = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"Model parameters: {num_params:,}")

    out_dir = output_cfg.get("out_dir", f"runs_{model_name}")
    run_name = output_cfg.get("run_name", f"{model_name}-{task}")
    best_path = os.path.join(out_dir, f"best_{run_name}")
    ckpt = None
    if train_cfg.get("resume"):
        # train.resume_path overrides the default out_dir/best_<run> location
        ckpt_path = train_cfg.get("resume_path") or best_path
        ckpt = load_checkpoint(ckpt_path)
        if ckpt is None and verbose:
            print(f"[warn] no checkpoint at {ckpt_path}; starting fresh")
        if ckpt is not None and ckpt.get("params") is not None:
            load_flax_params(model, ckpt["params"], ckpt.get("batch_stats"))
        else:
            ckpt = None
    # the run's parameters: the whole model's, then this rank's shards
    if mesh is not None:
        layout.shards = shard_params(mesh, model)
    steps_per_epoch = max(1, (n_train + train_bs - 1) // train_bs)
    opt, schedule = build_optimizer(model, train_cfg, steps_per_epoch, layout.shards)
    names = opt.names

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # device-resident split arrays (single transfer)
    dev_splits = {s: {k: on_device(v) for k, v in arrays.items()}
                  for s, arrays in bundle.splits.items()}

    if task == "zinc":
        wandb_name = run_name
    else:
        wandb_name = f"{run_name} ({'+'.join(dataset_cfg.get('train_algorithms', []))})"
    logger = (RunLogger(out_dir, run_name, wandb_cfg, config, wandb_name=wandb_name)
              if main else _NoLog())
    logger.log({"model/num_parameters": num_params})
    # the histograms' gathers are collectives: every rank decides alike
    histograms = _wandb_module(wandb_cfg) is not None

    zinc = task == "zinc"
    better = (lambda a, b: a < b) if zinc else (lambda a, b: a > b)
    best_val = float("inf") if zinc else -1.0
    start_epoch = 1
    if ckpt is not None:
        if ckpt.get("opt_state"):
            # AdamW moments and step counts, cast to this optimizer's
            # dtypes: mu precision is a storage choice, not state
            state = opt_state_to_torch(ckpt["opt_state"], names,
                                       with_schedule=schedule is not None)
            if state is not None:
                for which in ("mu", "nu"):   # this rank's blocks
                    state[which] = [shard_tensor(t, layout.shards[k])
                                    if k in layout.shards else t
                                    for k, t in zip(names, state[which])]
                opt.load_state(state)
            elif verbose:
                print("[warn] checkpoint opt_state does not match the "
                      "optimizer; resuming with a fresh optimizer state")
        elif verbose:
            print("[warn] checkpoint has no opt_state; resuming with a "
                  "fresh optimizer state")
        best_val = float(ckpt.get("best_val", best_val))
        start_epoch = int(ckpt.get("epoch", 0)) + 1
        if verbose:
            print(f"Resumed from epoch {start_epoch - 1} "
                  f"(best_val={best_val:.4f})")
    # resumed: the loaded params ARE the best so far
    best = _snapshot(model, opt) if start_epoch > 1 else None
    history: List[Dict[str, Any]] = []
    step_losses: List[np.ndarray] = []
    shuffle_rng = np.random.default_rng(seed)
    t0 = time.time()
    time_to_best = 0.0
    initial_val_metric = 0.0

    eval_batches = {s: tuple(on_device(a) for a in
                             make_batches(bundle.n(s), batch_size, None))
                    for s in ("val", "test")}
    vidx, vvalid = eval_batches["val"]
    train_valid = on_device(make_batches(n_train, train_bs, None)[1])

    # K epochs per block. Any K is exact: the block's best epoch is chosen by
    # the val metric with strict improvement, so K only groups the work.
    # The epoch count rounds UP to a multiple of K, as in the reference.
    k_disp = max(1, int(train_cfg.get("epochs_per_dispatch", 1)))
    metric_key, metric_name = ("mae", "mae") if zinc else ("accuracy", "acc")
    # torch.profiler traces of the listed epochs (rank 0)
    profile_epochs = set(train_cfg.get("profile_epochs", []) or []) if main else set()
    trace_dir = os.path.join(out_dir, f"{run_name}_trace")
    moe_aux_weight = float(config.get("model", {}).get("moe_aux_weight", 0.01))

    epoch = start_epoch
    while epoch <= epochs:
        blk_best, blk_metric, blk_ep = None, None, -1
        va_metrics: List[float] = []
        for j in range(k_disp):
            ep = epoch + j
            prof = start_profile(device) if ep in profile_epochs else None
            ep_start = time.time()
            idx = on_device(make_batches(n_train, train_bs, shuffle_rng)[0])
            tr_stats, losses = train_epoch(model, opt, dev_splits["train"], idx,
                                           train_valid, bundle, generator,
                                           layout=layout, moe_aux_weight=moe_aux_weight)
            va_stats = eval_epoch(model, dev_splits["val"], vidx, vvalid, bundle, layout)
            # the epoch's one read from the device
            tr_host, va_host, loss_host = _to_host(tr_stats, va_stats,
                                                   {"losses": losses})
            if prof is not None:
                stop_profile(prof, os.path.join(trace_dir, f"epoch_{ep:03d}.json"))
            dur = time.time() - ep_start
            step_losses.append(loss_host["losses"])
            tr = _epoch_metrics(tr_host, task)
            va = _epoch_metrics(va_host, task)
            tr_metric, va_metric = tr[metric_key], va[metric_key]
            if blk_metric is None or better(va_metric, blk_metric):
                # strict improvement keeps the first of equal epochs
                blk_best, blk_metric, blk_ep = _snapshot(model, opt), va_metric, j

            cur_lr = schedule(ep * steps_per_epoch) if schedule else lr
            log = {
                "epoch": ep,
                "train/loss": tr["loss"], "val/loss": va["loss"],
                "lr": float(cur_lr),
                "time/epoch_duration": dur,
                "throughput/graphs_per_sec": n_train_examples / dur if dur > 0 else 0.0,
                "memory/device_mb": _device_memory_mb(device),
            }
            # the reference's key name, emitted as an alias
            log["memory/gpu_allocated_mb"] = log["memory/device_mb"]
            if "grad_norm" in tr:
                log["train/grad_norm"] = tr["grad_norm"]
            if zinc:
                for kk in ("mae", "mse", "rmse"):
                    log[f"train/{kk}"] = tr[kk]
                    log[f"val/{kk}"] = va[kk]
            else:
                log["train/acc"] = tr_metric
                log["val/acc"] = va_metric
                for side, m in (("train", tr), ("val", va)):
                    log[f"{side}/precision"] = m.get("precision", m.get("precision_macro", 0))
                    log[f"{side}/recall"] = m.get("recall", m.get("recall_macro", 0))
                    log[f"{side}/f1"] = m.get("f1", m.get("f1_macro", 0))
                if task == "shortest_path":
                    for side, m in (("train", tr), ("val", va)):
                        log[f"{side}/mse"] = m.get("mse", 0)
                        log[f"{side}/mae"] = m.get("mae", 0)
            gain = abs(va_metric - initial_val_metric)
            elapsed = time.time() - t0
            log["efficiency/time_per_metric_unit"] = elapsed / gain if gain > 0 else 0
            logger.log(log)
            history.append(log)
            if verbose:
                print(f"epoch {ep:03d} | train {tr['loss']:.4f}/{metric_name}="
                      f"{tr_metric:.4f} | val {va['loss']:.4f}/{metric_name}="
                      f"{va_metric:.4f} | time {dur:.2f}s")
            va_metrics.append(va_metric)

        # adopt the block's best epoch when it beats the global best, strictly
        if blk_ep >= 0 and better(va_metrics[blk_ep], best_val):
            best_val = va_metrics[blk_ep]
            best = blk_best
            time_to_best = time.time() - t0
            whole = _whole(best, names, layout.shards)
            if main:
                save_checkpoint(best_path, {
                    "params": params_to_flax(whole["params"]),
                    "batch_stats": batch_stats_to_flax(whole["params"]),
                    "opt_state": opt_state_from_torch(
                        whole["opt"], names, with_schedule=schedule is not None),
                    "epoch": epoch + blk_ep, "best_val": best_val,
                    "config": config, "vocab": bundle.vocab,
                    "serve": serving_meta(model_name, bundle)})
        if histograms:
            # the block's last epoch: the parameters, and the gradients of
            # its first train batch, with dropout seeds out of the run's stream
            step = epoch + k_disp - 1
            logger.log_param_histograms(
                _gathered(dict(model.named_parameters()), layout.shards), step)
            probe_gen = torch.Generator().manual_seed(
                int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
            grads = grad_probe(model, opt, dev_splits["train"], idx[0], train_valid[0],
                               bundle, probe_gen, layout, moe_aux_weight)
            logger.log_grad_histograms(_gathered(grads, layout.shards), step)
        epoch += k_disp

    total_time = time.time() - t0

    # reload the best epoch, then run the test split
    if best is not None:
        model.load_state_dict(best["params"])

    # eval-only (epochs=0 + resume): no epoch ran, so score the val split here
    if epochs < start_epoch and best is not None and bundle.n("val"):
        va = _epoch_metrics(_to_host(eval_epoch(
            model, dev_splits["val"], vidx, vvalid, bundle, layout))[0], task)
        va_metric = va[metric_key]
        logger.log({"val/loss": va["loss"], f"val/{metric_name}": va_metric})
        if verbose:
            print(f"eval-only | val {va['loss']:.4f}/{metric_name}={va_metric:.4f}")
    if bundle.n("test") == 0:
        print("[warn] No test examples found. Test metrics will be trivial.")
        te = {"loss": 0.0} | ({"mae": 0.0, "mse": 0.0, "rmse": 0.0}
                             if zinc else {"accuracy": 0.0})
    else:
        tidx, tvalid = eval_batches["test"]
        te = _epoch_metrics(_to_host(eval_epoch(
            model, dev_splits["test"], tidx, tvalid, bundle, layout))[0], task)
    if main and "confusion_matrix" in te:
        _log_confusion_matrix(logger, te["confusion_matrix"], task,
                              os.path.join(out_dir, f"{run_name}_test_cm.png"))

    if verbose:
        print("\n" + "=" * 80 + "\nTEST RESULTS\n" + "=" * 80)
        print(f"Loss: {te['loss']:.4f}")
        if zinc:
            print(f"MAE: {te['mae']:.4f}\nMSE: {te['mse']:.4f}\nRMSE: {te['rmse']:.4f}")
        else:
            print(f"Accuracy: {te['accuracy']:.4f}")
            if "confusion_matrix" in te:
                print("\n" + format_confusion_matrix(te["confusion_matrix"], task))
        print(f"\nTotal training time: {total_time:.2f}s")
        print(f"Time to best validation: {time_to_best:.2f}s")

    test_log = {"test/loss": te["loss"],
                "time/total_train_time": total_time,
                "time/time_to_best_val": time_to_best}
    if zinc:
        test_log |= {f"test/{k}": te[k] for k in ("mae", "mse", "rmse")}
    else:
        test_log["test/acc"] = te["accuracy"]
        test_log["test/precision"] = te.get("precision", te.get("precision_macro", 0))
        test_log["test/recall"] = te.get("recall", te.get("recall_macro", 0))
        test_log["test/f1"] = te.get("f1", te.get("f1_macro", 0))
        if task == "shortest_path":
            test_log["test/mse"] = te.get("mse", 0)
            test_log["test/mae"] = te.get("mae", 0)
    logger.log(test_log)
    logger.finish()
    if world > 1:   # rank 0's checkpoint and log are on disk for all
        dist.barrier()
    if layout.shards or getattr(model, "sp_mesh", None) or getattr(model, "ep_mesh", None):
        # the whole model, on one process
        state = _whole({"params": model.state_dict(), "opt": opt.state()}, names,
                       layout.shards)["params"]
        model = build_model(model_name, config, bundle,
                            generator=torch.Generator().manual_seed(seed)).to(device)
        model.load_state_dict(state)

    return TrainResult(best_val=best_val, test_metrics=te, history=history,
                       params=params_to_flax(model.state_dict()),
                       batch_stats=batch_stats_to_flax(model.state_dict()),
                       bundle=bundle, model=model, step_losses=step_losses)
