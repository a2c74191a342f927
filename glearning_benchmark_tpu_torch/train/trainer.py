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
``batch_stats``.

Not ported: the ``parallel.*`` layouts (ROADMAP queue A, item 9; any such
key above 1 raises), the Switch MoE FFN (item 8), profiler traces
(``train.profile_epochs``), W&B histograms and the images of
``train/viz.py`` (the confusion matrix; the example-graph log is text).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import (batch_stats_to_flax, load_flax_params, opt_state_from_torch,
                       opt_state_to_torch, params_to_flax)
from ..models.gps import GPSModel
from ..models.mpnn import MPNN
from ..models.transformer import SimpleTransformer
from ..tokenization.vocab import SPECIAL
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint, serving_meta
from .datasets import QUERY_OFFSETS, QUERY_TASKS, DatasetBundle, build_dataset
from .metrics import (classification_metrics_from_cm, format_confusion_matrix,
                      regression_metrics_from_sums)
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
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the model a checkpoint of ``model_name`` was trained as, with
    the JAX package's config defaults. ``generator`` seeds the initial
    parameters. For the token models, ``model.remat`` recomputes encoder
    layers in the backward pass (default: rows of 1024 tokens and longer).
    Attention always runs through the flash-attention kernels (their plain
    versions on the CPU); ``model.use_flash`` only sets the rate they drop
    attention probabilities at (:func:`attention_dropout_rate`). GPS reads
    its widths from the config's ``gt:`` block."""
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
    if int(model_cfg.get("moe_experts", 0)) > 0:
        raise NotImplementedError("the Switch MoE FFN is not ported yet "
                                  "(ROADMAP queue A, item 8: models/moe.py)")
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
        generator=generator,
    )


# ---------------------------------------------------------------------------
# one batch: forward, loss, statistics
# ---------------------------------------------------------------------------

def _apply_model(model, batch: Dict[str, torch.Tensor], bundle: DatasetBundle,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits of one gathered batch: [B] / [B, C] for unpacked rows and
    graphs, [B, K] / [B, K, C] for packed rows."""
    if bundle.kind == "graphs":
        adj = batch["adj"].to(torch.float32)   # stored uint8
        return model(batch["node_feat"], adj, batch["mask"], etype=batch.get("eadj"),
                     generator=generator)
    if "seg" in batch:
        return model(batch["ids"], batch["seg"] > 0,
                     q_token_id=bundle.q_token_id, seg=batch["seg"],
                     pos=batch["pos"], pos_bos=batch["pos_bos"],
                     pos_u=batch["pos_u"], pos_v=batch["pos_v"],
                     generator=generator)
    return model(batch["ids"], batch["mask"], q_token_id=bundle.q_token_id,
                 generator=generator)


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


def build_optimizer(model: nn.Module, train_cfg: dict, steps_per_epoch: int):
    """(``ClippedAdamW`` over the model's parameters, schedule or None) as
    ``train_cfg`` asks: ``scheduler: cosine_with_warmup`` warms up over
    ``num_warmup_epochs`` (default 5) epochs, then decays over the rest of
    ``epochs``; the AdamW first moment is stored in bf16 by default, f32 on
    request (``mu_dtype``)."""
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
                       mu_dtype=train_cfg.get("mu_dtype", "bfloat16"))
    return opt, schedule


def _gather(arrays: Dict[str, torch.Tensor], idx: torch.Tensor):
    return {k: v[idx] for k, v in arrays.items()}


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


def train_epoch(model, opt: ClippedAdamW, arrays, idx, valid,
                bundle: DatasetBundle, generator: Optional[torch.Generator],
                max_steps: Optional[int] = None):
    """One pass over the minibatches ``idx``/``valid`` ([nb, bs] device
    tensors). Returns (summed statistics, per-step losses [steps]), both on
    the device: nothing is read back here."""
    model.train()
    params = opt.params
    total, losses = None, []
    steps = idx.shape[0] if max_steps is None else min(max_steps, idx.shape[0])
    for b in range(steps):
        batch = _gather(arrays, idx[b])
        logits = _apply_model(model, batch, bundle, generator)
        lg, y, lvalid = _loss_inputs(logits, batch, valid[b])
        loss, stats = _loss_and_stats(lg, y, lvalid, bundle.task,
                                      bundle.num_classes)
        grads = torch.autograd.grad(loss, params)
        # the gradient norm BEFORE clipping, as a per-epoch mean
        has = (stats["count"] > 0).to(torch.float32)
        stats["gn_sum"] = opt.step(grads) * has
        stats["gn_cnt"] = has
        total = _add_stats(total, stats)
        losses.append(loss.detach())
    return total, torch.stack(losses)


@torch.no_grad()
def eval_epoch(model, arrays, idx, valid, bundle: DatasetBundle):
    """Summed statistics of a deterministic pass, on the device."""
    model.eval()
    total = None
    for b in range(idx.shape[0]):
        batch = _gather(arrays, idx[b])
        logits = _apply_model(model, batch, bundle)
        lg, y, lvalid = _loss_inputs(logits, batch, valid[b])
        _, stats = _loss_and_stats(lg, y, lvalid, bundle.task,
                                   bundle.num_classes)
        total = _add_stats(total, stats)
    return total


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _device_memory_mb(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / (1024 ** 2)


class RunLogger:
    """stdout + JSONL metrics log with the reference W&B key schema; uses
    wandb when ``wandb.use`` is set and the package imports."""

    def __init__(self, out_dir: str, run_name: str, wandb_cfg: dict, config: dict,
                 wandb_name: Optional[str] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "w")  # fresh log per run
        self.wandb = None
        if wandb_cfg.get("use"):
            try:
                import wandb  # noqa: PLC0415
            except ImportError:
                print("[warn] wandb.use is set but wandb does not import; "
                      "logging to the JSONL file only")
            else:
                self.wandb = wandb
                wandb.init(project=wandb_cfg.get("project", "graph-token"),
                           name=wandb_name or run_name, config=config)

    def log(self, d: Dict[str, Any]):
        clean = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in d.items()}
        self._f.write(json.dumps(clean) + "\n")
        self._f.flush()
        if self.wandb:
            self.wandb.log(d)

    def finish(self):
        self._f.close()
        if self.wandb:
            self.wandb.finish()


def _check_parallel(config: dict) -> None:
    parallel = config.get("parallel", {}) or {}
    for key in ("model_axis", "seq_shards", "pipe_stages", "expert_shards"):
        if int(parallel.get(key, 1)) > 1:
            raise NotImplementedError(
                f"parallel.{key} > 1 is not ported yet (ROADMAP queue A, "
                "item 9: parallel/); the port trains on one GPU")
    if parallel.get("ep_manual"):
        raise NotImplementedError("parallel.ep_manual is not ported yet "
                                  "(ROADMAP queue A, item 9)")


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


def train(config: dict, model_name: str, limit: Optional[int] = None,
          verbose: bool = True,
          device: Optional[str | torch.device] = None) -> TrainResult:
    """Train ``model_name`` as ``config`` says. ``device=None`` means cuda
    and raises when there is no GPU; pass ``"cpu"`` to train on the CPU."""
    device = resolve_device(device)
    dataset_cfg = config["dataset"]
    train_cfg = config.get("train", {})
    output_cfg = config.get("output", {})
    wandb_cfg = config.get("wandb", {"use": False})
    _check_parallel(config)

    seed = int(train_cfg.get("seed", 0))
    epochs = int(train_cfg.get("epochs", 100))
    batch_size = int(train_cfg.get("batch_size", 128))
    lr = float(train_cfg.get("lr", 1e-3))
    task = dataset_cfg["task"]

    bundle = build_dataset(model_name, dataset_cfg, seed, limit=limit)
    n_train = bundle.n("train")
    if n_train == 0:
        raise RuntimeError("No training examples found. Did you run the task generator?")
    # packed train split: n_train counts ROWS (each holding ~K sequences);
    # scale the row batch so examples-per-step stays ~batch_size, and report
    # throughput in examples
    packed_train = "seg" in bundle.splits["train"]
    n_train_examples = int(bundle.meta.get("n_examples_train", n_train))
    train_bs = train_batch_size(bundle, batch_size)
    if verbose:
        print(f"#train: {n_train} | #val: {bundle.n('val')} | #test: {bundle.n('test')}")
        if packed_train:
            print(f"packed train split: {n_train_examples} examples in "
                  f"{n_train} rows (x{n_train_examples / max(n_train, 1):.2f} "
                  f"density), row batch {train_bs}")
        if task != "zinc" and bundle.kind == "graphs":
            print(_example_graphs(dataset_cfg, task, seed))

    generator = torch.Generator().manual_seed(seed)  # init, then dropout seeds
    model = build_model(model_name, config, bundle, generator=generator).to(device)
    steps_per_epoch = max(1, (n_train + train_bs - 1) // train_bs)
    opt, schedule = build_optimizer(model, train_cfg, steps_per_epoch)
    names, params = opt.names, opt.params
    num_params = sum(p.numel() for p in params)
    if verbose:
        print(f"Model parameters: {num_params:,}")

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # device-resident split arrays (single transfer)
    dev_splits = {s: {k: on_device(v) for k, v in arrays.items()}
                  for s, arrays in bundle.splits.items()}

    out_dir = output_cfg.get("out_dir", f"runs_{model_name}")
    run_name = output_cfg.get("run_name", f"{model_name}-{task}")
    if task == "zinc":
        wandb_name = run_name
    else:
        wandb_name = f"{run_name} ({'+'.join(dataset_cfg.get('train_algorithms', []))})"
    logger = RunLogger(out_dir, run_name, wandb_cfg, config, wandb_name=wandb_name)
    logger.log({"model/num_parameters": num_params})

    zinc = task == "zinc"
    better = (lambda a, b: a < b) if zinc else (lambda a, b: a > b)
    best_val = float("inf") if zinc else -1.0
    start_epoch = 1
    best_path = os.path.join(out_dir, f"best_{run_name}")
    if train_cfg.get("resume"):
        # train.resume_path overrides the default out_dir/best_<run> location
        ckpt_path = train_cfg.get("resume_path") or best_path
        ckpt = load_checkpoint(ckpt_path)
        if ckpt is None and verbose:
            print(f"[warn] no checkpoint at {ckpt_path}; starting fresh")
        if ckpt is not None and ckpt.get("params") is not None:
            load_flax_params(model, ckpt["params"], ckpt.get("batch_stats"))
            if ckpt.get("opt_state"):
                # AdamW moments and step counts, cast to this optimizer's
                # dtypes: mu precision is a storage choice, not state
                state = opt_state_to_torch(ckpt["opt_state"], names,
                                           with_schedule=schedule is not None)
                if state is not None:
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

    epoch = start_epoch
    while epoch <= epochs:
        blk_best, blk_metric, blk_ep = None, None, -1
        va_metrics: List[float] = []
        for j in range(k_disp):
            ep = epoch + j
            ep_start = time.time()
            idx = on_device(make_batches(n_train, train_bs, shuffle_rng)[0])
            tr_stats, losses = train_epoch(model, opt, dev_splits["train"], idx,
                                           train_valid, bundle, generator)
            va_stats = eval_epoch(model, dev_splits["val"], vidx, vvalid, bundle)
            # the epoch's one read from the device
            tr_host, va_host, loss_host = _to_host(tr_stats, va_stats,
                                                   {"losses": losses})
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
            save_checkpoint(best_path, {
                "params": params_to_flax(best["params"]),
                "batch_stats": batch_stats_to_flax(best["params"]),
                "opt_state": opt_state_from_torch(
                    best["opt"], names, with_schedule=schedule is not None),
                "epoch": epoch + blk_ep, "best_val": best_val,
                "config": config, "vocab": bundle.vocab,
                "serve": serving_meta(model_name, bundle)})
        epoch += k_disp

    total_time = time.time() - t0

    # reload the best epoch, then run the test split
    if best is not None:
        model.load_state_dict(best["params"])

    # eval-only (epochs=0 + resume): no epoch ran, so score the val split here
    if epochs < start_epoch and best is not None and bundle.n("val"):
        va = _epoch_metrics(_to_host(eval_epoch(
            model, dev_splits["val"], vidx, vvalid, bundle))[0], task)
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
            model, dev_splits["test"], tidx, tvalid, bundle))[0], task)

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

    return TrainResult(best_val=best_val, test_metrics=te, history=history,
                       params=params_to_flax(model.state_dict()),
                       batch_stats=batch_stats_to_flax(model.state_dict()),
                       bundle=bundle, model=model, step_losses=step_losses)
