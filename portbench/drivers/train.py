"""Training cells: the port's ``train_epoch`` over the cell's rows.

Set-up builds one training object (the model of the cell's configuration,
with the parameters made from the seed, and its ``ClippedAdamW``) and
drives it through the first three steps of the first epoch, one
``train_epoch`` call a step, reading after them what the output check
compares: each step's loss, each leaf's first gradient as the optimizer
got it (from its second moment after one step: |g| = sqrt(sum nu /
(1 - b2))), every parameter's change over the three steps (kept on the
host until the check) and the first step's predictions (read by a forward
hook on the model's head). The window then
goes on with the same object, one ``train_epoch`` call an epoch over the
rest of the rows, reading the epoch's losses back once, as the trainer
does; every epoch the rows are reshuffled from the seed. The window ends
after the first epoch that ends past ``seconds``.

Rows (``traffic["rows"]``):

- ``dense``: ``rows_per_step`` rows of ``row_len`` valid tokens, one
  sequence a row, ``steps_per_epoch`` steps an epoch; ids drawn on the
  device from the seed (``<bos>`` first, then uniform over ``vocab``), and
  a target a row;
- ``zinc``: the port's packed bundle of the ZINC corpus the benchmark
  writes, at ``graphs_per_step`` graphs a step (the trainer's
  ``train_batch_size``).

With ``--trace 1`` whole epochs are traced after the window until a
second has passed. The output check then runs the plain reference over the
same three steps from the same seed (``check.py``).
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import check, devtrace
from ..harness import Cell, Outcome
from ..metrics._counts import allowed_pairs
from . import common

FIRST_STEPS = 3


def epoch_batches(n_rows: int, rows_per_step: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """[steps, rows_per_step] row indices of one epoch in an order drawn from
    ``rng``, and their validity (the last step filled with row 0, invalid)."""
    order = rng.permutation(n_rows)
    steps = -(-n_rows // rows_per_step)
    idx = np.zeros(steps * rows_per_step, dtype=np.int64)
    idx[:n_rows] = order
    valid = np.zeros(steps * rows_per_step, dtype=bool)
    valid[:n_rows] = True
    return idx.reshape(steps, rows_per_step), valid.reshape(steps, rows_per_step)


def dense_inputs(traffic: Dict, seed: int, device: torch.device):
    """The port's bundle, the rows on the device and their host copies."""
    from glearning_benchmark_tpu_torch.train.datasets import DatasetBundle

    n = int(traffic["rows_per_step"]) * int(traffic["steps_per_epoch"])
    length, vocab = int(traffic["row_len"]), int(traffic["vocab"])
    gen = torch.Generator(device=device).manual_seed(seed + 1)   # the weights draw from seed
    ids = torch.randint(3, vocab, (n, length), generator=gen, device=device, dtype=torch.int32)
    ids[:, 0] = 0                                    # <bos>
    y = 2.0 * torch.randn(n, generator=gen, device=device)
    arrays = {"ids": ids, "mask": torch.ones(n, length, dtype=torch.bool, device=device), "y": y}
    empty = {"y": np.zeros(0, np.float32)}
    bundle = DatasetBundle(task="zinc", kind="tokens",
                           splits={"train": {"y": np.zeros(n, np.float32)}, "val": empty,
                                   "test": empty},
                           num_classes=1, vocab_size=vocab,
                           meta={"max_len": length, "pad_id": 2, "bos_id": 0})
    host = {k: v.cpu().numpy() for k, v in arrays.items()}
    return bundle, arrays, host


def row_counts(host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Valid tokens, allowed pairs (a head, a layer) and examples of every row."""
    seg = host["seg"] if "seg" in host else host["mask"].astype(np.int32)
    pairs = np.asarray([allowed_pairs(r[None]) for r in seg], dtype=np.int64)
    examples = (host["ex_valid"].sum(1) if "ex_valid" in host
                else np.ones(len(seg), dtype=np.int64))
    return {"tokens": (seg > 0).sum(1).astype(np.int64), "pairs": pairs,
            "examples": examples.astype(np.int64)}


def _totals(counts, idx: np.ndarray, valid: np.ndarray) -> Dict[str, int]:
    rows = idx[valid]
    return {k: int(v[rows].sum()) for k, v in counts.items()}


class Setup:
    """One training object and its feed: the cell's rows on the device, the
    model with the parameters made from the seed, its optimizer, the epoch
    order and the dropout generator."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.parts = common.Parts()
        from glearning_benchmark_tpu_torch.train.trainer import (build_model, build_optimizer,
                                                                train_batch_size)

        self.parts.mark("port_import")
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.spans: Dict[str, float] = {}
        if device.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=device)
            common.sync(device)
        self.parts.mark("device_init")
        if tr["rows"] == "dense":
            self.bundle, self.arrays, self.host = dense_inputs(tr, seed, device)
            self.rows_per_step = int(tr["rows_per_step"])
        else:
            root = common.zinc_root(cell, tr)
            self.bundle, self.spans["bundle_s"] = common.build_bundle(cell, root)
            self.host = self.bundle.splits["train"]
            self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                           for k, v in self.host.items()}
            self.rows_per_step = train_batch_size(self.bundle, int(tr["graphs_per_step"]))
        self.n_rows = int(next(iter(self.arrays.values())).shape[0])
        self.counts = row_counts(self.host)
        common.sync(device)
        self.parts.mark("inputs")
        with torch.device(device):
            self.model = build_model(cfg["model_name"], cfg, self.bundle)
        common.load_weights(self.model, seed, device)
        steps_per_epoch = -(-self.n_rows // self.rows_per_step)
        self.opt, _ = build_optimizer(self.model, cfg["train"], steps_per_epoch)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator().manual_seed(seed)
        self.new_epoch()
        common.sync(device)
        self.parts.mark("model")

    def new_epoch(self) -> None:
        self.idx, self.valid = epoch_batches(self.n_rows, self.rows_per_step, self.rng)
        self.idx_d = torch.from_numpy(self.idx).to(self.device)
        self.valid_d = torch.from_numpy(self.valid).to(self.device)
        self.at = 0

    def steps(self, n: Optional[int] = None) -> np.ndarray:
        """One ``train_epoch`` call over the next ``n`` steps of the epoch
        (all that are left with None); their losses, read back."""
        from glearning_benchmark_tpu_torch.train.trainer import train_epoch

        if self.at >= self.idx.shape[0]:
            self.new_epoch()
        stop = self.idx.shape[0] if n is None else self.at + n
        _, losses = train_epoch(self.model, self.opt, self.arrays, self.idx_d[self.at:stop],
                                self.valid_d[self.at:stop], self.bundle, self.gen)
        self.enqueued = (self.at, stop)
        return losses

    def first_steps(self) -> Tuple[Dict, Dict]:
        """The program's readings over the first steps, one call a step, and
        those steps' rows. The seconds spent taking the readings (the
        gradient norms after the first step, the change after the last)
        are the check's, kept in ``self.readings_s``, not set-up's."""
        first = {"idx": self.idx[:FIRST_STEPS], "valid": self.valid[:FIRST_STEPS]}
        losses: List[float] = []
        grad_norms: Dict[str, float] = {}
        preds: List[torch.Tensor] = []
        self.readings_s = 0.0
        for b in range(FIRST_STEPS):
            hook = (self.model.cls.register_forward_hook(
                lambda mod, args, out: preds.append(out.detach().float().squeeze(-1).cpu()))
                if b == 0 else None)
            losses.append(float(self.steps(1).cpu()[0]))
            if hook is not None:
                hook.remove()
            self.at += 1
            if b == 0:
                self.parts.mark("first_step")
                t0 = time.perf_counter()
                grad_norms = {k: math.sqrt(float(nu.double().sum()) / (1.0 - self.opt.b2))
                              for k, nu in zip(self.opt.names, self.opt.nu)}
                self.readings_s += time.perf_counter() - t0
        self.parts.mark("later_steps")
        t0 = time.perf_counter()
        start = common.weights.make(common.weights.shapes_of(self.model), self.seed, self.device)
        delta = {k: (p.detach() - start[k]).cpu() for k, p in self.model.named_parameters()}
        del start
        common.sync(self.device)
        self.readings_s += time.perf_counter() - t0
        self.parts.mark("readings")
        return {"losses": losses, "grad_norms": grad_norms, "delta": delta,
                "preds": preds[0].numpy()}, first

    def epochs(self, min_seconds: float) -> Dict:
        """Whole epochs (the first from where the last call ended) until
        ``min_seconds`` have passed: steps, valid tokens, pairs, examples,
        enqueue seconds, losses not finite, seconds."""
        tot = {"steps": 0, "tokens": 0, "pairs": 0, "examples": 0, "enqueue_s": 0.0, "bad": 0}
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            losses = self.steps()
            tot["enqueue_s"] += time.perf_counter() - t1
            lh = losses.cpu().numpy()                  # the epoch's one read
            tot["bad"] += int((~np.isfinite(lh)).sum())
            a, b = self.enqueued
            tot["steps"] += b - a
            for k, v in _totals(self.counts, self.idx[a:b], self.valid[a:b]).items():
                tot[k] += v
            self.at = b
            if time.perf_counter() - t0 >= min_seconds:
                tot["seconds"] = time.perf_counter() - t0
                return tot

    def free(self) -> None:
        del self.model, self.opt, self.arrays, self.idx_d, self.valid_d
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Outcome:
    parts = common.Parts(t_start)
    parts.mark("start")
    st = Setup(cell, seed, device)
    program, first = st.first_steps()
    common.sync(device)
    # set-up: from the process's start to the window, less the check's readings
    setup_s = time.perf_counter() - t_start - st.readings_s
    parts.extend(st.parts)

    window = st.epochs(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced, tr_counts = None, None
    if trace:
        box = {}

        def traced_epochs():
            box["t"] = st.epochs(1.0)
            return box["t"]["steps"]

        traced = devtrace.capture(traced_epochs, lambda: common.sync(device),
                                  device.type == "cuda")
        tr_counts = box["t"]
        if device.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated(device))
    host = st.host
    st.free()
    checks, ref_s = check.train(cell, seed, device, program, first, host)

    e2e = {"setup_s": setup_s, "train_tokens_per_s": window["tokens"] / window["seconds"]}
    ctx = SimpleNamespace(kind="train", arch=common.arch(cell.config),
                          peaks=common.card_peaks(device), window=window, trace=traced,
                          traced=tr_counts, spans=st.spans)
    return Outcome(e2e=e2e, ctx=ctx, checks=checks, attempted=window["steps"],
                   failed=window["bad"], memory_peak_bytes=peak, trace=traced,
                   extra={"timing": {"setup_s": setup_s, "window_s": window["seconds"],
                                     "steps": window["steps"], "reference_s": ref_s,
                                     "setup_parts": parts.table()}})
