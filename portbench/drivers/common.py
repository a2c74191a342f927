"""Pieces every driver uses: the ZINC data, the cell's architecture, device
syncs, the parameters made from the seed."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import weights
from ..metrics._peaks import peaks
from ..reference import zinc


class Parts:
    """Named stretches of set-up: for each, its seconds on the host's clock
    and the process's CPU seconds, each from the mark before."""

    def __init__(self, t0: Optional[float] = None):
        self.marks: List[Tuple[str, float, float]] = []
        self.last = (time.perf_counter() if t0 is None else t0, 0.0 if t0 is not None
                     else time.process_time())

    def mark(self, name: str) -> None:
        now = (time.perf_counter(), time.process_time())
        self.marks.append((name, now[0] - self.last[0], now[1] - self.last[1]))
        self.last = now

    def extend(self, other: "Parts") -> None:
        self.marks.extend(other.marks)

    def table(self) -> Dict[str, List[float]]:
        return {name: [wall, cpu] for name, wall, cpu in self.marks}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def arch(config: Dict) -> Dict[str, int]:
    m = config["model"]
    return {"d_model": int(m["d_model"]), "heads": int(m["nhead"]),
            "layers": int(m["nlayers"]), "d_ff": int(m["d_ff"])}


def card_peaks(device: torch.device):
    return peaks(torch.cuda.get_device_name(device)) if device.type == "cuda" else None


def zinc_root(cell, traffic: Dict) -> str:
    """The fixed directory of the cell's ZINC corpus, made on first use."""
    sizes = traffic.get("corpus", zinc.SPLIT_SIZES)
    root = os.path.join(cell.cache, "ZINC-" + "-".join(str(sizes[s]) for s in zinc.SPLIT_SIZES))
    zinc.ensure_corpus(root, sizes)
    return root


def dataset_config(cell, root: str) -> Dict:
    return {**cell.config["dataset"], "zinc_root": root}


def build_bundle(cell, root: str) -> Tuple[object, float]:
    """The port's bundle of the cell's configuration, and the seconds its
    build (or its cache's load) took."""
    from glearning_benchmark_tpu_torch.train.datasets import build_dataset

    t0 = time.perf_counter()
    bundle = build_dataset(cell.config["model_name"], dataset_config(cell, root),
                           int(cell.config["train"].get("seed", 0)))
    return bundle, time.perf_counter() - t0


def load_weights(model: torch.nn.Module, seed: int, device: torch.device) -> None:
    """Overwrite the model's parameters with the ones made from ``seed``."""
    made = weights.make(weights.shapes_of(model), seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(made[name])
