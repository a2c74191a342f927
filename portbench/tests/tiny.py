"""Tiny cells for the CPU tests: a throwaway benchmark root whose cells run
the real drivers on the CPU at a small size (the port's plain versions in
place of its kernels)."""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
CORPUS = {"train": 60, "val": 20, "test": 20}
MODEL = {"use_flash": False, "d_model": 32, "nhead": 2, "nlayers": 2, "d_ff": 64,
         "dropout": 0.1, "max_pos": 1024}
MIXES = {
    "dense": {"driver": "train", "rows": "dense", "row_len": 64, "rows_per_step": 4,
              "steps_per_epoch": 4, "vocab": 50},
    "packed": {"driver": "train", "rows": "zinc", "graphs_per_step": 12, "corpus": CORPUS},
}
LIMITS = {"dense": {"loss1_mean_gap": 1e-4, "pred1_gap": 6e-3, "loss_gap": 2e-3,
                    "grad_gap": 6e-3, "grad_median_gap": 6e-3, "update_gap": 0.2},
          "packed": {"rows_differ": 0, "loss1_mean_gap": 1e-4, "pred1_gap": 6e-3,
                     "loss_gap": 2e-3, "grad_gap": 6e-3, "grad_median_gap": 6e-3,
                     "update_gap": 0.2}}


def make_root(tmp: str, limits: Optional[Dict] = None) -> str:
    """A benchmark root under ``tmp`` holding BENCHMARK.json and a bench
    folder ``pb`` with the tiny cells' files (the metric readers copied)."""
    bench = os.path.join(tmp, "pb")
    for sub in ("traffic", "limits", "configs"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(bench, "metrics"),
                    dirs_exist_ok=True)
    with open(os.path.join(HERE, "configs", "tt_d1024.json")) as f:
        cfg = json.load(f)
    cfg["model"] = dict(MODEL)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "https://example.org", "reduced": [],
                        "file": "pb/configs/tiny.json", "why": "tiny"}]
    spec["workloads"] = [{"name": f"tiny.{k}", "config": "tiny", "traffic": k, "chips": 1,
                          "why": "tiny"} for k in MIXES]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            # the tiny training cells report every training metric under both names
            m["workloads"] = ["tiny.packed"] if m["name"] == "bundle_s" else ["tiny.dense",
                                                                               "tiny.packed"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for k, mix in MIXES.items():
        with open(os.path.join(bench, "traffic", f"{k}.json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(bench, "limits", f"tiny.{k}.json"), "w") as f:
            json.dump({**LIMITS[k], **((limits or {}).get(k, {}))}, f)
    return tmp


def run(root: str, mix: str, seed: int = 2**31 + 7, trace: bool = False,
        seconds: float = 0.5) -> Dict:
    """One run of a tiny cell on the CPU; its result line."""
    cell = harness.find_cell(root, f"tiny.{mix}", os.path.join(root, "pb"))
    out = harness.driver(cell).run(cell, seed=seed, seconds=seconds, trace=trace,
                                   device=torch.device("cpu"), t_start=0.0)
    return harness.result(cell, out, trace, {"platform": "cpu"})
