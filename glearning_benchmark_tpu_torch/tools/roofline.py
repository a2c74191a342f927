"""Roofline placement of the results campaign's training epochs on the card
they were measured on (the root ``tools/roofline.py`` on the port's
campaign results).

    python -m glearning_benchmark_tpu_torch.tools.roofline \
        [--results runs_torch/results_full.json] [--step-overhead-ms MS] \
        [--out runs_torch/roofline.json]

For each run of ``tools.run_benchmarks`` in ``--results`` (from any of its
run lists) it computes two lower bounds on one epoch and places the
measured ``steady_epoch_s`` against them:

- FLOP bound: the model's forward and backward FLOPs over the card's bf16
  tensor-core peak;
- HBM bound: the least activation and parameter traffic over the card's
  HBM bandwidth.

The peaks are the data sheet's for the card each run names
(``utils.card.datasheet``); a run measured on a card the table does not
hold, or on the host, raises. The cost model (``transformer_cost``,
``gnn_cost``) is the root tool's, copied. Its bundles are the port's
(``train.datasets.build_dataset``) under the run's config and overrides
(the run list's and the campaign's ``--override``s the result records),
with the token rows' density from ``seg`` (packed) or ``mask``. Steps an
epoch are the port trainer's (``train_batch_size``: a packed split counts
rows). The bound is ``max(flop, hbm) + steps * --step-overhead-ms`` (the
per-step launch cost one chooses to charge; 0 by default), and
``binding`` names the larger term: ``flops``, ``hbm`` or ``per-step
overhead``.

Like the root tool's, the bounds model the train split's forward and
backward only, while the measured epoch also runs the validation pass: the
``x_of_bound`` figures are upper bounds on the true gap. No training runs
and no device is used. Prints one JSON line a run with the card's name and
power limit, and writes ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from ..train.datasets import build_dataset
from ..train.trainer import train_batch_size
from ..utils.card import datasheet
from ..utils.config import load_config, normalize_config
from . import RESULTS_DIR, emit, save
from .run_benchmarks import REPO, SETS, apply_overrides


def transformer_cost(n_rows, L, d, dff, layers, heads, packed_density=1.0):
    """Per-epoch fwd+bwd FLOPs and minimum HBM bytes for the encoder.

    FLOPs: per token, per layer: qkv 2*3d^2 + out 2d^2 + ff 2*2*d*dff,
    attention 2*2*L*d (QK^T + PV, flash or not); backward ~2x forward.
    Bytes: activations read+write per layer (~6 tensors of [T, d] bf16) +
    attention K/V streaming (flash: Q,K,V once) — a deliberate lower bound
    (perfect fusion, no re-reads).
    """
    T = n_rows * L * packed_density
    lin = (2 * 3 * d * d) + (2 * d * d) + (2 * 2 * d * dff)
    attn = 2 * 2 * L * d
    fwd = T * layers * (lin + attn)
    flops = 3 * fwd  # fwd + ~2x bwd
    act_bytes = T * layers * 6 * d * 2 * 2   # 6 tensors, bf16, fwd+bwd
    return flops, act_bytes


def gnn_cost(n_graphs, n_max, hidden, layers):
    """Dense-adjacency GIN: per layer A@H (2*N^2*d) + MLP (2*2*d^2*N)."""
    fwd = n_graphs * layers * (2 * n_max * n_max * hidden +
                               2 * 2 * hidden * hidden * n_max)
    flops = 3 * fwd
    bytes_ = n_graphs * layers * (n_max * n_max +          # adj uint8
                                  6 * n_max * hidden * 2) * 2
    return flops, bytes_


def place(name: str, model: str, config_path: str, overrides: dict, result: dict,
          step_overhead_ms: float) -> dict:
    """One run's row: its epoch's FLOPs and bytes, both bounds on the card
    ``result`` names, and the measured epoch against their sum."""
    peaks = datasheet(result["card"]["name"])
    path = config_path if os.path.isfile(config_path) else os.path.join(REPO, config_path)
    cfg = apply_overrides(normalize_config(load_config(path)),
                          {**overrides, **result.get("overrides", {})})
    bundle = build_dataset(model, cfg["dataset"], cfg["train"].get("seed", 0))
    tr = bundle.splits["train"]
    mcfg = cfg.get("model", {})
    if model in ("ibtt", "agtt"):
        n_items, L = tr["ids"].shape
        density = float((tr["seg"] > 0).mean() if "seg" in tr else tr["mask"].mean())
        flops, hbm = transformer_cost(
            n_items, L, int(mcfg.get("d_model", 32)), int(mcfg.get("d_ff", 128)),
            int(mcfg.get("nlayers", 4)), int(mcfg.get("nhead", 4)), packed_density=density)
    else:
        n_items, n_max = len(tr["y"]), tr["adj"].shape[-1]
        flops, hbm = gnn_cost(n_items, n_max, int(mcfg.get("hidden_dim", 64)),
                              int(mcfg.get("num_layers", 5)))
    flop_bound = flops / peaks["bf16_flops"]
    hbm_bound = hbm / peaks["hbm_bytes_s"]
    steps = -(-n_items // train_batch_size(bundle, int(cfg["train"].get("batch_size", 128))))
    overhead = steps * step_overhead_ms / 1e3
    bound = max(flop_bound, hbm_bound) + overhead
    measured = result["steady_epoch_s"]
    return {
        "run": name,
        "rows_or_graphs": int(n_items),
        "steps_per_epoch": int(steps),
        "ms_per_step": measured / steps * 1e3,
        "epoch_flops": float(flops),
        "flop_bound_s": flop_bound,
        "hbm_bound_s": hbm_bound,
        "step_overhead_s": overhead,
        "bound_s": bound,
        "measured_s": measured,
        "x_of_bound": measured / bound,
        "binding": (("flops" if flop_bound > hbm_bound else "hbm")
                    if max(flop_bound, hbm_bound) > overhead else "per-step overhead"),
        "peaks": peaks,
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=os.path.join(RESULTS_DIR, "results_full.json"))
    ap.add_argument("--step-overhead-ms", type=float, default=0.0,
                    help="a per-step cost added to the bound (launches, host work)")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "roofline.json"))
    args = ap.parse_args(argv)

    with open(args.results) as f:
        results = json.load(f)
    runs = {run[0]: run for runs in SETS.values() for run in runs}
    report = {}
    for name, result in results.items():
        if "error" in result:
            continue
        row = place(*runs[name], result, args.step_overhead_ms)
        report[name] = emit(row, result["card"])
    save(args.out, report)
    return report


if __name__ == "__main__":
    main()
