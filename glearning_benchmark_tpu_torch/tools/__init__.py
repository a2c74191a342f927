"""The port's measurement tools, each runnable as ``python -m``:

- ``glearning_benchmark_tpu_torch.bench``: the north-star metric, ZINC
  graphs tokenized per second (the root ``bench.py``);
- ``tools.serve_bench``: serving latency per request bucket;
- ``tools.mfu_bench``: the training step's model-FLOPs utilization;
- ``tools.flash_ab``: the attention kernels against plain attention and
  ``scaled_dot_product_attention``;
- ``tools.export_zinc`` and ``tools.graph_stats_report``: the ZINC export
  and the corpus statistics report;
- ``tools.dropout_microbench``: how to draw and apply the FFN dropout mask;
- ``tools.scaling_bench``: the north star at N processes;
- ``tools.run_benchmarks``: the results campaign beside the JAX package's.

Each prints one JSON object per result line, the summary last, every line
with the card's name and power limit (``"card"``), and writes its results
under ``runs_torch/`` unless told otherwise.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

RESULTS_DIR = "runs_torch"


def emit(row: Dict[str, Any], card: Dict[str, str]) -> Dict[str, Any]:
    """Print ``row`` with the card beside it as one JSON line; return it."""
    line = {**row, "card": card}
    print(json.dumps(line), flush=True)
    return line


def save(path: str, obj: Any) -> None:
    """Write ``obj`` as JSON to ``path``, making its directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
