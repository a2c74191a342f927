"""Dataset bundle type and the query-task tables.

Port of ``glearning_benchmark_tpu/train/datasets.py``: ``DatasetBundle``,
``SPLITS``, ``QUERY_TASKS`` and ``QUERY_OFFSETS`` (copied). Building
bundles from corpora comes with the training slice; serving rebuilds a
bundle from a checkpoint's ``serve`` block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

SPLITS = ("train", "val", "test")

# every task whose label is query-conditioned: token-model query-node
# readout, the AGTT '<q> u v' trail append, graph-model query features
QUERY_TASKS = ("shortest_path", "reachability", "edge_existence",
               "node_degree", "maximum_flow", "node_classification")

# token offsets of (u, v) after the '<q>' marker in the IBTT text grammar:
# '<q> shortest_distance u v' -> (2, 3); '<q> u' -> (1, 1);
# '<q> class u' -> (2, 2); pair default '<q> u v' -> (1, 2)
QUERY_OFFSETS = {"shortest_path": (2, 3), "node_degree": (1, 1),
                 "node_classification": (2, 2)}  # default (1, 2)


@dataclass
class DatasetBundle:
    task: str
    kind: str                      # 'tokens' | 'graphs'
    splits: Dict[str, Dict[str, np.ndarray]]
    num_classes: int
    vocab: Optional[dict] = None
    vocab_size: int = 0
    q_token_id: Optional[int] = None
    in_dim: int = 1
    meta: dict = field(default_factory=dict)

    def n(self, split: str) -> int:
        return len(self.splits[split]["y"])
