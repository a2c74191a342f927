"""Array-based graph structures.

Port of ``glearning_benchmark_tpu/data/graphs.py`` (``Graph`` and
``GraphCorpus``, copied; numpy only). The dense ``GraphBatch`` /
``batch_graphs`` of the graph-native models come with their port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Graph:
    """A single graph.

    edges: int32 [E, 2] — edges in emission order (ZINC stores both
        orientations of every bond, PyG-style)
    num_nodes: int
    y: label (int for classification, float for regression)
    node_labels: optional int32 [N] (e.g. ZINC atom types)
    edge_labels: optional int32 [E] (e.g. ZINC bond types, 1-based)
    query_u/query_v: optional ints (query-task node pair)
    """

    edges: np.ndarray
    num_nodes: int
    y: float | int
    node_labels: Optional[np.ndarray] = None
    edge_labels: Optional[np.ndarray] = None
    query_u: Optional[int] = None
    query_v: Optional[int] = None

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


class GraphCorpus(list):
    """A list of :class:`Graph` that may also carry the corpus's flat
    struct-of-arrays form (``flat``), as read from a ZINC ``.npz`` export.
    Immutable after load: replacing an element desyncs it from ``flat``."""

    flat: Optional[dict] = None
