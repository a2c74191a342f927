"""Array-based graph structures.

Port of ``glearning_benchmark_tpu/data/graphs.py`` (copied; numpy only):
``Graph``, ``GraphCorpus``, and the dense padded ``GraphBatch`` that
``batch_graphs`` builds for the graph-native models (``adj`` [B, N, N],
``node_feat`` [B, N, F], ``node_mask`` [B, N], the optional ``eadj`` of
edge types).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.num_nodes, dtype=np.int32)
        if self.num_edges:
            np.add.at(d, self.edges[:, 0], 1)
            np.add.at(d, self.edges[:, 1], 1)
        return d

    def adjacency(self, n_pad: Optional[int] = None) -> np.ndarray:
        n = n_pad or self.num_nodes
        a = np.zeros((n, n), dtype=np.float32)
        if self.num_edges:
            u, v = self.edges[:, 0], self.edges[:, 1]
            a[u, v] = 1.0
            a[v, u] = 1.0
        return a


class GraphCorpus(list):
    """A list of :class:`Graph` that may also carry the corpus's flat
    struct-of-arrays form (``flat``), as read from a ZINC ``.npz`` export.
    Immutable after load: replacing an element desyncs it from ``flat``."""

    flat: Optional[dict] = None


@dataclass
class GraphBatch:
    """Dense padded batch of graphs (all arrays are fixed-shape)."""

    adj: np.ndarray          # [B, N, N] float32 symmetric adjacency
    node_feat: np.ndarray    # [B, N, F] float32 node features
    node_mask: np.ndarray    # [B, N] bool
    y: np.ndarray            # [B] int32 or float32
    num_nodes: np.ndarray    # [B] int32
    query_u: Optional[np.ndarray] = None  # [B] int32
    query_v: Optional[np.ndarray] = None  # [B] int32
    eadj: Optional[np.ndarray] = None     # [B, N, N] uint8 edge types (0 = none)

    @property
    def batch_size(self) -> int:
        return int(self.adj.shape[0])


def pad_graphs(graphs: Sequence[Graph], n_max: Optional[int] = None) -> int:
    m = max((g.num_nodes for g in graphs), default=1)
    if n_max is not None:
        if m > n_max:
            raise ValueError(f"graph with {m} nodes exceeds pad size {n_max}")
        return n_max
    return m


def batch_graphs(
    graphs: Sequence[Graph],
    n_max: Optional[int] = None,
    node_feat_mode: str = "const",
    query_encoding: bool = False,
    label_dtype=np.int32,
    edge_types: bool = False,
) -> GraphBatch:
    """Batch graphs to dense padded arrays.

    node_feat_mode:
      - "const": x = ones [N,1] (reference nativegraph.py:396)
      - "labels": one-feature int node labels as float [N,1] (ZINC atoms)
    query_encoding: append two binary columns marking (source, target)
      (reference: add_query_encoding_to_features, nativegraph.py:16-31).
    edge_types: also emit ``eadj`` [B,N,N] uint8 holding each edge's label
      (ZINC bond types 1-4, 0 = no edge) for edge-featured message passing
      (GINE); graphs without ``edge_labels`` contribute type 1 edges.
    """
    b = len(graphs)
    n = pad_graphs(graphs, n_max)
    feat_dim = 1 + (2 if query_encoding else 0)
    adj = np.zeros((b, n, n), dtype=np.float32)
    eadj = np.zeros((b, n, n), dtype=np.uint8) if edge_types else None
    x = np.zeros((b, n, feat_dim), dtype=np.float32)
    mask = np.zeros((b, n), dtype=bool)
    y = np.zeros((b,), dtype=label_dtype)
    nn = np.zeros((b,), dtype=np.int32)
    has_query = any(g.query_u is not None for g in graphs)
    qu = np.zeros((b,), dtype=np.int32) if has_query else None
    qv = np.zeros((b,), dtype=np.int32) if has_query else None

    for i, g in enumerate(graphs):
        k = g.num_nodes
        if g.num_edges:
            u, v = g.edges[:, 0], g.edges[:, 1]
            adj[i, u, v] = 1.0
            adj[i, v, u] = 1.0
            if eadj is not None:
                et = (g.edge_labels.astype(np.uint8)
                      if g.edge_labels is not None
                      else np.ones(len(u), dtype=np.uint8))
                eadj[i, u, v] = et
                eadj[i, v, u] = et
        if node_feat_mode == "labels" and g.node_labels is not None:
            x[i, :k, 0] = g.node_labels.astype(np.float32)
        else:
            x[i, :k, 0] = 1.0
        mask[i, :k] = True
        y[i] = g.y
        nn[i] = k
        if has_query:
            qu[i] = -1 if g.query_u is None else g.query_u
            qv[i] = -1 if g.query_v is None else g.query_v
            if query_encoding and g.query_u is not None:
                x[i, g.query_u, 1] = 1.0
                x[i, g.query_v, 2] = 1.0

    return GraphBatch(adj=adj, node_feat=x, node_mask=mask, y=y, num_nodes=nn,
                      query_u=qu, query_v=qv, eadj=eadj)
