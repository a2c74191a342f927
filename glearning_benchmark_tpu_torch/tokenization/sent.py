"""SENT trail tokenization (AGTT): graphs -> trail token-id sequences.

Port of ``glearning_benchmark_tpu/tokenization/sent.py`` (the pure-Python
``TrailTokenizer``, copied; numpy only). The training bundles take the
native batched path (``..native.sent_tokenize_batch_native``) when it is
available; serving tokenises here, as the JAX package's serving does.

Re-implements, from the observed interface contract, the external AutoGraph
``Graph2TrailTokenizer`` the reference drives but does not vendor
(reference: trainer/train_agtt.py:514-542, remap switch :195-244; AutoGraph
itself is git-ignored, reference .gitignore:13-16). The binding contract we
honor exactly:

- special-token layout: 0=SOS, 1=RESET, 2=LADJ, 3=RADJ, 4=EOS, 5=PAD
  (authoritative per the executed remap code, train_agtt.py:195-206);
- ``set_num_nodes(m)`` fixes node-position ids at
  [idx_offset, idx_offset+m); ``set_num_node_and_edge_types(a, e)`` (called
  AFTER set_num_nodes) fixes node-label ids at [node_idx_offset,
  node_idx_offset+a) and edge-label ids at [edge_idx_offset,
  edge_idx_offset+e) (train_agtt.py:534-542, 189-191);
- calling the tokenizer on a graph returns a 1-D int array; for labeled
  graphs it consumes node labels (atom ints) and 1-based edge labels (bonds).

The walk itself (AutoGraph's exact traversal order is not observable from the
reference snapshot) is defined here as a *deterministic* SENT variant:

- decompose each connected component into edge-disjoint trails by
  Hierholzer-style greedy walks: start at the lowest-index odd-degree vertex
  (or the lowest-index vertex with remaining edges), always step to the
  lowest-index unused neighbor;
- emit SOS, then the first trail's node positions; each subsequent trail is
  prefixed with RESET; a trail whose start vertex already appeared earlier in
  the token stream is additionally marked LADJ (left-adjacency repair) and
  one whose end vertex reappears as a *later* trail's start vertex is marked
  RADJ (right-adjacency repair) — see the emission at the RADJ comment below;
- labeled graphs interleave labels: pos(v0) lab(v0) elab(e01) pos(v1)
  lab(v1) ...;
- isolated nodes are emitted after a RESET as bare positions; EOS terminates;
  truncation to ``truncation_length`` keeps EOS.

Determinism is per-graph and seed-free, so tokenize-once caching is safe
(the reference re-tokenizes every epoch, train_agtt.py:246-273 — semantically
idempotent, and our pinned walk keeps it exactly so).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.graphs import Graph
from .vocab import get_atom_type_id, get_bond_type_id

SOS, RESET, LADJ, RADJ, EOS, PAD = 0, 1, 2, 3, 4, 5
_NUM_SPECIALS = 6


class TrailTokenizer:
    """Deterministic SENT trail tokenizer with the AutoGraph id layout."""

    pad = PAD  # class attribute, used as the padding id in collate
               # (reference: train_agtt.py:286-287 uses Graph2TrailTokenizer.pad)

    def __init__(
        self,
        dataset_names: Optional[list] = None,
        max_length: int = 600,
        truncation_length: Optional[int] = None,
        labeled_graph: bool = False,
        undirected: bool = True,
    ):
        self.max_length = max_length
        self.truncation_length = truncation_length or max_length
        self.labeled_graph = labeled_graph
        self.undirected = undirected
        self.idx_offset = _NUM_SPECIALS
        self.max_num_nodes: Optional[int] = None
        self.node_idx_offset: Optional[int] = None
        self.edge_idx_offset: Optional[int] = None
        self.num_node_types: Optional[int] = None
        self.num_edge_types: Optional[int] = None

    # -- configuration (reference call order: set_num_nodes first) ---------
    def set_num_nodes(self, max_num_nodes: int) -> None:
        self.max_num_nodes = int(max_num_nodes)
        self.node_idx_offset = self.idx_offset + self.max_num_nodes
        self.edge_idx_offset = self.node_idx_offset  # until types are set

    def set_num_node_and_edge_types(self, num_node_types: int, num_edge_types: int) -> None:
        if self.max_num_nodes is None:
            raise RuntimeError("call set_num_nodes before set_num_node_and_edge_types")
        self.num_node_types = int(num_node_types)
        self.num_edge_types = int(num_edge_types)
        self.node_idx_offset = self.idx_offset + self.max_num_nodes
        self.edge_idx_offset = self.node_idx_offset + self.num_node_types

    @property
    def vocab_size(self) -> int:
        if self.max_num_nodes is None:
            return self.idx_offset
        base = self.idx_offset + self.max_num_nodes
        if self.labeled_graph and self.num_node_types is not None:
            base += self.num_node_types + self.num_edge_types
        return base

    # -- trail decomposition ----------------------------------------------
    @staticmethod
    def _unique_undirected(g: Graph):
        """Undirected unique edges + their labels, first-occurrence order."""
        e = np.asarray(g.edges, dtype=np.int64).reshape(-1, 2)
        if e.shape[0] == 0:
            return e.astype(np.int32), np.zeros((0,), dtype=np.int32)
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        key = lo * 1_000_003 + hi
        _, first = np.unique(key, return_index=True)
        first.sort()
        labels = (g.edge_labels[first].astype(np.int32)
                  if g.edge_labels is not None else np.ones(len(first), dtype=np.int32))
        return e[first].astype(np.int32), labels

    def decompose_trails(self, g: Graph) -> List[List[int]]:
        """Edge-disjoint trail cover. Each trail is a list of alternating
        (node, edge_idx, node, edge_idx, ..., node) entries encoded as
        (node_list, edge_idx_list) pairs flattened: we return node lists and
        stash edge indices on ``self._last_edge_trails``."""
        edges, _ = self._unique_undirected(g)
        n = g.num_nodes
        adj: List[List[tuple]] = [[] for _ in range(n)]
        for ei in range(edges.shape[0]):
            u, v = int(edges[ei, 0]), int(edges[ei, 1])
            adj[u].append((v, ei))
            adj[v].append((u, ei))
        for lst in adj:
            lst.sort()  # lowest-index-neighbor-first determinism
        used = np.zeros(edges.shape[0], dtype=bool)
        ptr = [0] * n
        deg = np.array([len(a) for a in adj])
        remaining = deg.copy()

        node_trails: List[List[int]] = []
        edge_trails: List[List[int]] = []

        def next_unused(u: int) -> Optional[tuple]:
            while ptr[u] < len(adj[u]):
                v, ei = adj[u][ptr[u]]
                if not used[ei]:
                    return v, ei
                ptr[u] += 1
            return None

        while remaining.sum() > 0:
            odd = np.flatnonzero((remaining % 2 == 1) & (remaining > 0))
            start = int(odd[0]) if odd.size else int(np.flatnonzero(remaining > 0)[0])
            trail_nodes = [start]
            trail_edges: List[int] = []
            cur = start
            while True:
                nxt = next_unused(cur)
                if nxt is None:
                    break
                v, ei = nxt
                used[ei] = True
                remaining[cur] -= 1
                remaining[v] -= 1
                trail_nodes.append(v)
                trail_edges.append(ei)
                cur = v
            node_trails.append(trail_nodes)
            edge_trails.append(trail_edges)

        # isolated nodes (no edges at all) form singleton trails
        isolated = np.flatnonzero(deg == 0)
        for u in isolated:
            node_trails.append([int(u)])
            edge_trails.append([])

        self._last_edge_trails = edge_trails
        return node_trails

    # -- emission ----------------------------------------------------------
    def __call__(self, g: Graph) -> np.ndarray:
        if self.max_num_nodes is None:
            raise RuntimeError("call set_num_nodes before tokenizing")
        edges, edge_labels = self._unique_undirected(g)
        node_trails = self.decompose_trails(g)
        edge_trails = self._last_edge_trails

        idx0 = self.idx_offset
        labeled = self.labeled_graph and self.num_node_types is not None
        node_lab = g.node_labels if g.node_labels is not None else None

        out: List[int] = [SOS]
        seen_nodes: set = set()
        for t, (nodes, eidx) in enumerate(zip(node_trails, edge_trails)):
            if t > 0:
                out.append(RESET)
                if nodes[0] in seen_nodes:
                    out.append(LADJ)
            # emit first node
            out.append(idx0 + nodes[0])
            if labeled and node_lab is not None:
                out.append(self.node_idx_offset + int(node_lab[nodes[0]]))
            seen_nodes.add(nodes[0])
            for k, v in enumerate(nodes[1:]):
                if labeled:
                    # edge label precedes the next node position
                    out.append(self.edge_idx_offset + int(edge_labels[eidx[k]]) - 1)
                out.append(idx0 + v)
                if labeled and node_lab is not None:
                    out.append(self.node_idx_offset + int(node_lab[v]))
                seen_nodes.add(v)
            # RADJ: trail's end vertex reappears as a later trail's start
            # (right-adjacency repair)
            if (t + 1 < len(node_trails)
                    and nodes[-1] in {nt[0] for nt in node_trails[t + 1:]}):
                out.append(RADJ)
        out.append(EOS)

        if len(out) > self.truncation_length:
            out = out[: self.truncation_length - 1] + [EOS]
        return np.asarray(out, dtype=np.int32)

    # -- ZINC fixed-vocab remap (reference: train_agtt.py:171-244) ---------
    def remap_zinc_tokens(self, tokens: np.ndarray, fixed_vocab: Dict[str, int]) -> np.ndarray:
        """Map raw AutoGraph-layout ids onto the fixed ZINC vocabulary via a
        precomputed lookup table (the reference loops per token in Python)."""
        node_off, edge_off, idx_off = self.node_idx_offset, self.edge_idx_offset, self.idx_offset
        size = max(int(tokens.max(initial=0)) + 1, edge_off + (self.num_edge_types or 0) + 1)
        lut = np.empty(size, dtype=np.int32)
        bos_id = fixed_vocab["<bos>"]
        eos_id = fixed_vocab["<eos>"]
        pad_id = fixed_vocab["<pad>"]
        for tok in range(size):
            if tok == SOS:
                lut[tok] = bos_id
            elif tok in (RESET, LADJ, RADJ, PAD):
                lut[tok] = pad_id
            elif tok == EOS:
                lut[tok] = eos_id
            elif node_off <= tok < edge_off:
                a = tok - node_off
                try:
                    lut[tok] = get_atom_type_id(a)
                except ValueError:
                    lut[tok] = 22 + tok
            elif tok >= edge_off:
                b = tok - edge_off + 1
                try:
                    lut[tok] = get_bond_type_id(b)
                except ValueError:
                    lut[tok] = 22 + tok
            elif idx_off <= tok < node_off:
                lut[tok] = 22 + (tok - idx_off)
            else:
                lut[tok] = 22 + tok
        return lut[tokens]

    # -- query append (reference: train_agtt.py:256-267) -------------------
    def append_query(self, tokens: np.ndarray, query_u: int, query_v: int) -> np.ndarray:
        """Append '<q> u v' as ids. The '<q>' marker is one past the last
        node-position id. The reference computes it from the *per-batch first
        graph's* num_nodes (train_agtt.py:131 — a latent bug when batch
        graphs differ in size); we pin it to idx_offset + max_num_nodes so
        the id is consistent across the dataset."""
        q_id = self.idx_offset + self.max_num_nodes
        extra = np.array([q_id, self.idx_offset + query_u, self.idx_offset + query_v],
                         dtype=np.int32)
        return np.concatenate([tokens, extra])

    @property
    def query_token_id(self) -> int:
        return self.idx_offset + int(self.max_num_nodes)
