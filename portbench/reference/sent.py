"""SENT trails of ZINC molecules in the fixed ZINC vocabulary.

A frozen copy of the port's ``TrailTokenizer`` walk and its ZINC remap
(``glearning_benchmark_tpu_torch/tokenization/sent.py``: ``decompose_trails``,
``__call__``, ``remap_zinc_tokens``; the fixed ids of
``tokenization/vocab.py``), for labeled undirected graphs only, written
straight into the fixed vocabulary: <bos> 0, <eos> 1, <pad> 2, atoms 8-16,
bonds 17-20, node positions 22 + index. RESET, LADJ and RADJ map to <pad>
as the remap does.
"""

from __future__ import annotations

from typing import List

import numpy as np

BOS, EOS, PAD = 0, 1, 2
ATOM0, BOND0, POS0 = 8, 17, 22


def vocab_size(max_nodes: int) -> int:
    """The ZINC bundle's embedding rows: the 22 fixed ids, the node
    positions and 100 spare rows."""
    return 22 + max_nodes + 100


def _unique_undirected(edges: np.ndarray, bonds: np.ndarray):
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.shape[0] == 0:
        return e.astype(np.int32), np.zeros((0,), dtype=np.int32)
    key = np.minimum(e[:, 0], e[:, 1]) * 1_000_003 + np.maximum(e[:, 0], e[:, 1])
    _, first = np.unique(key, return_index=True)
    first.sort()
    return e[first].astype(np.int32), bonds[first].astype(np.int32)


def _trails(n: int, edges: np.ndarray):
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for ei in range(edges.shape[0]):
        u, v = int(edges[ei, 0]), int(edges[ei, 1])
        adj[u].append((v, ei))
        adj[v].append((u, ei))
    for lst in adj:
        lst.sort()
    used = np.zeros(edges.shape[0], dtype=bool)
    ptr = [0] * n
    deg = np.array([len(a) for a in adj])
    remaining = deg.copy()
    node_trails, edge_trails = [], []
    while remaining.sum() > 0:
        odd = np.flatnonzero((remaining % 2 == 1) & (remaining > 0))
        cur = int(odd[0]) if odd.size else int(np.flatnonzero(remaining > 0)[0])
        nodes, eidx = [cur], []
        while True:
            while ptr[cur] < len(adj[cur]) and used[adj[cur][ptr[cur]][1]]:
                ptr[cur] += 1
            if ptr[cur] == len(adj[cur]):
                break
            v, ei = adj[cur][ptr[cur]]
            used[ei] = True
            remaining[cur] -= 1
            remaining[v] -= 1
            nodes.append(v)
            eidx.append(ei)
            cur = v
        node_trails.append(nodes)
        edge_trails.append(eidx)
    for u in np.flatnonzero(deg == 0):
        node_trails.append([int(u)])
        edge_trails.append([])
    return node_trails, edge_trails


def trail(edges: np.ndarray, atoms: np.ndarray, bonds: np.ndarray, max_len: int) -> np.ndarray:
    """The molecule's SENT trail in fixed ZINC ids, cut to ``max_len`` with
    <eos> kept."""
    n = int(atoms.shape[0])
    und, und_bonds = _unique_undirected(edges, bonds)
    node_trails, edge_trails = _trails(n, und)
    out = [BOS]
    seen = set()
    for t, (nodes, eidx) in enumerate(zip(node_trails, edge_trails)):
        if t > 0:
            out.append(PAD)                      # RESET
            if nodes[0] in seen:
                out.append(PAD)                  # LADJ
        out += [POS0 + nodes[0], ATOM0 + int(atoms[nodes[0]])]
        seen.add(nodes[0])
        for k, v in enumerate(nodes[1:]):
            out += [BOND0 + int(und_bonds[eidx[k]]) - 1, POS0 + v, ATOM0 + int(atoms[v])]
            seen.add(v)
        if t + 1 < len(node_trails) and nodes[-1] in {nt[0] for nt in node_trails[t + 1:]}:
            out.append(PAD)                      # RADJ
    out.append(EOS)
    if len(out) > max_len:
        out = out[:max_len - 1] + [EOS]
    return np.asarray(out, dtype=np.int32)


def bucket(n: int) -> int:
    """The row length a split of longest sequence ``n`` is padded to."""
    for b in (64, 128, 256, 512, 640, 1024, 2048):
        if n <= b:
            return b
    return n
