"""Graph-distribution statistics: orbit counts, degree/clustering
histograms, and MMD distances between corpora.

Port of ``glearning_benchmark_tpu/eval/graph_stats.py`` (numpy, copied; the
orbit counts through the port's own bridge ``..native``). The tests hold
its counts and MMD values equal to the JAX package's.

Mirrors the capability the reference obtains from AutoGraph's evaluation
stack (ORCA orbit counts + GraphRNN-style MMD over degree / clustering /
orbit statistics — reference docs/setup.md:30-36 compiles ORCA for exactly
this). Orbit counting runs in C++ (gstats.cpp, ORCA orbits 0-14 for
all 2-4-node graphlets) with an independent pure-numpy fallback used for
cross-checking; the MMD kernels are the standard Gaussian-TV (histogram
statistics) and RBF (vector statistics) forms.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence

import numpy as np

from .. import native

N_ORBITS = 15


# ---------------------------------------------------------------------------
# orbit counting
# ---------------------------------------------------------------------------

def _orbit_counts_numpy(edges: np.ndarray, n: int) -> np.ndarray:
    """Pure-python/numpy orbit counter — the independent oracle for the
    native kernel (tests cross-check them bit-for-bit). Enumerates all
    triples and quads over the dense adjacency and classifies the induced
    subgraph by edge count + in-subset degree sequence."""
    counts = np.zeros((n, N_ORBITS), dtype=np.int64)
    if n == 0:
        return counts
    adj = np.zeros((n, n), dtype=bool)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size:
        adj[e[:, 0], e[:, 1]] = True
        adj[e[:, 1], e[:, 0]] = True
        np.fill_diagonal(adj, False)
    counts[:, 0] = adj.sum(1)

    for a, b, c in combinations(range(n), 3):
        ab, ac, bc = adj[a, b], adj[a, c], adj[b, c]
        ne = int(ab) + int(ac) + int(bc)
        if ne == 3:
            counts[[a, b, c], 3] += 1
        elif ne == 2:
            mid = a if (ab and ac) else (b if (ab and bc) else c)
            for x in (a, b, c):
                counts[x, 2 if x == mid else 1] += 1

    for quad in combinations(range(n), 4):
        sub = adj[np.ix_(quad, quad)]
        dg = sub.sum(1)
        ne = int(dg.sum()) // 2
        if ne < 3 or (dg == 0).any():
            continue  # disconnected
        if ne == 6:
            counts[list(quad), 14] += 1
        elif ne == 5:
            for x, d in zip(quad, dg):
                counts[x, 13 if d == 3 else 12] += 1
        elif ne == 4:
            if (dg == 2).all():
                counts[list(quad), 8] += 1
            else:  # paw
                for x, d in zip(quad, dg):
                    counts[x, 9 if d == 1 else (11 if d == 3 else 10)] += 1
        else:  # ne == 3, connected: star or P4
            if dg.max() == 3:
                for x, d in zip(quad, dg):
                    counts[x, 7 if d == 3 else 6] += 1
            else:
                for x, d in zip(quad, dg):
                    counts[x, 4 if d == 1 else 5] += 1
    return counts


def orbit_counts(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-node ORCA orbit counts [num_nodes, 15] for one graph."""
    return orbit_counts_batch([edges], [num_nodes])[0]


def orbit_counts_batch(edges_list: Sequence[np.ndarray],
                       n_nodes_list: Sequence[int]) -> List[np.ndarray]:
    """Per-node orbit counts for a batch; native C++ when available."""
    if native.gstats_available():
        try:
            flat = native.orbit_counts_batch_native(edges_list, n_nodes_list)
        except ValueError:
            # the library refuses a graph it cannot count (a self-loop or an
            # endpoint out of range): the numpy path below takes the batch
            flat = None
        if flat is not None:
            out, off = [], 0
            for nn in n_nodes_list:
                out.append(flat[off:off + int(nn)])
                off += int(nn)
            return out
    return [_orbit_counts_numpy(e, int(nn))
            for e, nn in zip(edges_list, n_nodes_list)]


# ---------------------------------------------------------------------------
# scalar statistics
# ---------------------------------------------------------------------------

def degree_histogram(edges: np.ndarray, num_nodes: int,
                     max_degree: int = 64) -> np.ndarray:
    """Normalized degree histogram [max_degree+1]."""
    deg = np.zeros(num_nodes, dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size:
        seen = {(min(int(u), int(v)), max(int(u), int(v)))
                for u, v in e if u != v}
        for u, v in seen:
            deg[u] += 1
            deg[v] += 1
    h = np.bincount(np.minimum(deg, max_degree), minlength=max_degree + 1)
    return h / max(h.sum(), 1)


def clustering_coefficients(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-node local clustering coefficient via adjacency powers."""
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size:
        adj[e[:, 0], e[:, 1]] = 1.0
        adj[e[:, 1], e[:, 0]] = 1.0
        np.fill_diagonal(adj, 0.0)
    deg = adj.sum(1)
    tri = np.diag(adj @ adj @ adj) / 2.0
    denom = deg * (deg - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0, tri / denom, 0.0)
    return c


def _clustering_hist(edges, n, bins: int = 20) -> np.ndarray:
    h, _ = np.histogram(clustering_coefficients(edges, n),
                        bins=bins, range=(0.0, 1.0))
    return h / max(h.sum(), 1)


# ---------------------------------------------------------------------------
# MMD kernels (GraphRNN-style)
# ---------------------------------------------------------------------------

def _pairwise_tv(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Total-variation distance matrix between two stacks of histograms
    (rows sum to 1); ragged lengths must be pre-padded."""
    return 0.5 * np.abs(xs[:, None, :] - ys[None, :, :]).sum(-1)


def mmd_gaussian_tv(samples_a: Sequence[np.ndarray],
                    samples_b: Sequence[np.ndarray],
                    sigma: float = 1.0) -> float:
    """MMD^2 with k(x,y) = exp(-TV(x,y)^2 / (2 sigma^2)) over histogram
    samples (one histogram per graph)."""
    width = max(max(len(x) for x in samples_a), max(len(x) for x in samples_b))
    pad = lambda s: np.stack([np.pad(np.asarray(x, np.float64),
                                     (0, width - len(x))) for x in s])
    xa, xb = pad(samples_a), pad(samples_b)
    k = lambda p, q: np.exp(-_pairwise_tv(p, q) ** 2 / (2 * sigma ** 2)).mean()
    return float(k(xa, xa) + k(xb, xb) - 2 * k(xa, xb))


def mmd_rbf(xs: np.ndarray, ys: np.ndarray, sigma: float = 30.0) -> float:
    """MMD^2 with an RBF kernel over vector statistics (rows = graphs)."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    d2 = lambda p, q: ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)
    k = lambda p, q: np.exp(-d2(p, q) / (2 * sigma ** 2)).mean()
    return float(k(xs, xs) + k(ys, ys) - 2 * k(xs, ys))


# ---------------------------------------------------------------------------
# corpus comparison
# ---------------------------------------------------------------------------

def compare_corpora(graphs_a, graphs_b, max_graphs: int = 200,
                    seed: int = 0) -> Dict[str, float]:
    """MMD distances between two graph corpora over the AutoGraph/GraphRNN
    statistic suite: degree histograms (gaussian-TV), clustering-coefficient
    histograms (gaussian-TV), and per-graph mean orbit-count vectors (RBF).
    ``graphs_*`` are sequences of objects with .edges and .num_nodes.
    Corpora larger than ``max_graphs`` are subsampled deterministically."""
    rng = np.random.default_rng(seed)

    def sample(gs):
        gs = list(gs)
        if len(gs) > max_graphs:
            idx = np.sort(rng.choice(len(gs), size=max_graphs, replace=False))
            gs = [gs[i] for i in idx]
        return gs

    ga, gb = sample(graphs_a), sample(graphs_b)

    def stats(gs):
        edges = [np.asarray(g.edges).reshape(-1, 2) for g in gs]
        nn = [int(g.num_nodes) for g in gs]
        deg = [degree_histogram(e, n) for e, n in zip(edges, nn)]
        clus = [_clustering_hist(e, n) for e, n in zip(edges, nn)]
        orb = np.stack([o.mean(0) for o in orbit_counts_batch(edges, nn)])
        return deg, clus, orb

    da, ca, oa = stats(ga)
    db, cb, ob = stats(gb)
    return {
        "degree_mmd": mmd_gaussian_tv(da, db),
        "clustering_mmd": mmd_gaussian_tv(ca, cb),
        "orbit_mmd": mmd_rbf(oa, ob),
        "n_a": len(ga), "n_b": len(gb),
    }
