"""Corpus-characterization report of the port (the root
``tools/graph_stats_report.py``, on the port's generator and
``eval/graph_stats``): per-algorithm summary statistics of generated
graphs, and a pairwise MMD matrix (degree, clustering, orbit counts from the
native orbit counter) across algorithms, the diagonal a split-half
self-distance (the noise floor).

    python -m glearning_benchmark_tpu_torch.tools.graph_stats_report \
        [--algorithms er ba sbm sfn] [--graphs 120] [--plot]

Prints one JSON line per algorithm's summary, then the MMD matrix; writes
``--out`` (default ``runs_torch/graph_stats.json``) and, with ``--plot``, a
heatmap PNG a statistic beside it. A host tool: nothing runs on the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from ..data import generator as G
from ..eval.graph_stats import clustering_coefficients, compare_corpora, orbit_counts_batch
from ..utils.card import HOST
from . import RESULTS_DIR, emit, save

ALGORITHMS = ["er", "ba", "sbm", "sfn", "complete", "star", "path"]
STATS = ("degree_mmd", "clustering_mmd", "orbit_mmd")


def summarize(graphs) -> Dict[str, float]:
    """Mean nodes, edges, clustering coefficient, and triangles, squares
    and 4-cliques a node (orbits 3, 8 and 14), rounded as the reference."""
    nn = np.array([g.num_nodes for g in graphs])
    ne = np.array([len(g.edges) for g in graphs])
    edges = [np.asarray(g.edges).reshape(-1, 2) for g in graphs]
    clus = np.array([clustering_coefficients(e, int(n)).mean() for e, n in zip(edges, nn)])
    orb = np.stack([o.mean(0) for o in orbit_counts_batch(edges, nn.tolist())])
    return {
        "nodes_mean": round(float(nn.mean()), 2),
        "edges_mean": round(float(ne.mean()), 2),
        "clustering_mean": round(float(clus.mean()), 4),
        "triangles_per_node_mean": round(float(orb[:, 3].mean()), 3),
        "squares_per_node_mean": round(float(orb[:, 8].mean()), 3),
        "k4_per_node_mean": round(float(orb[:, 14].mean()), 3),
    }


def report(algorithms: List[str], n_graphs: int, seed: int) -> Dict:
    corpora = {a: [G.generate_graph(a, G.graph_seed(seed, a, "eval", i))
                   for i in range(n_graphs)] for a in algorithms}
    out = {"n_graphs": n_graphs, "summary": {a: summarize(gs) for a, gs in corpora.items()},
           "mmd": {}}
    for i, a in enumerate(algorithms):
        for b in algorithms[i:]:
            if a == b:
                half = n_graphs // 2
                cmp_ = compare_corpora(corpora[a][:half], corpora[a][half:])
            else:
                cmp_ = compare_corpora(corpora[a], corpora[b])
            out["mmd"][f"{a}|{b}"] = {k: round(v, 6) for k, v in cmp_.items()
                                      if k.endswith("_mmd")}
    return out


def mmd_matrix(rep: Dict, algorithms: List[str], stat: str) -> np.ndarray:
    m = np.zeros((len(algorithms), len(algorithms)))
    for i, a in enumerate(algorithms):
        for j, b in enumerate(algorithms):
            key = f"{a}|{b}" if f"{a}|{b}" in rep["mmd"] else f"{b}|{a}"
            m[i, j] = rep["mmd"][key][stat]
    return m


def plot(rep: Dict, algorithms: List[str], base: str) -> List[str]:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = []
    for stat in STATS:
        fig, ax = plt.subplots(figsize=(5.2, 4.4))
        im = ax.imshow(mmd_matrix(rep, algorithms, stat), cmap="viridis")
        ax.set_xticks(range(len(algorithms)), algorithms, rotation=45, ha="right")
        ax.set_yticks(range(len(algorithms)), algorithms)
        ax.set_title(f"{stat} between generator corpora")
        fig.colorbar(im)
        fig.tight_layout()
        paths.append(f"{base}_{stat}.png")
        fig.savefig(paths[-1], dpi=120)
        plt.close(fig)
    return paths


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithms", nargs="+", default=ALGORITHMS)
    ap.add_argument("--graphs", type=int, default=120)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "graph_stats.json"))
    ap.add_argument("--plot", action="store_true", help="MMD heatmap PNGs beside --out")
    args = ap.parse_args(argv)
    rep = report(list(args.algorithms), args.graphs, args.seed)
    save(args.out, rep)
    for a in args.algorithms:
        emit({"algorithm": a, **rep["summary"][a]}, HOST)
    pngs = plot(rep, list(args.algorithms), os.path.splitext(args.out)[0]) if args.plot else []
    return emit({"summary": "graph_stats_report", "n_graphs": args.graphs,
                 "algorithms": list(args.algorithms),
                 "degree_mmd": mmd_matrix(rep, list(args.algorithms), "degree_mmd").tolist(),
                 "out": args.out, "plots": pngs}, HOST)


if __name__ == "__main__":
    main()
