"""Corpus loaders for the graph-token JSON layout.

Port of ``glearning_benchmark_tpu/data/loader.py`` (copied; numpy and
Python only): format-tolerant record extraction (JSON array / dict / JSONL
/ raw lines), two directory layouts with val->test fallback,
per-algorithm file sampling (``num_graphs``) and per-graph pair sampling
(``num_pairs_per_graph``) with the same two ``random.Random`` streams and
the same stable per-algorithm seeds, INF-pair dropping, class detection and
class balancing.

Every file goes through the Python parse path. The JAX package also has a
native strict-layout scan (``native/gtok.cpp``), a speed path that is
byte-identical to the Python one; it is not ported yet (ROADMAP queue A,
item 7), so the examples are the same and only the load is slower.
"""

from __future__ import annotations

import json
import os
import random
from glob import glob
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.hashing import stable_hash
from .graphs import Graph
from .text_grammar import (
    COUNT_TASKS,
    PAIR_QUERY_BINARY_TASKS,
    PAIR_QUERY_COUNT_TASKS,
    SINGLE_QUERY_COUNT_TASKS,
    parse_count_label_from_text,
    parse_distance_label_from_text,
    parse_pair_query_from_text,
    parse_query_nodes_from_text,
    parse_single_query_from_text,
    parse_yes_no_from_text,
    text_record_to_graph,
)


def _parse_task_label_query(t: str, task: str):
    """(label, query_nodes) for the extended task families."""
    if task in PAIR_QUERY_BINARY_TASKS:
        return parse_yes_no_from_text(t), parse_pair_query_from_text(t)
    if task in COUNT_TASKS:
        lab = parse_count_label_from_text(t, COUNT_TASKS[task])
        q = None
        if task in SINGLE_QUERY_COUNT_TASKS:
            u = parse_single_query_from_text(t)
            q = (u, u) if u is not None else None
        elif task in PAIR_QUERY_COUNT_TASKS:
            q = parse_pair_query_from_text(t)
        return lab, q
    return None, None


def _extract_text_and_label(rec: Any, task: str):
    """(text, label, query_nodes) from a record of any supported shape
    (reference: data_loader.py:57-110; extended task grammars on top)."""
    query_nodes = None
    if task in PAIR_QUERY_BINARY_TASKS or task in COUNT_TASKS:
        t = None
        if isinstance(rec, str):
            t = rec.strip()
        elif isinstance(rec, dict):
            t = rec.get("text") or rec.get("sequence")
        elif isinstance(rec, list) and all(isinstance(x, (str, int)) for x in rec):
            t = " ".join(map(str, rec))
        if not isinstance(t, str):
            return None, None, None
        lab, q = _parse_task_label_query(t, task)
        return t.strip(), lab, q
    if isinstance(rec, str):
        t = rec.strip()
    elif isinstance(rec, dict):
        t = rec.get("text") or rec.get("sequence")
        if t is None and isinstance(rec.get("tokens"), (list, tuple)):
            t = " ".join(map(str, rec["tokens"]))
        lab = rec.get("label", rec.get("answer"))
        if task == "shortest_path":
            if isinstance(lab, int):
                q = parse_query_nodes_from_text(t) if isinstance(t, str) else None
                return (t.strip() if isinstance(t, str) else None), lab, q
            if isinstance(t, str):
                return t.strip(), parse_distance_label_from_text(t), parse_query_nodes_from_text(t)
            return None, None, None
        if isinstance(lab, str):
            ll = lab.lower().strip()
            lab = 1 if ll in ("yes", "true", "connected", "reachable") else (
                0 if ll in ("no", "false", "disconnected", "unreachable") else None)
        elif isinstance(lab, (int, bool)):
            lab = int(bool(lab))
        if isinstance(t, str):
            t = t.strip()
            if lab is None:
                lab = parse_yes_no_from_text(t)
            return t, lab, None
        return None, None, None
    elif isinstance(rec, list) and all(isinstance(x, (str, int)) for x in rec):
        t = " ".join(map(str, rec))
    else:
        return None, None, None

    if task == "shortest_path":
        return t, parse_distance_label_from_text(t), parse_query_nodes_from_text(t)
    return t, parse_yes_no_from_text(t), None


def _read_records(path: str) -> List[Any]:
    with open(path, "r") as f:
        raw = f.read().strip()
    if not raw:
        return []
    try:
        obj = json.loads(raw)
        return obj if isinstance(obj, list) else [obj]
    except json.JSONDecodeError:
        pass
    recs: List[Any] = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
            recs.extend(obj if isinstance(obj, list) else [obj])
        except json.JSONDecodeError:
            recs.append(line)
    return recs


def resolve_split_dir(root: str, task: str, algorithm: str, split: str,
                      use_split_tasks_dirs: bool = True) -> str:
    """Layout A (tasks_train/tasks_test) or B (tasks/), val->test fallback
    (reference: data_loader.py:499-520, 608-624)."""
    if use_split_tasks_dirs:
        top = "tasks_test" if split in ("val", "test") else "tasks_train"
        base = os.path.join(root, top, task, algorithm)
    else:
        base = os.path.join(root, "tasks", task, algorithm)
    split_dir = os.path.join(base, split)
    if split == "val" and not glob(os.path.join(split_dir, "*.json")):
        split_dir = os.path.join(base, "test")
    return split_dir


def load_examples(
    path_glob: str,
    task: str = "cycle_check",
    seed: int = 0,
    num_graphs: Optional[int] = None,
    num_pairs_per_graph: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Load example dicts {"text", "label"[, "query_u","query_v"]} from files.

    ``num_graphs`` subsamples files; for shortest_path,
    ``num_pairs_per_graph`` subsamples query-pair records within each file
    (reference: data_loader.py:112-245). The sampling population is every
    record with query nodes — INCLUDING unlabeled (INF/unreachable) pairs,
    exactly like the reference (data_loader.py:166-176 requires only
    ``query_nodes is not None``); unlabeled sampled entries are dropped
    downstream, so a graph can contribute fewer than
    ``num_pairs_per_graph`` usable examples.
    """
    files = sorted(glob(path_glob))
    if num_graphs is not None and len(files) > num_graphs:
        rng = random.Random(seed)
        files = sorted(rng.sample(files, num_graphs))

    out: List[Dict[str, Any]] = []
    pair_rng = random.Random(seed)
    sample_pairs = task == "shortest_path" and num_pairs_per_graph is not None
    for fp in files:
        recs = _read_records(fp)
        file_examples: List[Dict[str, Any]] = []
        for rec in recs:
            t, y, q = _extract_text_and_label(rec, task=task)
            if not t:
                continue
            entry: Dict[str, Any] = {"text": t, "label": y}
            if q is not None:
                entry["query_u"], entry["query_v"] = q
            if sample_pairs:
                if q is not None:
                    file_examples.append(entry)
            else:
                out.append(entry)
        if sample_pairs:
            if len(file_examples) > num_pairs_per_graph:
                file_examples = pair_rng.sample(file_examples, num_pairs_per_graph)
            out.extend(file_examples)
    return out


def load_examples_multi_algorithm(
    root: str,
    task: str,
    algorithms: Sequence[str],
    split: str,
    use_split_tasks_dirs: bool = True,
    seed: int = 0,
    num_graphs: Optional[int] = None,
    num_pairs_per_graph: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Concatenate per-algorithm example lists with stable derived seeds
    (reference: data_loader.py:588-633; ``hash(algo)`` replaced by
    ``stable_hash``)."""
    all_examples: List[Dict[str, Any]] = []
    for algo in algorithms:
        split_dir = resolve_split_dir(root, task, algo, split, use_split_tasks_dirs)
        path_glob = os.path.join(split_dir, "*.json")
        algo_seed = seed + stable_hash(algo) % 10000
        all_examples.extend(load_examples(
            path_glob, task=task, seed=algo_seed,
            num_graphs=num_graphs, num_pairs_per_graph=num_pairs_per_graph))
    return all_examples


def load_graphs_multi_algorithm(
    root: str,
    task: str,
    algorithms: Sequence[str],
    split: str,
    use_split_tasks_dirs: bool = True,
    seed: int = 0,
    num_graphs: Optional[int] = None,
    num_pairs_per_graph: Optional[int] = None,
) -> List[Graph]:
    """Graph-native loading: parse each text record back into a ``Graph``
    (the reference does this in two near-identical PyG adapters,
    graph_token_dataset_{nativegraph,autograph}.py; one code path here)."""
    examples = load_examples_multi_algorithm(
        root, task, algorithms, split, use_split_tasks_dirs, seed,
        num_graphs, num_pairs_per_graph)
    graphs: List[Graph] = []
    for ex in examples:
        if ex.get("label") is None:
            continue
        g = text_record_to_graph(ex["text"], task=task, label=ex.get("label"))
        if g is not None:
            graphs.append(g)
    return graphs


def load_examples_connected_nodes(path_glob: str, data_fraction: float = 1.0,
                                  seed: int = 0) -> List[Dict[str, Any]]:
    """Connectivity-query loader: '<text> <q> u v <p>' inputs with yes/no
    labels (reference: data_loader.py:408-449)."""
    files = sorted(glob(path_glob))
    out: List[Dict[str, Any]] = []
    for fp in files:
        recs = _read_records(fp)
        if recs and isinstance(recs[0], dict):
            obj = recs[0]
        elif recs and isinstance(recs, list):
            obj = recs[0] if isinstance(recs[0], dict) else None
        else:
            obj = None
        if not isinstance(obj, dict):
            continue
        text = obj.get("text")
        if not isinstance(text, str):
            toks = obj.get("tokens")
            text = " ".join(map(str, toks)) if isinstance(toks, list) else None
        if not text:
            continue
        u = obj.get("u", obj.get("src", obj.get("source")))
        v = obj.get("v", obj.get("dst", obj.get("target")))
        if (u is None or v is None) and isinstance(obj.get("pair"), (list, tuple)) \
                and len(obj["pair"]) == 2:
            u, v = obj["pair"]
        lab = obj.get("label", obj.get("answer", obj.get("connected")))
        if isinstance(lab, str):
            ll = lab.lower().strip()
            lab = 1 if ll in ("yes", "true", "connected", "reachable") else (
                0 if ll in ("no", "false", "disconnected", "unreachable") else None)
        elif isinstance(lab, (int, bool)):
            lab = int(bool(lab))
        text_in = (f"{text.strip()} <q> {u} {v} <p>"
                   if u is not None and v is not None else text.strip())
        if lab is None:
            lab = parse_yes_no_from_text(text)
        out.append({"text": text_in, "label": lab, "u": u, "v": v})
    if data_fraction < 1.0 and out:
        rng = random.Random(seed)
        out = rng.sample(out, max(1, int(len(out) * data_fraction)))
    return out


def resolve_split_globs(root: str, task: str, algorithm: str,
                        use_split_tasks_dirs: bool = True):
    """(train_glob, val_glob, test_glob) triple (reference:
    data_loader.py:499-520)."""
    return tuple(
        os.path.join(resolve_split_dir(root, task, algorithm, split,
                                       use_split_tasks_dirs), "*.json")
        for split in ("train", "val", "test"))


def resolve_multi_algorithm_globs(root: str, task: str, train_algorithms,
                                  test_algorithm: str,
                                  use_split_tasks_dirs: bool = True):
    """(train_globs, val_globs, test_glob) for multi-algorithm setups
    (reference: data_loader.py:523-585)."""
    train_globs, val_globs = [], []
    for algo in train_algorithms:
        tg, vg, _ = resolve_split_globs(root, task, algo, use_split_tasks_dirs)
        train_globs.append(tg)
        val_globs.append(vg)
    _, _, test_glob = resolve_split_globs(root, task, test_algorithm,
                                          use_split_tasks_dirs)
    return train_globs, val_globs, test_glob


def determine_num_classes(examples: List[Dict[str, Any]], task: str) -> int:
    """cycle_check -> 2, zinc -> 1, shortest_path -> max label + 1
    (reference: data_loader.py:636-686)."""
    if task == "cycle_check":
        return 2
    if task == "zinc":
        return 1
    max_label = -1
    for ex in examples:
        lab = ex.get("label")
        if isinstance(lab, (int, np.integer)):
            max_label = max(max_label, int(lab))
    return max_label + 1


def determine_num_classes_graphs(graphs, task: str) -> int:
    """Class count from Graph objects (reference determine_num_classes_pyg,
    data_loader.py:688-738)."""
    if task == "cycle_check":
        return 2
    if task == "zinc":
        return 1
    max_label = -1
    for g in graphs:
        if isinstance(g.y, (int, np.integer)):
            max_label = max(max_label, int(g.y))
    return max_label + 1


def get_balanced_indices(graphs, strategy: str = "undersample",
                         seed: int = 0) -> List[int]:
    """Balanced index subset for a graph list (reference:
    data_loader.py:337-405)."""
    by_label: Dict[Any, List[int]] = {}
    for i, g in enumerate(graphs):
        if g.y is not None:
            by_label.setdefault(int(g.y) if isinstance(g.y, (int, np.integer)) else g.y,
                                []).append(i)
    if not by_label:
        return list(range(len(graphs)))
    sizes = [len(v) for v in by_label.values()]
    if strategy == "undersample":
        target = min(sizes)
    elif strategy == "median":
        target = int(np.median(sizes))
    else:
        raise ValueError(f"unknown balancing strategy: {strategy}")
    rng = random.Random(seed)
    out: List[int] = []
    for lab in sorted(by_label):
        idxs = by_label[lab]
        out.extend(idxs if len(idxs) <= target else rng.sample(idxs, target))
    rng.shuffle(out)
    return out


def balance_classes(examples: List[Dict[str, Any]], strategy: str = "undersample",
                    seed: int = 0) -> List[Dict[str, Any]]:
    """Class balancing (reference: data_loader.py:248-334)."""
    by_label: Dict[Any, List[Dict[str, Any]]] = {}
    for ex in examples:
        lab = ex.get("label")
        if lab is not None:
            by_label.setdefault(lab, []).append(ex)
    if not by_label:
        return examples
    sizes = [len(v) for v in by_label.values()]
    if strategy == "undersample":
        target = min(sizes)
    elif strategy == "median":
        target = int(np.median(sizes))
    elif strategy == "oversample":
        target = max(sizes)
    elif strategy == "soft_oversample":
        target = int(np.mean(sizes))
    else:
        raise ValueError(f"unknown balancing strategy: {strategy}")
    rng = random.Random(seed)
    balanced: List[Dict[str, Any]] = []
    for lab in sorted(by_label, key=lambda x: (str(type(x)), x)):
        exs = by_label[lab]
        if len(exs) > target:
            balanced.extend(rng.sample(exs, target))
        elif len(exs) < target:
            balanced.extend(exs)
            balanced.extend(rng.choices(exs, k=target - len(exs)))
        else:
            balanced.extend(exs)
    rng.shuffle(balanced)
    return balanced
