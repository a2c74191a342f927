"""Record readers for the graph-token JSON layout.

Port of ``glearning_benchmark_tpu/data/loader.py``: only the
format-tolerant record extraction (``_read_records``,
``_extract_text_and_label``) that the prediction CLI reads input files
with, copied. Corpus loading and sampling come with the training slice.
"""

from __future__ import annotations

import json
from typing import Any, List

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
