"""The graph-token text grammar: serialization and parsing.

Port of ``glearning_benchmark_tpu/data/text_grammar.py`` (copied; numpy
only). The generator serializes with ``graph_to_text``; the loaders and
the serving path parse records back into graphs
(``text_record_to_graph``).

Grammar (reference: docs/synthetic_data.md:96-120, parser in
graph_data_loader/graph_token_dataset_nativegraph.py:54-96):

    <bos> u v <e> u v <e> ... <n> 0 1 ... <q> QUERY <p> LABEL <eos>

Note the edge endpoints come BEFORE the ``<e>`` marker. Queries:

    cycle_check:    <q> has_cycle <p> yes|no
    shortest_path:  <q> shortest_distance u v <p> lenK | INF

Labels for shortest_path are parsed 0-indexed (len1 -> 0); INF/unreachable
records are dropped by the loaders (reference: data_loader.py:19-40).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .graphs import Graph


def graph_to_text(
    edges: np.ndarray,
    num_nodes: int,
    query: str,
    label: str,
) -> str:
    """Serialize a graph + task into the graph-token grammar."""
    parts: List[str] = ["<bos>"]
    for u, v in np.asarray(edges).reshape(-1, 2):
        parts.append(f"{int(u)} {int(v)} <e>")
    parts.append("<n> " + " ".join(str(i) for i in range(num_nodes)))
    parts.append(f"<q> {query} <p> {label} <eos>")
    return " ".join(parts)


def parse_yes_no_from_text(text: str) -> Optional[int]:
    """Last yes/no token in the text decides the binary label
    (reference: data_loader.py:12-17)."""
    for t in reversed(text.split()):
        tl = t.lower()
        if tl == "yes":
            return 1
        if tl == "no":
            return 0
    return None


def parse_distance_label_from_text(text: str) -> Optional[int]:
    """'<p> len3' -> 2 (0-indexed); INF/unreachable -> None
    (reference: data_loader.py:19-40)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<p>" and i + 1 < len(toks):
            lab = toks[i + 1].upper()
            if lab in ("INF", "INFINITY", "<EOS>"):
                return None
            if lab.startswith("LEN"):
                try:
                    return int(lab[3:]) - 1
                except ValueError:
                    pass
    return None


def parse_query_nodes_from_text(text: str) -> Optional[Tuple[int, int]]:
    """'<q> shortest_distance u v' -> (u, v) (reference: data_loader.py:42-55)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<q>" and i + 3 < len(toks) and toks[i + 1] == "shortest_distance":
            try:
                return int(toks[i + 2]), int(toks[i + 3])
            except ValueError:
                pass
    return None


PAIR_QUERY_BINARY_TASKS = ("reachability", "edge_existence")
COUNT_TASKS = {"node_degree": "d", "node_count": "n", "triangle_count": "t",
               "edge_count": "m", "maximum_flow": "f",
               "node_classification": "c"}
# count-labeled tasks whose query is a node pair / a single node
PAIR_QUERY_COUNT_TASKS = ("maximum_flow",)
SINGLE_QUERY_COUNT_TASKS = ("node_degree", "node_classification")


def parse_count_label_from_text(text: str, prefix: str) -> Optional[int]:
    """'<p> d3' -> 3 for prefix 'd' (node_degree / node_count / triangle
    count grammars: dK, nK, tK)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<p>" and i + 1 < len(toks):
            lab = toks[i + 1]
            if lab.lower().startswith(prefix) and len(lab) > len(prefix):
                try:
                    return int(lab[len(prefix):])
                except ValueError:
                    pass
    return None


def parse_pair_query_from_text(text: str) -> Optional[Tuple[int, int]]:
    """'<q> u v <p>' -> (u, v) (reachability / edge_existence grammars)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<q>" and i + 2 < len(toks):
            try:
                return int(toks[i + 1]), int(toks[i + 2])
            except ValueError:
                return None
    return None


def parse_single_query_from_text(text: str) -> Optional[int]:
    """'<q> u <p>' or '<q> class u <p>' -> u: the first integer token in
    the query section (node_degree / node_classification grammars)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<q>":
            for t in toks[i + 1:]:
                if t == "<p>":
                    return None
                try:
                    return int(t)
                except ValueError:
                    continue
            return None
    return None


def parse_cycle_label_from_text(text: str) -> Optional[int]:
    """'<p> yes|no' -> 1|0 (reference: nativegraph.py:99-117)."""
    toks = text.split()
    for i, tok in enumerate(toks):
        if tok == "<p>" and i + 1 < len(toks):
            lab = toks[i + 1].lower()
            if lab == "yes":
                return 1
            if lab == "no":
                return 0
    return None


def parse_graph_from_text(text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
    """Parse node list and edge list back out of the token text.

    Edge pattern is "u v <e>" (endpoints BEFORE the marker); nodes follow
    ``<n>`` until a section marker (reference: nativegraph.py:54-96).
    """
    toks = text.split()
    edges: List[Tuple[int, int]] = []
    nodes: List[int] = []
    i = 0
    n_tok = len(toks)
    while i < n_tok:
        if i + 2 < n_tok and toks[i + 2] == "<e>":
            try:
                edges.append((int(toks[i]), int(toks[i + 1])))
                i += 3
                continue
            except ValueError:
                i += 1
                continue
        if toks[i] == "<n>" and i + 1 < n_tok:
            i += 1
            while i < n_tok and toks[i] not in ("<q>", "<p>", "<eos>"):
                try:
                    nodes.append(int(toks[i]))
                    i += 1
                except ValueError:
                    break
            break
        i += 1
    return nodes, edges


def text_record_to_graph(text: str, task: str, label=None) -> Optional[Graph]:
    """Convert one text record into a Graph (reference: nativegraph.py:344-418)."""
    nodes, edges = parse_graph_from_text(text)
    if not nodes:
        node_set = {n for e in edges for n in e}
        nodes = sorted(node_set)
    if not nodes:
        return None
    num_nodes = max(nodes) + 1
    qu = qv = None
    if task == "shortest_path":
        if label is None:
            label = parse_distance_label_from_text(text)
        q = parse_query_nodes_from_text(text)
        if q is None or label is None:
            return None
        qu, qv = q
    elif task in PAIR_QUERY_BINARY_TASKS:
        if label is None:
            label = parse_yes_no_from_text(text)
        q = parse_pair_query_from_text(text)
        if q is None or label is None:
            return None
        qu, qv = q
    elif task in COUNT_TASKS:
        if label is None:
            label = parse_count_label_from_text(text, COUNT_TASKS[task])
        if label is None:
            return None
        if task in SINGLE_QUERY_COUNT_TASKS:
            u = parse_single_query_from_text(text)
            if u is None:
                return None
            qu = qv = u
        elif task in PAIR_QUERY_COUNT_TASKS:
            q = parse_pair_query_from_text(text)
            if q is None:
                return None
            qu, qv = q
    else:
        if label is None:
            label = parse_cycle_label_from_text(text)
        if label is None:
            return None
    e = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    return Graph(edges=e, num_nodes=num_nodes, y=int(label), query_u=qu, query_v=qv)
