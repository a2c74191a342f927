"""IBTT (index-based) tokenization: molecules and token texts -> id sequences.

Port of ``glearning_benchmark_tpu/tokenization/ibtt.py`` (copied; numpy
only): the string path, ``encode_text`` / ``encode_texts`` and the scalar
graph->ids path ``tokenize_zinc_corpus_ids``, which the corpus fast paths of
``ibtt_fast.py`` are held against.

Conformance targets (byte-exact with the reference):

- ZINC molecule serialization (reference: zinc_dataset_indexbase.py:143-195):
    <bos> (<atom> Sym)*N (<bond> type u v)*E' <q> regression <p> val_X_XX <eos>
  where E' is the directed edge list deduplicated to canonical sorted pairs in
  first-occurrence order, u/v are the *directed* endpoints of that first
  occurrence, and the label formats as f"val_{y:.2f}" with '.'->'_' and
  '-'->'neg'. Truncation keeps <eos> (zinc_dataset_indexbase.py:217-221).

- Text encoding (reference: TokenDataset, data_loader.py:465-486): tokens are
  cut after the first '<p>' (inclusive — the label never reaches the model),
  OOV maps to <pad>, sequences truncate to max_len.

Beyond the per-example string path, ``encode_texts`` vectorizes whole-corpus
encoding with a single ``np.unique`` + table lookup instead of a Python dict
probe per token — the corpus is tokenized once into one padded [N, L] int32
matrix (the reference re-runs Python loops per batch per epoch).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..data.graphs import Graph
from ..data.zinc import zinc_atom_symbol, zinc_bond_name


def zinc_label_token(label: float) -> str:
    """f"val_{label:.2f}" with '.'->'_' and '-'->'neg' (reference:
    zinc_dataset_indexbase.py:192-193)."""
    return f"val_{label:.2f}".replace(".", "_").replace("-", "neg")


def tokenize_zinc_molecule(g: Graph, max_len: Optional[int] = None) -> str:
    """Serialize one ZINC molecule to the IBTT token string, byte-exact with
    the reference's ``tokenize_molecule`` given the same directed edge list."""
    tokens: List[str] = ["<bos>"]
    for a in g.node_labels:
        tokens.append("<atom>")
        tokens.append(zinc_atom_symbol(int(a)))
    seen = set()
    for i in range(g.edges.shape[0]):
        u, v = int(g.edges[i, 0]), int(g.edges[i, 1])
        key = (u, v) if u <= v else (v, u)
        if key in seen:
            continue
        seen.add(key)
        bond = zinc_bond_name(int(g.edge_labels[i])) if g.edge_labels is not None and i < len(g.edge_labels) else "unknown"
        tokens.extend(["<bond>", bond, str(u), str(v)])
    tokens.extend(["<q>", "regression"])
    tokens.extend(["<p>", zinc_label_token(float(g.y)), "<eos>"])
    if max_len is not None and len(tokens) > max_len:
        tokens = tokens[: max_len - 1] + ["<eos>"]
    return " ".join(tokens)


def strip_label_tokens(tokens: List[str]) -> List[str]:
    """Cut after the first '<p>' inclusive (reference: data_loader.py:479-481)."""
    if "<p>" in tokens:
        p = tokens.index("<p>")
        return tokens[: p + 1]
    return tokens


def encode_text(text: str, vocab: Dict[str, int], max_len: int = 512,
                strip_label: bool = True) -> np.ndarray:
    """Single-text encode matching TokenDataset semantics."""
    toks = text.split()
    if strip_label:
        toks = strip_label_tokens(toks)
    pad = vocab["<pad>"]
    ids = [vocab.get(t, pad) for t in toks][:max_len]
    return np.asarray(ids, dtype=np.int32)


def encode_texts(
    texts: Sequence[str],
    vocab: Dict[str, int],
    max_len: int = 512,
    strip_label: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized whole-corpus encode.

    Returns (ids [N, L_max<=max_len] int32 padded with <pad>, lengths [N]).
    Semantics match ``encode_text`` per row; implementation does one
    ``np.unique`` over the flattened corpus and a single gather, so the cost
    per token is a vectorized table lookup rather than a dict probe.
    """
    pad = np.int32(vocab["<pad>"])
    n = len(texts)
    if n == 0:
        return np.zeros((0, 0), dtype=np.int32), np.zeros((0,), dtype=np.int32)

    tok_lists = [t.split() for t in texts]
    if strip_label:
        tok_lists = [strip_label_tokens(t) for t in tok_lists]
    lengths = np.fromiter((min(len(t), max_len) for t in tok_lists),
                          dtype=np.int32, count=n)
    flat = np.asarray([tok for toks in tok_lists for tok in toks[:max_len]],
                      dtype=object)
    uniq, inverse = np.unique(flat, return_inverse=True)
    lut = np.fromiter((vocab.get(u, int(pad)) for u in uniq),
                      dtype=np.int32, count=len(uniq))
    flat_ids = lut[inverse]

    l_max = int(lengths.max()) if n else 0
    ids = np.full((n, l_max), pad, dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    # scatter rows (vectorized over a boolean ragged mask)
    row_idx = np.repeat(np.arange(n), lengths)
    col_idx = np.arange(offs[-1]) - np.repeat(offs[:-1], lengths)
    ids[row_idx, col_idx] = flat_ids
    return ids, lengths


def tokenize_zinc_corpus(
    graphs: Iterable[Graph],
    max_len: int = 1024,
) -> List[str]:
    """Serialize many molecules (string conformance path)."""
    return [tokenize_zinc_molecule(g, max_len=max_len) for g in graphs]


def tokenize_zinc_corpus_ids(
    graphs: Sequence[Graph],
    vocab: Dict[str, int],
    max_len: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Direct graph->ids fast path (no intermediate strings).

    Produces exactly ``encode_texts(tokenize_zinc_corpus(...), vocab,
    strip_label=True)`` — i.e. the model-input view ending at '<p>' — but
    assembles ids numerically: specials/atoms/bonds from the fixed table and
    node-index tokens via a precomputed digit-string lookup. This is the
    per-chip hot path benchmarked by bench.py.
    """
    pad = np.int32(vocab["<pad>"])
    bos, eos = vocab["<bos>"], vocab["<eos>"]
    atom_tok, bond_tok = vocab["<atom>"], vocab["<bond>"]
    q_tok, p_tok, regress = vocab["<q>"], vocab["<p>"], vocab["regression"]
    # atom-symbol ids indexed by atom int; bond ids indexed by 1-based bond int
    atom_ids = np.array([vocab.get(zinc_atom_symbol(i), int(pad)) for i in range(9)],
                        dtype=np.int32)
    bond_ids = np.array([int(pad)] + [vocab.get(zinc_bond_name(b), int(pad)) for b in range(1, 5)],
                        dtype=np.int32)
    max_n = max((g.num_nodes for g in graphs), default=0)
    index_ids = np.array([vocab.get(str(i), int(pad)) for i in range(max_n)],
                         dtype=np.int32)

    rows: List[np.ndarray] = []
    for g in graphs:
        n = g.num_nodes
        # atoms block: interleave <atom>, sym
        atoms = np.empty(2 * n, dtype=np.int32)
        atoms[0::2] = atom_tok
        atoms[1::2] = atom_ids[g.node_labels]
        # canonical-dedup directed edges in first-occurrence order
        e = g.edges
        lo = np.minimum(e[:, 0], e[:, 1]).astype(np.int64)
        hi = np.maximum(e[:, 0], e[:, 1]).astype(np.int64)
        key = lo * 1_000_003 + hi
        _, first = np.unique(key, return_index=True)
        first.sort()
        eu = e[first]
        eb = g.edge_labels[first] if g.edge_labels is not None else np.ones(len(first), dtype=np.int32)
        bonds = np.empty(4 * len(first), dtype=np.int32)
        bonds[0::4] = bond_tok
        bonds[1::4] = bond_ids[np.clip(eb, 0, 4)]
        bonds[2::4] = index_ids[eu[:, 0]]
        bonds[3::4] = index_ids[eu[:, 1]]
        label_id = np.int32(vocab.get(zinc_label_token(float(g.y)), int(pad)))
        tail = np.array([q_tok, regress, p_tok, label_id, eos], dtype=np.int32)
        seq = np.concatenate([[bos], atoms, bonds, tail]).astype(np.int32)
        # emulate the string path exactly: truncate the FULL sequence keeping
        # <eos> (zinc_dataset_indexbase.py:217-221), then strip after the
        # first '<p>' if present (data_loader.py:479-481)
        if seq.shape[0] > max_len:
            seq = np.concatenate([seq[: max_len - 1], [eos]]).astype(np.int32)
        p_pos = np.flatnonzero(seq == p_tok)
        if p_pos.size:
            seq = seq[: p_pos[0] + 1]
        rows.append(seq)

    lengths = np.fromiter((r.shape[0] for r in rows), dtype=np.int32, count=len(rows))
    l_max = int(lengths.max()) if rows else 0
    ids = np.full((len(rows), l_max), pad, dtype=np.int32)
    for i, r in enumerate(rows):
        ids[i, : r.shape[0]] = r
    return ids, lengths
