"""IBTT (index-based) tokenization: molecules and token texts -> id sequences.

Port of ``glearning_benchmark_tpu/tokenization/ibtt.py`` (the string path
and ``encode_texts``, copied; numpy only). The corpus fast paths stay in the
JAX package until the port needs them.

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

from typing import Dict, List, Optional, Sequence, Tuple

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


def encode_texts(
    texts: Sequence[str],
    vocab: Dict[str, int],
    max_len: int = 512,
    strip_label: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized whole-corpus encode.

    Returns (ids [N, L_max<=max_len] int32 padded with <pad>, lengths [N]).
    Semantics match the reference's per-text encode; implementation does one
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
