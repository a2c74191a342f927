"""Vocabularies: the synthetic-task dynamic vocab and the fixed ZINC vocab.

Port of ``glearning_benchmark_tpu/tokenization/vocab.py`` (copied; pure
Python).

Two distinct special-token tables coexist, exactly as in the reference:

- ``SPECIAL`` for the graph-token text grammar, IDs 0..8 by position
  (reference: data_loader.py:10);
- ``ZINC_SPECIAL_TOKENS`` for the fixed ZINC vocabulary, IDs 0..7, atoms
  8..16, bonds 17..20, 'regression' 21, dynamic tokens 22+
  (reference: zinc_vocab.py:28, 35-78).

Determinism: the reference extends the ZINC vocab in Python-set iteration
order (hash-randomized; reference train_ibtt.py:363-372). We pin dynamic
tokens to *first-occurrence order over the scanned texts*, which is stable
across processes and hosts and is what an insertion-ordered scan yields.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

SPECIAL = ["<pad>", "<bos>", "<e>", "<n>", "<q>", "<p>", "<eos>", "yes", "no"]

ZINC_SPECIAL_TOKENS = ["<bos>", "<eos>", "<pad>", "<unk>", "<q>", "<p>", "<atom>", "<bond>"]
ZINC_ATOM_TYPES = ["C", "N", "O", "F", "P", "S", "Cl", "Br", "I"]
ZINC_BOND_TYPES = ["single", "double", "triple", "aromatic"]
NUM_ATOM_TYPES = len(ZINC_ATOM_TYPES)
NUM_BOND_TYPES = len(ZINC_BOND_TYPES)


def build_vocab_from_texts(
    texts: Iterable[str],
    min_freq: int = 1,
    max_tokens: Optional[int] = None,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Frequency-ranked vocab seeded with SPECIAL (reference:
    data_loader.py:451-463). ``Counter.most_common`` tie-breaks by first
    occurrence, which is deterministic given text order."""
    cnt: Counter = Counter()
    for text in texts:
        cnt.update(text.split())
    vocab = {tok: i for i, tok in enumerate(SPECIAL)}
    idx = len(vocab)
    for tok, c in cnt.most_common():
        if tok in vocab:
            continue
        if c < min_freq:
            break
        vocab[tok] = idx
        idx += 1
        if max_tokens and idx >= max_tokens:
            break
    itos = {i: t for t, i in vocab.items()}
    return vocab, itos


def build_fixed_zinc_vocab() -> Tuple[Dict[str, int], Dict[int, str]]:
    """Frozen ID layout: specials 0-7, atoms 8-16, bonds 17-20,
    'regression' 21 (reference: zinc_vocab.py:35-78)."""
    vocab: Dict[str, int] = {}
    for tok in ZINC_SPECIAL_TOKENS:
        vocab[tok] = len(vocab)
    for atom in ZINC_ATOM_TYPES:
        vocab[atom] = len(vocab)
    for bond in ZINC_BOND_TYPES:
        vocab[bond] = len(vocab)
    vocab["regression"] = len(vocab)
    itos = {i: t for t, i in vocab.items()}
    return vocab, itos


def get_atom_type_id(atom_type_idx: int) -> int:
    """Atom index 0-8 -> fixed ID 8-16 (reference: zinc_vocab.py:81-96)."""
    if not (0 <= atom_type_idx < NUM_ATOM_TYPES):
        raise ValueError(f"invalid atom type index: {atom_type_idx}")
    return 8 + atom_type_idx


def get_bond_type_id(bond_type_idx: int) -> int:
    """Bond index 1-4 (1-based) -> fixed ID 17-20 (reference:
    zinc_vocab.py:99-115)."""
    if not (1 <= bond_type_idx <= NUM_BOND_TYPES):
        raise ValueError(f"invalid bond type index: {bond_type_idx}")
    return 17 + (bond_type_idx - 1)


def collect_dynamic_tokens(texts: Iterable[str], base_vocab: Dict[str, int]) -> List[str]:
    """All out-of-vocab tokens in first-occurrence order (pinned — the
    reference uses an unordered set here, train_ibtt.py:363-372)."""
    seen: Dict[str, None] = {}
    for text in texts:
        for tok in text.split():
            if tok not in base_vocab and tok not in seen:
                seen[tok] = None
    return list(seen)


def extend_vocab_with_dynamic_tokens(
    base_vocab: Dict[str, int], dynamic_tokens: Iterable[str]
) -> Dict[str, int]:
    """Append dynamic tokens after the fixed block (reference:
    zinc_vocab.py:154-179)."""
    vocab = dict(base_vocab)
    idx = max(vocab.values()) + 1
    for tok in dynamic_tokens:
        if tok not in vocab:
            vocab[tok] = idx
            idx += 1
    return vocab
