"""ZINC molecular graphs.

Port of ``glearning_benchmark_tpu/data/zinc.py`` (copied; numpy only): the
same stand-in generator, export reader and writer (``save_zinc_npz``) give
byte-identical graphs for the same split, and every split is a
``GraphCorpus`` carrying its flat struct-of-arrays form: the export's own
arrays, or ``ibtt_fast.flatten_zinc_corpus`` of the stand-in molecules.

The reference loads ZINC-12K through ``torch_geometric.datasets.ZINC`` (a
network download, reference: graph_data_loader/zinc_dataset_indexbase.py:79).
This environment has no network egress, so this module provides:

1. ``load_zinc_split(root, split)`` — loads real ZINC if an ``.npz`` export is
   present at ``<root>/zinc_<split>.npz`` (arrays: ``node_offsets``,
   ``edge_offsets``, ``atom_types``, ``edge_src``, ``edge_dst``,
   ``bond_types``, ``y``), matching PyG's tensor semantics: node features are
   atom-type ints 0-8, edge_attr bond ints 1-4, edge_index directed with both
   orientations of every bond.
2. A deterministic molecular *stand-in* generator with ZINC-like statistics
   (split sizes 10000/1000/1000, 9 atom types with realistic frequencies,
   tree + ring topology, 4 bond types, a locality-dominated regression
   target — see ``_standin_target``), used when no export exists. All
   downstream machinery (tokenizers, vocab, models, metrics) is exercised
   identically either way.

Graphs are returned with *directed duplicated* edges in (src-sorted) order —
the exact shape PyG's ZINC exposes — because IBTT tokenization order depends
on it (reference: zinc_dataset_indexbase.py:176-184 dedups the directed list
to canonical pairs in first-occurrence order).
"""

from __future__ import annotations

import hashlib
import os
from typing import List

import numpy as np

from .graphs import Graph, GraphCorpus

ZINC_NUM_ATOM_TYPES = 9   # C N O F P S Cl Br I (reference zinc_vocab.py:20)
ZINC_NUM_BOND_TYPES = 4   # single double triple aromatic (1-based ids)
# bumped when the stand-in's molecules or targets change; keys the dataset
# cache of train/datasets.py
ZINC_STANDIN_VERSION = 2

_ATOM_SYMBOLS = ["C", "N", "O", "F", "P", "S", "Cl", "Br", "I"]
_BOND_NAMES = {1: "single", 2: "double", 3: "triple", 4: "aromatic"}

# ZINC-like atom frequency (heavily carbon-dominated)
_ATOM_PROBS = np.array([0.72, 0.11, 0.10, 0.02, 0.002, 0.025, 0.015, 0.006, 0.002])
_ATOM_PROBS = _ATOM_PROBS / _ATOM_PROBS.sum()
_BOND_PROBS = np.array([0.68, 0.20, 0.02, 0.10])  # single/double/triple/aromatic

_SPLIT_SIZES = {"train": 10000, "val": 1000, "test": 1000}
_SPLIT_SEED = {"train": 0, "val": 1, "test": 2}


def get_zinc_num_types():
    """(num_node_types, num_edge_types) = (9, 4) (reference:
    zinc_dataset_autograph.py:76-100)."""
    return ZINC_NUM_ATOM_TYPES, ZINC_NUM_BOND_TYPES


def zinc_atom_symbol(idx: int) -> str:
    return _ATOM_SYMBOLS[idx] if 0 <= idx < len(_ATOM_SYMBOLS) else "X"


def zinc_bond_name(idx: int) -> str:
    return _BOND_NAMES.get(int(idx), "unknown")


def _synth_molecule(seed: int, target_weights=None) -> Graph:
    rng = np.random.default_rng(seed)
    n = int(np.clip(round(rng.normal(23, 5)), 9, 37))
    atom = rng.choice(ZINC_NUM_ATOM_TYPES, size=n, p=_ATOM_PROBS).astype(np.int32)

    # random tree with valence cap 4
    deg = np.zeros(n, dtype=np.int32)
    und_edges: List[tuple] = []
    for i in range(1, n):
        cands = np.flatnonzero(deg[:i] < 4)
        if cands.size == 0:
            cands = np.arange(i)
        j = int(cands[rng.integers(0, cands.size)])
        und_edges.append((j, i))
        deg[j] += 1
        deg[i] += 1

    # ring closures: connect nodes at moderate index distance
    n_rings = int(rng.integers(0, 4))
    existing = {tuple(sorted(e)) for e in und_edges}
    for _ in range(n_rings):
        a = int(rng.integers(0, n - 5))
        b = a + int(rng.integers(4, min(7, n - a)))
        key = (a, b)
        if key not in existing and deg[a] < 4 and deg[b] < 4:
            existing.add(key)
            und_edges.append(key)
            deg[a] += 1
            deg[b] += 1

    und = np.asarray(und_edges, dtype=np.int32)
    bond = rng.choice(np.arange(1, 5, dtype=np.int32), size=und.shape[0], p=_BOND_PROBS)

    # directed duplicated edges sorted by (src, dst), PyG-style
    src = np.concatenate([und[:, 0], und[:, 1]])
    dst = np.concatenate([und[:, 1], und[:, 0]])
    bb = np.concatenate([bond, bond])
    order = np.lexsort((dst, src))
    edges = np.stack([src[order], dst[order]], axis=1).astype(np.int32)
    bb = bb[order].astype(np.int32)

    y = _standin_target(atom, und, bond, deg, n, weights=target_weights)
    return Graph(edges=edges, num_nodes=n, y=float(round(y, 4)),
                 node_labels=atom, edge_labels=bb)


def _env_value(ints) -> float:
    """Deterministic pseudo-random value in [-1, 1] for an integer
    environment key (stable blake2b — the framework's stable-hashing
    invariant: identical across processes, hosts, and Python versions,
    unlike ``hash()``)."""
    h = hashlib.blake2b(np.asarray(ints, np.int64).tobytes(),
                        digest_size=8).digest()
    return 2.0 * (int.from_bytes(h, "little") / 2.0 ** 64) - 1.0


def _standin_target(atom, und, bond, deg, n, weights=None) -> float:
    """Locality-dominated regression target (r5 redesign; VERDICT r4 #2).

    The r2-r4 target was built from global counting features (atom/bond/
    ring counts and their smooth interactions). Counting is exactly what a
    token serializer reads off the sequence — our IBTT transformer hit MAE
    0.0886 while the mean-pooled GNNs sat at 0.29-0.42, INVERTING the
    reference's published family ordering on real ZINC (MPNN 0.4615 < GPS
    0.5002 < AGTT 0.6306 < IBTT 0.6620, BASELINE.md). Real constrained
    solubility is dominated by *local chemical environments* — the
    inductive bias message passing encodes and a serialization model must
    reconstruct by parsing the edge list.

    This target therefore puts its variance into hashed per-node
    environment contributions (offline oracle analysis:
    tools/zinc_target_lab.py):

      t1: mean over atoms of v(atom_i, sorted 1-hop neighbor atoms)
      t2: mean over atoms of v(... + sorted 2-hop atom multiset)
      t3: mean over bonds of v(bond_type, endpoint atoms)  [bond-aware
          models only: serializers see bond tokens, GINE sees edge types,
          plain GIN cannot — mirrors real ZINC where bond-blind MPNN still
          wins because atom environments carry most of the signal]
      + a mild ring term and a molecule-unique hashed noise floor
        (~0.2 MAE irreducible for every model — stands in for the
        component of real solubility unpredictable at these model scales)

    v() is a fixed hash-indexed value table: per-environment contributions
    must be *memorized from training exposure*, not extrapolated from a
    smooth formula — like real chemistry group contributions. Mean (not
    sum) aggregation matches the models' mean pooling. SCALE is a fixed
    constant (calibrated once so y std ~= 2.0, real ZINC's scale) — the
    target stays a pure per-molecule function, no corpus statistics.
    """
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for a, b in und:
        nbrs[int(a)].append(int(b))
        nbrs[int(b)].append(int(a))
    t1 = t2 = 0.0
    for i in range(n):
        n1 = sorted(int(atom[j]) for j in nbrs[i])
        key1 = (int(atom[i]),) + tuple(n1)
        t1 += _env_value(key1)
        two = sorted(int(atom[k]) for j in nbrs[i] for k in nbrs[j]
                     if k != i)
        t2 += _env_value(key1 + (99,) + tuple(two))
    t1 /= max(n, 1)
    t2 /= max(n, 1)
    if len(und):
        t3 = float(np.mean([
            _env_value((int(b), -3, int(min(atom[a], atom[c])),
                        int(max(atom[a], atom[c]))))
            for (a, c), b in zip(und, bond)]))
    else:
        t3 = 0.0
    rings = len(und) - (n - 1)
    noise = _env_value((-7,) + tuple(int(a) for a in atom)
                       + (-8,) + tuple(int(x) for x in und.ravel()))
    # fixed calibration constants (one-time, 3000-molecule sample): y std
    # ~= 2.0 centered near 0, real ZINC's scale. Constants, not corpus
    # statistics — the target stays a pure per-molecule function.
    # ``weights`` (w_env1, w_env2, w_bond, w_ring) overrides the v2
    # component mix for target-design experiments
    # (dataset.zinc_target_weights; tools/zinc_target_probe.py) — custom
    # mixes keep the v2 SCALE/CENTER, so only relative rankings, not
    # absolute MAE bands, are meaningful under them.
    w1, w2, w3, wr = weights if weights is not None else (1.0, 0.55, 0.25,
                                                          0.10)
    SCALE, CENTER = 11.5, 3.47
    return float(SCALE * (w1 * t1 + w2 * t2 + w3 * t3
                          + wr * np.tanh(rings - 1.5))
                 + 0.4 * noise + CENTER)


def save_zinc_npz(path: str, graphs: List[Graph]) -> None:
    """Write graphs in the export schema ``_load_npz`` consumes (the same
    writer the JAX package's tools/export_zinc.py uses on the real PyG
    dataset, so a real export and this round trip are schema-identical)."""
    node_off = np.zeros(len(graphs) + 1, dtype=np.int64)
    edge_off = np.zeros(len(graphs) + 1, dtype=np.int64)
    for i, g in enumerate(graphs):
        node_off[i + 1] = node_off[i] + g.num_nodes
        edge_off[i + 1] = edge_off[i] + len(g.edges)
    np.savez_compressed(
        path,
        node_offsets=node_off,
        edge_offsets=edge_off,
        atom_types=np.concatenate([g.node_labels for g in graphs]).astype(np.int32),
        edge_src=np.concatenate([g.edges[:, 0] for g in graphs]).astype(np.int32),
        edge_dst=np.concatenate([g.edges[:, 1] for g in graphs]).astype(np.int32),
        bond_types=np.concatenate([g.edge_labels for g in graphs]).astype(np.int32),
        y=np.asarray([g.y for g in graphs], dtype=np.float64),
    )


def _load_npz(path: str):
    """Returns (graphs, flat): per-molecule Graph views plus the corpus's
    flat struct-of-arrays form, built directly from the export arrays
    (the export schema is already flat — no per-molecule round-trip)."""
    z = np.load(path)
    node_off, edge_off = z["node_offsets"], z["edge_offsets"]
    atom, src, dst, bond, y = z["atom_types"], z["edge_src"], z["edge_dst"], z["bond_types"], z["y"]
    graphs: List[Graph] = []
    for i in range(len(node_off) - 1):
        ns, ne = int(node_off[i]), int(node_off[i + 1])
        es, ee = int(edge_off[i]), int(edge_off[i + 1])
        edges = np.stack([src[es:ee], dst[es:ee]], axis=1).astype(np.int32)
        graphs.append(Graph(
            edges=edges, num_nodes=ne - ns, y=float(y[i]),
            node_labels=atom[ns:ne].astype(np.int32),
            edge_labels=bond[es:ee].astype(np.int32)))
    node_off = node_off.astype(np.int64)
    edge_off = edge_off.astype(np.int64)
    # canonical flat dtypes = the native-kernel dtypes (int32 fields, int64
    # offsets — same contract as tokenization.ibtt_fast.flatten_zinc_corpus),
    # so the export's own int32 arrays flow through zero-copy
    flat = {
        "n_nodes": np.diff(node_off).astype(np.int32),
        "n_edges": np.diff(edge_off).astype(np.int32),
        "node_off": node_off, "edge_off": edge_off,
        "atoms": np.ascontiguousarray(atom, dtype=np.int32),
        "src": np.ascontiguousarray(src, dtype=np.int32),
        "dst": np.ascontiguousarray(dst, dtype=np.int32),
        "bond": np.ascontiguousarray(bond, dtype=np.int32),
        "y": y.astype(np.float64),
    }
    return graphs, flat


_warned = False


def load_zinc_split(root: str = "./data/ZINC", split: str = "train",
                    subset: bool = True, limit: int | None = None,
                    target_weights=None) -> GraphCorpus:
    """Load one ZINC split (real export if present, deterministic stand-in
    otherwise). Returns a :class:`GraphCorpus` carrying the flat
    struct-of-arrays form alongside the per-molecule Graph views."""
    global _warned
    if split not in _SPLIT_SIZES:
        raise ValueError(f"unknown split {split!r}")
    npz = os.path.join(root, f"zinc_{split}.npz")
    flat = None
    if os.path.isfile(npz):
        graphs, flat = _load_npz(npz)
    else:
        if not _warned:
            print("[zinc] no real ZINC export found; using deterministic "
                  "ZINC-like stand-in corpus (no network egress available)")
            _warned = True
        count = _SPLIT_SIZES[split]
        if limit is not None:
            count = min(count, limit)
        base = _SPLIT_SEED[split] * 1_000_000 + 777
        tw = tuple(float(w) for w in target_weights) if target_weights \
            else None
        graphs = [_synth_molecule(base + i, target_weights=tw)
                  for i in range(count)]
    if limit is not None and len(graphs) > limit:
        graphs, flat = graphs[:limit], None
    corpus = GraphCorpus(graphs)
    if flat is None:
        from ..tokenization.ibtt_fast import flatten_zinc_corpus
        flat = flatten_zinc_corpus(graphs)
    corpus.flat = flat
    return corpus
