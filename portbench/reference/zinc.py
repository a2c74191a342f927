"""The ZINC stand-in corpus, made by the benchmark itself.

A frozen copy of the port's deterministic molecule generator
(``glearning_benchmark_tpu_torch/data/zinc.py``: ``_synth_molecule``,
``_env_value``, ``_standin_target``, stand-in version 2), so that the
benchmark owns its inputs. :func:`ensure_corpus` writes the three splits in
the ZINC export schema (``zinc_<split>.npz``), which the port reads as a
real export; :func:`load_split` reads them back as plain arrays for the
reference and for the requests of a serving cell.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

NUM_ATOM_TYPES = 9
NUM_BOND_TYPES = 4
SPLIT_SIZES = {"train": 10000, "val": 1000, "test": 1000}
SPLIT_SEED = {"train": 0, "val": 1, "test": 2}

_ATOM_PROBS = np.array([0.72, 0.11, 0.10, 0.02, 0.002, 0.025, 0.015, 0.006, 0.002])
_ATOM_PROBS = _ATOM_PROBS / _ATOM_PROBS.sum()
_BOND_PROBS = np.array([0.68, 0.20, 0.02, 0.10])


@dataclass(frozen=True)
class Molecule:
    """One molecule: directed duplicated edges [E, 2] sorted by (src, dst),
    atom types [N], 1-based bond types [E], the regression target."""

    edges: np.ndarray
    atoms: np.ndarray
    bonds: np.ndarray
    y: float

    @property
    def num_nodes(self) -> int:
        return int(self.atoms.shape[0])


def _env_value(ints) -> float:
    h = hashlib.blake2b(np.asarray(ints, np.int64).tobytes(), digest_size=8).digest()
    return 2.0 * (int.from_bytes(h, "little") / 2.0 ** 64) - 1.0


def _target(atom, und, bond, n) -> float:
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for a, b in und:
        nbrs[int(a)].append(int(b))
        nbrs[int(b)].append(int(a))
    t1 = t2 = 0.0
    for i in range(n):
        key1 = (int(atom[i]),) + tuple(sorted(int(atom[j]) for j in nbrs[i]))
        t1 += _env_value(key1)
        two = sorted(int(atom[k]) for j in nbrs[i] for k in nbrs[j] if k != i)
        t2 += _env_value(key1 + (99,) + tuple(two))
    t1 /= max(n, 1)
    t2 /= max(n, 1)
    t3 = float(np.mean([_env_value((int(b), -3, int(min(atom[a], atom[c])),
                                    int(max(atom[a], atom[c]))))
                        for (a, c), b in zip(und, bond)])) if len(und) else 0.0
    rings = len(und) - (n - 1)
    noise = _env_value((-7,) + tuple(int(a) for a in atom)
                       + (-8,) + tuple(int(x) for x in und.ravel()))
    return float(11.5 * (1.0 * t1 + 0.55 * t2 + 0.25 * t3 + 0.10 * np.tanh(rings - 1.5))
                 + 0.4 * noise + 3.47)


def synth_molecule(seed: int) -> Molecule:
    rng = np.random.default_rng(seed)
    n = int(np.clip(round(rng.normal(23, 5)), 9, 37))
    atom = rng.choice(NUM_ATOM_TYPES, size=n, p=_ATOM_PROBS).astype(np.int32)
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
    n_rings = int(rng.integers(0, 4))
    existing = {tuple(sorted(e)) for e in und_edges}
    for _ in range(n_rings):
        a = int(rng.integers(0, n - 5))
        b = a + int(rng.integers(4, min(7, n - a)))
        if (a, b) not in existing and deg[a] < 4 and deg[b] < 4:
            existing.add((a, b))
            und_edges.append((a, b))
            deg[a] += 1
            deg[b] += 1
    und = np.asarray(und_edges, dtype=np.int32)
    bond = rng.choice(np.arange(1, 5, dtype=np.int32), size=und.shape[0], p=_BOND_PROBS)
    src = np.concatenate([und[:, 0], und[:, 1]])
    dst = np.concatenate([und[:, 1], und[:, 0]])
    bb = np.concatenate([bond, bond])
    order = np.lexsort((dst, src))
    edges = np.stack([src[order], dst[order]], axis=1).astype(np.int32)
    y = _target(atom, und, bond, n)
    return Molecule(edges=edges, atoms=atom, bonds=bb[order].astype(np.int32),
                    y=float(round(y, 4)))


def split_molecules(split: str, count: int) -> List[Molecule]:
    """The first ``count`` molecules of the stand-in split."""
    base = SPLIT_SEED[split] * 1_000_000 + 777
    return [synth_molecule(base + i) for i in range(count)]


def _save(path: str, mols: List[Molecule]) -> None:
    node_off = np.concatenate([[0], np.cumsum([m.num_nodes for m in mols])]).astype(np.int64)
    edge_off = np.concatenate([[0], np.cumsum([len(m.edges) for m in mols])]).astype(np.int64)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, node_offsets=node_off, edge_offsets=edge_off,
        atom_types=np.concatenate([m.atoms for m in mols]).astype(np.int32),
        edge_src=np.concatenate([m.edges[:, 0] for m in mols]).astype(np.int32),
        edge_dst=np.concatenate([m.edges[:, 1] for m in mols]).astype(np.int32),
        bond_types=np.concatenate([m.bonds for m in mols]).astype(np.int32),
        y=np.asarray([m.y for m in mols], dtype=np.float64))
    os.replace(tmp, path)


def ensure_corpus(root: str, sizes: Dict[str, int] = SPLIT_SIZES) -> None:
    """Write ``<root>/zinc_<split>.npz`` for every split that is missing,
    of ``sizes[split]`` molecules."""
    os.makedirs(root, exist_ok=True)
    for split in SPLIT_SIZES:
        path = os.path.join(root, f"zinc_{split}.npz")
        if not os.path.isfile(path):
            _save(path, split_molecules(split, int(sizes[split])))


def load_split(root: str, split: str) -> List[Molecule]:
    """The molecules of ``<root>/zinc_<split>.npz``."""
    with np.load(os.path.join(root, f"zinc_{split}.npz")) as z:
        no, eo = z["node_offsets"], z["edge_offsets"]
        atoms, src, dst, bonds, y = (z[k] for k in ("atom_types", "edge_src", "edge_dst",
                                                     "bond_types", "y"))
    out = []
    for i in range(len(no) - 1):
        es, ee = int(eo[i]), int(eo[i + 1])
        out.append(Molecule(edges=np.stack([src[es:ee], dst[es:ee]], axis=1).astype(np.int32),
                            atoms=atoms[int(no[i]):int(no[i + 1])].astype(np.int32),
                            bonds=bonds[es:ee].astype(np.int32), y=float(y[i])))
    return out


def load_corpus(root: str) -> Dict[str, List[Molecule]]:
    return {s: load_split(root, s) for s in SPLIT_SIZES}
