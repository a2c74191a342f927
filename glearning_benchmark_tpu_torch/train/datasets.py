"""Dataset assembly: configs -> fixed-shape arrays, one pass at startup.

Port of ``glearning_benchmark_tpu/train/datasets.py`` (numpy, copied; the
tests hold the arrays equal to the JAX package's): ``DatasetBundle``, the
query-task tables, the packed train split, the content-addressed bundle
cache, the synthetic graph-token corpora (generated when missing, then
loaded per algorithm: ``train_algorithms`` for train and val,
``test_algorithm`` for the out-of-distribution test split) and ZINC,
``build_ibtt_dataset``, ``build_agtt_dataset``, ``build_graph_dataset``
and the ``build_dataset`` dispatcher. Trails come from the Python
``TrailTokenizer`` (the native tokenizer is not ported yet).

Array layouts of a token split: ids [N, L] i32, mask [N, L] bool, y [N];
a packed train split: ids/seg/pos [R, L] i32, pos_bos/pos_u/pos_v [R, K]
i32, ex_valid [R, K] bool, y [R, K]; a graph split: node_feat [N, Nmax, F]
f32, adj [N, Nmax, Nmax] uint8, mask [N, Nmax] bool, y [N], and for ZINC
eadj [N, Nmax, Nmax] uint8 bond types.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..data.generator import GENERATOR_VERSION, ensure_corpus
from ..data.graphs import batch_graphs
from ..data.loader import (determine_num_classes, load_examples_multi_algorithm,
                           load_graphs_multi_algorithm)
from ..data.zinc import (ZINC_NUM_ATOM_TYPES, ZINC_NUM_BOND_TYPES,
                         ZINC_STANDIN_VERSION, load_zinc_split)
from ..tokenization.ibtt import encode_texts, tokenize_zinc_molecule
from ..tokenization.pack import pack_examples, pad_sequences, round_up_to_bucket
from ..tokenization.sent import TrailTokenizer
from ..tokenization.vocab import (build_fixed_zinc_vocab, build_vocab_from_texts,
                                  collect_dynamic_tokens,
                                  extend_vocab_with_dynamic_tokens)
from ..utils.hashing import stable_hash

# bumped when the bundles this module emits change
_CACHE_FORMAT = 1

SPLITS = ("train", "val", "test")

# every task whose label is query-conditioned: token-model query-node
# readout, the AGTT '<q> u v' trail append, graph-model query features
QUERY_TASKS = ("shortest_path", "reachability", "edge_existence",
               "node_degree", "maximum_flow", "node_classification")

# token offsets of (u, v) after the '<q>' marker in the IBTT text grammar:
# '<q> shortest_distance u v' -> (2, 3); '<q> u' -> (1, 1);
# '<q> class u' -> (2, 2); pair default '<q> u v' -> (1, 2)
QUERY_OFFSETS = {"shortest_path": (2, 3), "node_degree": (1, 1),
                 "node_classification": (2, 2)}  # default (1, 2)


@dataclass
class DatasetBundle:
    task: str
    kind: str                      # 'tokens' | 'graphs'
    splits: Dict[str, Dict[str, np.ndarray]]
    num_classes: int
    vocab: Optional[dict] = None
    vocab_size: int = 0
    q_token_id: Optional[int] = None
    in_dim: int = 1
    meta: dict = field(default_factory=dict)

    def n(self, split: str) -> int:
        return len(self.splits[split]["y"])


def _pack_train_split(seqs, labels, bucket, pad_id, q_id, offsets):
    """Replace an unpacked train split with packed rows (SURVEY §7 2d):
    multiple sequences per attention row behind a block-diagonal mask,
    segment-relative positions, host-precomputed readout slots. Eval splits
    stay unpacked (the reference collate contract is the eval surface)."""
    pk = pack_examples(seqs, bucket=bucket, pad_id=pad_id,
                       q_token_id=q_id, query_offsets=offsets)
    y = np.asarray(labels)
    y_ex = np.where(pk["ex_valid"], y[pk["ex_index"]], 0).astype(y.dtype)
    return {"ids": pk["ids"], "seg": pk["seg"], "pos": pk["pos"],
            "pos_bos": pk["pos_bos"], "pos_u": pk["pos_u"],
            "pos_v": pk["pos_v"], "ex_valid": pk["ex_valid"], "y": y_ex}


# ---------------------------------------------------------------------------
# content-addressed bundle cache under <root>/processed/, keyed by a stable
# hash of the full build configuration; its own key space, so it never
# reads a bundle the JAX package cached
# ---------------------------------------------------------------------------

def _cache_path(model_name: str, dataset_cfg: dict, seed: int, limit) -> Optional[str]:
    root = dataset_cfg.get("graph_token_root") or dataset_cfg.get("zinc_root")
    if not root:
        return None
    key_src = json.dumps({"model": model_name, "cfg": dataset_cfg,
                          "seed": seed, "limit": limit, "port": "torch",
                          "format": _CACHE_FORMAT,
                          "gen": GENERATOR_VERSION,
                          "zinc": ZINC_STANDIN_VERSION},
                         sort_keys=True, default=str)
    return os.path.join(root, "processed",
                        f"torch_{model_name}_{dataset_cfg.get('task')}_"
                        f"{stable_hash(key_src):016x}")


def _save_bundle(path: str, bundle: DatasetBundle) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {f"{s}__{k}": v for s, arr in bundle.splits.items()
              for k, v in arr.items()}
    np.savez_compressed(os.path.join(path, "data.npz"), **arrays)
    meta = {"task": bundle.task, "kind": bundle.kind,
            "num_classes": bundle.num_classes, "vocab": bundle.vocab,
            "vocab_size": bundle.vocab_size, "q_token_id": bundle.q_token_id,
            "in_dim": bundle.in_dim, "meta": bundle.meta}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _load_bundle(path: str) -> Optional[DatasetBundle]:
    """The cached bundle at ``path``, or None when there is none or it
    cannot be read (it is then rebuilt)."""
    npz_path = os.path.join(path, "data.npz")
    meta_path = os.path.join(path, "meta.json")
    if not (os.path.isfile(npz_path) and os.path.isfile(meta_path)):
        return None
    try:
        with np.load(npz_path) as z:
            splits: Dict[str, Dict[str, np.ndarray]] = {s: {} for s in SPLITS}
            for key in z.files:
                s, k = key.split("__", 1)
                splits[s][k] = z[key]
        with open(meta_path) as f:
            meta = json.load(f)
        return DatasetBundle(task=meta["task"], kind=meta["kind"], splits=splits,
                             num_classes=meta["num_classes"], vocab=meta["vocab"],
                             vocab_size=meta["vocab_size"],
                             q_token_id=meta["q_token_id"], in_dim=meta["in_dim"],
                             meta=meta["meta"])
    except (OSError, ValueError, KeyError):
        return None


def _resolve_corpus_root(dataset_cfg: dict, seed: int) -> str:
    root = dataset_cfg.get("graph_token_root", "graph-token")
    n = int(dataset_cfg.get("generate_num_graphs", 500))
    algos = list(dict.fromkeys(
        list(dataset_cfg.get("train_algorithms", [])) +
        [dataset_cfg.get("test_algorithm", "sfn")]))
    difficulty = dataset_cfg.get("difficulty")
    if difficulty:
        # dedicated root per difficulty preset: the per-directory generation
        # stamps encode the knobs, so sharing a root with the default corpus
        # would regenerate back and forth between presets
        root = f"{root}-{difficulty}"
    ensure_corpus(root, tasks=(dataset_cfg["task"],), algorithms=algos,
                  number_of_graphs=n, seed=1234,
                  difficulty=difficulty,
                  size_buckets=dataset_cfg.get("size_buckets"))
    return root


def _load_synthetic_examples(dataset_cfg: dict, seed: int):
    root = _resolve_corpus_root(dataset_cfg, seed)
    task = dataset_cfg["task"]
    algos = dataset_cfg["train_algorithms"]
    test_algo = dataset_cfg["test_algorithm"]
    kw = dict(
        use_split_tasks_dirs=dataset_cfg.get("use_split_tasks_dirs", True),
        seed=seed,
        num_graphs=dataset_cfg.get("num_graphs"),
        num_pairs_per_graph=dataset_cfg.get("num_pairs_per_graph"),
    )
    return {
        "train": load_examples_multi_algorithm(root, task, algos, "train", **kw),
        "val": load_examples_multi_algorithm(root, task, algos, "val", **kw),
        "test": load_examples_multi_algorithm(root, task, [test_algo], "test", **kw),
    }


def _load_synthetic_graphs(dataset_cfg: dict, seed: int):
    root = _resolve_corpus_root(dataset_cfg, seed)
    task = dataset_cfg["task"]
    algos = dataset_cfg["train_algorithms"]
    test_algo = dataset_cfg["test_algorithm"]
    kw = dict(
        use_split_tasks_dirs=dataset_cfg.get("use_split_tasks_dirs", True),
        seed=seed,
        num_graphs=dataset_cfg.get("num_graphs"),
        num_pairs_per_graph=dataset_cfg.get("num_pairs_per_graph"),
    )
    return {
        "train": load_graphs_multi_algorithm(root, task, algos, "train", **kw),
        "val": load_graphs_multi_algorithm(root, task, algos, "val", **kw),
        "test": load_graphs_multi_algorithm(root, task, [test_algo], "test", **kw),
    }


def _drop_unlabeled(examples):
    return [e for e in examples if e.get("label") is not None]


def _zinc_graphs(dataset_cfg: dict, limit: Optional[int]):
    return {s: load_zinc_split(dataset_cfg.get("zinc_root", "./data/ZINC"), s,
                               subset=dataset_cfg.get("subset", True), limit=limit,
                               target_weights=dataset_cfg.get("zinc_target_weights"))
            for s in SPLITS}


# ---------------------------------------------------------------------------
# IBTT (token) datasets
# ---------------------------------------------------------------------------

def build_ibtt_dataset(dataset_cfg: dict, seed: int, limit: Optional[int] = None) -> DatasetBundle:
    task = dataset_cfg["task"]
    max_len = int(dataset_cfg.get("max_len", 600))

    if task == "zinc":
        mols = _zinc_graphs(dataset_cfg, limit)
        texts = {s: [tokenize_zinc_molecule(m, max_len=max_len) for m in mols[s]]
                 for s in SPLITS}
        labels = {s: np.array([m.y for m in mols[s]], dtype=np.float32) for s in SPLITS}
        # fixed vocab + dynamic tokens over all splits, pinned order
        fixed, _ = build_fixed_zinc_vocab()
        dyn = collect_dynamic_tokens(
            (t for s in SPLITS for t in texts[s]), fixed)
        vocab = extend_vocab_with_dynamic_tokens(fixed, dyn)
        num_classes = 1
    else:
        ex = _load_synthetic_examples(dataset_cfg, seed)
        ex = {s: _drop_unlabeled(v) for s, v in ex.items()}
        if limit:
            ex = {s: v[:limit] for s, v in ex.items()}
        texts = {s: [e["text"] for e in v] for s, v in ex.items()}
        labels = {s: np.array([e["label"] for e in v], dtype=np.int32)
                  for s, v in ex.items()}
        vocab, _ = build_vocab_from_texts(
            texts["train"], max_tokens=dataset_cfg.get("max_vocab"))
        num_classes = determine_num_classes(
            [e for v in ex.values() for e in v], task)

    pad_id = vocab["<pad>"]
    packed = {s: encode_texts(texts[s], vocab, max_len=max_len) for s in SPLITS}
    # per-split buckets: the train split pads only to ITS max (the OOD test
    # algorithm often has far longer serializations — e.g. er test graphs at
    # ~600 tokens vs path train graphs at ~200 — and attention cost is L²);
    # val and test share one bucket
    train_bucket = round_up_to_bucket(max(packed["train"][0].shape[1], 1))
    eval_bucket = round_up_to_bucket(max(
        max(packed[s][0].shape[1] if packed[s][0].size else 1 for s in ("val", "test")), 1))
    splits = {}
    for s in SPLITS:
        bucket = train_bucket if s == "train" else eval_bucket
        ids, lens = packed[s]
        n, l = ids.shape if ids.size else (0, 0)
        out = np.full((n, bucket), pad_id, dtype=np.int32)
        if ids.size:
            out[:, :l] = ids
        mask = np.arange(bucket)[None, :] < lens[:, None]
        splits[s] = {"ids": out, "mask": mask, "y": labels[s]}

    q_id = vocab.get("<q>") if task in QUERY_TASKS else None

    n_examples_train = len(labels["train"])
    if bool(dataset_cfg.get("pack", False)) and n_examples_train:
        ids_t, lens_t = packed["train"]
        seqs = [ids_t[i, : lens_t[i]] for i in range(len(lens_t))]
        splits["train"] = _pack_train_split(
            seqs, labels["train"], train_bucket, pad_id, q_id,
            QUERY_OFFSETS.get(task, (1, 2)))

    return DatasetBundle(task=task, kind="tokens", splits=splits,
                         num_classes=num_classes, vocab=vocab,
                         vocab_size=len(vocab), q_token_id=q_id,
                         meta={"max_len": max(train_bucket, eval_bucket),
                               "pad_id": pad_id,
                               "n_examples_train": n_examples_train})


# ---------------------------------------------------------------------------
# AGTT (trail token) datasets
# ---------------------------------------------------------------------------

def build_agtt_dataset(dataset_cfg: dict, seed: int, limit: Optional[int] = None) -> DatasetBundle:
    task = dataset_cfg["task"]
    max_len = int(dataset_cfg.get("max_len", 600))
    is_zinc = task == "zinc"
    if is_zinc:
        graphs = _zinc_graphs(dataset_cfg, limit)
    else:
        graphs = _load_synthetic_graphs(dataset_cfg, seed)
        if limit:
            graphs = {s: v[:limit] for s, v in graphs.items()}

    tok = TrailTokenizer(max_length=max_len, truncation_length=max_len,
                         labeled_graph=is_zinc, undirected=True)
    # position table sized over ALL splits, so no eval graph is dropped
    max_nodes_train = max(g.num_nodes for g in graphs["train"])
    max_nodes = max(g.num_nodes for s in SPLITS for g in graphs[s])
    if max_nodes > max_nodes_train:
        print(f"[agtt] eval graphs exceed the train max ({max_nodes} > "
              f"{max_nodes_train} nodes); position table sized globally so "
              f"none are dropped")
    tok.set_num_nodes(max_nodes)
    if is_zinc:
        tok.set_num_node_and_edge_types(ZINC_NUM_ATOM_TYPES, ZINC_NUM_BOND_TYPES)
        fixed, _ = build_fixed_zinc_vocab()
        # fixed vocab size + node positions remapped to 22+
        vocab_size = len(fixed) + max_nodes + 100
        pad_id = fixed["<pad>"]
        bos_like = fixed["<bos>"]
    else:
        vocab_size = tok.idx_offset + max_nodes + 1  # +1 for '<q>'
        pad_id = TrailTokenizer.pad
        bos_like = 0  # SOS
        fixed = None

    seqs_by_split = {}
    for s in SPLITS:
        seqs = []
        for g in graphs[s]:
            t = tok(g)
            if is_zinc:
                t = tok.remap_zinc_tokens(t, fixed)
            if task in QUERY_TASKS and g.query_u is not None:
                # single-node queries carry query_v == query_u, so the
                # appended trail suffix is always '<q> u v'
                t = tok.append_query(t, g.query_u, g.query_v)
            seqs.append((t, g.y))
        seqs_by_split[s] = seqs

    def split_bucket(names):
        m = max((len(t) for s in names for t, _ in seqs_by_split[s]), default=1)
        return round_up_to_bucket(min(m, max_len + 3))

    # per-split buckets (see build_ibtt_dataset): train tight, val/test shared
    buckets = {"train": split_bucket(["train"]),
               "val": split_bucket(["val", "test"]),
               "test": split_bucket(["val", "test"])}
    label_dtype = np.float32 if is_zinc else np.int32
    splits = {}
    for s in SPLITS:
        bucket = buckets[s]
        seqs = [t for t, _ in seqs_by_split[s]]
        ys = [y for _, y in seqs_by_split[s]]
        ids, mask = pad_sequences(seqs, pad_id=pad_id, max_len=bucket)
        n, l = ids.shape
        out = np.full((n, bucket), pad_id, dtype=np.int32)
        outm = np.zeros((n, bucket), dtype=bool)
        out[:, :l] = ids
        outm[:, :l] = mask
        splits[s] = {"ids": out, "mask": outm, "y": np.array(ys, dtype=label_dtype)}
    bucket = max(buckets.values())

    all_ex = [{"label": int(y)} for s in SPLITS for _, y in seqs_by_split[s]] \
        if not is_zinc else []
    num_classes = 1 if is_zinc else determine_num_classes(all_ex, task)
    q_id = tok.query_token_id if task in QUERY_TASKS else None

    n_examples_train = len(seqs_by_split["train"])
    if bool(dataset_cfg.get("pack", False)) and n_examples_train:
        splits["train"] = _pack_train_split(
            [t for t, _ in seqs_by_split["train"]],
            np.array([y for _, y in seqs_by_split["train"]], dtype=label_dtype),
            buckets["train"], pad_id, q_id, (1, 2))  # trail '<q> u v'

    return DatasetBundle(task=task, kind="tokens", splits=splits,
                         num_classes=num_classes, vocab=None,
                         vocab_size=vocab_size, q_token_id=q_id,
                         meta={"max_len": bucket, "pad_id": pad_id,
                               "idx_offset": tok.idx_offset,
                               "bos_id": bos_like, "max_nodes": max_nodes,
                               "n_examples_train": n_examples_train})


# ---------------------------------------------------------------------------
# Graph-native datasets (MPNN / GPS)
# ---------------------------------------------------------------------------

def build_graph_dataset(dataset_cfg: dict, seed: int, limit: Optional[int] = None) -> DatasetBundle:
    task = dataset_cfg["task"]
    is_zinc = task == "zinc"
    if is_zinc:
        graphs = _zinc_graphs(dataset_cfg, limit)
    else:
        graphs = _load_synthetic_graphs(dataset_cfg, seed)
        if limit:
            graphs = {s: v[:limit] for s, v in graphs.items()}

    n_max = max(g.num_nodes for s in SPLITS for g in graphs[s])
    splits = {}
    for s in SPLITS:
        gb = batch_graphs(graphs[s], n_max=n_max,
                          node_feat_mode="labels" if is_zinc else "const",
                          query_encoding=task in QUERY_TASKS,
                          label_dtype=np.float32 if is_zinc else np.int32,
                          edge_types=is_zinc)
        # adjacency stored uint8 (4x smaller on the device); the trainer
        # casts each gathered batch to f32
        splits[s] = {"node_feat": gb.node_feat, "adj": gb.adj.astype(np.uint8),
                     "mask": gb.node_mask, "y": gb.y}
        if gb.eadj is not None:
            # bond-type adjacency for edge-featured (GINE) message passing
            splits[s]["eadj"] = gb.eadj

    if is_zinc:
        num_classes = 1
    else:
        all_ex = [{"label": int(g.y)} for s in SPLITS for g in graphs[s]]
        num_classes = determine_num_classes(all_ex, task)
    in_dim = splits["train"]["node_feat"].shape[-1]
    return DatasetBundle(task=task, kind="graphs", splits=splits,
                         num_classes=num_classes, in_dim=in_dim,
                         meta={"n_max": n_max})


def build_dataset(model_name: str, dataset_cfg: dict, seed: int,
                  limit: Optional[int] = None) -> DatasetBundle:
    """The bundle of ``model_name`` for ``dataset_cfg``, from the cache when
    ``dataset.cache`` (default true) finds it there, else built and cached."""
    builders = {"ibtt": build_ibtt_dataset, "agtt": build_agtt_dataset,
                "mpnn": build_graph_dataset, "ggps": build_graph_dataset}
    if model_name not in builders:
        raise ValueError(f"unknown model {model_name!r}")
    cache = bool(dataset_cfg.get("cache", True))
    path = _cache_path(model_name, dataset_cfg, seed, limit) if cache else None
    if path is not None:
        cached = _load_bundle(path)
        if cached is not None:
            return cached
    bundle = builders[model_name](dataset_cfg, seed, limit=limit)
    if path is not None:
        try:
            _save_bundle(path, bundle)
        except OSError as e:   # a read-only data root: train uncached
            print(f"[warn] dataset cache not written: {e}")
    return bundle
