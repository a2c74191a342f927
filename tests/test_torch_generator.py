"""Port parity: the synthetic graph-token corpora, their loaders, the dense
graph batches and the synthetic dataset bundles, CPU.

- ``data/generator.py``: the port and the JAX package write the same
  corpus, byte for byte (file names, JSON text, ``.complete`` stamps), for
  all seven algorithms, ``cycle_check``, ``shortest_path`` and two extended
  tasks, a few graphs each, at the default difficulty and at ``hard``.
- ``data/loader.py``: ``load_examples_multi_algorithm`` and
  ``load_graphs_multi_algorithm`` give equal examples and graphs, with
  ``num_graphs`` and ``num_pairs_per_graph`` sampling on; class detection,
  class balancing and the split-path helpers agree.
- ``data/graphs.py``: ``batch_graphs`` gives equal arrays, with the query
  encoding and the edge-type matrix ``eadj``.
- ``train/datasets.py``: the synthetic IBTT, AGTT (packed and unpacked)
  and graph bundles are equal array by array.
"""

import glob
import os

import numpy as np
import pytest

from glearning_benchmark_tpu.data import generator as jax_generator
from glearning_benchmark_tpu.data import graphs as jax_graphs
from glearning_benchmark_tpu.data import loader as jax_loader
from glearning_benchmark_tpu.data import text_grammar as jax_grammar
from glearning_benchmark_tpu.tokenization import vocab as jax_vocab
from glearning_benchmark_tpu.train import datasets as jax_datasets
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.data import generator, graphs, loader, text_grammar
from glearning_benchmark_tpu_torch.tokenization import vocab
from glearning_benchmark_tpu_torch.train import datasets

TRAIN_ALGOS = ["ba", "sbm"]
TEST_ALGO = "sfn"
N_GRAPHS, N_TEST = 12, 6


def _files(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)
                       + glob.glob(os.path.join(root, "**", ".complete"),
                                   recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("difficulty", [None, "hard"])
def test_corpus_is_byte_identical(tmp_path, difficulty):
    tasks = ("cycle_check", "shortest_path", "node_degree", "maximum_flow")
    for mod, side in ((generator, "port"), (jax_generator, "jax")):
        mod.ensure_corpus(str(tmp_path / side), tasks=tasks,
                          algorithms=mod.ALGORITHMS, difficulty=difficulty,
                          number_of_graphs=3, test_graphs=2, seed=99)
    ours, ref = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    # 7 algorithms x 4 tasks x 3 splits, each with its stamp
    assert sum(name.endswith(".complete") for name in ref) == 7 * 4 * 3
    assert len(ref) == 7 * 4 * (3 + 2 + 2 + 3)
    assert sorted(ours) == sorted(ref)
    for name, data in ref.items():
        assert ours[name] == data, name
    assert generator.GENERATOR_VERSION == jax_generator.GENERATOR_VERSION == 4
    assert generator.TASKS == jax_generator.TASKS
    assert generator.DIFFICULTY_PLANS == jax_generator.DIFFICULTY_PLANS


def test_generated_graphs_and_seeds_match():
    for algo in generator.ALGORITHMS:
        for i in range(4):
            seed = generator.graph_seed(5, algo, "val", i)
            assert seed == jax_generator.graph_seed(5, algo, "val", i)
            a = generator.generate_graph(algo, seed, size_buckets=("large",))
            b = jax_generator.generate_graph(algo, seed, size_buckets=("large",))
            assert a.num_nodes == b.num_nodes
            assert a.edges.dtype == b.edges.dtype and a.edges.tobytes() == b.edges.tobytes()
            np.testing.assert_array_equal(a.degrees(), b.degrees())
            np.testing.assert_array_equal(a.adjacency(60), b.adjacency(60))
            assert text_grammar.graph_to_text(a.edges, a.num_nodes, "q", "l") == \
                jax_grammar.graph_to_text(b.edges, b.num_nodes, "q", "l")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small corpus of the configs' algorithms (train ba+sbm, test sfn),
    both tasks, written by the port."""
    root = str(tmp_path_factory.mktemp("gt") / "graph-token")
    generator.ensure_corpus(root, tasks=("cycle_check", "shortest_path"),
                            algorithms=TRAIN_ALGOS + [TEST_ALGO],
                            number_of_graphs=N_GRAPHS, test_graphs=N_TEST)
    return root


def _same_examples(a, b):
    assert len(a) == len(b) and len(a) > 0
    for ea, eb in zip(a, b):
        assert ea == eb


def _same_graph_lists(a, b):
    assert len(a) == len(b) and len(a) > 0
    for ga, gb in zip(a, b):
        assert (ga.num_nodes, ga.y, ga.query_u, ga.query_v) == \
            (gb.num_nodes, gb.y, gb.query_u, gb.query_v)
        assert ga.edges.tobytes() == gb.edges.tobytes()


@pytest.mark.parametrize("task", ["cycle_check", "shortest_path"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_multi_algorithm_loaders_match(corpus, task, split):
    kw = dict(use_split_tasks_dirs=True, seed=3, num_graphs=7, num_pairs_per_graph=5)
    algos = [TEST_ALGO] if split == "test" else TRAIN_ALGOS
    ex = loader.load_examples_multi_algorithm(corpus, task, algos, split, **kw)
    ref = jax_loader.load_examples_multi_algorithm(corpus, task, algos, split, **kw)
    _same_examples(ex, ref)
    n_files = min(7, N_GRAPHS if split == "train" else N_TEST)
    if task == "shortest_path":
        assert len(ex) == len(algos) * n_files * 5     # pairs sampled per file
        assert all("query_u" in e for e in ex)
    else:
        assert len(ex) == len(algos) * n_files
    _same_graph_lists(
        loader.load_graphs_multi_algorithm(corpus, task, algos, split, **kw),
        jax_loader.load_graphs_multi_algorithm(corpus, task, algos, split, **kw))
    # no sampling: every record of every file
    full = loader.load_examples_multi_algorithm(corpus, task, algos, split)
    _same_examples(full, jax_loader.load_examples_multi_algorithm(corpus, task, algos, split))
    assert loader.determine_num_classes(full, task) == \
        jax_loader.determine_num_classes(full, task)


def test_split_paths_classes_and_balancing_match(corpus):
    for use_split in (True, False):
        for split in ("train", "val", "test"):
            assert loader.resolve_split_dir(corpus, "cycle_check", "ba", split, use_split) \
                == jax_loader.resolve_split_dir(corpus, "cycle_check", "ba", split, use_split)
        assert loader.resolve_split_globs(corpus, "shortest_path", "sbm", use_split) == \
            jax_loader.resolve_split_globs(corpus, "shortest_path", "sbm", use_split)
        assert loader.resolve_multi_algorithm_globs(
            corpus, "cycle_check", TRAIN_ALGOS, TEST_ALGO, use_split) == \
            jax_loader.resolve_multi_algorithm_globs(
                corpus, "cycle_check", TRAIN_ALGOS, TEST_ALGO, use_split)
    ex = loader.load_examples_multi_algorithm(corpus, "shortest_path", TRAIN_ALGOS, "train",
                                              num_pairs_per_graph=20, seed=1)
    ex = [e for e in ex if e["label"] is not None]
    for strategy in ("undersample", "median", "oversample", "soft_oversample"):
        _same_examples(loader.balance_classes(ex, strategy, seed=4),
                       jax_loader.balance_classes(ex, strategy, seed=4))
    gs = loader.load_graphs_multi_algorithm(corpus, "shortest_path", TRAIN_ALGOS, "train",
                                            num_pairs_per_graph=20, seed=1)
    for strategy in ("undersample", "median"):
        assert loader.get_balanced_indices(gs, strategy, seed=2) == \
            jax_loader.get_balanced_indices(gs, strategy, seed=2)
    assert loader.determine_num_classes_graphs(gs, "shortest_path") == \
        jax_loader.determine_num_classes_graphs(gs, "shortest_path")
    texts = [e["text"] for e in ex]
    for kw in ({}, {"min_freq": 3}, {"max_tokens": 30}):
        assert vocab.build_vocab_from_texts(texts, **kw) == \
            jax_vocab.build_vocab_from_texts(texts, **kw)


def test_connected_nodes_loader_matches(tmp_path):
    import json
    rng = np.random.default_rng(0)
    for i in range(9):
        rec = {"text": f"<bos> 0 1 <e> <n> 0 1 2 graph {i}",
               ["u", "src", "pair"][i % 3]: [0, 2] if i % 3 == 2 else 0,
               "label": ["yes", "no", True, 0][i % 4]}
        if i % 3 != 2:
            rec["v" if i % 3 == 0 else "dst"] = int(rng.integers(1, 3))
        (tmp_path / f"g{i}.json").write_text(json.dumps([rec]))
    pattern = str(tmp_path / "*.json")
    for frac in (1.0, 0.5):
        _same_examples(loader.load_examples_connected_nodes(pattern, frac, seed=2),
                       jax_loader.load_examples_connected_nodes(pattern, frac, seed=2))


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("task,query", [("shortest_path", True), ("cycle_check", False)])
def test_batch_graphs_matches(corpus, task, query):
    gs = loader.load_graphs_multi_algorithm(corpus, task, TRAIN_ALGOS, "val",
                                            num_pairs_per_graph=3)
    rgs = jax_loader.load_graphs_multi_algorithm(corpus, task, TRAIN_ALGOS, "val",
                                                 num_pairs_per_graph=3)
    # every third graph with bond types, so eadj holds types other than 1
    labelled = [g if i % 3 else type(g)(edges=g.edges, num_nodes=g.num_nodes, y=g.y,
                                         edge_labels=(np.arange(g.num_edges) % 4 + 1
                                                      ).astype(np.int32),
                                         query_u=g.query_u, query_v=g.query_v)
                for i, g in enumerate(gs)]
    rlabelled = [jax_graphs.Graph(**vars(g)) for g in labelled]
    n_max = max(g.num_nodes for g in gs) + 3
    for mode in ("const", "labels"):
        a = graphs.batch_graphs(labelled, n_max=n_max, node_feat_mode=mode,
                                query_encoding=query, edge_types=True)
        b = jax_graphs.batch_graphs(rlabelled, n_max=n_max, node_feat_mode=mode,
                                    query_encoding=query, edge_types=True)
        _same_arrays({k: v for k, v in vars(a).items() if v is not None},
                     {k: v for k, v in vars(b).items() if v is not None})
        assert a.eadj.max() == 4 and (a.query_u is not None) == query
    a = graphs.batch_graphs(gs)
    b = jax_graphs.batch_graphs(rgs)
    assert a.eadj is None and a.adj.shape == b.adj.shape
    assert a.node_feat.tobytes() == b.node_feat.tobytes()
    assert graphs.pad_graphs(gs) == jax_graphs.pad_graphs(rgs)
    with pytest.raises(ValueError):
        graphs.pad_graphs(gs, n_max=2)


def _cfg(corpus, task, **extra):
    return {"task": task, "graph_token_root": corpus, "train_algorithms": TRAIN_ALGOS,
            "test_algorithm": TEST_ALGO, "use_split_tasks_dirs": True,
            "num_graphs": 10, "num_pairs_per_graph": 4, "max_len": 600,
            "generate_num_graphs": N_GRAPHS, "cache": False, **extra}


@pytest.mark.parametrize("model_name,task,pack", [
    ("ibtt", "cycle_check", True), ("ibtt", "shortest_path", False),
    ("agtt", "cycle_check", False), ("agtt", "shortest_path", True),
    ("mpnn", "cycle_check", False), ("ggps", "shortest_path", False)])
def test_synthetic_bundles_are_identical(corpus, model_name, task, pack):
    cfg = _cfg(corpus, task, pack=pack, max_vocab=600)
    got = datasets.build_dataset(model_name, cfg, 0)
    ref = jax_trainer.build_dataset(model_name, cfg, 0)
    assert got.kind == ref.kind == ("graphs" if model_name in ("mpnn", "ggps") else "tokens")
    for split in datasets.SPLITS:
        _same_arrays(got.splits[split], ref.splits[split])
        assert got.n(split) > 0
    for field in ("task", "num_classes", "vocab", "vocab_size", "q_token_id", "in_dim",
                  "meta"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ("seg" in got.splits["train"]) == pack
    if got.kind == "graphs":
        assert got.splits["train"]["adj"].dtype == np.uint8
        assert got.in_dim == (3 if task == "shortest_path" else 1)
    assert datasets.QUERY_TASKS == jax_datasets.QUERY_TASKS


def test_missing_corpus_is_generated_and_cached(tmp_path):
    """A config whose root holds no corpus generates it (the default root
    stamps, or ``<root>-<difficulty>``) and caches the bundle."""
    root = str(tmp_path / "graph-token")
    cfg = _cfg(root, "cycle_check", generate_num_graphs=4, cache=True,
               train_algorithms=["path"], test_algorithm="star")
    first = datasets.build_dataset("mpnn", cfg, 0, limit=20)
    stamp = os.path.join(root, "tasks_train", "cycle_check", "path", "train", ".complete")
    with open(stamp) as f:
        assert f.read().startswith("ok v4 n=4/50 seed=1234")
    assert os.path.isdir(os.path.join(root, "processed"))
    again = datasets.build_dataset("mpnn", cfg, 0, limit=20)
    for split in datasets.SPLITS:
        _same_arrays(again.splits[split], first.splits[split])
    # num_graphs samples 10 of each split's 50 files; the train split has 4
    assert (first.n("train"), first.n("val"), first.n("test")) == (4, 10, 10)
    hard = datasets.build_dataset("mpnn", dict(cfg, difficulty="hard", cache=False), 0,
                                  limit=5)
    assert os.path.isdir(root + "-hard") and hard.n("train") == 4
