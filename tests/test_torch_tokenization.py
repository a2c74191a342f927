"""Port parity: the port's copies of the data and tokenizer modules give
byte-identical graphs, token ids and token strings to the JAX package's,
on a few hundred stand-in ZINC molecules."""

import os

import numpy as np
import pytest

from glearning_benchmark_tpu.data import text_grammar as jax_grammar
from glearning_benchmark_tpu.data import zinc as jax_zinc
from glearning_benchmark_tpu.tokenization import ibtt as jax_ibtt
from glearning_benchmark_tpu.tokenization import sent as jax_sent
from glearning_benchmark_tpu.tokenization import vocab as jax_vocab
from glearning_benchmark_tpu_torch.data import text_grammar, zinc
from glearning_benchmark_tpu_torch.tokenization import ibtt, sent, vocab
from glearning_benchmark_tpu_torch.tokenization.pack import pad_sequences

N = 300


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert ga.num_nodes == gb.num_nodes and ga.y == gb.y
        for f in ("edges", "node_labels", "edge_labels"):
            x, y = getattr(ga, f), getattr(gb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nozinc"))
    ours = zinc.load_zinc_split(root, "val", limit=N)
    ref = jax_zinc.load_zinc_split(root, "val", limit=N)
    return ours, ref


def test_standin_graphs_are_identical(graphs):
    _same_graphs(*graphs)


def test_npz_export_reads_identically(graphs, tmp_path):
    ours, ref = graphs
    jax_zinc.save_zinc_npz(str(tmp_path / "zinc_test.npz"), list(ref[:50]))
    a = zinc.load_zinc_split(str(tmp_path), "test")
    b = jax_zinc.load_zinc_split(str(tmp_path), "test")
    _same_graphs(a, b)
    for k, v in b.flat.items():
        assert a.flat[k].tobytes() == v.tobytes(), k


def test_sent_trails_are_identical(graphs):
    ours, ref = graphs
    max_nodes = max(g.num_nodes for g in ref)
    toks = []
    for mod in (sent, jax_sent):
        tok = mod.TrailTokenizer(max_length=1024, truncation_length=1024,
                                 labeled_graph=True, undirected=True)
        tok.set_num_nodes(max_nodes)
        tok.set_num_node_and_edge_types(9, 4)
        toks.append(tok)
    fixed = vocab.build_fixed_zinc_vocab()[0]
    assert fixed == jax_vocab.build_fixed_zinc_vocab()[0]
    for ga, gb in zip(ours, ref):
        a = toks[0].remap_zinc_tokens(toks[0](ga), fixed)
        b = toks[1].remap_zinc_tokens(toks[1](gb), fixed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        qa = toks[0].append_query(a, 1, 2)
        qb = toks[1].append_query(b, 1, 2)
        assert qa.tobytes() == qb.tobytes()
    assert toks[0].query_token_id == toks[1].query_token_id
    seqs = [toks[0](g) for g in ours[:40]]
    ids, mask = pad_sequences(seqs, pad_id=5, max_len=64)
    from glearning_benchmark_tpu.tokenization.pack import pad_sequences as jp
    rid, rmask = jp(seqs, pad_id=5, max_len=64)
    assert ids.tobytes() == rid.tobytes() and mask.tobytes() == rmask.tobytes()


def test_ibtt_texts_and_ids_are_identical(graphs):
    ours, ref = graphs
    texts = [ibtt.tokenize_zinc_molecule(g, max_len=1024) for g in ours]
    assert texts == [jax_ibtt.tokenize_zinc_molecule(g, max_len=1024)
                     for g in ref]
    short = [ibtt.tokenize_zinc_molecule(g, max_len=40) for g in ours[:20]]
    assert short == [jax_ibtt.tokenize_zinc_molecule(g, max_len=40)
                     for g in ref[:20]]
    fixed = vocab.build_fixed_zinc_vocab()[0]
    voc = vocab.extend_vocab_with_dynamic_tokens(
        fixed, vocab.collect_dynamic_tokens(texts, fixed))
    fixed_j = jax_vocab.build_fixed_zinc_vocab()[0]
    assert voc == jax_vocab.extend_vocab_with_dynamic_tokens(
        fixed_j, jax_vocab.collect_dynamic_tokens(texts, fixed_j))
    for max_len in (1024, 50):
        a = ibtt.encode_texts(texts, voc, max_len=max_len)
        b = jax_ibtt.encode_texts(texts, voc, max_len=max_len)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_text_records_parse_identically():
    rng = np.random.default_rng(0)
    for i in range(30):
        n = int(rng.integers(3, 12))
        edges = rng.integers(0, n, size=(int(rng.integers(1, 15)), 2))
        text = jax_grammar.graph_to_text(edges, n, "shortest_distance 0 2",
                                         f"len{1 + i % 3}")
        for task in ("shortest_path", "cycle_check"):
            a = text_grammar.text_record_to_graph(text, task)
            b = jax_grammar.text_record_to_graph(text, task)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.num_nodes, a.y, a.query_u, a.query_v) == \
                    (b.num_nodes, b.y, b.query_u, b.query_v)
                assert a.edges.tobytes() == b.edges.tobytes()


# ---------------------------------------------------------------------------
# packing and the dataset bundles (the training path)
# ---------------------------------------------------------------------------

def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("q_id", [None, 30])
def test_pack_examples_is_byte_identical(graphs, q_id):
    """pack_examples on stand-in ZINC trails (one cut by the bucket)."""
    from glearning_benchmark_tpu.tokenization import pack as jax_pack
    from glearning_benchmark_tpu_torch.tokenization import pack

    tok = jax_sent.TrailTokenizer(max_length=1024, truncation_length=1024,
                                  labeled_graph=True, undirected=True)
    tok.set_num_nodes(max(g.num_nodes for g in graphs[1]))
    tok.set_num_node_and_edge_types(jax_zinc.ZINC_NUM_ATOM_TYPES,
                                    jax_zinc.ZINC_NUM_BOND_TYPES)
    seqs = [np.asarray(tok(g)) for g in graphs[1]]
    bucket = 128                      # shorter than the longest trail
    assert max(len(s) for s in seqs) > bucket
    ref = jax_pack.pack_examples(seqs, bucket=bucket, pad_id=2, q_token_id=q_id,
                                 query_offsets=(1, 2))
    got = pack.pack_examples(seqs, bucket=bucket, pad_id=2, q_token_id=q_id,
                             query_offsets=(1, 2))
    _same_arrays(got, ref)
    for n in (1, 64, 65, 600, 641, 5000):
        assert pack.round_up_to_bucket(n) == jax_pack.round_up_to_bucket(n)


@pytest.mark.parametrize("model_name,pack", [("agtt", True), ("agtt", False),
                                             ("ibtt", True), ("ibtt", False)])
def test_zinc_bundles_are_identical(tmp_path, model_name, pack):
    """build_ibtt_dataset / build_agtt_dataset for task zinc: every array,
    the vocab and the meta equal the JAX package's."""
    from glearning_benchmark_tpu.train import datasets as jax_ds
    from glearning_benchmark_tpu_torch.train import datasets as ds

    cfg = {"task": "zinc", "zinc_root": str(tmp_path / "nozinc"),
           "subset": True, "max_len": 1024, "pack": pack}
    build = f"build_{model_name}_dataset"
    ref = getattr(jax_ds, build)(cfg, 0, limit=120)
    got = getattr(ds, build)(cfg, 0, limit=120)
    for split in ds.SPLITS:
        _same_arrays(got.splits[split], ref.splits[split])
    for field in ("task", "kind", "num_classes", "vocab", "vocab_size",
                  "q_token_id", "in_dim", "meta"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ("seg" in got.splits["train"]) == pack


def test_build_dataset_caches_and_refuses_what_is_not_ported(tmp_path):
    from glearning_benchmark_tpu_torch.train import datasets as ds

    cfg = {"task": "zinc", "zinc_root": str(tmp_path / "z"), "subset": True,
           "max_len": 1024, "pack": True}
    first = ds.build_dataset("agtt", cfg, 0, limit=40)
    path = ds._cache_path("agtt", cfg, 0, 40)
    assert (tmp_path / "z" / "processed").is_dir() and path.startswith(str(tmp_path))
    again = ds.build_dataset("agtt", cfg, 0, limit=40)     # from the cache
    for split in ds.SPLITS:
        _same_arrays(again.splits[split], first.splits[split])
    assert again.meta == first.meta
    # the graph models' ZINC bundle: dense graphs with bond types, cached
    graphs = ds.build_dataset("mpnn", cfg, 0, limit=40)
    assert graphs.kind == "graphs" and graphs.splits["train"]["eadj"].max() > 1
    assert graphs.splits["train"]["adj"].dtype == np.uint8
    assert os.path.isdir(ds._cache_path("mpnn", cfg, 0, 40))
    assert ds.build_dataset("ggps", cfg, 0, limit=40).meta == graphs.meta
    with pytest.raises(ValueError):
        ds.build_dataset("nope", cfg, 0)


def test_config_and_metrics_copies_match(tmp_path):
    from glearning_benchmark_tpu.train import metrics as jax_metrics
    from glearning_benchmark_tpu.utils import config as jax_config
    from glearning_benchmark_tpu_torch.train import metrics
    from glearning_benchmark_tpu_torch.utils import config

    for name in ("agtt_zinc", "ibtt_zinc", "gps_graph_token"):
        path = f"configs/{name}.yaml"
        assert config.normalize_config(config.load_config(path)) == \
            jax_config.normalize_config(jax_config.load_config(path))
    cm = np.random.default_rng(0).integers(0, 9, size=(4, 4))
    for task in ("cycle_check", "shortest_path", "node_degree"):
        a = metrics.classification_metrics_from_cm(cm, task, 3.0, 50.0)
        b = jax_metrics.classification_metrics_from_cm(cm, task, 3.0, 50.0)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert metrics.format_confusion_matrix(cm, task) == \
            jax_metrics.format_confusion_matrix(cm, task)
    assert metrics.regression_metrics_from_sums(1.5, 2.5, 1.5, 10.0) == \
        jax_metrics.regression_metrics_from_sums(1.5, 2.5, 1.5, 10.0)


# ---------------------------------------------------------------------------
# the corpus helpers: text encode, scalar ids, packing, batches, hashing,
# the npz writer and the stand-in flat form
# ---------------------------------------------------------------------------

def test_encode_text_and_corpus_ids_are_identical(graphs):
    ours, ref = graphs
    texts = ibtt.tokenize_zinc_corpus(ours, max_len=1024)
    assert texts == jax_ibtt.tokenize_zinc_corpus(ref, max_len=1024)
    fixed = vocab.build_fixed_zinc_vocab()[0]
    voc = vocab.extend_vocab_with_dynamic_tokens(
        fixed, vocab.collect_dynamic_tokens(texts, fixed))
    for text in texts[:30] + ["UNSEEN <bos> <p> x", ""]:
        for max_len, strip in ((1024, True), (12, True), (1024, False)):
            a = ibtt.encode_text(text, voc, max_len=max_len, strip_label=strip)
            b = jax_ibtt.encode_text(text, voc, max_len=max_len, strip_label=strip)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for max_len in (1024, 40):
        a = ibtt.tokenize_zinc_corpus_ids(ours, voc, max_len=max_len)
        b = jax_ibtt.tokenize_zinc_corpus_ids(ref, voc, max_len=max_len)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        # the scalar ids are the encoded strings, row by row
        enc = ibtt.encode_texts(ibtt.tokenize_zinc_corpus(ours, max_len=max_len), voc,
                                max_len=max_len)
        assert a[0].tobytes() == enc[0].tobytes() and a[1].tobytes() == enc[1].tobytes()


@pytest.mark.parametrize("n,bucket", [(40, True), (600, True), (600, False)])
def test_pack_corpus_is_byte_identical(n, bucket):
    """Under 512 rows the numpy path, from 512 up the native pass."""
    from glearning_benchmark_tpu.tokenization import pack as jax_pack
    from glearning_benchmark_tpu_torch.tokenization import pack

    rng = np.random.default_rng(n)
    ids = rng.integers(0, 50, size=(n, 100)).astype(np.int32)
    lens = rng.integers(1, 101, size=n).astype(np.int32)
    got = pack.pack_corpus(ids, lens, pad_id=3, bucket=bucket)
    ref = jax_pack.pack_corpus(ids, lens, pad_id=3, bucket=bucket)
    assert got[0].shape == (n, 128 if bucket else 100)
    _same_arrays({"ids": got[0], "mask": got[1]}, {"ids": ref[0], "mask": ref[1]})


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False), (True, True)])
def test_batch_iterator_is_identical(shuffle, drop):
    from glearning_benchmark_tpu.tokenization import pack as jax_pack
    from glearning_benchmark_tpu_torch.tokenization import pack

    got = list(pack.batch_iterator(103, 16, shuffle, 5, drop_remainder=drop))
    ref = list(jax_pack.batch_iterator(103, 16, shuffle, 5, drop_remainder=drop))
    assert len(got) == len(ref) == (6 if drop else 7)
    for (a, va), (b, vb) in zip(got, ref):
        assert va == vb and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_stable_token_hash_is_identical():
    from glearning_benchmark_tpu.utils import hashing as jax_hashing
    from glearning_benchmark_tpu_torch.utils import hashing

    toks = ["<bos>", "val_1_25", "C", "", "ünï"]
    a, b = hashing.stable_token_hash(toks), jax_hashing.stable_token_hash(toks)
    assert a.dtype == b.dtype == np.uint64 and a.tobytes() == b.tobytes()
    assert hashing.stable_hash("ba") == jax_hashing.stable_hash("ba")


def test_save_zinc_npz_round_trip_and_num_types(graphs, tmp_path):
    ours, ref = graphs
    zinc.save_zinc_npz(str(tmp_path / "zinc_val.npz"), list(ours[:60]))
    jax_zinc.save_zinc_npz(str(tmp_path / "ref.npz"), list(ref[:60]))
    a, b = np.load(tmp_path / "zinc_val.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    back = zinc.load_zinc_split(str(tmp_path), "val")
    _same_graphs(back, ref[:60])
    assert zinc.get_zinc_num_types() == jax_zinc.get_zinc_num_types() == (9, 4)


def test_standin_split_carries_its_flat_form(graphs):
    """A stand-in split carries the flat struct-of-arrays form, equal field
    for field to the JAX package's."""
    ours, ref = graphs
    assert ours.flat is not None and ours.flat.keys() == ref.flat.keys()
    for k, v in ref.flat.items():
        assert ours.flat[k].dtype == v.dtype and ours.flat[k].tobytes() == v.tobytes(), k
