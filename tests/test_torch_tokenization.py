"""Port parity: the port's copies of the data and tokenizer modules give
byte-identical graphs, token ids and token strings to the JAX package's,
on a few hundred stand-in ZINC molecules."""

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
