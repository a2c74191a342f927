"""Port parity of ``tokenization/ibtt_fast.py``: the cases of
``tests/test_ibtt_fast.py`` against the port (every host path byte-exact with
the scalar path and with the JAX package's), and the torch device encoder on
the CPU equal to the JAX package's jitted ``device_encode_corpus`` on the CPU
and to ``corpus_ids_best``."""

from unittest import mock

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.tokenization import ibtt_fast as jax_fast
from glearning_benchmark_tpu_torch import native
from glearning_benchmark_tpu_torch.data.graphs import Graph
from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
from glearning_benchmark_tpu_torch.tokenization.ibtt import (tokenize_zinc_corpus_ids,
                                                             tokenize_zinc_molecule)
from glearning_benchmark_tpu_torch.tokenization.ibtt_fast import (
    _edges_lexsorted_per_mol, build_zinc_vocab_fast, corpus_ids_best,
    corpus_ids_vectorized, device_encode_corpus, device_encoder_inputs,
    flatten_zinc_corpus, make_device_encoder)
from glearning_benchmark_tpu_torch.tokenization.vocab import (
    build_fixed_zinc_vocab, collect_dynamic_tokens, extend_vocab_with_dynamic_tokens)

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _string_vocab(mols, max_len=1024):
    fixed, _ = build_fixed_zinc_vocab()
    texts = [tokenize_zinc_molecule(m, max_len=max_len) for m in mols]
    return extend_vocab_with_dynamic_tokens(fixed, collect_dynamic_tokens(texts, fixed))


def _remake(m, edges, edge_labels):
    return Graph(edges=np.asarray(edges, np.int32), num_nodes=m.num_nodes, y=m.y,
                 node_labels=m.node_labels, edge_labels=np.asarray(edge_labels, np.int32))


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _matches_scalar(fn, mols, vocab, max_len=1024):
    ids, lens = fn(mols, vocab, max_len=max_len)
    ids_s, lens_s = tokenize_zinc_corpus_ids(mols, vocab, max_len=max_len)
    np.testing.assert_array_equal(lens, lens_s)
    l = ids_s.shape[1]
    np.testing.assert_array_equal(ids[:, :l], ids_s)
    assert (ids[:, l:] == vocab["<pad>"]).all()
    return ids, lens


@pytest.fixture(scope="module")
def mols():
    return load_zinc_split(split="val", limit=200)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fast_vocab_matches_string_path_and_the_jax_package(mols, path):
    with mock.patch.object(native, "get_lib", (lambda: None) if path == "numpy"
                           else native.get_lib):
        vocab = build_zinc_vocab_fast(mols)
    assert vocab == _string_vocab(mols)
    assert vocab == jax_fast.build_zinc_vocab_fast(list(mols))


@pytest.mark.parametrize("fn", [corpus_ids_vectorized, corpus_ids_best])
def test_host_ids_match_scalar_and_the_jax_package(mols, fn):
    vocab = build_zinc_vocab_fast(mols)
    got = _matches_scalar(fn, mols, vocab)
    _same(got, getattr(jax_fast, fn.__name__)(list(mols), vocab, max_len=1024))
    _same(tokenize_zinc_corpus_ids(mols, vocab),
          jax_fast.tokenize_zinc_corpus_ids(list(mols), vocab, max_len=1024))


@pytest.mark.parametrize("max_len", [40, 60, 120])
def test_truncation_is_patched_exactly(mols, max_len):
    sub = mols[:64]
    vocab = build_zinc_vocab_fast(sub)
    for fn in (corpus_ids_vectorized, corpus_ids_best):
        ids, lens = fn(sub, vocab, max_len=max_len)
        ids_s, lens_s = tokenize_zinc_corpus_ids(sub, vocab, max_len=max_len)
        np.testing.assert_array_equal(lens, lens_s)
        np.testing.assert_array_equal(ids[:, : ids_s.shape[1]], ids_s)
        _same((ids, lens), getattr(jax_fast, fn.__name__)(sub, vocab, max_len=max_len))


def _unsorted(ms):
    m = ms[3]
    perm = np.random.default_rng(0).permutation(m.edges.shape[0])
    ms[3] = _remake(m, m.edges[perm], m.edge_labels[perm])


def _duplicate(ms):
    m = ms[2]
    ms[2] = _remake(m, np.concatenate([m.edges[:1], m.edges]),
                    np.concatenate([m.edge_labels[:1], m.edge_labels]))


def _unmirrored(ms):
    m = ms[1]
    keep = m.edges[:, 0] > m.edges[:, 1]   # reversed-direction copies only
    ms[1] = _remake(m, m.edges[keep], m.edge_labels[keep])


@pytest.mark.parametrize("breaker", [_unsorted, _duplicate, _unmirrored])
def test_gate_failures_fall_back_exactly(mols, breaker):
    """An unsorted, duplicated or unmirrored directed edge list fails the
    gate, and every path (the device encoder too) then equals the scalar
    path."""
    ms = list(mols[:8])
    breaker(ms)
    assert not _edges_lexsorted_per_mol(flatten_zinc_corpus(ms))
    vocab = _string_vocab(ms)
    assert build_zinc_vocab_fast(ms) == vocab
    for fn in (corpus_ids_vectorized, corpus_ids_best):
        _matches_scalar(fn, ms, vocab)
    ids, lens = device_encode_corpus(ms, vocab, device="cpu")
    _same((ids.numpy(), lens.numpy()), tokenize_zinc_corpus_ids(ms, vocab))


def test_native_encode_single_direction_buffer_sizing(mols):
    """Single-direction (src < dst only) lists pass the gate but keep E, not
    E/2, bonds: the native buffer is sized from the kept counts."""
    halved = [_remake(m, m.edges[m.edges[:, 0] < m.edges[:, 1]],
                      m.edge_labels[m.edges[:, 0] < m.edges[:, 1]]) for m in mols[:16]]
    assert _edges_lexsorted_per_mol(flatten_zinc_corpus(halved))
    vocab = _string_vocab(halved)
    ids_n, lens_n, trunc = native.zinc_encode_native(flatten_zinc_corpus(halved), vocab)
    ids_s, lens_s = tokenize_zinc_corpus_ids(halved, vocab)
    assert not trunc.any()
    np.testing.assert_array_equal(lens_n, lens_s)
    np.testing.assert_array_equal(ids_n[:, : ids_s.shape[1]], ids_s)
    _matches_scalar(corpus_ids_best, halved, vocab)


def test_flatten_offsets_and_the_jax_package(mols):
    flat = flatten_zinc_corpus(list(mols[:10]))
    assert flat["node_off"][-1] == sum(m.num_nodes for m in mols[:10])
    assert flat["edge_off"][-1] == sum(m.edges.shape[0] for m in mols[:10])
    assert flat["atoms"].shape[0] == flat["node_off"][-1]
    ref = jax_fast.flatten_zinc_corpus(list(mols[:10]))
    assert flat.keys() == ref.keys()
    for k in flat:
        _same((flat[k],), (ref[k],))


def test_corpus_carried_flat_reused_and_exact():
    corpus = load_zinc_split(split="val", limit=120)
    assert corpus.flat is not None and flatten_zinc_corpus(corpus) is corpus.flat
    fresh = flatten_zinc_corpus(list(corpus))
    for k in fresh:
        np.testing.assert_array_equal(corpus.flat[k], fresh[k], err_msg=k)


@pytest.mark.parametrize("what", ["y", "edge_label"])
def test_corpus_carried_flat_mutation_falls_back(what):
    """A sampled molecule replaced after load (its label, or only an edge
    label) defeats the spot-check and flatten recomputes."""
    corpus = load_zinc_split(split="val", limit=50)
    idx = (len(corpus) - 1) * 3 // 7 if what == "y" else len(corpus) - 1
    g = corpus[idx]
    el = g.edge_labels.copy()
    if what == "edge_label":
        el[0] = (el[0] % 4) + 1
    corpus[idx] = Graph(edges=g.edges, num_nodes=g.num_nodes,
                        y=g.y + (1.0 if what == "y" else 0.0),
                        node_labels=g.node_labels, edge_labels=el)
    flat = flatten_zinc_corpus(corpus)
    assert flat is not corpus.flat
    assert flat["y"][idx] == corpus[idx].y and flat["bond"][-1] == corpus[-1].edge_labels[-1]


# ---------------------------------------------------------------------------
# the device encoder
# ---------------------------------------------------------------------------

def test_device_encoder_matches_the_jax_encoder_and_corpus_ids_best(mols):
    """On 200 stand-in molecules: the torch encoder on the CPU gives the ids
    and lens of the JAX package's jitted encoder on the CPU (same width, pad
    tail included) and of corpus_ids_best over each row's lens."""
    vocab = build_zinc_vocab_fast(mols)
    ids, lens = device_encode_corpus(mols, vocab, device="cpu")
    assert ids.device.type == "cpu" and ids.dtype == lens.dtype == torch.int32
    ref_ids, ref_lens = jax_fast.device_encode_corpus(list(mols), vocab)
    _same((ids.numpy(), lens.numpy()), (np.asarray(ref_ids), np.asarray(ref_lens)))
    best_ids, best_lens = corpus_ids_best(mols, vocab)
    np.testing.assert_array_equal(lens.numpy(), best_lens)
    for i, n in enumerate(best_lens):
        np.testing.assert_array_equal(ids[i, :n].numpy(), best_ids[i, :n])
        assert (ids[i, n:] == vocab["<pad>"]).all()


def test_device_encoder_drops_invalid_and_out_of_range_writes(mols):
    """Flat arrays padded to a bucket with invalid entries, one of them
    pointing past the buffer: the writes land in the dump slot, never in
    a row, and never fault."""
    sub = list(mols[:20])
    vocab = build_zinc_vocab_fast(sub)
    flat = flatten_zinc_corpus(sub)
    l_max, max_nodes, args = device_encoder_inputs(flat)
    want = make_device_encoder(l_max, vocab, max_nodes, "cpu")(*args)
    (n, node_off, atoms, mol_of_atom, ku, kv, kb, mol_of_kept, kept_counts, kept_off,
     atom_valid, kept_valid) = args
    big = len(sub) + 5          # a molecule index past the batch

    def padded(t, fill, k=7):
        return torch.cat([t, torch.full((k,), fill, dtype=t.dtype)])

    got = make_device_encoder(l_max, vocab, max_nodes, "cpu")(
        n, node_off, padded(atoms, 1), padded(mol_of_atom, big), padded(ku, 1),
        padded(kv, 2), padded(kb, 1), padded(mol_of_kept, 0), kept_counts, kept_off,
        padded(atom_valid, False), padded(kept_valid, False))
    _same((got[0].numpy(), got[1].numpy()), (want[0].numpy(), want[1].numpy()))
