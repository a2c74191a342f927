"""Port parity of the native host bridge (``glearning_benchmark_tpu_torch.
native``): the cases of ``tests/test_native.py`` against the port's bridge,
each entry point's output equal to the JAX package's on both its native and
its Python path, the C++ copies byte-identical to ``native/*.cpp``, and
builds from two processes at once."""

import ctypes
import hashlib
import pathlib
import random
import struct
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from glearning_benchmark_tpu import native as jax_native
from glearning_benchmark_tpu.data import loader as jax_loader
from glearning_benchmark_tpu.tokenization import sent as jax_sent
from glearning_benchmark_tpu_torch import native
from glearning_benchmark_tpu_torch.data import generator as G
from glearning_benchmark_tpu_torch.data import loader
from glearning_benchmark_tpu_torch.data.graphs import Graph
from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
from glearning_benchmark_tpu_torch.tokenization import ibtt_fast
from glearning_benchmark_tpu_torch.tokenization.ibtt import encode_texts
from glearning_benchmark_tpu_torch.tokenization.sent import TrailTokenizer
from glearning_benchmark_tpu_torch.tokenization.vocab import build_vocab_from_texts

REPO = pathlib.Path(__file__).resolve().parent.parent


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        else:
            assert x == y


def test_libraries_build_and_load():
    assert native.available() and native.gstats_available()
    assert set(native.build_seconds()) == {"gtok", "gstats"}
    assert jax_native.available() and jax_native.gstats_available()


@pytest.mark.parametrize("name", ["gtok", "gstats"])
def test_sources_are_byte_identical_to_the_repo_root(name):
    ours = pathlib.Path(native.SOURCES[name])
    assert ours.parent == REPO / "glearning_benchmark_tpu_torch" / "csrc" / "host"
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (ours, REPO / "native" / f"{name}.cpp")]
    assert digest[0] == digest[1]


_BUILD_AND_LOAD = """
import ctypes, sys
from glearning_benchmark_tpu_torch import native
path = native.build("gtok", build_dir=sys.argv[1])
lib = ctypes.CDLL(path)
assert hasattr(lib, "gtok_fmt_2f")
print(path)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes find no library and compile the same one at once: each
    writes a temporary file of its own and renames it into place, so both
    load a whole library and nothing else is left behind."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [pathlib.Path(paths.pop()).name]


# ---------------------------------------------------------------------------
# SENT trails
# ---------------------------------------------------------------------------

def _adversarial_graphs():
    """Random graphs stressing the walker's scratch reuse: duplicate and
    mirrored edges, isolated nodes, several components, n = 1."""
    rng = np.random.default_rng(7)
    graphs = []
    for trial in range(60):
        n = int(rng.integers(1, 60))
        e = int(rng.integers(0, max(1, n * 3)))
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        keep = src != dst
        edges = np.stack([src[keep], dst[keep]], 1).astype(np.int32)
        if len(edges) and trial % 3 == 0:
            edges = np.concatenate([edges, edges[::-1][:, ::-1], edges[:3]])
        graphs.append(Graph(edges=edges, num_nodes=n, y=0.0,
                            node_labels=rng.integers(0, 9, n).astype(np.int32),
                            edge_labels=rng.integers(1, 5, len(edges)).astype(np.int32)))
    return graphs


def _sent_case(case):
    if case == "unlabeled":
        return ([G.generate_graph(a, s) for a in ("er", "ba", "sbm", "path", "star",
                                                  "complete") for s in range(5)],
                600, False)
    if case == "labeled_zinc":
        return load_zinc_split(split="val", limit=60), 1024, True
    if case == "truncated":
        return [G.generate_graph("complete", 5)], 16, False
    graphs = _adversarial_graphs()
    return graphs, 700, case == "adversarial_labeled"


@pytest.mark.parametrize("case", ["unlabeled", "labeled_zinc", "truncated",
                                  "adversarial_unlabeled", "adversarial_labeled"])
def test_sent_native_matches_python_and_the_jax_package(case):
    graphs, max_len, labeled = _sent_case(case)
    toks = []
    for mod in (TrailTokenizer, jax_sent.TrailTokenizer):
        tok = mod(max_length=max_len, truncation_length=max_len, labeled_graph=labeled)
        tok.set_num_nodes(max(g.num_nodes for g in graphs))
        if labeled:
            tok.set_num_node_and_edge_types(9, 4)
        toks.append(tok)
    kw = dict(labeled=labeled)
    if labeled:
        kw.update(node_idx_offset=toks[0].node_idx_offset,
                  edge_idx_offset=toks[0].edge_idx_offset)
    ids, lens = native.sent_tokenize_batch_native(graphs, toks[0].idx_offset, max_len, **kw)
    _same((ids, lens), jax_native.sent_tokenize_batch_native(
        graphs, toks[1].idx_offset, max_len, **kw))
    for i, g in enumerate(graphs):
        want = toks[0](g)
        np.testing.assert_array_equal(want, ids[i, : lens[i]])
        np.testing.assert_array_equal(toks[1](g), want)
        assert (ids[i, lens[i]:] == TrailTokenizer.pad).all()
        assert lens[i] <= max_len


# ---------------------------------------------------------------------------
# whole-corpus text encoding
# ---------------------------------------------------------------------------

def _encode_case(case):
    if case == "cycle_texts":
        graphs = [G.generate_graph(a, s) for a in ("er", "ba") for s in range(10)]
        texts = [G.cycle_check_records(g)[0]["text"] for g in graphs]
        return texts, build_vocab_from_texts(texts)[0], 600
    vocab = build_vocab_from_texts(["a b c <p> yes <eos>"])[0]
    if case == "oov_and_strip":
        return ["UNSEEN a <p> yes <eos>"], vocab, 10
    if case == "whitespace_classes":
        # Python str.split() breaks on \r \v \f and 0x1c-0x1f too
        return ["a\rb \tc <p> yes", "a\x0bb\x0cc", "a\x1cb\x1dc\x1eb\x1fa", "a b c",
                "a b"], vocab, 16
    return ["a b c", "b a"], vocab, 16   # non-ASCII: the exact scalar path


@pytest.mark.parametrize("case", ["cycle_texts", "oov_and_strip", "whitespace_classes",
                                  "non_ascii"])
def test_encode_native_matches_python_and_the_jax_package(case):
    texts, vocab, max_len = _encode_case(case)
    ids_p, lens_p = encode_texts(texts, vocab, max_len=max_len)
    ids_n, lens_n = native.encode_texts_native(texts, vocab, max_len=max_len)
    np.testing.assert_array_equal(lens_p, lens_n)
    np.testing.assert_array_equal(ids_p, ids_n[:, : ids_p.shape[1]])
    _same((ids_n, lens_n), jax_native.encode_texts_native(texts, vocab, max_len=max_len))
    if case == "oov_and_strip":
        assert lens_n[0] == 3 and ids_n[0, 0] == vocab["<pad>"] and ids_n[0, 2] == vocab["<p>"]


def test_encode_native_prebuilt_vocab_handle():
    vocab, _ = build_vocab_from_texts(["a b <p> yes <eos>"])
    nv = native.NativeVocab(vocab)
    texts = ["a b <p> yes <eos>", "b a a <p> no"]
    want = native.encode_texts_native(texts, vocab, max_len=10)
    for _ in range(2):  # twice: the handle must survive reuse
        _same(native.encode_texts_native(texts, nv, max_len=10), want)
    with pytest.raises(ValueError):
        native.encode_texts_native(["a b"], nv, max_len=10)


# ---------------------------------------------------------------------------
# corpus scanner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_corpus")
    G.generate_corpus(str(root), tasks=("cycle_check", "shortest_path"),
                      algorithms=("ba", "path", "er"), number_of_graphs=15)
    return root


def _load_three_ways(root, task, algos, split, **kw):
    """The port's loader with the native scan, the port's loader on the
    Python path, and the JAX package's loader."""
    fast = loader.load_examples_multi_algorithm(str(root), task, algos, split, **kw)
    with mock.patch.object(native, "get_lib", lambda: None):
        assert not native.available()
        slow = loader.load_examples_multi_algorithm(str(root), task, algos, split, **kw)
    ref = jax_loader.load_examples_multi_algorithm(str(root), task, algos, split, **kw)
    return fast, slow, ref


@pytest.mark.parametrize("task,algos,split,kw", [
    ("cycle_check", ["ba", "er"], "train", {"seed": 3}),
    ("shortest_path", ["path", "er"], "train", {"seed": 0, "num_pairs_per_graph": 10}),
    ("shortest_path", ["path", "er"], "train", {"seed": 7, "num_pairs_per_graph": 10}),
    ("shortest_path", ["path"], "val", {"seed": 1}),
])
def test_corpus_scan_matches_python_and_the_jax_package(scan_corpus, task, algos, split, kw):
    """Pair sampling picks the same records in the same order (the same RNG
    stream), INF (label None) entries included."""
    fast, slow, ref = _load_three_ways(scan_corpus, task, algos, split, **kw)
    assert fast == slow == ref and len(fast) > 0
    files = sorted((scan_corpus / "tasks_train" / task / algos[0] / "train").glob("*.json"))
    _same(native.scan_corpus_file(str(files[0]), task),
          jax_native.scan_corpus_file(str(files[0]), task))
    if "num_pairs_per_graph" in kw:
        assert any(e["label"] is None for e in fast)
    if task == "cycle_check":
        assert len(fast) == 30


def test_corpus_scan_strict_gate_falls_back(tmp_path):
    """Files outside the strict generator layout scan to None, and the
    Python reader takes them."""
    cases = {
        "jsonl.json": '{"text": "<bos> 0 1 <e> <q> has_cycle <p> yes <eos>"}\n'
                      '{"text": "<bos> <q> has_cycle <p> no <eos>"}',
        "extra_key.json": '[{"text": "<bos> <q> has_cycle <p> yes <eos>", "label": 1}]',
        "escape.json": '[{"text": "a \\u003cp> yes"}]',
        "nonascii.json": '[{"text": "café yes"}]',
        "raw.json": "<bos> 0 1 <e> <q> has_cycle <p> yes <eos>",
    }
    for name, content in cases.items():
        fp = tmp_path / name
        fp.write_text(content)
        assert loader._scan_file_native(str(fp), "cycle_check") is None, name
        assert jax_loader._scan_file_native(str(fp), "cycle_check") is None, name
    ex = loader.load_examples(str(tmp_path / "*.json"), task="cycle_check")
    assert len(ex) == 6 and all(e["label"] in (0, 1) for e in ex)
    assert ex == jax_loader.load_examples(str(tmp_path / "*.json"), task="cycle_check")


def test_corpus_scan_accepts_strict_and_strips(tmp_path):
    fp = tmp_path / "g.json"
    fp.write_text('[{"text": "  <bos> 0 1 <e> <n> 0 1 '
                  '<q> shortest_distance 0 1 <p> len1 <eos>  "},'
                  ' {"text": "<bos> <n> 0 <q> shortest_distance 0 0 <p> INF <eos>"}]')
    assert loader._scan_file_native(str(fp), "shortest_path") is not None
    ex = loader.load_examples(str(tmp_path / "*.json"), task="shortest_path")
    assert ex[0]["text"].startswith("<bos>") and ex[0]["text"].endswith("<eos>")
    assert ex[0]["label"] == 0 and ex[0]["query_u"] == 0 and ex[0]["query_v"] == 1
    assert ex[1]["label"] is None
    assert ex == jax_loader.load_examples(str(tmp_path / "*.json"), task="shortest_path")


# ---------------------------------------------------------------------------
# the ZINC fast-path gate, packing, the vocab stream, the label formatter
# ---------------------------------------------------------------------------

def _gate_case(n_nodes, src, dst, off):
    return dict(n_nodes=np.asarray(n_nodes), src=np.asarray(src, np.int64),
                dst=np.asarray(dst, np.int64), edge_off=np.asarray(off, np.int64))


GATE_CASES = {
    "pass": ([3], [0, 1, 1, 2], [1, 0, 2, 1], [0, 4]),
    "self_loop": ([2], [0, 1], [0, 1], [0, 2]),
    "no_forward_mirror": ([3], [2], [0], [0, 1]),
    "duplicate_directed": ([3], [0, 0, 1, 1], [1, 1, 0, 0], [0, 4]),
    "unsorted": ([3], [1, 0], [0, 1], [0, 2]),
    "second_mol_misses": ([2, 3], [0, 1, 0, 2], [1, 0, 1, 1], [0, 2, 4]),
    "ring_no_mirror": ([4], [0, 1, 2, 3], [1, 2, 3, 0], [0, 4]),
    "empty": ([2], [], [], [0, 0]),
    "trailing_empty": ([3, 1], [0, 1, 1, 2], [1, 0, 2, 1], [0, 4, 4]),
    "two_trailing_empty": ([3, 1, 1], [0, 1, 1, 2], [1, 0, 2, 1], [0, 4, 4, 4]),
    "leading_empty": ([1, 3], [0, 1, 1, 2], [1, 0, 2, 1], [0, 0, 4]),
    "empty_and_unsorted": ([3, 1], [1, 0, 1, 2], [0, 1, 2, 1], [0, 4, 4]),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_edges_lexsorted_gate_native_matches_numpy(case):
    """gtok_edges_lexsorted agrees with the numpy gate on every accept and
    reject class, and with the JAX package's."""
    c = _gate_case(*GATE_CASES[case])
    got = native.edges_lexsorted_native(dict(c))
    assert got == jax_native.edges_lexsorted_native(dict(c))
    with mock.patch.object(native, "get_lib", lambda: None):
        assert ibtt_fast._edges_lexsorted_per_mol(dict(c)) == got


@pytest.mark.parametrize("n,l,lb", [(700, 37, 64), (2, 6, 8)])
def test_pack_ids_native_matches_numpy(n, l, lb):
    """gtok_pack_ids == pack_corpus's numpy semantics (pad tail, bool mask
    from lens), lens beyond the bucket clamped, negative lens all False."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 99, size=(n, l)).astype(np.int32)
    lens = rng.integers(0, l + 1, size=n).astype(np.int32)
    lens[0] = lb + 5
    lens[-1] = -3
    out, mask = native.pack_ids_native(ids, lens, lb, pad_id=7)
    ref = np.full((n, lb), 7, dtype=np.int32)
    ref[:, :l] = ids
    _same((out, mask), (ref, np.arange(lb)[None, :] < lens[:, None]))
    _same((out, mask), jax_native.pack_ids_native(ids, lens, lb, pad_id=7))
    assert mask[0].all() and not mask[-1].any()


def test_zinc_native_threaded_matches_sequential_and_the_jax_package(monkeypatch):
    """The threaded molecule shards write disjoint rows: GTOK_THREADS=4 is
    bit-identical to GTOK_THREADS=1, and to the JAX package's library."""
    mols = load_zinc_split(split="val", limit=100)
    vocab = ibtt_fast.build_zinc_vocab_fast(mols, flat=ibtt_fast.flatten_zinc_corpus(list(mols)))
    big_flat = ibtt_fast.flatten_zinc_corpus(list(mols) * 40)
    runs = []
    for threads in ("4", "1"):
        monkeypatch.setenv("GTOK_THREADS", threads)
        runs.append((native.zinc_encode_native(dict(big_flat), vocab, max_len=1024),
                     native.zinc_vocab_stream_native(dict(big_flat))))
    ref = (jax_native.zinc_encode_native(dict(big_flat), vocab, max_len=1024),
           jax_native.zinc_vocab_stream_native(dict(big_flat)))
    for (enc, stream) in runs[1:] + [ref]:
        _same(enc, runs[0][0])
        _same(stream, runs[0][1])


def test_zinc_vocab_stream_out_of_range_node_errors():
    """An edge to a node index beyond the corpus max makes the stream raise,
    and build_zinc_vocab_fast then takes its numpy path, as the JAX
    package's does."""
    flat = {
        "n_nodes": np.array([3], dtype=np.int64),
        "n_edges": np.array([2], dtype=np.int64),
        "node_off": np.array([0, 3], dtype=np.int64),
        "edge_off": np.array([0, 2], dtype=np.int64),
        "atoms": np.zeros(3, dtype=np.int64),
        "src": np.array([0, 1], dtype=np.int64),
        "dst": np.array([99, 2], dtype=np.int64),
        "bond": np.ones(2, dtype=np.int64),
        "y": np.zeros(1, dtype=np.float64),
    }
    with pytest.raises(RuntimeError):
        native.zinc_vocab_stream_native(flat)


def _fmt_cases():
    rng = random.Random(0)
    cases = [rng.uniform(-300, 300) for _ in range(300)]
    cases += [rng.uniform(-3, 3) for _ in range(300)]
    for k in range(-300, 300):          # decimal ties x.xx5, multiples of 0.005
        cases += [k / 100 + 0.005, k * 0.005]
    for e in range(-10, 17):            # magnitudes across the fast path's guard
        cases += [rng.uniform(-1, 1) * 10**e for _ in range(20)]
    for _ in range(500):                # random finite bit patterns
        y = struct.unpack("<d", struct.pack("<Q", rng.getrandbits(64)))[0]
        if y == y and abs(y) != float("inf"):
            cases.append(y)
    return cases + [0.0, -0.0, -0.001, 0.125, -0.125, 2.675, -2.675, 1e15, -1e15,
                    2.0e13, -2.0e13, float("nan"), float("inf"), float("-inf")]


def test_fast_fmt_2f_matches_python():
    """The native "%.2f" (the ZINC label contract) is byte-equal to
    Python's f"{y:.2f}" and takes its fast path on the common range."""
    lib = native.get_lib()
    buf = ctypes.create_string_buffer(1024)
    cases = _fmt_cases()
    n_fast = 0
    for y in cases:
        r = lib.gtok_fmt_2f(y, buf, 1024)
        assert buf.value.decode() == f"{y:.2f}", repr(y)
        n_fast += r == 1
    assert n_fast > len(cases) // 3
