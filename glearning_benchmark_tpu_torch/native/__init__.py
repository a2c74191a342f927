"""ctypes bindings to the native host tokenization core.

Port of ``glearning_benchmark_tpu/native/__init__.py``: every entry point
with the reference's signature and argtypes, over the package's own copies
of ``native/gtok.cpp`` and ``native/gstats.cpp`` (``csrc/host/``; a test
holds them byte-identical to the repo-root sources). The callers check
:func:`available` / :func:`gstats_available` and take their Python path
when it is False, as the reference's do.

Each library is built with g++ (``native/Makefile``'s flags) at first use
into ``_build/`` beside the package, named by a sha256 of its source, the
flags and the CPU that ``-march=native`` resolves to, through the same
build helper as the CUDA kernels (``utils/build.py``: a temporary file,
then an atomic rename, so processes that build at once are safe). A failed
build logs the compiler's stderr once and leaves the library unavailable;
an error of a native call raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.build import BUILD_DIR, compile_library, library_path

_HOST_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "csrc", "host")
SOURCES = {name: os.path.join(_HOST_SRC, f"{name}.cpp") for name in ("gtok", "gstats")}
# native/Makefile's compiler and CXXFLAGS, plus -shared
CXX = "g++"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-pthread", "-shared"]

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_build_seconds: Dict[str, float] = {}
_lock = threading.Lock()      # the corpus loader scans files from threads


@functools.lru_cache(maxsize=None)
def _native_arch() -> bytes:
    """What ``-march=native`` resolves to on this host (g++'s own report),
    so a library built for one CPU is never loaded on another."""
    out = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.strip().startswith(("-march=", "-mtune="))]
    return "\n".join(lines).encode()


def build(name: str, build_dir: Path = BUILD_DIR) -> str:
    """Path of the library of ``SOURCES[name]``, compiled if no library of
    the same source, flags and CPU is in ``build_dir`` yet."""
    with open(SOURCES[name], "rb") as f:
        source = f.read()
    lib = library_path(name, [source, " ".join(CXXFLAGS).encode(), _native_arch()],
                       Path(build_dir))
    if not lib.is_file():
        secs, _ = compile_library([CXX] + CXXFLAGS + [SOURCES[name]], lib)
        _build_seconds[name] = secs
    return str(lib)


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The bound library ``name``, built at first use; None (after logging
    why, once) when it cannot be built or loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(build(name))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"[native] lib{name} unavailable, Python paths used instead: {e}",
                  file=sys.stderr)
            lib = None
        if lib is not None:
            (_bind_gtok if name == "gtok" else _bind_gstats)(lib)
        _libs[name] = lib
        return lib


def build_seconds() -> Dict[str, float]:
    """Build (or find) and bind both libraries; g++ seconds per library,
    0.0 for one that was already built."""
    for name in SOURCES:
        _load(name)
    return {name: _build_seconds.get(name, 0.0) for name in SOURCES}


def _bind_gtok(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gtok_vocab_create.restype = ctypes.c_void_p
    lib.gtok_vocab_create.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int32, i32p]
    lib.gtok_vocab_free.argtypes = [ctypes.c_void_p]
    lib.gtok_encode_texts.restype = ctypes.c_int32
    lib.gtok_encode_texts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    lib.gtok_sent_tokenize_batch.restype = ctypes.c_int32
    lib.gtok_sent_tokenize_batch.argtypes = [
        i32p, i32p, i32p, i64p, i32p, i32p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gtok_zinc_encode.restype = ctypes.c_int32
    lib.gtok_zinc_encode.argtypes = [
        i32p, i64p, i32p, i32p, i32p, i64p, ctypes.c_int32,
        i32p, i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u8p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gtok_zinc_vocab_stream.restype = ctypes.c_int32
    lib.gtok_zinc_vocab_stream.argtypes = [
        i32p, i32p, i64p, f64p, ctypes.c_int32, ctypes.c_int32,
        i64p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    # test hook: fast "%.2f" formatter (the tests cross-check its bytes
    # against Python's f"{y:.2f}")
    lib.gtok_fmt_2f.restype = ctypes.c_int32
    lib.gtok_fmt_2f.argtypes = [ctypes.c_double, ctypes.c_char_p,
                                ctypes.c_int32]
    lib.gtok_edges_lexsorted.restype = ctypes.c_int32
    lib.gtok_edges_lexsorted.argtypes = [i32p, i32p, i64p, ctypes.c_int32]
    lib.gtok_zinc_lmax.restype = ctypes.c_int64
    lib.gtok_zinc_lmax.argtypes = [i32p, i32p, i64p, i32p, ctypes.c_int32]
    u8p_pack = ctypes.POINTER(ctypes.c_uint8)
    lib.gtok_pack_ids.restype = None
    lib.gtok_pack_ids.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, u8p_pack]
    lib.gtok_corpus_scan.restype = ctypes.c_void_p
    lib.gtok_corpus_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, i64p]
    lib.gtok_corpus_fill.argtypes = [
        ctypes.c_void_p, i64p, i64p, i32p, i32p, i32p, i32p]
    lib.gtok_corpus_free.argtypes = [ctypes.c_void_p]


def get_lib():
    """Load (building if needed) the tokenization library; None if unavailable."""
    return _load("gtok")


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# libgstats — graphlet orbit counting (gstats.cpp), the ORCA-equivalent host
# component for generation-quality evaluation
# ---------------------------------------------------------------------------

def _bind_gstats(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gstats_orbit_counts_batch.restype = ctypes.c_int32
    lib.gstats_orbit_counts_batch.argtypes = [
        i32p, i32p, i64p, i32p, i64p, ctypes.c_int32, i64p]


def get_gstats():
    """Load (building if needed) the orbit-count library; None if unavailable."""
    return _load("gstats")


def gstats_available() -> bool:
    return get_gstats() is not None


def orbit_counts_batch_native(edges_list, n_nodes_list) -> np.ndarray:
    """Per-node graphlet orbit counts (ORCA orbits 0-14) for a batch of
    graphs. ``edges_list[g]`` is an [E_g, 2] int array (undirected, either
    or both directions); returns int64 [sum(n_nodes), 15] with graph g's
    rows at ``offsets[g]:offsets[g]+n_nodes[g]`` where offsets = cumsum."""
    lib = get_gstats()
    if lib is None:
        raise RuntimeError("native gstats library unavailable")
    n_graphs = len(n_nodes_list)
    n_nodes = np.asarray(n_nodes_list, dtype=np.int32)
    e_counts = np.array([len(e) for e in edges_list], dtype=np.int64)
    edge_off = np.zeros(n_graphs + 1, dtype=np.int64)
    np.cumsum(e_counts, out=edge_off[1:])
    node_off = np.zeros(n_graphs + 1, dtype=np.int64)
    np.cumsum(n_nodes.astype(np.int64), out=node_off[1:])
    if edge_off[-1]:
        flat = np.concatenate([np.asarray(e, dtype=np.int32).reshape(-1, 2)
                               for e in edges_list if len(e)])
    else:
        flat = np.zeros((0, 2), dtype=np.int32)
    src = np.ascontiguousarray(flat[:, 0], dtype=np.int32)
    dst = np.ascontiguousarray(flat[:, 1], dtype=np.int32)
    counts = np.zeros((int(node_off[-1]), 15), dtype=np.int64)
    rc = lib.gstats_orbit_counts_batch(
        _i32p(src), _i32p(dst), _i64p(edge_off), _i32p(n_nodes),
        _i64p(node_off), n_graphs,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError(f"gstats_orbit_counts_batch failed at graph {-rc - 1}")
    return counts


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _flat_as(flat, key: str, dtype) -> np.ndarray:
    """Contiguous dtype view/copy of a flat-corpus field, cached in the flat
    dict (keys prefixed ``_as:``) — the same flat dict is threaded through
    vocab build / encode / gate calls, so each field converts at most once
    per corpus instead of once per native call."""
    dt = np.dtype(dtype)
    ck = f"_as:{key}:{dt.name}"
    a = flat.get(ck)
    if a is None:
        a = np.ascontiguousarray(flat[key], dtype=dt)
        flat[ck] = a
    return a


class NativeVocab:
    """Native hash-map vocab handle."""

    def __init__(self, vocab: Dict[str, int]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        toks = list(vocab)
        blob = "".join(toks).encode("utf-8")
        offs = np.zeros(len(toks) + 1, dtype=np.int64)
        np.cumsum([len(t.encode("utf-8")) for t in toks], out=offs[1:])
        ids = np.asarray([vocab[t] for t in toks], dtype=np.int32)
        self._lib = lib
        self._handle = lib.gtok_vocab_create(blob, _i64p(offs), len(toks), _i32p(ids))
        # kept so a prebuilt handle is usable across encode_texts_native calls
        self.pad_id: Optional[int] = vocab.get("<pad>")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gtok_vocab_free(self._handle)
            self._handle = None


def encode_texts_native(
    texts: Sequence[str],
    vocab: Dict[str, int] | NativeVocab,
    max_len: int = 512,
    strip_label: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native whole-corpus text encode; semantics of tokenization.ibtt.encode_text."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    nv = vocab if isinstance(vocab, NativeVocab) else NativeVocab(vocab)
    pad_id = vocab["<pad>"] if isinstance(vocab, dict) else nv.pad_id
    if pad_id is None:
        raise ValueError("vocab has no <pad> id")
    blob = "\n".join(texts).encode("utf-8")
    if not blob.isascii():
        # Python str.split() also breaks on unicode whitespace (U+00A0, …)
        # which the byte-level C tokenizer cannot see; keep native == scalar
        # bit-for-bit by routing non-ASCII corpora through the exact path.
        # ASCII-ness is one C-speed scan; the token grammar is ASCII, so
        # production corpora never take this branch.
        if not isinstance(vocab, dict):
            raise ValueError("non-ASCII texts need the vocab dict (scalar path)")
        from ..tokenization.ibtt import encode_text
        rows = [encode_text(t, vocab, max_len=max_len, strip_label=strip_label)
                for t in texts]
        lens = np.asarray([len(r) for r in rows], dtype=np.int32)
        l = int(lens.max()) if len(texts) else 0
        ids = np.full((len(texts), l), pad_id, dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return ids, lens
    offs = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(t.encode("utf-8")) + 1 for t in texts], out=offs[1:])
    offs[-1] -= 1  # no trailing separator
    ids = np.empty((len(texts), max_len), dtype=np.int32)
    lens = np.empty(len(texts), dtype=np.int32)
    rc = lib.gtok_encode_texts(nv._handle, blob, _i64p(offs), len(texts),
                               max_len, pad_id, int(strip_label),
                               _i32p(ids), _i32p(lens))
    if rc != 0:
        raise RuntimeError(f"gtok_encode_texts failed: {rc}")
    l = int(lens.max()) if len(texts) else 0
    return ids[:, :l].copy(), lens


def edges_lexsorted_native(flat) -> bool:
    """Native fast-path gate (gtok_edges_lexsorted): exact semantics of
    ibtt_fast._edges_lexsorted_per_mol's numpy checks in one O(E log deg)
    pass with no temporaries."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = _flat_as(flat, "src", np.int32)
    dst = _flat_as(flat, "dst", np.int32)
    edge_off = _flat_as(flat, "edge_off", np.int64)
    n_mols = len(flat["n_nodes"])
    return bool(lib.gtok_edges_lexsorted(_i32p(src), _i32p(dst),
                                         _i64p(edge_off), n_mols))


def zinc_vocab_stream_native(flat):
    """Dynamic-token codes in first-occurrence order + label strings.

    Returns (codes int64 array, label_strs list). Codes <= max_nodes are node
    indices; codes > max_nodes are max_nodes+1+label_rank. Semantics of
    tokenization.ibtt_fast.build_zinc_vocab_fast's discovery stage."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    b = len(flat["n_nodes"])
    max_nodes = int(flat["n_nodes"].max()) if b else 0
    src = _flat_as(flat, "src", np.int32)
    dst = _flat_as(flat, "dst", np.int32)
    edge_off = _flat_as(flat, "edge_off", np.int64)
    y = _flat_as(flat, "y", np.float64)
    cap = max_nodes + 2 + b  # node indices + one label per molecule, upper bound
    codes = np.empty(cap, dtype=np.int64)
    blob = ctypes.create_string_buffer(b * 24 + 16)
    n = lib.gtok_zinc_vocab_stream(
        _i32p(src), _i32p(dst), _i64p(edge_off),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), b, max_nodes,
        _i64p(codes), cap, blob, len(blob))
    if n < 0:
        raise RuntimeError("gtok_zinc_vocab_stream buffer overflow")
    labels = blob.value.decode("utf-8").split("\n")
    labels = [s for s in labels if s]
    return codes[:n], labels


def zinc_encode_native(flat, vocab, max_len: int = 1024):
    """Native whole-corpus ZINC IBTT encode over flat arrays (see
    tokenization.ibtt_fast.flatten_zinc_corpus). Returns (ids, lens,
    trunc_mask); rows flagged in trunc_mask need the exact scalar-path
    patch. Requires lexsorted directed edges (caller checks)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    # one id-table function shared with the numpy path (ibtt_fast._id_tables)
    # — the native==numpy byte-exactness invariant rides on these tables
    from ..tokenization.ibtt_fast import _id_tables

    b = len(flat["n_nodes"])
    pad = vocab["<pad>"]
    max_nodes = int(flat["n_nodes"].max()) if b else 0
    atom_ids, bond_ids, index_ids = _id_tables(vocab, max_nodes)
    tail_ids = np.asarray([vocab["<q>"], vocab["regression"], vocab["<p>"],
                           vocab["<atom>"], vocab["<bond>"]], dtype=np.int32)
    atoms = _flat_as(flat, "atoms", np.int32)
    src = _flat_as(flat, "src", np.int32)
    dst = _flat_as(flat, "dst", np.int32)
    bond = _flat_as(flat, "bond", np.int32)
    node_off = _flat_as(flat, "node_off", np.int64)
    edge_off = _flat_as(flat, "edge_off", np.int64)
    # exact l_max from the ACTUAL kept (src < dst) edge counts — sizing from
    # n_edges/2 assumes a mirrored edge list and under-allocates for
    # single-direction inputs (the C side also bounds-checks, returning an
    # error instead of writing past the buffer). Computed natively
    # (gtok_zinc_lmax, one threaded pass) — the numpy keep/cumsum chain this
    # replaces cost more than the encode kernel itself.
    l_max = flat.get("_l_max")
    if l_max is None:
        nn32 = _flat_as(flat, "n_nodes", np.int32)
        l_max = int(lib.gtok_zinc_lmax(_i32p(src), _i32p(dst),
                                       _i64p(edge_off), _i32p(nn32), b)) \
            if b else 1
        flat["_l_max"] = l_max
    out = np.empty((b, l_max), dtype=np.int32)
    lens = np.empty(b, dtype=np.int32)
    trunc = np.empty(b, dtype=np.uint8)
    rc = lib.gtok_zinc_encode(
        _i32p(atoms), _i64p(node_off), _i32p(src), _i32p(dst), _i32p(bond),
        _i64p(edge_off), b, _i32p(atom_ids), _i32p(bond_ids), _i32p(index_ids),
        _i32p(tail_ids), max_len, pad, vocab["<bos>"], l_max,
        _i32p(out), _i32p(lens), trunc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"gtok_zinc_encode failed: {rc}")
    true_max = int(lens.max()) if b else 0
    return out[:, :true_max], lens, trunc.astype(bool)


def pack_ids_native(ids: np.ndarray, lens: np.ndarray, l_bucket: int,
                    pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel corpus pack (semantics of tokenization.pack.pack_corpus):
    returns (out int32 [n, l_bucket], mask bool [n, l_bucket])."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n, l = ids.shape
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    out = np.empty((n, l_bucket), dtype=np.int32)
    mask = np.empty((n, l_bucket), dtype=np.uint8)
    lib.gtok_pack_ids(_i32p(ids), _i32p(lens32), n, l, l_bucket, pad_id,
                      _i32p(out), mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, mask.view(bool)


def sent_tokenize_batch_native(
    graphs,
    idx_offset: int,
    trunc_len: int,
    labeled: bool = False,
    node_idx_offset: int = 0,
    edge_idx_offset: int = 0,
    pad_id: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native batched SENT tokenization; semantics of TrailTokenizer.__call__."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    b = len(graphs)
    # a GraphCorpus carries its flat struct-of-arrays form — reuse it
    # (spot-checked) instead of re-concatenating per-graph arrays
    flat = getattr(graphs, "flat", None)
    if flat is not None:
        from ..tokenization.ibtt_fast import _corpus_flat_matches
        if not _corpus_flat_matches(flat, graphs):
            flat = None
    if flat is not None:
        edge_off = _flat_as(flat, "edge_off", np.int64)
        node_off = _flat_as(flat, "node_off", np.int64)
        src = _flat_as(flat, "src", np.int32)
        dst = _flat_as(flat, "dst", np.int32)
        elab = _flat_as(flat, "bond", np.int32)
        num_nodes = _flat_as(flat, "n_nodes", np.int32)
        nlab = _flat_as(flat, "atoms", np.int32) if labeled else np.zeros(0, np.int32)
    else:
        n_edges = np.asarray([g.edges.shape[0] for g in graphs], dtype=np.int64)
        edge_off = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(n_edges, out=edge_off[1:])
        if edge_off[-1]:
            src = np.ascontiguousarray(
                np.concatenate([g.edges[:, 0] for g in graphs]).astype(np.int32))
            dst = np.ascontiguousarray(
                np.concatenate([g.edges[:, 1] for g in graphs]).astype(np.int32))
            elab = np.ascontiguousarray(np.concatenate([
                g.edge_labels if g.edge_labels is not None
                else np.ones(g.edges.shape[0], np.int32) for g in graphs]).astype(np.int32))
        else:
            src = dst = elab = np.zeros(0, dtype=np.int32)
        num_nodes = np.asarray([g.num_nodes for g in graphs], dtype=np.int32)
        node_off = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(num_nodes.astype(np.int64), out=node_off[1:])
        if labeled:
            nlab = np.ascontiguousarray(
                np.concatenate([g.node_labels for g in graphs]).astype(np.int32))
        else:
            nlab = np.zeros(0, dtype=np.int32)
    out = np.empty((b, trunc_len), dtype=np.int32)
    lens = np.empty(b, dtype=np.int32)
    rc = lib.gtok_sent_tokenize_batch(
        _i32p(src), _i32p(dst), _i32p(elab), _i64p(edge_off), _i32p(num_nodes),
        _i32p(nlab), _i64p(node_off), b, int(labeled), idx_offset,
        node_idx_offset, edge_idx_offset, trunc_len, pad_id, _i32p(out),
        _i32p(lens))
    if rc != 0:
        raise RuntimeError(f"gtok_sent_tokenize_batch failed: {rc}")
    return out, lens


_CORPUS_TASK_KINDS = {"cycle_check": 0, "shortest_path": 1}


def scan_corpus_file(path: str, task: str):
    """Native scan of one strict-layout graph-token corpus JSON file
    (native/gtok.cpp gtok_corpus_scan).

    Returns ``(buf, offs, lens, labels, has_q, qu, qv)`` — text i is
    ``buf[offs[i]:offs[i]+lens[i]]`` (ASCII, decode lazily), ``labels``
    uses -2 for Python None, ``qu``/``qv`` are meaningful where
    ``has_q`` is 1 — or ``None`` when the library is unavailable, the
    task is not one of the two reference tasks, or the file deviates from
    the strict layout (the caller must fall back to the Python reader in
    either case).
    """
    kind = _CORPUS_TASK_KINDS.get(task)
    lib = get_lib()
    if kind is None or lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    n = ctypes.c_int64(0)
    handle = lib.gtok_corpus_scan(buf, len(buf), kind, ctypes.byref(n))
    if not handle:
        return None
    try:
        count = n.value
        offs = np.empty(count, dtype=np.int64)
        lens = np.empty(count, dtype=np.int64)
        labels = np.empty(count, dtype=np.int32)
        has_q = np.empty(count, dtype=np.int32)
        qu = np.empty(count, dtype=np.int32)
        qv = np.empty(count, dtype=np.int32)
        if count:
            lib.gtok_corpus_fill(handle, _i64p(offs), _i64p(lens),
                                 _i32p(labels), _i32p(has_q), _i32p(qu),
                                 _i32p(qv))
    finally:
        lib.gtok_corpus_free(handle)
    return buf, offs, lens, labels, has_q, qu, qv
