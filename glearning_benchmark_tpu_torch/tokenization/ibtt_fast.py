"""Corpus-flat vectorized ZINC IBTT tokenization.

Port of ``glearning_benchmark_tpu/tokenization/ibtt_fast.py``. The host
paths are copied (numpy, and the native library through the port's own
bridge ``..native``); the tests hold their output byte-identical to the JAX
package's. The JAX package's jitted XLA device encoder becomes
:func:`make_device_encoder` / :func:`device_encode_corpus` in torch tensor
ops on an explicit ``device`` (cuda unless the caller asks for the CPU).

The reference serializes per molecule in Python (strings + per-token dict
lookups, re-run per epoch; zinc_dataset_indexbase.py:143-195 +
data_loader.py:465-486). :func:`tokenize_zinc_corpus_ids` already removed
the strings; this module removes the per-molecule loop entirely: the whole
corpus becomes a handful of flat arrays and the padded [B, L] token matrix
is produced by ~20 vectorized ops (global scatter by computed positions) —
O(total tokens), no Python in the loop. The same position arithmetic runs
as torch scatters on the device (:func:`device_encode_corpus`).

Output layout per row (byte-exact with the reference, model-input view
stripped at '<p>'):

    <bos> (<atom> sym)*N (<bond> type u v)*E' <q> regression <p>

E' = directed edge list deduped to canonical pairs in first-occurrence
order. The fast path requires each molecule's directed edge list to be
lexsorted by (src, dst) — PyG's ZINC layout — in which case canonical
first-occurrence order == the (src < dst) subsequence. Molecules violating
the precondition (or needing truncation) fall back to the exact scalar path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..data.graphs import Graph
from ..data.zinc import zinc_atom_symbol, zinc_bond_name
from .ibtt import tokenize_zinc_corpus_ids, zinc_label_token
from .vocab import build_fixed_zinc_vocab, extend_vocab_with_dynamic_tokens


# ---------------------------------------------------------------------------
# corpus flattening
# ---------------------------------------------------------------------------

def _corpus_flat_matches(flat: Dict[str, np.ndarray], mols: Sequence[Graph]) -> bool:
    """Spot-check that a corpus-carried flat form still describes `mols`:
    length plus a full field compare (incl. edge labels) at eight evenly
    spread sample indices. Graph is a frozen dataclass, so the corpus's
    molecules are immutable; the hazard this guards is *element replacement*
    or truncation after load, which the samples catch with high probability
    (single-element replacement at a non-sampled index is the caller's
    contract violation — GraphCorpus documents the corpus as immutable)."""
    if flat is None or flat["n_nodes"].shape[0] != len(mols) or not len(mols):
        return flat is not None and len(mols) == 0 and flat["n_nodes"].size == 0
    no, eo = flat["node_off"], flat["edge_off"]
    b = len(mols)
    samples = {0, b - 1} | {(k * (b - 1)) // 7 for k in range(1, 7)}
    for i in samples:
        m = mols[i]
        ns, ne = int(no[i]), int(no[i + 1])
        es, ee = int(eo[i]), int(eo[i + 1])
        el = (m.edge_labels if m.edge_labels is not None
              else np.ones(m.edges.shape[0], np.int64))
        if (ne - ns != m.num_nodes or ee - es != m.edges.shape[0]
                or not np.array_equal(flat["atoms"][ns:ne], m.node_labels)
                or not np.array_equal(flat["src"][es:ee], m.edges[:, 0])
                or not np.array_equal(flat["dst"][es:ee], m.edges[:, 1])
                or not np.array_equal(flat["bond"][es:ee], el)
                or flat["y"][i] != m.y):
            return False
    return True


def flatten_zinc_corpus(mols: Sequence[Graph]) -> Dict[str, np.ndarray]:
    """Concatenate a molecule list into flat arrays (one-time host prep).

    When `mols` is a :class:`GraphCorpus` that already carries its flat
    struct-of-arrays form (the TPU-native corpus storage — built zero-copy
    from an `.npz` export or once at load), that form is reused after a
    spot-check instead of re-concatenating B small per-molecule arrays."""
    carried = getattr(mols, "flat", None)
    if carried is not None and _corpus_flat_matches(carried, mols):
        return carried
    b = len(mols)
    # canonical flat dtypes are the NATIVE-KERNEL dtypes (int32 fields,
    # int64 offsets): the hot consumers (gtok.cpp via native._flat_as) then
    # take every array zero-copy, and the numpy paths upcast locally where
    # their key arithmetic needs int64
    n_nodes = np.fromiter((m.num_nodes for m in mols), dtype=np.int32, count=b)
    n_edges = np.fromiter((m.edges.shape[0] for m in mols), dtype=np.int32, count=b)
    atoms = np.concatenate([m.node_labels for m in mols]) if b else np.zeros(0, np.int32)
    if b and int(n_edges.sum()):
        e = np.concatenate([m.edges for m in mols], axis=0)
        eb = np.concatenate([
            m.edge_labels if m.edge_labels is not None
            else np.ones(m.edges.shape[0], np.int32) for m in mols])
    else:
        e = np.zeros((0, 2), np.int32)
        eb = np.zeros(0, np.int32)
    ys = np.fromiter((m.y for m in mols), dtype=np.float64, count=b)
    return {
        "n_nodes": n_nodes, "n_edges": n_edges,
        "node_off": np.concatenate(
            [[0], np.cumsum(n_nodes, dtype=np.int64)]),
        "edge_off": np.concatenate(
            [[0], np.cumsum(n_edges, dtype=np.int64)]),
        "atoms": np.ascontiguousarray(atoms, dtype=np.int32),
        "src": np.ascontiguousarray(e[:, 0], dtype=np.int32),
        "dst": np.ascontiguousarray(e[:, 1], dtype=np.int32),
        "bond": np.ascontiguousarray(eb, dtype=np.int32), "y": ys,
    }


def _edges_lexsorted_per_mol(flat: Dict[str, np.ndarray]) -> bool:
    """Fast-path gate. Per molecule the directed edge list must be STRICTLY
    lexsorted by (src, dst) — a duplicated directed edge would be kept twice
    by the fast paths but deduped by the scalar path — contain no self-loops,
    and every reversed (src > dst) edge must have its (src < dst) mirror in
    the same molecule — otherwise the fast paths would drop a bond the scalar
    path emits. Under these conditions canonical first-occurrence dedup ==
    the (src < dst) subsequence. PyG's mirrored lexsorted ZINC layout always
    passes; anything else falls back to the exact scalar path."""
    cached = flat.get("_lexsorted")
    if cached is not None:
        return bool(cached)

    def done(r: bool) -> bool:
        flat["_lexsorted"] = r
        return r

    if native.available():
        return done(native.edges_lexsorted_native(flat))

    # numpy fallback: upcast to int64 — the packed-key arithmetic below
    # (src*big+dst, mol*big² + canon) would overflow the canonical int32
    # fields for large node-id ranges
    src = flat["src"].astype(np.int64)
    dst = flat["dst"].astype(np.int64)
    eo = flat["edge_off"]
    if src.size == 0:
        return done(True)
    if (src == dst).any():
        return done(False)
    big = int(max(src.max(), dst.max())) + 2
    key = src * big + dst
    starts = np.zeros(src.size, dtype=bool)
    # interior boundaries equal to src.size mark trailing zero-edge
    # molecules — no edge starts there, so they impose no constraint
    # (indexing them would walk off the end of `starts`)
    interior = eo[1:-1]
    starts[interior[interior < src.size]] = True
    if not bool(np.all((key[1:] > key[:-1]) | starts[1:])):
        return done(False)
    rev = src > dst
    if rev.any():
        mol_of_edge = np.repeat(np.arange(len(eo) - 1), np.diff(eo))
        canon = np.minimum(src, dst) * big + np.maximum(src, dst)
        mol_key = mol_of_edge.astype(np.int64) * (big * big) + canon
        # the forward subsequence is ALREADY globally sorted (edges are
        # grouped by molecule and strictly lexsorted within one, so the
        # src<dst subsequence has strictly increasing (mol, canon) keys):
        # binary-search it instead of np.isin's full concat-sort
        fwd = mol_key[~rev]
        if fwd.size == 0:
            return done(False)  # reversed edges with no forward mirrors at all
        needles = mol_key[rev]
        pos = np.searchsorted(fwd, needles)
        hit = (pos < fwd.size) & (fwd[np.minimum(pos, fwd.size - 1)] == needles)
        if not bool(hit.all()):
            return done(False)
    return done(True)


# ---------------------------------------------------------------------------
# vocab tables
# ---------------------------------------------------------------------------

def _id_tables(vocab: Dict[str, int], max_nodes: int):
    pad = vocab["<pad>"]
    atom_ids = np.array([vocab.get(zinc_atom_symbol(i), pad) for i in range(9)], np.int32)
    bond_ids = np.array([pad] + [vocab.get(zinc_bond_name(x), pad) for x in range(1, 5)], np.int32)
    index_ids = np.array([vocab.get(str(i), pad) for i in range(max_nodes + 1)], np.int32)
    return atom_ids, bond_ids, index_ids


def build_zinc_vocab_fast(mols: Sequence[Graph],
                          flat: Dict[str, np.ndarray] | None = None) -> Dict[str, int]:
    """Fixed ZINC vocab + dynamic tokens in the exact first-occurrence order
    the string-path corpus scan would produce — computed numerically.

    Per molecule the OOV token stream is: node-index strings in bond
    emission order (str(u), str(v) per kept bond), then the molecule's
    'val_*' label string. Numeric encoding: index i -> code i; label ->
    code max_nodes + label_rank (labels ranked by first appearance).
    """
    if flat is None:
        flat = flatten_zinc_corpus(mols)
    if not _edges_lexsorted_per_mol(flat):
        # exact but slower: scan strings
        from .ibtt import tokenize_zinc_molecule
        from .vocab import collect_dynamic_tokens
        fixed, _ = build_fixed_zinc_vocab()
        texts = [tokenize_zinc_molecule(m) for m in mols]
        return extend_vocab_with_dynamic_tokens(fixed, collect_dynamic_tokens(texts, fixed))

    if native.available():
        try:
            codes, label_strs = native.zinc_vocab_stream_native(flat)
        except RuntimeError:
            # the stream refuses what its buffers cannot hold (a node index
            # beyond the corpus max): the numpy path below takes the corpus
            codes = None
        if codes is not None:
            max_nodes = int(flat["n_nodes"].max()) if len(mols) else 0
            dynamic = [str(int(c)) if c <= max_nodes
                       else label_strs[int(c) - max_nodes - 1] for c in codes]
            fixed, _ = build_fixed_zinc_vocab()
            return extend_vocab_with_dynamic_tokens(fixed, dynamic)

    keep = flat["src"] < flat["dst"]
    max_nodes = int(flat["n_nodes"].max()) if len(mols) else 0

    # label codes by first appearance of distinct label strings
    labels = [zinc_label_token(float(y)) for y in flat["y"]]
    label_first: Dict[str, int] = {}
    label_codes = np.empty(len(labels), dtype=np.int64)
    for i, s in enumerate(labels):
        if s not in label_first:
            label_first[s] = len(label_first)
        label_codes[i] = label_first[s]
    label_strs = list(label_first)

    # build the global OOV code stream: per molecule, interleaved (u, v) of
    # kept bonds then the label code
    b = len(mols)
    kept_counts = np.bincount(
        np.repeat(np.arange(b), flat["n_edges"])[keep], minlength=b)
    stream_len = 2 * kept_counts + 1
    stream_off = np.concatenate([[0], np.cumsum(stream_len)])
    stream = np.empty(stream_off[-1], dtype=np.int64)
    ku = flat["src"][keep]
    kv = flat["dst"][keep]
    mol_of_kept = np.repeat(np.arange(b), kept_counts.astype(np.int64)) \
        if ku.size else np.zeros(0, np.int64)
    kept_off = np.concatenate([[0], np.cumsum(kept_counts)])
    j = np.arange(ku.size) - kept_off[mol_of_kept]
    base = stream_off[mol_of_kept]
    stream[base + 2 * j] = ku
    stream[base + 2 * j + 1] = kv
    stream[stream_off[1:] - 1] = max_nodes + 1 + label_codes

    # first-occurrence order over the stream
    uniq_codes, first_idx = np.unique(stream, return_index=True)
    order = np.argsort(first_idx, kind="stable")
    dynamic: List[str] = []
    for code in uniq_codes[order]:
        if code <= max_nodes:
            dynamic.append(str(int(code)))
        else:
            dynamic.append(label_strs[int(code) - max_nodes - 1])

    fixed, _ = build_fixed_zinc_vocab()
    return extend_vocab_with_dynamic_tokens(fixed, dynamic)


# ---------------------------------------------------------------------------
# vectorized encoding (numpy host path)
# ---------------------------------------------------------------------------

def corpus_ids_vectorized(
    mols: Sequence[Graph],
    vocab: Dict[str, int],
    max_len: int = 1024,
    flat: Dict[str, np.ndarray] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-corpus ZINC encode via global scatter. Byte-exact with
    ``tokenize_zinc_corpus_ids`` (tested); rows needing truncation or with
    non-lexsorted edges are patched through the exact scalar path."""
    b = len(mols)
    if b == 0:
        return np.zeros((0, 0), np.int32), np.zeros((0,), np.int32)
    if flat is None:
        flat = flatten_zinc_corpus(mols)
    if not _edges_lexsorted_per_mol(flat):
        return tokenize_zinc_corpus_ids(mols, vocab, max_len=max_len)

    pad = np.int32(vocab["<pad>"])
    bos, atom_tok, bond_tok = vocab["<bos>"], vocab["<atom>"], vocab["<bond>"]
    q_tok, p_tok, regress = vocab["<q>"], vocab["<p>"], vocab["regression"]
    max_nodes = int(flat["n_nodes"].max())
    atom_ids, bond_ids, index_ids = _id_tables(vocab, max_nodes)

    n = flat["n_nodes"]
    keep = flat["src"] < flat["dst"]
    mol_of_edge = np.repeat(np.arange(b), flat["n_edges"])
    kept_counts = np.bincount(mol_of_edge[keep], minlength=b)
    lengths = 1 + 2 * n + 4 * kept_counts + 3          # stripped at '<p>'
    full_len = lengths + 2                             # + label + <eos>
    trunc = full_len > max_len

    # width = stripped max over the untruncated rows, matching the scalar and
    # native paths exactly (pack_corpus buckets on this width — 2 spare pad
    # columns here could bump a 127/255-wide corpus into the next bucket on
    # the numpy path only). Truncated rows are absent from the scatter;
    # _patch_truncated grows the matrix on demand when they need more width.
    l_max = int(lengths[~trunc].max()) if (~trunc).any() else 1
    out = np.full(b * l_max, pad, dtype=np.int32)

    # atoms: positions base + 1 + 2k / +2
    mol_of_atom = np.repeat(np.arange(b), n)
    k = np.arange(flat["atoms"].size) - flat["node_off"][mol_of_atom]
    abase = mol_of_atom * l_max + 1 + 2 * k
    ok = ~trunc[mol_of_atom]
    out[abase[ok]] = atom_tok
    out[abase[ok] + 1] = atom_ids[flat["atoms"][ok]]

    # bonds
    ku, kv, kb = flat["src"][keep], flat["dst"][keep], flat["bond"][keep]
    mol_of_kept = mol_of_edge[keep]
    kept_off = np.concatenate([[0], np.cumsum(kept_counts)])
    j = np.arange(ku.size) - kept_off[mol_of_kept]
    bbase = mol_of_kept * l_max + 1 + 2 * n[mol_of_kept] + 4 * j
    ok = ~trunc[mol_of_kept]
    out[bbase[ok]] = bond_tok
    out[bbase[ok] + 1] = bond_ids[np.clip(kb[ok], 0, 4)]
    out[bbase[ok] + 2] = index_ids[ku[ok]]
    out[bbase[ok] + 3] = index_ids[kv[ok]]

    # bos + tail
    rows = np.arange(b)
    okr = ~trunc
    out[rows[okr] * l_max] = bos
    tbase = rows * l_max + 1 + 2 * n + 4 * kept_counts
    out[tbase[okr]] = q_tok
    out[tbase[okr] + 1] = regress
    out[tbase[okr] + 2] = p_tok

    ids = out.reshape(b, l_max)
    lens = lengths.astype(np.int32)

    # patch truncated rows through the exact scalar path
    if trunc.any():
        ids, l_max, lens = _patch_truncated(ids, lens, trunc, mols, vocab, max_len, pad)
    return ids, lens


def _patch_truncated(ids, lens, trunc, mols, vocab, max_len, pad):
    b, l_max = ids.shape
    if trunc.any():
        t_idx = np.flatnonzero(trunc)
        sub_ids, sub_lens = tokenize_zinc_corpus_ids(
            [mols[i] for i in t_idx], vocab, max_len=max_len)
        if sub_ids.shape[1] > l_max:
            grown = np.full((b, sub_ids.shape[1]), pad, dtype=np.int32)
            grown[:, :l_max] = ids
            ids = grown
            l_max = ids.shape[1]
        for t, i in enumerate(t_idx):
            ids[i, : sub_lens[t]] = sub_ids[t, : sub_lens[t]]
            ids[i, sub_lens[t]:] = pad
            lens[i] = sub_lens[t]
    return ids, l_max, lens


def corpus_ids_best(
    mols: Sequence[Graph],
    vocab: Dict[str, int],
    max_len: int = 1024,
    flat: Dict[str, np.ndarray] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fastest available host path: native C++ single-pass encode when the
    library is built and edges are lexsorted, numpy-vectorized otherwise.
    Byte-exact with the scalar path either way (truncated rows patched)."""
    if flat is None:
        flat = flatten_zinc_corpus(mols)
    if not native.available() or not _edges_lexsorted_per_mol(flat):
        return corpus_ids_vectorized(mols, vocab, max_len=max_len, flat=flat)
    ids, lens, trunc = native.zinc_encode_native(flat, vocab, max_len=max_len)
    if trunc.any():
        ids, _, lens = _patch_truncated(ids, lens, trunc, mols, vocab, max_len,
                                        np.int32(vocab["<pad>"]))
    return ids, lens


# ---------------------------------------------------------------------------
# device encoding (torch scatters on the device)
# ---------------------------------------------------------------------------

def make_device_encoder(l_max: int, vocab: Dict[str, int], max_nodes: int,
                        device: torch.device | str = "cuda"):
    """Build an encoder over flat corpus tensors on ``device``.

    Same position arithmetic as :func:`corpus_ids_vectorized`, expressed as
    masked index writes into a flat [B * l_max] buffer. The JAX package's
    XLA scatters drop out-of-range writes (``mode='drop'``); torch's index
    writes fault on them instead (a device-side assert on CUDA), so the
    buffer has one dump slot at ``B * l_max`` that every invalid or
    out-of-range index is routed to, and which is sliced off. Indices are
    int64. Truncated rows must be patched on the host (they are rare and
    detected from the returned lens).
    """
    dev = torch.device(device)
    pad = vocab["<pad>"]
    # the fixed tokens as 0-dim tensors on the device: a Python number
    # written through an index would be copied from the host at every call,
    # and that copy waits for the device's queue to drain
    bos, atom_tok, bond_tok, q_tok, p_tok, regress = (
        torch.tensor(vocab[t], dtype=torch.int32, device=dev)
        for t in ("<bos>", "<atom>", "<bond>", "<q>", "<p>", "regression"))
    atom_tab, bond_tab, index_tab = (torch.as_tensor(t, device=dev)
                                     for t in _id_tables(vocab, max_nodes))

    def encode(n_nodes, node_off, atoms, mol_of_atom,
               ku, kv, kb, mol_of_kept, kept_counts, kept_off,
               atom_valid, kept_valid):
        b = n_nodes.shape[0]
        oob = b * l_max                      # the dump slot
        out = torch.full((oob + 1,), pad, dtype=torch.int32, device=dev)

        def put(idx, vals, valid=None):
            keep = (idx >= 0) & (idx < oob)
            if valid is not None:
                keep &= valid
            out[torch.where(keep, idx, oob)] = vals

        # gathers clamp their indices, as XLA's do (a padded slot may name
        # any molecule); the writes of such a slot are dropped
        n_nodes, kept_counts = n_nodes.long(), kept_counts.long()
        mol_of_atom, mol_of_kept = mol_of_atom.long(), mol_of_kept.long()
        k = (torch.arange(atoms.shape[0], device=dev)
             - node_off.long()[mol_of_atom.clamp(0, b - 1)])
        abase = mol_of_atom * l_max + 1 + 2 * k
        put(abase, atom_tok, atom_valid)
        put(abase + 1, atom_tab[atoms.long().clamp(0, 8)], atom_valid)

        mol = mol_of_kept.clamp(0, b - 1)
        j = torch.arange(ku.shape[0], device=dev) - kept_off.long()[mol]
        bbase = mol_of_kept * l_max + 1 + 2 * n_nodes[mol] + 4 * j
        put(bbase, bond_tok, kept_valid)
        put(bbase + 1, bond_tab[kb.long().clamp(0, 4)], kept_valid)
        put(bbase + 2, index_tab[ku.long().clamp(0, max_nodes)], kept_valid)
        put(bbase + 3, index_tab[kv.long().clamp(0, max_nodes)], kept_valid)

        rows = torch.arange(b, device=dev)
        put(rows * l_max, bos)
        tbase = rows * l_max + 1 + 2 * n_nodes + 4 * kept_counts
        put(tbase, q_tok)
        put(tbase + 1, regress)
        put(tbase + 2, p_tok)
        lens = tbase + 3 - rows * l_max
        return out[:oob].view(b, l_max), lens.to(torch.int32)

    return encode


def device_encoder_inputs(flat: Dict[str, np.ndarray]):
    """(l_max, max_nodes, the encoder's argument tensors on the host) of a
    lexsorted corpus; rows wider than ``max_len`` need the host path."""
    b = len(flat["n_nodes"])
    n = flat["n_nodes"]
    keep = flat["src"] < flat["dst"]
    mol_of_edge = np.repeat(np.arange(b), flat["n_edges"])
    kept_counts = np.bincount(mol_of_edge[keep], minlength=b)
    l_max = int((1 + 2 * n + 4 * kept_counts + 3).max())
    mol_of_atom = np.repeat(np.arange(b), n)
    kept_off = np.concatenate([[0], np.cumsum(kept_counts)])
    host = (n, flat["node_off"][:-1], flat["atoms"], mol_of_atom,
            flat["src"][keep], flat["dst"][keep], flat["bond"][keep],
            mol_of_edge[keep], kept_counts, kept_off[:-1],
            np.ones(int(n.sum()), dtype=bool), np.ones(int(keep.sum()), dtype=bool))
    return l_max, int(n.max()), tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in host)


def device_encode_corpus(mols: Sequence[Graph], vocab: Dict[str, int],
                         max_len: int = 1024, device: torch.device | str = "cuda"):
    """End-to-end device path: flatten on host, scatter-encode on device.

    Returns (ids [B, L] int32, lens [B] int32), torch tensors on ``device``.
    Byte-exact with the host paths for non-truncated corpora (ZINC never
    truncates at max_len=1024)."""
    flat = flatten_zinc_corpus(mols)
    if not _edges_lexsorted_per_mol(flat):
        ids, lens = tokenize_zinc_corpus_ids(mols, vocab, max_len=max_len)
        return torch.as_tensor(ids, device=device), torch.as_tensor(lens, device=device)
    l_max, max_nodes, host = device_encoder_inputs(flat)
    if l_max + 2 > max_len:     # with label and <eos>, a row would truncate
        ids, lens = corpus_ids_vectorized(mols, vocab, max_len=max_len, flat=flat)
        return torch.as_tensor(ids, device=device), torch.as_tensor(lens, device=device)
    args = [a.to(device) for a in host]
    return make_device_encoder(l_max, vocab, max_nodes, device)(*args)
