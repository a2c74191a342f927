"""Padding and packing of token-id sequences into fixed-shape batches.

Port of ``glearning_benchmark_tpu/tokenization/pack.py`` (numpy, copied;
the tests hold the outputs byte-identical to the JAX package's):
``pad_sequences``, ``round_up_to_bucket``, ``pack_corpus`` (a whole corpus
padded to one static bucket, through the native parallel pass from 512 rows
up), ``pack_examples`` (several sequences per row behind a block-diagonal
mask) and ``batch_iterator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def pad_sequences(
    seqs: Sequence[np.ndarray],
    pad_id: int,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad variable-length id sequences. Returns (ids [B, L], mask [B, L])."""
    b = len(seqs)
    lens = [min(len(s), max_len) if max_len else len(s) for s in seqs]
    l = max(lens, default=0)
    ids = np.full((b, l), pad_id, dtype=np.int32)
    mask = np.zeros((b, l), dtype=bool)
    for i, s in enumerate(seqs):
        k = lens[i]
        ids[i, :k] = s[:k]
        mask[i, :k] = True
    return ids, mask


def round_up_to_bucket(n: int, buckets: Sequence[int] = (64, 128, 256, 512, 640, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def pack_corpus(
    ids: np.ndarray,
    lengths: np.ndarray,
    pad_id: int,
    bucket: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged-ish [N, L] matrix out to a static bucket length.

    Returns (ids [N, L_bucket], mask [N, L_bucket]): one static shape for
    the whole corpus. The stage is pure memory bandwidth, so from 512 rows
    up it takes the parallel native pass (``gtok_pack_ids``, bit-identical)
    when the library is available; an error of that pass raises.
    """
    from .. import native

    n, l = ids.shape
    lb = round_up_to_bucket(l) if bucket else l
    if n >= 512 and native.available():
        return native.pack_ids_native(ids, np.asarray(lengths), lb, pad_id)
    # numpy path: fill only the pad tail (out[:, l:]) instead of np.full
    # over the whole matrix — the [:, :l] region is overwritten
    out = np.empty((n, lb), dtype=np.int32)
    out[:, :l] = ids
    if lb > l:
        out[:, l:] = pad_id
    mask = np.arange(lb)[None, :] < lengths[:, None]
    return out, mask


def pack_examples(
    seqs: Sequence[np.ndarray],
    bucket: int,
    pad_id: int,
    q_token_id: Optional[int] = None,
    query_offsets: Tuple[int, int] = (2, 3),
) -> dict:
    """First-fit-decreasing packing of whole sequences into fixed-length rows.

    Multiple sequences share one attention row; ``seg`` carries a 1-based
    segment id per token (0 = padding) for the block-diagonal attention
    mask, and ``pos`` the within-segment position so learned absolute
    positions restart at every packed sequence (semantics identical to the
    unpacked batch). Per-example readout positions are precomputed here —
    <bos> at the segment start and, when ``q_token_id`` is given, the query
    node slots at ``q_pos + query_offsets`` — so the packed forward needs no
    in-jit '<q>' search.

    Returns dict with:
      ids  [R, bucket] i32     seg [R, bucket] i32     pos [R, bucket] i32
      ex_of_row: per-row list of original example indices (python list)
      pos_bos/pos_u/pos_v [R, K] i32   ex_valid [R, K] bool
      ex_index [R, K] i32 (original example index, 0 where invalid)
    where K = max sequences packed into any row. Sequences longer than
    ``bucket`` are truncated to it (matching pad_sequences' max_len cut).
    """
    n = len(seqs)
    lens = np.asarray([min(len(s), bucket) for s in seqs], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    rows: List[List[int]] = []
    space: List[int] = []
    for e in order.tolist():
        need = int(lens[e])
        placed = False
        for r in range(len(rows)):      # first fit
            if space[r] >= need:
                rows[r].append(e)
                space[r] -= need
                placed = True
                break
        if not placed:
            rows.append([e])
            space.append(bucket - need)
    # deterministic row order: by first (longest) member's original index
    rows.sort(key=lambda members: members[0])

    r_count = len(rows)
    k_max = max((len(m) for m in rows), default=1)
    ids = np.full((r_count, bucket), pad_id, dtype=np.int32)
    seg = np.zeros((r_count, bucket), dtype=np.int32)
    pos = np.zeros((r_count, bucket), dtype=np.int32)
    pos_bos = np.zeros((r_count, k_max), dtype=np.int32)
    pos_u = np.zeros((r_count, k_max), dtype=np.int32)
    pos_v = np.zeros((r_count, k_max), dtype=np.int32)
    ex_valid = np.zeros((r_count, k_max), dtype=bool)
    ex_index = np.zeros((r_count, k_max), dtype=np.int32)
    for r, members in enumerate(rows):
        off = 0
        for k, e in enumerate(members):
            s = np.asarray(seqs[e][: lens[e]], dtype=np.int32)
            m = len(s)
            ids[r, off: off + m] = s
            seg[r, off: off + m] = k + 1
            pos[r, off: off + m] = np.arange(m, dtype=np.int32)
            pos_bos[r, k] = off
            ex_valid[r, k] = True
            ex_index[r, k] = e
            if q_token_id is not None:
                hits = np.flatnonzero(s == q_token_id)
                if hits.size:
                    qp = int(hits[0])
                    ou, ov = query_offsets
                    if qp + ov < m:
                        pos_u[r, k] = off + qp + ou
                        pos_v[r, k] = off + qp + ov
            off += m
    return {"ids": ids, "seg": seg, "pos": pos, "pos_bos": pos_bos,
            "pos_u": pos_u, "pos_v": pos_v, "ex_valid": ex_valid,
            "ex_index": ex_index, "ex_of_row": rows}


def batch_iterator(
    n: int,
    batch_size: int,
    shuffle: bool,
    seed: int,
    drop_remainder: bool = False,
):
    """Yield index arrays; the final short batch is padded by repeating index
    0 with a validity count so every step keeps a static batch shape."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        chunk = idx[start : start + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            if drop_remainder:
                return
            chunk = np.concatenate([chunk, np.zeros(batch_size - valid, dtype=chunk.dtype)])
        yield chunk, valid
