"""First-fit-decreasing packing of sequences into rows.

The same rows as the port's ``pack_examples``
(``glearning_benchmark_tpu_torch/tokenization/pack.py``): sequences sorted
by length, longest first (stable), each placed in the first row with room,
rows ordered by their first member's index; ``seg`` 1-based segment ids,
``pos`` positions within a segment, ``pos_bos`` each segment's start. The
first fit is found with numpy over the rows' free space, not a Python scan.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def pack(seqs: Sequence[np.ndarray], row_len: int, pad_id: int) -> Dict[str, np.ndarray]:
    lens = np.asarray([min(len(s), row_len) for s in seqs], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    space = np.full(len(seqs), row_len, dtype=np.int64)    # at most one row a sequence
    members = []
    n_rows = 0
    for e in order.tolist():
        fits = np.flatnonzero(space[:n_rows] >= lens[e])
        r = int(fits[0]) if fits.size else n_rows
        if r == n_rows:
            members.append([])
            n_rows += 1
        members[r].append(e)
        space[r] -= lens[e]
    members.sort(key=lambda m: m[0])
    k_max = max((len(m) for m in members), default=1)
    ids = np.full((n_rows, row_len), pad_id, dtype=np.int32)
    seg = np.zeros((n_rows, row_len), dtype=np.int32)
    pos = np.zeros((n_rows, row_len), dtype=np.int32)
    pos_bos = np.zeros((n_rows, k_max), dtype=np.int32)
    ex_valid = np.zeros((n_rows, k_max), dtype=bool)
    ex_index = np.zeros((n_rows, k_max), dtype=np.int64)
    for r, mem in enumerate(members):
        off = 0
        for k, e in enumerate(mem):
            m = int(lens[e])
            ids[r, off:off + m] = seqs[e][:m]
            seg[r, off:off + m] = k + 1
            pos[r, off:off + m] = np.arange(m)
            pos_bos[r, k] = off
            ex_valid[r, k] = True
            ex_index[r, k] = e
            off += m
    return {"ids": ids, "seg": seg, "pos": pos, "pos_bos": pos_bos,
            "ex_valid": ex_valid, "ex_index": ex_index}
