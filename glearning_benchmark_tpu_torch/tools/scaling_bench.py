"""The north star at N processes: byte-exact ZINC tokenization graphs/s and
vocab-build bytes/s at N = 1, 2, 4 (the root ``tools/scaling_bench.py`` on
the port's modules and ``torch.distributed``).

    python -m glearning_benchmark_tpu_torch.tools.scaling_bench \
        [--mols 40000] [--hosts 1,2,4] [--reps 5] [--out runs_torch/scaling.json]

"Hosts" are N OS processes joined by ``torch.distributed`` over gloo (a
file rendezvous in a temporary directory), each pinned to one core and to
one native thread (``GTOK_THREADS=1``), since the N processes share one
machine's cores and memory bus: a host's efficiency here is a lower bound
of a real fleet's. The corpus is the deterministic ZINC stand-in (molecule
i from seed 777 + i), split into contiguous shards by
``parallel/data.host_shard_bounds``. Weak scaling: ``--mols`` is one
host's shard, so the corpus grows with N.

Each host, best of ``--reps`` after barriers, times the vocab build
(``flatten_zinc_corpus`` and ``parallel/multiproc.multiprocess_zinc_vocab``,
which all-gathers the shards' dynamic tokens) and the tokenization
(``corpus_ids_best`` and ``pack_corpus``), each clock stopped before the
closing barrier; a point's time is its slowest host's. The tool then holds
every point to one process: each host's vocab must equal
``build_zinc_vocab_fast`` over the whole corpus, id for id, and its ids
must equal that vocab's ids of its shard (valid tokens and lengths, by
sha256); a mismatch raises. It reports tokenize graphs/s and vocab bytes/s
(the corpus text the reference's Counter scans) per N, with the efficiency
against N = 1, and writes ``--out``; the root ``SCALING.json`` is the JAX
package's. The root tool's DRAM-ceiling (STREAM) and cache-resident series
are not ported.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..utils.card import HOST
from . import RESULTS_DIR, emit, save

MAX_LEN = 1024
SEED0 = 777                  # molecule i is _synth_molecule(SEED0 + i)
CHUNK = 2000                 # molecules a task of the parent's generation pool
POINT_TIMEOUT_S = 900        # a host process's limit
PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def molecules(start: int, end: int) -> list:
    from ..data.zinc import _synth_molecule

    return [_synth_molecule(SEED0 + i) for i in range(start, end)]


def digest(vocab: Dict[str, int], ids: np.ndarray = None, lens: np.ndarray = None) -> str:
    """sha256 of a vocab (its items by id) and, given, the valid ids of
    every row and the row lengths."""
    h = hashlib.sha256(json.dumps(sorted(vocab.items(), key=lambda kv: kv[1])).encode())
    if ids is not None:
        valid = np.arange(ids.shape[1])[None, :] < lens[:, None]
        h.update(np.ascontiguousarray(ids[valid], dtype=np.int64).tobytes())
        h.update(np.asarray(lens, dtype=np.int64).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# one host: a child process
# ---------------------------------------------------------------------------

def child_main(rank: int, world: int, init: str, n_mols: int, reps: int) -> None:
    import torch.distributed as dist

    from ..parallel.data import host_shard_bounds
    from ..parallel.multiproc import multiprocess_zinc_vocab
    from ..tokenization.ibtt import tokenize_zinc_molecule
    from ..tokenization.ibtt_fast import corpus_ids_best, flatten_zinc_corpus
    from ..tokenization.pack import pack_corpus

    if world > 1:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)

    def sync():
        if world > 1:
            dist.barrier()

    # the shard is untimed set-up, as are its text bytes (what a Counter scans)
    start, end = host_shard_bounds(n_mols, rank, world)
    mols = molecules(start, end)
    stream_bytes = sum(len(tokenize_zinc_molecule(m, max_len=MAX_LEN).encode())
                       for m in mols)
    # no cyclic collection inside a timed phase of one host only
    gc.collect()
    gc.freeze()
    gc.disable()
    best = {"t_vocab": float("inf"), "t_tok": float("inf"),
            "w_vocab": float("inf"), "w_tok": float("inf")}
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        flat = flatten_zinc_corpus(mols)
        vocab = multiprocess_zinc_vocab(mols, flat=flat)
        w = time.perf_counter() - t0
        sync()
        best["t_vocab"] = min(best["t_vocab"], time.perf_counter() - t0)
        best["w_vocab"] = min(best["w_vocab"], w)

        sync()
        t0 = time.perf_counter()
        ids, lens = corpus_ids_best(mols, vocab, max_len=MAX_LEN, flat=flat)
        pack_corpus(ids, lens, pad_id=vocab["<pad>"])
        w = time.perf_counter() - t0
        sync()
        best["t_tok"] = min(best["t_tok"], time.perf_counter() - t0)
        best["w_tok"] = min(best["w_tok"], w)
    print(json.dumps({"rank": rank, "n": world, "start": start, "end": end,
                      "mols": len(mols), **best, "vocab_size": len(vocab),
                      "vocab_sha": digest(vocab), "ids_sha": digest(vocab, ids, lens),
                      "stream_bytes": stream_bytes}), flush=True)
    if world > 1:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def run_point(n: int, n_mols: int, reps: int, work: str) -> List[dict]:
    """N child processes over ``n_mols`` molecules; their result lines."""
    env = dict(os.environ, GTOK_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [PKG_PARENT,
                                                        os.environ.get("PYTHONPATH")])))
    cores = os.cpu_count() or 1
    init = f"file://{os.path.join(work, f'rdzv_{n}_{n_mols}')}"
    procs = []
    try:
        for rank in range(n):
            cmd = [sys.executable, "-m", __spec__.name, "--child", "--rank", str(rank),
                   "--world", str(n), "--init", init, "--mols", str(n_mols),
                   "--reps", str(reps)]
            if n <= cores and shutil.which("taskset"):
                # a core each, counted down from the last, away from the parent
                cmd = ["taskset", "-c", str((cores - 1 - rank) % cores)] + cmd
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True, env=env))
        outs = []
        for proc in procs:
            out, err = proc.communicate(timeout=POINT_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"host process failed ({proc.returncode}):\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def one_process_digests(mols: list, n_mols: int, outs: List[dict]) -> tuple:
    """(vocab digest, [ids digest of each host's shard]) of one process's
    build over the first ``n_mols`` molecules."""
    from ..tokenization.ibtt_fast import build_zinc_vocab_fast, corpus_ids_best

    vocab = build_zinc_vocab_fast(mols[:n_mols])
    shards = []
    for o in outs:
        ids, lens = corpus_ids_best(mols[o["start"]:o["end"]], vocab, max_len=MAX_LEN)
        shards.append(digest(vocab, ids, lens))
    return digest(vocab), shards


def point_row(outs: List[dict]) -> dict:
    """A point's numbers: the slowest host's work time gates each phase."""
    t_vocab = max(o["w_vocab"] for o in outs)
    t_tok = max(o["w_tok"] for o in outs)
    mols = sum(o["mols"] for o in outs)
    return {"n_hosts": len(outs), "mols": mols,
            "tokenize_graphs_per_sec": mols / t_tok,
            "vocab_bytes_per_sec": sum(o["stream_bytes"] for o in outs) / t_vocab,
            "t_tok_s": t_tok, "t_vocab_s": t_vocab,
            "t_tok_incl_barrier_s": max(o["t_tok"] for o in outs),
            "t_vocab_incl_barrier_s": max(o["t_vocab"] for o in outs),
            "t_tok_per_host": [o["w_tok"] for o in outs],
            "t_vocab_per_host": [o["w_vocab"] for o in outs],
            "vocab_size": outs[0]["vocab_size"]}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mols", type=int, default=40000,
                    help="molecules a host (weak scaling: the corpus grows with N)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hosts", default="1,2,4")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "scaling.json"))
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.rank, args.world, args.init, args.mols, args.reps)
        return {}

    hosts = [int(x) for x in args.hosts.split(",")]
    # the whole corpus once, for the one-process checks (parallel set-up)
    total = max(hosts) * args.mols
    chunks = [(i, min(i + CHUNK, total)) for i in range(0, total, CHUNK)]
    if len(chunks) == 1:
        mols = molecules(0, total)
    else:
        with ProcessPoolExecutor(min(len(chunks), os.cpu_count() or 1),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            mols = [m for part in pool.map(molecules, *zip(*chunks)) for m in part]
    points = []
    with tempfile.TemporaryDirectory() as work:
        for n in hosts:
            outs = run_point(n, args.mols * n, args.reps, work)
            vocab_sha, shard_shas = one_process_digests(mols, args.mols * n, outs)
            if {o["vocab_sha"] for o in outs} != {vocab_sha}:
                raise AssertionError(f"N={n}: a host's vocab differs from one process's")
            if [o["ids_sha"] for o in outs] != shard_shas:
                raise AssertionError(f"N={n}: a host's ids differ from one process's")
            row = point_row(outs)
            row["equal_to_one_process"] = True
            points.append(row)
    for pt in points:
        n = pt["n_hosts"]
        pt["tokenize_efficiency"] = (pt["tokenize_graphs_per_sec"]
                                     / (n * points[0]["tokenize_graphs_per_sec"]))
        pt["vocab_efficiency"] = pt["vocab_bytes_per_sec"] / (n * points[0]["vocab_bytes_per_sec"])
        emit(pt, dict(HOST))
    result = {"workload": "zinc_standin_tokenize+vocab", "mols": args.mols, "reps": args.reps,
              "mode": "N processes, torch.distributed gloo, file rendezvous, contiguous "
                      "shards, one core and one native thread each",
              "cores": os.cpu_count(), "points": points}
    save(args.out, result)
    return emit({"summary": "scaling_bench", "out": args.out,
                 "tokenize_efficiency": {p["n_hosts"]: p["tokenize_efficiency"] for p in points},
                 "vocab_efficiency": {p["n_hosts"]: p["vocab_efficiency"] for p in points}},
                dict(HOST))


if __name__ == "__main__":
    main()
