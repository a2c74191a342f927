"""Serving benchmark of the port: end-to-end request latency and throughput
per request bucket, for each model family (``tools/serve_bench.py`` of the
root, on the port's ``train`` and ``serve.Predictor``).

    python -m glearning_benchmark_tpu_torch.tools.serve_bench \
        [--families ibtt,agtt,mpnn,ggps] [--buckets 1,8,64,256] [--reps N] [--device cpu]

For each family it trains a short checkpoint at the family's
``configs/<family>_graph_token.yaml`` shape on a 200-graph corpus (the
model and bucket shapes are the config's; accuracy does not move latency),
then serves ``cycle_check`` ``val`` records (texts for ibtt, graphs for the
others) and times, per request bucket of 1, 8, 64 and 256 graphs, raw inputs
-> tokenization -> padded bucket -> forward -> logits on the host:

- ``cold_first_call_ms``: the first request of a fresh ``Predictor``;
- ``warmup_s`` and ``warmed_first_call_ms``: ``Predictor.warmup`` of a
  second fresh ``Predictor`` at that bucket, then its first request;
- ``warm_p50_ms`` / ``warm_p99_ms`` over ``--reps`` requests (default 30 up
  to bucket 64, 12 above, as the reference) on rotating request slices, and
  ``graphs_per_s_at_p50``.

The port's forward is eager: nothing is traced or compiled, so the cold
call measures the CUDA context and cuBLAS handles of the process's first
request, the first launch of each kernel (the flash-attention libraries are
built once into ``_build/`` and loaded at first use) and the caching
allocator's first allocations, where the JAX package's measures a compile.
Every call ends with the logits on the host (``Predictor`` copies them out),
so a host clock times the device's work.

Writes ``--out`` (default ``runs_torch/serve_bench.json``); checkpoints and
the corpus go under ``--out-dir`` (default ``runs_torch/serve_bench``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..serve import Predictor
from ..train.trainer import train
from ..utils.card import device_info
from ..utils.device import resolve_device
from . import RESULTS_DIR, emit, save

BATCH_BUCKETS = (1, 8, 64, 256)
FAMILIES = ("ibtt", "agtt", "mpnn", "ggps")
TASK = "cycle_check"
CORPUS_GRAPHS = 200


def config_file(family: str) -> str:
    stem = "gps" if family == "ggps" else family
    return os.path.join("configs", f"{stem}_graph_token.yaml")


def serve_config(config: dict, family: str, out_dir: str, corpus_root: str,
                 epochs: int) -> dict:
    """The family's shipped config (normalised) cut to a short serving
    checkpoint: its epochs, a 200-graph corpus, wandb off, outputs under
    ``out_dir``. Model and bucket shapes stay the config's."""
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in config.items()}
    cfg["train"]["epochs"] = epochs
    cfg["output"] = {"out_dir": out_dir, "run_name": f"{family}-serve"}
    cfg["wandb"] = {"use": False}
    ds = cfg["dataset"]
    ds.update(graph_token_root=corpus_root, task=TASK, num_graphs=CORPUS_GRAPHS,
              generate_num_graphs=CORPUS_GRAPHS)
    return cfg


def request_pool(corpus_root: str, n: int):
    """``n`` val records, the forms a serving client sends: (texts, graphs),
    each repeated up to ``n``."""
    from ..data.loader import load_examples_multi_algorithm
    from ..data.text_grammar import text_record_to_graph

    ex = load_examples_multi_algorithm(corpus_root, TASK, ["ba", "sbm"], "val",
                                       use_split_tasks_dirs=True, seed=0)
    ex = (ex * (n // max(len(ex), 1) + 1))[:n]
    texts = [e["text"] for e in ex]
    graphs = [g for g in (text_record_to_graph(e["text"], TASK, label=e.get("label"))
                          for e in ex) if g is not None]
    if graphs:      # unparseable records: replicate back up to n
        graphs = (graphs * (n // len(graphs) + 1))[:n]
    return texts, graphs


def _ms(secs: float) -> float:
    return secs * 1e3


def bench_family(family: str, config: dict, device: torch.device,
                 buckets: Sequence[int] = BATCH_BUCKETS, reps: Optional[int] = None,
                 epochs: int = 2, out_dir: str = os.path.join(RESULTS_DIR, "serve_bench"),
                 corpus_root: Optional[str] = None) -> Dict:
    """Train ``family``'s serving checkpoint (unless ``out_dir`` holds one)
    and time every bucket; prints each row as it is measured."""
    corpus_root = corpus_root or os.path.join(out_dir, "graph-token")
    card = device_info(device)
    ckpt = os.path.join(out_dir, f"best_{family}-serve")
    if not os.path.exists(ckpt + ".npz"):
        cfg = serve_config(config, family, out_dir, corpus_root, epochs)
        train(cfg, family, verbose=False, device=device)
    texts, graphs = request_pool(corpus_root, 2 * max(buckets))
    pool = texts if family == "ibtt" else graphs

    def requests(bs: int, i: int):
        # the modulus admits the last offset (len - bs), so the largest
        # bucket (len / 2) does not pin every rep to offset 0
        off = (i * bs) % max(len(pool) - bs + 1, 1)
        return pool[off:off + bs]

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def call_of(p: Predictor):
        return p.predict_texts if family == "ibtt" else p.predict_graphs

    rows: List[Dict] = []
    meta: Dict = {}
    for bs in buckets:
        fresh = Predictor.from_checkpoint(ckpt, device=device)
        meta = fresh.serve["meta"]
        call = call_of(fresh)
        _, cold_s = timed(call, requests(bs, 0))
        warmed = Predictor.from_checkpoint(ckpt, device=device)
        _, warmup_s = timed(warmed.warmup, [bs])
        _, warmed_first_s = timed(call_of(warmed), requests(bs, 0))
        n_reps = reps or (30 if bs <= 64 else 12)
        lats = []
        for i in range(n_reps):
            out, secs = timed(call, requests(bs, i + 1))
            if len(out["pred"]) != bs:
                raise AssertionError(f"{family}: {len(out['pred'])} predictions for {bs} graphs")
            lats.append(secs)
        p50, p99 = (float(np.percentile(lats, q)) for q in (50, 99))
        rows.append(emit({"family": family, "batch": bs,
                          "cold_first_call_ms": _ms(cold_s), "warmup_s": warmup_s,
                          "warmed_first_call_ms": _ms(warmed_first_s),
                          "warm_p50_ms": _ms(p50), "warm_p99_ms": _ms(p99),
                          "graphs_per_s_at_p50": bs / p50, "reps": n_reps,
                          "device": device.type}, card))
    return {"family": family, "rows": rows, "length_bucket": int(meta.get("max_len", 0) or 0)}


def main(argv: Optional[List[str]] = None) -> Dict:
    from ..utils.config import load_config, normalize_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--buckets", default=",".join(map(str, BATCH_BUCKETS)))
    ap.add_argument("--reps", type=int, default=None,
                    help="warm requests a bucket (default 30 up to 64, 12 above)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=os.path.join(RESULTS_DIR, "serve_bench"))
    ap.add_argument("--corpus", default=None,
                    help="graph-token corpus root (default: <out-dir>/graph-token)")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "serve_bench.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    buckets = [int(b) for b in args.buckets.split(",")]
    results = [bench_family(fam, normalize_config(load_config(config_file(fam))), device,
                            buckets, args.reps, args.epochs, args.out_dir, args.corpus)
               for fam in args.families.split(",")]
    summary = {"batch_buckets": buckets, "task": TASK, "families": results}
    save(args.out, summary)
    return emit({"summary": "serve_bench", "batch_buckets": buckets,
                 "warm_p50_ms": {f["family"]: {r["batch"]: r["warm_p50_ms"] for r in f["rows"]}
                                 for f in results},
                 "device": device.type}, device_info(device))


if __name__ == "__main__":
    main()
