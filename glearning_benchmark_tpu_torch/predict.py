"""Batched inference CLI for the port (the serving entry point).

Port of the repository's ``predict.py``:

    python -m glearning_benchmark_tpu_torch.predict --checkpoint out/best_run \\
        --zinc-split val [--device cuda|cpu]
    python -m glearning_benchmark_tpu_torch.predict --checkpoint out/best_run \\
        --input records.json

Inputs: a graph-token records file (JSON array / JSONL / raw text lines),
or for zinc checkpoints a ZINC split (real export if present, else the
stand-in). Output: one JSON line per example on stdout (or --output); a
throughput summary goes to stderr. ``--device`` defaults to cuda and the
run fails without a GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _records_from_file(path: str, task: str):
    from .data.loader import _extract_text_and_label, _read_records
    out = []
    for rec in _read_records(path):
        text, label, _query = _extract_text_and_label(rec, task)
        if text:
            out.append({"text": text, "label": label})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint stem or .npz (out/best_<run>)")
    ap.add_argument("--input", default=None,
                    help="records file (JSON array / JSONL / raw text lines)")
    ap.add_argument("--zinc-split", default=None,
                    choices=["train", "val", "test"],
                    help="predict a ZINC split instead of --input")
    ap.add_argument("--zinc-root", default="./data/ZINC")
    ap.add_argument("--output", default=None, help="JSONL out (default stdout)")
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    from .serve import Predictor, predict_records
    from .train.metrics import class_names

    p = Predictor.from_checkpoint(args.checkpoint, max_batch=args.max_batch,
                                  device=args.device)
    print(f"[predict] {p.model_name} / {p.task} on {p.device} "
          f"(num_classes={p.bundle.num_classes})", file=sys.stderr)

    t0 = time.perf_counter()
    if args.zinc_split:
        from .data.zinc import load_zinc_split
        graphs = load_zinc_split(args.zinc_root, args.zinc_split)
        out = p.predict_graphs(graphs)
        n = len(graphs)
    elif args.input:
        records = _records_from_file(args.input, p.task)
        if not records:
            sys.exit(f"no parseable records in {args.input!r}")
        out = predict_records(p, records)
        n = len(records)
    else:
        sys.exit("pass --input or --zinc-split")
    dt = time.perf_counter() - t0

    sink = open(args.output, "w") if args.output else sys.stdout
    try:
        if p.task == "zinc":
            for i, v in enumerate(out["pred"]):
                sink.write(json.dumps({"index": i, "pred": round(float(v), 6)}) + "\n")
        else:
            names = class_names(p.task, p.bundle.num_classes)
            for i, (c, pr) in enumerate(zip(out["pred"], out["prob"])):
                sink.write(json.dumps({
                    "index": i, "pred": int(c),
                    "label": names[int(c)] if int(c) < len(names) else str(int(c)),
                    "prob": round(float(pr), 4)}) + "\n")
    finally:
        if args.output:
            sink.close()
    print(f"[predict] {n} examples in {dt:.3f}s "
          f"({n / max(dt, 1e-9):.0f} examples/s, first call builds the kernel)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
