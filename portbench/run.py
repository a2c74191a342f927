"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m portbench.run`` from the root of the repo does the same.)
From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same checks are the last lines of standard error. Without the cards,
or with JAX or the JAX package loaded once the window has closed, the run
prints no result and exits with another code than 0.

Build and kernel caches, and the data the benchmark makes, are kept in
fixed directories inside the checkout (``_portbench_cache/`` and the
port's ``_build/``), so only a cell's first run in a checkout builds them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# run as a script, the script's own folder heads sys.path: the root takes
# its place, so that the benchmark's modules import only as ``portbench.*``
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.driver(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                   trace=bool(args.trace), device=device, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules that must not load were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
    line = harness.result(cell, out, bool(args.trace), dev)
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
