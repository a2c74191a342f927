"""The results campaign of the port: train the reference configurations and
record their results beside the JAX package's (the root
``tools/run_benchmarks.py`` on the port's ``train()``).

    python -m glearning_benchmark_tpu_torch.tools.run_benchmarks \
        [--set quick|full|hard|extended|scaling] [--only NAME,...] \
        [--override KEY=JSON ...] [--device cpu]

The run lists (``RUNS_FULL``, ``RUNS_QUICK``, ``RUNS_HARD``,
``RUNS_EXTENDED``) and ``apply_overrides`` are the reference's, copied;
``train.epochs_per_dispatch`` is a plain loop in the port's trainer. Each
run executes in a child process (``--child``) under the reference's
watchdog: a child with no output for ``--stall-secs`` is killed and the run
retried, up to 4 attempts. ``--override KEY=JSON`` (repeatable) is applied
to every run after its own overrides, e.g. ``train.epochs=1`` for a smoke
run. ``--set scaling`` runs ``tools.scaling_bench``.

Writes ``runs_torch/results_<set>.json`` and ``.md`` (``--out``), the runs'
checkpoints and logs under ``runs_torch/campaign`` (the root ``RESULTS*.json``
are the JAX package's and are only read). Beside each run's ``best_val`` and
``test`` it puts the JAX package's figures for that run (``RESULTS.json``,
``RESULTS_HARD.json`` or ``RESULTS_EXTENDED.json``) and, where the JAX
package ran seeds of it (``RESULTS_seeds.json``, ``ZINC_SEEDS.json``),
whether the port's ``best_val`` lies within their spread. These are
accuracies (ZINC: MAE), not speeds.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..utils.card import device_info
from ..utils.device import resolve_device
from . import RESULTS_DIR, emit, save

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (run name, model, config path, overrides): the reference's lists
RUNS_FULL = [
    # cycle_check (train ba+sbm, OOD test sfn) — baselines: MPNN .9961,
    # GPS .9822, AGTT .9727, IBTT .9651 val acc
    ("ibtt-cycle", "ibtt", "configs/ibtt_graph_token.yaml", {}),
    ("mpnn-cycle", "mpnn", "configs/mpnn_graph_token.yaml", {"dataset.num_graphs": 500}),
    ("agtt-cycle", "agtt", "configs/agtt_graph_token.yaml", {"dataset.num_graphs": 500}),
    ("gps-cycle", "ggps", "configs/gps_graph_token.yaml", {"dataset.num_graphs": 500}),
    # shortest_path — IBTT/AGTT train on path; MPNN/GPS on er+sbm+path
    ("ibtt-sp", "ibtt", "configs/ibtt_graph_token.yaml",
     {"dataset.task": "shortest_path", "dataset.train_algorithms": ["path"],
      "dataset.test_algorithm": "er", "train.epochs": 300,
      "train.epochs_per_dispatch": 25, "output.run_name": "ibtt-sp"}),
    ("agtt-sp", "agtt", "configs/agtt_graph_token.yaml",
     {"dataset.task": "shortest_path", "dataset.train_algorithms": ["path"],
      "dataset.test_algorithm": "er", "dataset.num_graphs": 500,
      "train.epochs": 300, "train.epochs_per_dispatch": 25,
      "output.run_name": "agtt-sp"}),
    ("mpnn-sp", "mpnn", "configs/mpnn_graph_token.yaml",
     {"dataset.task": "shortest_path",
      "dataset.train_algorithms": ["er", "sbm", "path"],
      "dataset.test_algorithm": "ba", "dataset.num_graphs": 300,
      "train.epochs": 300, "train.epochs_per_dispatch": 25,
      "output.run_name": "mpnn-sp"}),
    ("gps-sp", "ggps", "configs/gps_graph_token.yaml",
     {"dataset.task": "shortest_path",
      "dataset.train_algorithms": ["er", "sbm", "path"],
      "dataset.test_algorithm": "ba", "dataset.num_graphs": 300,
      "train.epochs": 300, "train.epochs_per_dispatch": 25,
      "output.run_name": "gps-sp"}),
    # zinc (stand-in corpus unless a real export is present)
    ("ibtt-zinc", "ibtt", "configs/ibtt_zinc.yaml",
     {"train.epochs_per_dispatch": 10}),
    ("agtt-zinc", "agtt", "configs/agtt_zinc.yaml",
     {"train.epochs_per_dispatch": 10}),
    ("mpnn-zinc", "mpnn", "configs/mpnn_zinc.yaml",
     {"train.epochs_per_dispatch": 10}),
    ("gps-zinc", "ggps", "configs/gps_zinc.yaml",
     {"train.epochs_per_dispatch": 10}),
]

RUNS_QUICK = [r[:3] + ({**r[3], "train.epochs": 10},) for r in RUNS_FULL[:4]]

# the reference's difficulty-calibrated preset (dataset.difficulty: hard)
_HARD = {"dataset.difficulty": "hard", "dataset.num_graphs": 500,
         "train.epochs_per_dispatch": 10}
_HARD_CYC = {**_HARD, "dataset.train_algorithms": ["er", "sbm"],
             "dataset.test_algorithm": "ba"}
_HARD_SP = {**_HARD, "dataset.task": "shortest_path", "train.epochs": 300,
            "train.epochs_per_dispatch": 25}
RUNS_HARD = [
    ("ibtt-cycle-hard", "ibtt", "configs/ibtt_graph_token.yaml",
     {**_HARD_CYC, "output.run_name": "ibtt-cycle-hard"}),
    ("mpnn-cycle-hard", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_HARD_CYC, "output.run_name": "mpnn-cycle-hard"}),
    ("agtt-cycle-hard", "agtt", "configs/agtt_graph_token.yaml",
     {**_HARD_CYC, "output.run_name": "agtt-cycle-hard"}),
    ("gps-cycle-hard", "ggps", "configs/gps_graph_token.yaml",
     {**_HARD_CYC, "output.run_name": "gps-cycle-hard"}),
    ("ibtt-sp-hard", "ibtt", "configs/ibtt_graph_token.yaml",
     {**_HARD_SP, "dataset.train_algorithms": ["path"],
      "dataset.test_algorithm": "er", "output.run_name": "ibtt-sp-hard"}),
    ("agtt-sp-hard", "agtt", "configs/agtt_graph_token.yaml",
     {**_HARD_SP, "dataset.train_algorithms": ["path"],
      "dataset.test_algorithm": "er", "output.run_name": "agtt-sp-hard"}),
    ("mpnn-sp-hard", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_HARD_SP, "dataset.train_algorithms": ["er", "sbm", "path"],
      "dataset.test_algorithm": "ba", "dataset.num_graphs": 300,
      "output.run_name": "mpnn-sp-hard"}),
    ("gps-sp-hard", "ggps", "configs/gps_graph_token.yaml",
     {**_HARD_SP, "dataset.train_algorithms": ["er", "sbm", "path"],
      "dataset.test_algorithm": "ba", "dataset.num_graphs": 300,
      "output.run_name": "gps-sp-hard"}),
]

# the reference's other eight graph-token task families
_EXT = {"dataset.num_graphs": 500, "train.epochs": 100,
        "train.epochs_per_dispatch": 10}
RUNS_EXTENDED = [
    ("ibtt-reach", "ibtt", "configs/ibtt_graph_token.yaml",
     {**_EXT, "dataset.task": "reachability", "dataset.test_algorithm": "er",
      "output.run_name": "ibtt-reach"}),
    ("ibtt-edgeexist", "ibtt", "configs/ibtt_graph_token.yaml",
     {**_EXT, "dataset.task": "edge_existence",
      "output.run_name": "ibtt-edgeexist"}),
    ("agtt-maxflow", "agtt", "configs/agtt_graph_token.yaml",
     {**_EXT, "dataset.task": "maximum_flow",
      "output.run_name": "agtt-maxflow"}),
    ("mpnn-degree", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_EXT, "dataset.task": "node_degree", "output.run_name": "mpnn-degree"}),
    ("mpnn-nodecount", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_EXT, "dataset.task": "node_count",
      "output.run_name": "mpnn-nodecount"}),
    ("mpnn-nodecount-add", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_EXT, "dataset.task": "node_count", "model.pooling": "add",
      "output.run_name": "mpnn-nodecount-add"}),
    ("mpnn-nodeclass", "mpnn", "configs/mpnn_graph_token.yaml",
     {**_EXT, "dataset.task": "node_classification",
      "dataset.train_algorithms": ["sbm"], "dataset.test_algorithm": "sbm",
      "output.run_name": "mpnn-nodeclass"}),
    ("gps-triangle", "ggps", "configs/gps_graph_token.yaml",
     {**_EXT, "dataset.task": "triangle_count",
      "output.run_name": "gps-triangle"}),
    ("gps-edgecount", "ggps", "configs/gps_graph_token.yaml",
     {**_EXT, "dataset.task": "edge_count",
      "output.run_name": "gps-edgecount"}),
]

SETS = {"quick": RUNS_QUICK, "full": RUNS_FULL, "hard": RUNS_HARD,
        "extended": RUNS_EXTENDED}
# the JAX package's result table of each set
JAX_RESULTS = {"quick": "RESULTS.json", "full": "RESULTS.json", "hard": "RESULTS_HARD.json",
               "extended": "RESULTS_EXTENDED.json"}
ZINC_FAMILY = {"ibtt-zinc": "ibtt", "agtt-zinc": "agtt", "mpnn-zinc": "mpnn",
               "gps-zinc": "ggps"}


def apply_overrides(cfg: dict, overrides: dict) -> dict:
    for key, val in overrides.items():
        cur = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return cfg


def run_one(name: str, model: str, config_path: str, overrides: dict,
            result_path: str, device: str) -> None:
    """Child entry: one training run; its result JSON to ``result_path``."""
    from ..train.trainer import train
    from ..utils.config import load_config, normalize_config

    path = config_path if os.path.isfile(config_path) else os.path.join(REPO, config_path)
    cfg = normalize_config(load_config(path))
    cfg["output"]["out_dir"] = os.path.join(RESULTS_DIR, "campaign")
    cfg = apply_overrides(cfg, overrides)
    cfg.setdefault("output", {})["run_name"] = name
    t0 = time.time()
    res = train(cfg, model, verbose=True, device=device)
    te = {k: (float(v) if not hasattr(v, "tolist") else None)
          for k, v in res.test_metrics.items() if k != "confusion_matrix"}
    epochs = res.history
    # the last half: the first epochs carry the warm-up
    steady = [h["time/epoch_duration"] for h in epochs[len(epochs) // 2:]] or \
             [h["time/epoch_duration"] for h in epochs]
    out = {
        "model": model,
        "task": cfg["dataset"]["task"],
        "best_val": float(res.best_val),
        "test": te,
        "wall_s": round(time.time() - t0, 1),
        "epochs": len(epochs),
        "steady_epoch_s": round(sum(steady) / max(len(steady), 1), 4),
        "graphs_per_sec": round(max(h["throughput/graphs_per_sec"] for h in epochs), 1),
        "device": device,
    }
    with open(result_path, "w") as f:
        json.dump(out, f)


_current_child = None


def _kill_child(signum=None, frame=None):
    if _current_child is not None and _current_child.poll() is None:
        _current_child.kill()
    if signum is not None:
        sys.exit(1)


def run_with_watchdog(name, model, config_path, overrides, result_path, device: str,
                      stall_secs: int, max_tries: int = 4) -> dict:
    """Run the child under a no-output-progress watchdog with retries."""
    global _current_child

    payload = json.dumps([name, model, config_path, overrides, result_path, device])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    for attempt in range(1, max_tries + 1):
        if os.path.exists(result_path):
            os.unlink(result_path)
        log = f"{result_path}.log"
        with open(log, "w") as lf:
            proc = subprocess.Popen([sys.executable, "-u", "-m", __spec__.name, "--child",
                                     payload], stdout=lf, stderr=subprocess.STDOUT, env=env)
            _current_child = proc
        last_size, last_change = -1, time.time()
        while True:
            rc = proc.poll()
            size = os.path.getsize(log) if os.path.exists(log) else 0
            if size != last_size:
                last_size, last_change = size, time.time()
            if rc is not None:
                break
            if time.time() - last_change > stall_secs:
                print(f"[{name}] attempt {attempt}: stalled "
                      f"({stall_secs}s without output) — killing", flush=True)
                proc.kill()
                proc.wait()
                rc = -9
                break
            time.sleep(1)
        if rc == 0 and os.path.exists(result_path):
            with open(result_path) as f:
                return json.load(f)
        print(f"[{name}] attempt {attempt} failed (rc={rc}); log tail:", flush=True)
        try:
            with open(log) as f:
                print("".join(f.readlines()[-8:]), flush=True)
        except OSError:
            pass
        time.sleep(10)
    return {"model": model, "error": f"failed after {max_tries} attempts"}


def _read(name: str) -> dict:
    path = os.path.join(REPO, name)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def seed_spread(name: str) -> Optional[List[float]]:
    """[lowest, highest] ``best_val`` of the JAX package's seeds of run
    ``name`` (its seed 0 from RESULTS.json, seeds 1 and 2 from
    RESULTS_seeds.json; ZINC_SEEDS.json for the ZINC runs), or None where it
    ran no seeds."""
    if name in ZINC_FAMILY:
        vals = _read("ZINC_SEEDS.json").get("_summary", {}).get(ZINC_FAMILY[name], {})
        vals = vals.get("vals")
    else:
        seeds = _read("RESULTS_seeds.json")
        vals = [r["best_val"] for k, r in seeds.items() if k.rsplit("-s", 1)[0] == name]
        if vals and name in _read("RESULTS.json"):
            vals.append(_read("RESULTS.json")[name]["best_val"])
    return [min(vals), max(vals)] if vals else None


def compare(name: str, result: dict, set_name: str) -> dict:
    """The JAX package's figures of run ``name`` beside the port's."""
    ref = _read(JAX_RESULTS[set_name]).get(name)
    out = {"jax_best_val": None, "jax_test": None, "jax_seed_spread": seed_spread(name),
           "within_seed_spread": None}
    if ref:
        out["jax_best_val"] = ref.get("best_val")
        out["jax_test"] = ref.get("test")
    spread = out["jax_seed_spread"]
    if spread and "best_val" in result:
        out["within_seed_spread"] = spread[0] <= result["best_val"] <= spread[1]
    return out


def markdown(results: dict, title: str) -> List[str]:
    lines = [title, "",
             "| run | model | task | best val | JAX best val | within JAX seeds | test | "
             "JAX test | steady epoch (s) | graphs/s |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for name, r in results.items():
        if "error" in r:
            lines.append(f"| {name} | {r['model']} | — | ERROR | | | {r['error'][:60]} | | | |")
            continue
        key = "mae" if r["task"] == "zinc" else "accuracy"
        jax_test = (r.get("jax_test") or {}).get(key)
        jbv = r.get("jax_best_val")
        lines.append(
            f"| {name} | {r['model']} | {r['task']} | {r['best_val']:.4f} | "
            f"{'—' if jbv is None else f'{jbv:.4f}'} | "
            f"{'—' if r.get('within_seed_spread') is None else r['within_seed_spread']} | "
            f"{key}={r['test'].get(key):.4f} | "
            f"{'—' if jax_test is None else f'{key}={jax_test:.4f}'} | "
            f"{r['steady_epoch_s']} | {r['graphs_per_sec']} |")
    return lines


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", default="full", choices=["quick", "full", "scaling", "extended",
                                                      "hard"])
    ap.add_argument("--only", default=None, help="comma-separated run names")
    ap.add_argument("--override", action="append", default=[], metavar="KEY=JSON",
                    help="set KEY (dotted) to the JSON value in every run")
    ap.add_argument("--out", default=None,
                    help="default runs_torch/results_<set>.json (and .md beside it)")
    ap.add_argument("--stall-secs", type=int, default=600)
    ap.add_argument("--rerun", action="store_true",
                    help="re-run entries already present in --out")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args, rest = ap.parse_known_args(argv)

    if args.child:
        run_one(*json.loads(args.child))
        return {}
    if args.set == "scaling":
        from . import scaling_bench

        return scaling_bench.main(rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    device = resolve_device(args.device)
    card = device_info(device)
    extra = {}
    for item in args.override:
        key, _, val = item.partition("=")
        extra[key] = json.loads(val)
    runs = SETS[args.set]
    if args.only:
        wanted = set(args.only.split(","))
        runs = [r for r in runs if r[0] in wanted]
    out = args.out or os.path.join(RESULTS_DIR, f"results_{args.set}.json")
    results = {}
    if os.path.isfile(out):
        with open(out) as f:
            results = json.load(f)

    signal.signal(signal.SIGTERM, _kill_child)
    signal.signal(signal.SIGINT, _kill_child)
    work = os.path.join(os.path.dirname(os.path.abspath(out)), "campaign_results")
    os.makedirs(work, exist_ok=True)
    for name, model, config_path, overrides in runs:
        if not args.rerun and name in results and "error" not in results[name]:
            print(f"[{name}] already done — skipping", flush=True)
            continue
        print(f"\n{'=' * 80}\nRUN {name} ({model})\n{'=' * 80}", flush=True)
        res = run_with_watchdog(name, model, config_path, {**overrides, **extra},
                                os.path.join(work, f"{name}.json"), device.type,
                                args.stall_secs)
        res.update(card=card, overrides=extra, **compare(name, res, args.set))
        results[name] = res
        save(out, results)
        emit({"run": name, **res}, card)

    out_md = os.path.splitext(out)[0] + ".md"
    title = f"# RESULTS of the port, set {args.set}, on {card['name']} ({card['power_limit']})"
    with open(out_md, "w") as f:
        f.write("\n".join(markdown(results, title)) + "\n")
    return emit({"summary": "run_benchmarks", "set": args.set, "out": out, "md": out_md,
                 "runs": list(results), "errors": [k for k, r in results.items()
                                                   if "error" in r]}, card)


if __name__ == "__main__":
    main()
