"""Finding a cell's parts by name, running it, and printing its result.

``BENCHMARK.json`` (at the root) names the cells. A cell's configuration
file is the one its ``configs`` entry gives; its traffic mix is
``traffic/<mix>.json``, whose ``driver`` key names the module of
``drivers/`` that runs it; the limits of its output check are
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``, or where that file is missing by the reader of its
base name, the metric's name without its last ``.<suffix>`` (``mfu.train``
by ``metrics/mfu.py``, which a later ``mfu.serve`` shares unless it brings
``metrics/mfu.serve.py``). A driver returns an :class:`Outcome`; this
module turns it into the result line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "glearning_benchmark_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    cache: str                      # fixed directory of the run's caches and data
    bench_dir: str = HERE


@dataclass
class Outcome:
    """What a driver measured. ``e2e``: the end-to-end values by name;
    ``ctx``: what the per-layer readers read; ``checks``: {name: (value,
    limit)}, each passing when value <= limit."""

    e2e: Dict[str, float]
    ctx: Any
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None
    extra: Dict[str, Any] = field(default_factory=dict)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def find_cell(root: str, workload: str, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, with its files
    read from ``bench_dir``."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(known: {', '.join(sorted(by_name))})")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(os.path.join(root, conf["file"])),
                traffic=load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
                limits=load_json(os.path.join(bench_dir, "limits", f"{workload}.json")),
                end_to_end=e2e, per_layer=layer,
                cache=os.path.join(root, "_portbench_cache"), bench_dir=bench_dir)


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reader_path(bench_dir: str, metric: str) -> str:
    """``metrics/<metric>.py``, else the reader of the metric's base name."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(bench_dir, "metrics", f"{metric.rsplit('.', 1)[0]}.py")
    return path


def reader(cell: Cell, metric: str) -> Callable[[Any], Optional[float]]:
    path = reader_path(cell.bench_dir, metric)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of ``sys.modules`` that the run may not hold,
    compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def result(cell: Cell, out: Outcome, trace: bool, device: Dict[str, Any]) -> Dict[str, Any]:
    """The result line's object, with ``checks`` last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = reader(cell, m["name"])(out.ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = float(out.e2e[m["name"]])
            metrics[m["name"]] = {"value": v if math.isfinite(v) else sys.float_info.max,
                                  "unit": m["unit"]}
    correct = (out.failed == 0 and bool(out.checks)
               and all(math.isfinite(v) and v <= lim for v, lim in out.checks.values()))
    # JSON has no infinity: a number that could not be read prints as the
    # largest float
    checks = {k: {"value": float(v) if math.isfinite(v) else sys.float_info.max,
                  "limit": float(lim)} for k, (v, lim) in out.checks.items()}
    line = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line.update(out.extra)
    line["checks"] = checks
    return line


def check_lines(line: Dict[str, Any]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            f" {'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for k, c in line["checks"].items()]
