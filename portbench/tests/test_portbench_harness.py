"""The harness: cells found by name, the result line, the import check, and
BENCHMARK.json against the contract's shape rules."""

import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = tiny.REPO
BENCH = tiny.HERE


def test_throwaway_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = os.path.join(root, "pb")
    with open(os.path.join(bench, "traffic", "odd.json"), "w") as f:
        json.dump({"driver": "train", "rows": "dense", "row_len": 8, "rows_per_step": 2,
                   "steps_per_epoch": 4, "vocab": 9}, f)
    with open(os.path.join(bench, "limits", "tiny.odd.json"), "w") as f:
        json.dump({"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}, f)
    with open(os.path.join(bench, "metrics", "odd_metric.train.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.5 if ctx.window['steps'] else None\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "tiny.odd", "config": "tiny", "traffic": "odd",
                              "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "odd_metric.train", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "odd", "moves": "setup_s",
                              "workloads": ["tiny.odd"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny.odd")
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = harness.find_cell(root, "tiny.odd", bench)
    assert cell.traffic["row_len"] == 8 and cell.limits["loss_gap"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["odd_metric.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s", "setup_s"}
    line = tiny.run(root, "odd", trace=True)
    assert line["metrics"] == {"odd_metric.train": {"value": 42.5, "unit": "ms"}}
    assert line["correct"] is True


def test_a_reader_is_found_by_the_metric_name_then_its_base_name(tmp_path):
    bench = str(tmp_path)
    os.makedirs(os.path.join(bench, "metrics"))
    for name in ("base_ms.py", "base_ms.serve.py"):
        open(os.path.join(bench, "metrics", name), "w").close()
    path = lambda name: os.path.basename(harness.reader_path(bench, name))  # noqa: E731
    assert path("base_ms.train") == "base_ms.py"
    assert path("base_ms.zinc") == "base_ms.py"
    assert path("base_ms.serve") == "base_ms.serve.py"
    assert path("base_ms") == "base_ms.py"


def _outcome(checks, failed=0):
    return harness.Outcome(e2e={"setup_s": 1.5, "train_tokens_per_s": 10.0}, ctx=None,
                           checks=checks, attempted=4, failed=failed, memory_peak_bytes=7)


def test_result_line_keys_and_correct(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = harness.find_cell(root, "tiny.dense", os.path.join(root, "pb"))
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 7}
    line = harness.result(cell, _outcome({"loss_gap": (1e-4, 1e-3)}), False, dev)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert line["checks"] == {"loss_gap": {"value": 1e-4, "limit": 1e-3}}
    assert harness.result(cell, _outcome({"loss_gap": (2e-3, 1e-3)}), False, dev)[
        "correct"] is False
    assert harness.result(cell, _outcome({"loss_gap": (0.0, 1e-3)}, failed=1), False, dev)[
        "correct"] is False
    bad = harness.result(cell, _outcome({"loss_gap": (float("inf"), 1e-3)}), False, dev)
    assert bad["correct"] is False and bad["checks"]["loss_gap"]["value"] == sys.float_info.max
    assert "Infinity" not in json.dumps(bad)
    text = harness.check_lines(line)
    assert text == ["check loss_gap 0.0001 limit 0.001 ok"]
    assert json.loads(json.dumps(line)) == line


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    for name in ("glearning_benchmark_tpu_torch", "glearning_benchmark_tpu_torch.serve",
                 "jaxtyping", "flaxen", "jaxlibx"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("jax", "jaxlib", "flax", "glearning_benchmark_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "glearning_benchmark_tpu.ops",
                        types.ModuleType("glearning_benchmark_tpu.ops"))
    assert harness.forbidden_modules() == ["glearning_benchmark_tpu", "jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
            assert not name.startswith(("glearning_benchmark_tpu_torch.tools", "chip_smoke")), \
                (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "hashlib", "os", "math", "dataclasses",
                                          "typing", "numpy", "torch"), (path, name)


def test_importing_the_benchmark_loads_neither_jax_nor_the_port():
    code = ("import sys, portbench.harness, portbench.check, portbench.control, "
            "portbench.drivers.train, portbench.devtrace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'glearning_benchmark_tpu', "
            "'glearning_benchmark_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract_shape():
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in spec["command"])
    configs = {c["name"]: c for c in spec["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    cells = [w["name"] for w in spec["workloads"]]
    assert len(cells) == len(set(cells))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))
    names = set()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert os.path.isfile(harness.reader_path(BENCH, m["name"]))
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in spec["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in spec["per_layer"])


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tt_d1024.train_packed", "--seed", str(2**31 + 5), "--seconds", "3",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
