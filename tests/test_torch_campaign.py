"""The port's results campaign (``tools.run_benchmarks``) on the CPU: its
run lists and overrides equal the root tool's, read from the root file's
source as data (its assignments, not its imports), and one tiny 1-epoch
MPNN cycle_check run goes through the watchdog child and is put beside the
JAX package's figures.
"""

import ast
import json
import pathlib

from glearning_benchmark_tpu_torch.data import generator
from glearning_benchmark_tpu_torch.tools import run_benchmarks

REPO = pathlib.Path(__file__).resolve().parent.parent
LISTS = ("RUNS_FULL", "RUNS_QUICK", "RUNS_HARD", "RUNS_EXTENDED")


def _root_data() -> dict:
    """The root tool's run lists and ``apply_overrides``, executed alone."""
    tree = ast.parse((REPO / "tools" / "run_benchmarks.py").read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith(("RUNS_", "_HARD", "_EXT")))
            or (isinstance(node, ast.FunctionDef) and node.name == "apply_overrides")]
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "run_benchmarks", "exec"), ns)
    return ns


def test_run_lists_and_overrides_equal_the_root_tool():
    ref = _root_data()
    for name in LISTS:
        assert getattr(run_benchmarks, name) == ref[name], name
    cfg = {"train": {"epochs": 100}, "dataset": {"task": "cycle_check"}}
    over = {"train.epochs": 3, "dataset.train_algorithms": ["er"], "model.pooling": "add"}
    assert (run_benchmarks.apply_overrides(json.loads(json.dumps(cfg)), over)
            == ref["apply_overrides"](json.loads(json.dumps(cfg)), over))


def test_one_epoch_mpnn_run(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)     # the config's corpus and the runs land here
    generator.ensure_corpus("data/graph-token", tasks=("cycle_check",),
                            algorithms=("ba", "sbm", "sfn"), number_of_graphs=10, seed=1234)
    run_benchmarks.main(["--only", "mpnn-cycle", "--override", "train.epochs=1",
                         "--override", "dataset.generate_num_graphs=10", "--device", "cpu"])
    res = json.loads((tmp_path / "runs_torch" / "results_full.json").read_text())
    run = res["mpnn-cycle"]
    jax = json.loads((REPO / "RESULTS.json").read_text())["mpnn-cycle"]
    assert run["epochs"] == 1 and 0.0 <= run["best_val"] <= 1.0
    assert 0.0 <= run["test"]["accuracy"] <= 1.0
    assert run["jax_best_val"] == jax["best_val"] and run["jax_test"] == jax["test"]
    assert run["jax_seed_spread"] == [1.0, 1.0]
    assert run["within_seed_spread"] == (run["best_val"] == 1.0)
    assert "| mpnn-cycle | mpnn | cycle_check |" in (
        tmp_path / "runs_torch" / "results_full.md").read_text()
