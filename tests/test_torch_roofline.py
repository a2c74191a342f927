"""The port's roofline tool (``tools.roofline``) on the CPU, against the
root ``tools/roofline.py``'s cost model.

A results file of two fabricated campaign runs measured on an H100 (a
token model, ibtt-cycle, and a graph model, mpnn-cycle, on a 10-graph
corpus): the port's ``epoch_flops``, ``flop_bound_s`` and ``hbm_bound_s``
equal the root tool's formulas on the JAX package's own bundles of those
runs at the H100's data-sheet peaks; every line names the card and its
power limit; a per-step overhead adds steps x overhead to the bound; a
run measured on the host has no peaks and raises.
"""

import contextlib
import copy
import importlib.util
import io
import json
import os

import pytest

from glearning_benchmark_tpu.train import datasets as jax_datasets
from glearning_benchmark_tpu.utils.config import load_config, normalize_config
from glearning_benchmark_tpu_torch.data import generator
from glearning_benchmark_tpu_torch.tools import roofline, run_benchmarks

H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
PEAK_FLOPS, PEAK_HBM = 989.4e12, 3.35e12        # the card's data sheet
EXTRA = {"dataset.generate_num_graphs": 10}     # the campaign's --override


def _result(model: str, epoch_s: float, card: dict = H100) -> dict:
    return {"model": model, "task": "cycle_check", "best_val": 1.0, "test": {},
            "epochs": 1, "steady_epoch_s": epoch_s, "graphs_per_sec": 1.0,
            "device": "cuda", "card": card, "overrides": EXTRA}


def _root_cost(name: str) -> tuple:
    """(epoch FLOPs, HBM bytes) of run ``name`` by the root tool's formulas
    on the JAX package's bundle of its config."""
    spec = importlib.util.spec_from_file_location(
        "root_roofline", os.path.join(run_benchmarks.REPO, "tools", "roofline.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    _, model, path, over = next(r for r in run_benchmarks.RUNS_FULL if r[0] == name)
    cfg = run_benchmarks.apply_overrides(
        normalize_config(load_config(os.path.join(run_benchmarks.REPO, path))),
        {**over, **EXTRA})
    mc = cfg["model"]
    if model == "ibtt":
        tr = jax_datasets.build_ibtt_dataset(cfg["dataset"], seed=0).splits["train"]
        density = float((tr["seg"] > 0).mean() if "seg" in tr else tr["mask"].mean())
        return root.transformer_cost(*tr["ids"].shape, mc["d_model"], mc["d_ff"],
                                     mc["nlayers"], mc["nhead"], packed_density=density)
    tr = jax_datasets.build_graph_dataset(cfg["dataset"], seed=0).splits["train"]
    return root.gnn_cost(len(tr["y"]), tr["adj"].shape[-1], mc["hidden_dim"],
                         mc["num_layers"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("roofline")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        generator.ensure_corpus("data/graph-token", tasks=("cycle_check",),
                                algorithms=("ba", "sbm", "sfn"), number_of_graphs=10,
                                seed=1234)
    return root


def _run(corpus, results: dict, *extra) -> tuple:
    path = corpus / "results_full.json"
    path.write_text(json.dumps(results))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(corpus)
        report = roofline.main(["--results", str(path), "--out",
                                str(corpus / "roofline.json"), *extra])
    return report, [json.loads(line) for line in out.getvalue().splitlines()]


def test_bounds_equal_the_root_tool_at_the_h100_peaks(corpus):
    results = {"ibtt-cycle": _result("ibtt", 0.0874), "mpnn-cycle": _result("mpnn", 0.1919)}
    report, lines = _run(corpus, results)
    assert [line["run"] for line in lines] == ["ibtt-cycle", "mpnn-cycle"]
    assert json.loads((corpus / "roofline.json").read_text()) == report
    for line in lines:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(corpus)
            flops, hbm = _root_cost(line["run"])
        assert line["card"] == H100
        assert line["epoch_flops"] == pytest.approx(flops, rel=1e-12)
        assert line["flop_bound_s"] == pytest.approx(flops / PEAK_FLOPS, rel=1e-12)
        assert line["hbm_bound_s"] == pytest.approx(hbm / PEAK_HBM, rel=1e-12)
        assert line["bound_s"] == max(line["flop_bound_s"], line["hbm_bound_s"])
        assert line["binding"] in ("flops", "hbm")
        assert line["measured_s"] == results[line["run"]]["steady_epoch_s"]


def test_step_overhead_and_a_host_run(corpus):
    results = {"mpnn-cycle": _result("mpnn", 0.1919)}
    base, _ = _run(corpus, results)
    report, lines = _run(corpus, results, "--step-overhead-ms", "2.5")
    row, was = report["mpnn-cycle"], base["mpnn-cycle"]
    assert row["bound_s"] == pytest.approx(
        max(was["flop_bound_s"], was["hbm_bound_s"]) + row["steps_per_epoch"] * 2.5e-3)
    assert row["binding"] == "per-step overhead" and lines[0]["card"] == H100
    host = copy.deepcopy(results)
    host["mpnn-cycle"]["card"] = {"name": "cpu", "power_limit": "none"}
    with pytest.raises(KeyError, match="no datasheet peaks"):
        _run(corpus, host)
