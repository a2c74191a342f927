"""The port's observability surface: the images of ``train/viz.py``, the
test confusion-matrix PNG, the W&B images, tables and histograms (against a
stub ``wandb`` module: the package is not installed) and the
``train.profile_epochs`` trace.

The viz cases are those of the JAX package's ``tests/test_viz.py``, on the
port. The trainer cases run MPNN on a small cycle_check corpus for two
epochs with dropout on: with wandb the run logs a histogram of every
parameter and of its gradient at each epoch's end, and its step and eval
losses equal, bit for bit, those of the same run without wandb (the grad
probe draws its dropout seeds out of the run's stream and puts the
BatchNorm statistics back).
"""

import os
import sys
import types

import numpy as np
import pytest

from glearning_benchmark_tpu_torch.convert import flax_path
from glearning_benchmark_tpu_torch.data import generator as G
from glearning_benchmark_tpu_torch.train import trainer
from glearning_benchmark_tpu_torch.train.viz import (
    create_confusion_matrix_heatmap,
    create_graph_visualizations,
    log_graph_examples,
    visualize_graph,
)


def test_log_graph_examples_text():
    gs = [G.generate_graph("ba", s) for s in range(3)]
    txt = log_graph_examples(gs, task="cycle_check", num_examples=2)
    assert "Example Graphs" in txt and "Nodes:" in txt


def test_visualize_graph_image():
    g = G.generate_graph("er", 1)
    img = visualize_graph(g, task="cycle_check")
    assert img.size[0] > 100 and img.size[1] > 100


def test_confusion_heatmap():
    cm = np.array([[40, 3], [2, 55]])
    img = create_confusion_matrix_heatmap(cm, task="cycle_check")
    assert img.size[0] > 100
    cm7 = np.diag(np.arange(1, 8))
    img7 = create_confusion_matrix_heatmap(cm7, task="shortest_path")
    assert img7.size[0] > 100


def test_create_graph_visualizations_batch():
    gs = [G.generate_graph("path", s) for s in range(2)]
    imgs = create_graph_visualizations(gs, task="cycle_check", num_examples=2)
    assert len(imgs) == 2


class _Stub(types.ModuleType):
    """A ``wandb`` module that records what it is handed."""

    def __init__(self):
        super().__init__("wandb")
        self.logged = []
        self.Image = lambda img, caption="": ("image", img, caption)
        self.Table = lambda columns, data: ("table", columns, data)
        self.Histogram = lambda values: ("histogram", np.asarray(values))

    def init(self, **kw):
        self.init_kw = kw

    def log(self, d):
        self.logged.append(dict(d))

    def finish(self):
        self.finished = True


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gt") / "graph-token")
    G.ensure_corpus(root, tasks=("cycle_check",), algorithms=("ba", "sbm", "sfn"),
                    number_of_graphs=10, test_graphs=6)
    return root


def _run(corpus, out, wandb_use, profile_epochs=()):
    cfg = {"dataset": {"task": "cycle_check", "graph_token_root": corpus,
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "num_graphs": 10, "num_pairs_per_graph": 3,
                       "generate_num_graphs": 10, "cache": False},
           "model": {"hidden_dim": 16, "num_layers": 2, "dropout": 0.1,
                     "compute_dtype": "float32"},
           "train": {"batch_size": 16, "epochs": 2, "lr": 1e-3, "weight_decay": 1e-2,
                     "seed": 0, "profile_epochs": list(profile_epochs)},
           "output": {"out_dir": str(out), "run_name": "mpnn-viz"},
           "wandb": {"use": wandb_use}}
    return trainer.train(cfg, "mpnn", limit=60, verbose=False, device="cpu")


def test_wandb_run_logs_everything_and_trains_as_without(corpus, tmp_path, monkeypatch):
    stub = _Stub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    with_wandb = _run(corpus, tmp_path / "on", True)
    monkeypatch.delitem(sys.modules, "wandb")
    without = _run(corpus, tmp_path / "off", False, profile_epochs=(1,))

    # the run itself: bit for bit the same
    assert len(with_wandb.step_losses) == 2
    for a, b in zip(with_wandb.step_losses, without.step_losses):
        assert np.array_equal(a, b)
    for key in ("train/loss", "val/loss", "val/acc"):
        assert [h[key] for h in with_wandb.history] == [h[key] for h in without.history]
    assert with_wandb.test_metrics["loss"] == without.test_metrics["loss"]

    # a histogram for every parameter and every gradient, at each epoch's end
    names = {"/".join(flax_path(n)[0]) for n, _ in with_wandb.model.named_parameters()}
    hists = [d for d in stub.logged if any(k.startswith("parameters/") for k in d)]
    grads = [d for d in stub.logged if any(k.startswith("gradients/") for k in d)]
    assert [d["epoch"] for d in hists] == [1, 2] and [d["epoch"] for d in grads] == [1, 2]
    for logged, prefix in ((hists, "parameters"), (grads, "gradients")):
        for d in logged:
            assert {k.split("/", 1)[1] for k in d if k != "epoch"} == names
            assert all(v[0] == "histogram" and np.isfinite(v[1]).all()
                       for k, v in d.items() if k != "epoch")
    assert any(np.abs(v[1]).max() > 0 for k, v in grads[0].items() if k != "epoch")

    # the confusion matrix: the PNG on disk, one image and one table
    for out in ("on", "off"):
        assert os.path.getsize(tmp_path / out / "mpnn-viz_test_cm.png") > 0
    images = [d for d in stub.logged if "test/confusion_matrix_heatmap" in d]
    tables = [d for d in stub.logged if "test/confusion_matrix" in d]
    assert len(images) == 1 and images[0]["test/confusion_matrix_heatmap"][0] == "image"
    assert len(tables) == 1
    _, columns, data = tables[0]["test/confusion_matrix"]
    assert columns == ["True/Pred", "No", "Yes"] and len(data) == 2
    assert stub.finished

    # profile_epochs [1]: a torch.profiler Chrome trace of epoch 1
    traces = os.listdir(tmp_path / "off" / "mpnn-viz_trace")
    assert traces == ["epoch_001.json"]
    assert os.path.getsize(tmp_path / "off" / "mpnn-viz_trace" / traces[0]) > 0
    assert not os.path.exists(tmp_path / "on" / "mpnn-viz_trace")
