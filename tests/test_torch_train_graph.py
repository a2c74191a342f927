"""Port parity: ``train()`` of the four model families on the synthetic
graph-token corpora, against the JAX package's trainer, CPU.

Both trainers start from one initial checkpoint (written by the port, with
the BatchNorm ``batch_stats`` of the graph models) and train 2 epochs on a
tiny corpus (train ba+sbm, test sfn) at f32 with dropout off:

- ``mpnn`` on ``shortest_path`` (query features), ``ggps`` on
  ``cycle_check`` (with the warmup-cosine schedule of its config),
  ``ibtt`` on packed ``cycle_check`` rows and ``agtt`` on packed
  ``shortest_path`` rows;
- the train loss and the learning rate of every epoch within rtol 1e-4,
  the same best epoch, the same log keys;
- the gradient norm and the val and test losses within rtol 1e-4 for the
  token models. For the graph models the gradient norm within rtol 1e-3
  and the val and test losses within rtol 1e-2 (atol 1e-6 for a test loss
  near 0). There, many gradient elements are zero in exact arithmetic (a
  bias that feeds a BatchNorm) or nearly so (the synthetic graphs' node
  features are constant), and AdamW divides each element by its own
  magnitude: the first step turns each side's rounding noise into a step
  of about the learning rate, while the first step's gradients agree
  closely (``test_torch_graph_models.py``). The eval forward sees the
  pre-BatchNorm biases through the lag of the running mean behind them,
  so it moves most; the train loss, where those biases cancel, least.

Also an ``mpnn`` checkpoint, ``batch_stats`` and optimizer state included,
resumed in the other package for one more epoch, and the trained
checkpoint served by the port's ``Predictor`` with the trainer's own eval
logits. The JAX token trainers run with ``use_flash: false`` (the XLA
attention), so no Pallas interpret call is made here.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import batch_stats_to_flax, params_to_flax
from glearning_benchmark_tpu_torch.data import generator
from glearning_benchmark_tpu_torch.data.graphs import Graph
from glearning_benchmark_tpu_torch.data.loader import load_examples_multi_algorithm
from glearning_benchmark_tpu_torch.serve import Predictor, predict_records
from glearning_benchmark_tpu_torch.train import checkpoint, trainer

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAPH_GN_RTOL = 1e-3
GRAPH_EVAL_RTOL = 1e-2
GRAPH_EVAL_ATOL = 1e-6
MODELS = {
    "mpnn": {"hidden_dim": 16, "num_layers": 2, "dropout": 0.0},
    "ggps": {"graph_pooling": "mean"},
    "ibtt": {"d_model": 16, "nhead": 4, "nlayers": 1, "d_ff": 32, "dropout": 0.0,
             "max_pos": 600, "use_flash": False},
    "agtt": {"d_model": 16, "nhead": 4, "nlayers": 1, "d_ff": 32, "dropout": 0.0,
             "max_pos": 600, "use_flash": False},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gt") / "graph-token")
    generator.ensure_corpus(root, tasks=("cycle_check", "shortest_path"),
                            algorithms=("ba", "sbm", "sfn"), number_of_graphs=10,
                            test_graphs=6)
    return root


def _config(corpus, out, model_name, task, pack=False, **train_extra):
    cfg = {"dataset": {"task": task, "graph_token_root": corpus,
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "num_graphs": 10, "num_pairs_per_graph": 3, "max_len": 600,
                       "max_vocab": 600, "generate_num_graphs": 10, "pack": pack,
                       "cache": False},
           "model": {**MODELS[model_name], "compute_dtype": "float32"},
           "train": {"batch_size": 16, "epochs": 2, "lr": 1e-3, "weight_decay": 1e-2,
                     "seed": 0, **train_extra},
           "output": {"out_dir": out, "run_name": "run"},
           "wandb": {"use": False}}
    if model_name == "ggps":
        cfg["gt"] = {"layers": 2, "n_heads": 4, "dim_hidden": 16, "dropout": 0.0,
                     "attn_dropout": 0.0}
    return cfg


def _train(side, config, model_name):
    """The JAX trainer on one device (no data-parallel mesh over the test
    process's virtual CPU devices) or the port on the CPU."""
    if side == "port":
        return trainer.train(config, model_name, verbose=False, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "make_mesh", lambda **kwargs: None)
        return jax_trainer.train(config, model_name, verbose=False)


def _both(tmp, model_name, config):
    """Both trainers from one initial checkpoint of the port's model."""
    init = os.path.join(tmp, "init")
    bundle = trainer.build_dataset(model_name, config["dataset"], 0)
    model = trainer.build_model(model_name, config, bundle,
                                generator=torch.Generator().manual_seed(7))
    checkpoint.save_checkpoint(init, {"params": params_to_flax(model.state_dict()),
                                      "batch_stats": batch_stats_to_flax(model.state_dict()),
                                      "epoch": 0})
    out = {}
    for side in ("jax", "port"):
        cfg = copy.deepcopy(config)
        cfg["output"]["out_dir"] = os.path.join(tmp, side)
        cfg["train"].update(resume=True, resume_path=init)
        out[side] = (_train(side, cfg, model_name), cfg)
    return out


def _best(cfg):
    with open(os.path.join(cfg["output"]["out_dir"], "best_run.json")) as f:
        meta = json.load(f)
    return meta["epoch"], meta["best_val"]


def _log_keys(cfg):
    with open(os.path.join(cfg["output"]["out_dir"], "run_metrics.jsonl")) as f:
        return [sorted(json.loads(line)) for line in f]


def _tolerances(graph):
    """{key: (rtol, atol)} of the per-epoch comparison."""
    tight = (LOSS_RTOL, 0.0)
    if not graph:
        return {k: tight for k in ("train/loss", "lr", "train/grad_norm", "val/loss",
                                   "test/loss")}
    return {"train/loss": tight, "lr": tight, "train/grad_norm": (GRAPH_GN_RTOL, 0.0),
            "val/loss": (GRAPH_EVAL_RTOL, GRAPH_EVAL_ATOL),
            "test/loss": (GRAPH_EVAL_RTOL, GRAPH_EVAL_ATOL)}


def _close(got, want, key, tol):
    rtol, atol = tol[key]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=key)


def _assert_same_run(runs, graph=False, epochs=2):
    (jres, jcfg), (pres, pcfg) = runs["jax"], runs["port"]
    tol = _tolerances(graph)
    assert len(pres.history) == len(jres.history) == epochs
    for ph, jh in zip(pres.history, jres.history):
        assert ph.keys() == jh.keys()
        for key in ("train/loss", "train/grad_norm", "lr", "val/loss"):
            _close(ph[key], jh[key], key, tol)
    assert _best(pcfg)[0] == _best(jcfg)[0]
    _close(pres.test_metrics["loss"], jres.test_metrics["loss"], "test/loss", tol)
    assert _log_keys(pcfg) == _log_keys(jcfg)


@pytest.fixture(scope="module")
def mpnn_runs(corpus, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mpnn"))
    config = _config(corpus, tmp, "mpnn", "shortest_path")
    return tmp, config, _both(tmp, "mpnn", config)


def test_mpnn_shortest_path_matches_jax(mpnn_runs):
    _, _, runs = mpnn_runs
    _assert_same_run(runs, graph=True)
    bundle = runs["port"][0].bundle
    assert bundle.kind == "graphs" and bundle.in_dim == 3 and bundle.num_classes > 2
    stats = runs["port"][0].batch_stats
    assert sorted(stats) == ["bn_0", "bn_1", "conv_0", "conv_1"]


@pytest.mark.parametrize("model_name,task,pack", [
    ("ggps", "cycle_check", False), ("ibtt", "cycle_check", True),
    ("agtt", "shortest_path", True)])
def test_family_matches_jax(corpus, tmp_path, model_name, task, pack):
    extra = ({"scheduler": "cosine_with_warmup", "num_warmup_epochs": 1}
             if model_name == "ggps" else {})
    config = _config(corpus, str(tmp_path), model_name, task, pack=pack, **extra)
    runs = _both(str(tmp_path), model_name, config)
    _assert_same_run(runs, graph=model_name == "ggps")
    assert ("seg" in runs["port"][0].bundle.splits["train"]) == pack


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mpnn_checkpoint_resumes_in_the_other_package(mpnn_runs, writer):
    """The best checkpoint of ``writer``'s run (params, batch_stats, AdamW
    moments and count), resumed by the other package and by the writer for
    one more epoch: the same epoch, the same train loss."""
    tmp, config, runs = mpnn_runs
    _, wcfg = runs[writer]
    ckpt = os.path.join(wcfg["output"]["out_dir"], "best_run")
    epoch, _ = _best(wcfg)
    saved = checkpoint.load_checkpoint(ckpt)
    assert sorted(checkpoint._flatten(saved["batch_stats"])) == sorted(
        f"{m}/{s}" for m in ("bn_0", "bn_1", "conv_0/mlp_bn", "conv_1/mlp_bn")
        for s in ("mean", "var"))
    results = {}
    for side in ("jax", "port"):
        cfg = copy.deepcopy(config)
        cfg["output"]["out_dir"] = os.path.join(tmp, f"resume_{writer}_{side}")
        cfg["train"].update(resume=True, resume_path=ckpt, epochs=epoch + 1)
        results[side] = _train(side, cfg, "mpnn")
    jh, ph = results["jax"].history, results["port"].history
    assert len(jh) == len(ph) == 1 and ph[0]["epoch"] == jh[0]["epoch"] == epoch + 1
    tol = _tolerances(graph=True)
    for key in ("train/loss", "train/grad_norm", "lr", "val/loss"):
        _close(ph[0][key], jh[0][key], key, tol)


def test_served_graph_checkpoint_gives_the_eval_logits(mpnn_runs, corpus):
    """The port's best mpnn checkpoint through ``Predictor`` (records of the
    sfn test split) equals the trainer's eval forward on the same graphs."""
    _, _, runs = mpnn_runs
    res, cfg = runs["port"]
    pred = Predictor.from_checkpoint(os.path.join(cfg["output"]["out_dir"], "best_run"),
                                     max_batch=8, device="cpu")
    assert pred.warmup([1, 8]) and pred.bundle.meta["n_max"] == res.bundle.meta["n_max"]
    records = load_examples_multi_algorithm(corpus, "shortest_path", ["sfn"], "test",
                                            num_graphs=10, num_pairs_per_graph=3)
    records = [r for r in records if r["label"] is not None]
    served = predict_records(pred, records)
    test = res.bundle.splits["test"]
    assert len(records) == len(test["y"])
    batch = {k: torch.from_numpy(v) for k, v in test.items()}
    res.model.eval()
    with torch.no_grad():
        own = trainer._apply_model(res.model, batch, res.bundle).numpy()
    np.testing.assert_allclose(served["logits"], own, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(served["pred"], own.argmax(-1))
    too_big = Graph(edges=np.zeros((0, 2), np.int32), num_nodes=res.bundle.meta["n_max"] + 1,
                    y=0)
    with pytest.raises(ValueError, match="node bucket"):
        pred.predict_graphs([too_big])
    # a graph checkpoint whose BatchNorm statistics are lost is refused
    ckpt = checkpoint.load_checkpoint(os.path.join(cfg["output"]["out_dir"], "best_run"))
    with pytest.raises(ValueError, match="batch_stats"):
        Predictor("mpnn", ckpt["config"], ckpt["params"], None, None, ckpt["serve"],
                  device="cpu")


def test_chip_smoke_graph_config_literals_match_configs():
    """``chip_smoke.py`` trains the shipped graph-token and GPS-ZINC configs
    from literals (the card's machine need not have PyYAML): each block
    equals the YAML file's after ``normalize_config``, as ``train()`` reads
    it."""
    import importlib.util

    from glearning_benchmark_tpu_torch.utils.config import load_config, normalize_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {name for _, name, _ in smoke.GRAPH_RUNS} == set(smoke.GRAPH_CONFIGS)
    for name, literal in smoke.GRAPH_CONFIGS.items():
        cfg = normalize_config(load_config(os.path.join(repo, "configs", f"{name}.yaml")))
        for block, value in literal.items():
            assert value == cfg[block], (name, block)
    assert smoke.GRAPH_TOKEN_DATASET["generate_num_graphs"] == 500
