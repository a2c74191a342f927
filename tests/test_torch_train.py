"""Port parity: the optimizer and the trainer against the JAX package, CPU.

- ``train/optim.py`` against the jitted ``optax.chain(clip_by_global_norm,
  adamw)`` update on random gradients (some above the clip norm), both
  ``mu_dtype``s, with and without the warmup-cosine schedule: parameters
  within 1e-6 after 25 steps.
- The two trainers on the same tiny ZINC run (stand-in molecules, 2 layers,
  d16, dropout 0, f32 compute, 2 epochs) from the same initial checkpoint,
  packed and unpacked, and on a hand-built classification bundle
  (cross-entropy and the confusion matrix): per-epoch train and val loss
  within rtol 1e-4 (f32; the two sides differ in summation order only), the
  same best epoch, the same log keys.
- A checkpoint written by either trainer resumes in the other, optimizer
  moments and schedule step included: the next epoch's losses agree.
- With dropout on, the port's run is reproducible from its seed and differs
  from the run without dropout.

The JAX trainer runs with ``use_flash: false`` (its XLA attention), so no
Pallas interpret call is made here.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from glearning_benchmark_tpu.train import datasets as jax_datasets
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import params_to_flax
from glearning_benchmark_tpu_torch.train import checkpoint, datasets, trainer
from glearning_benchmark_tpu_torch.train.optim import (
    ClippedAdamW,
    warmup_cosine_decay_schedule,
)

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_schedule", [False, True], ids=["constant", "schedule"])
@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_optimizer_matches_optax(mu_dtype, with_schedule):
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7,), (3, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if with_schedule:
        jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 20)
        tsched = warmup_cosine_decay_schedule(0.0, 1e-2, 5, 20)
        for step in (0, 3, 5, 12, 20, 30):
            np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                       rtol=1e-6, atol=1e-9)
    else:
        jsched = tsched = 1e-2
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(jsched, weight_decay=1e-2,
                    mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16" else None))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)        # the JAX trainer's step is jitted
    tp = [torch.tensor(p) for p in p0]
    opt = ClippedAdamW(["a", "b", "c"], tp, tsched, weight_decay=1e-2,
                       mu_dtype=mu_dtype)
    for i in range(25):
        scale = 0.1 if i % 3 else 3.0          # every third step is clipped
        g = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        u, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
        gnorm = opt.step([torch.tensor(x) for x in g])
        np.testing.assert_allclose(
            float(gnorm), float(np.sqrt(sum((x ** 2).sum() for x in g))), rtol=1e-5)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    leaves = jax.tree.leaves(state)
    assert len(leaves) == 1 + 2 * len(shapes) + int(with_schedule)
    assert int(leaves[0]) == opt.count == 25
    if with_schedule:
        assert int(leaves[-1]) == opt.schedule_count == 25
    assert opt.mu[0].dtype == getattr(torch, mu_dtype)
    # the stored first moment: within one rounding of its dtype
    np.testing.assert_allclose(
        opt.mu[0].float().numpy(), np.asarray(leaves[1].astype(jnp.float32)),
        rtol=8e-3 if mu_dtype == "bfloat16" else 1e-5, atol=1e-7)


def test_optimizer_refuses_an_unknown_mu_dtype():
    with pytest.raises(ValueError, match="mu_dtype"):
        ClippedAdamW(["a"], [torch.zeros(2)], 1e-3, mu_dtype="float16")


# ---------------------------------------------------------------------------
# the trainers, side by side
# ---------------------------------------------------------------------------

MODEL = {"use_flash": False, "d_model": 16, "nhead": 4, "nlayers": 2, "d_ff": 32,
         "dropout": 0.0, "max_pos": 300, "compute_dtype": "float32"}


def _config(root, name, pack, **train_extra):
    return {"dataset": {"task": "zinc", "zinc_root": os.path.join(root, "zinc"),
                        "subset": True, "max_len": 1024, "pack": pack,
                        "cache": False},
            "model": dict(MODEL),
            "train": {"batch_size": 16, "epochs": 2, "lr": 3e-3,
                      "weight_decay": 1e-2, "seed": 0, **train_extra},
            "output": {"out_dir": os.path.join(root, name), "run_name": "run"},
            "wandb": {"use": False}}


def _initial_checkpoint(path, model_name, config, bundle):
    """Initial weights both trainers start from: a checkpoint of epoch 0
    with no optimizer state, written by the port."""
    model = trainer.build_model(model_name, config, bundle,
                                generator=torch.Generator().manual_seed(7))
    checkpoint.save_checkpoint(path, {"params": params_to_flax(model.state_dict()),
                                      "epoch": 0})


def _train(side, config, model_name, limit):
    """One run of the JAX trainer (on one device: the test process's eight
    virtual CPU devices would make it build a data-parallel mesh and round
    the packed row batch to it) or of the port (on the CPU)."""
    if side == "port":
        return trainer.train(config, model_name, limit=limit, verbose=False,
                             device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "make_mesh", lambda **kwargs: None)
        return jax_trainer.train(config, model_name, limit=limit, verbose=False)


def _both(tmp, case, model_name, config, limit=None):
    """Run the JAX trainer and the port from one initial checkpoint."""
    init = os.path.join(tmp, f"{case}_init")
    bundle = trainer.build_dataset(model_name, config["dataset"], 0, limit=limit)
    _initial_checkpoint(init, model_name, config, bundle)
    out = {}
    for side in ("jax", "port"):
        cfg = copy.deepcopy(config)
        cfg["output"]["out_dir"] = os.path.join(tmp, f"{case}_{side}")
        cfg["train"].update(resume=True, resume_path=init)
        out[side] = (_train(side, cfg, model_name, limit), cfg)
    return out


def _best(cfg):
    with open(os.path.join(cfg["output"]["out_dir"], "best_run.json")) as f:
        meta = json.load(f)
    return meta["epoch"], meta["best_val"]


def _log_keys(cfg):
    with open(os.path.join(cfg["output"]["out_dir"], "run_metrics.jsonl")) as f:
        return [sorted(json.loads(line)) for line in f]


def _assert_same_run(runs):
    (jres, jcfg), (pres, pcfg) = runs["jax"], runs["port"]
    assert len(pres.history) == len(jres.history) == 2
    for ph, jh in zip(pres.history, jres.history):
        assert ph.keys() == jh.keys()
        for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
            np.testing.assert_allclose(ph[key], jh[key], rtol=LOSS_RTOL, err_msg=key)
    assert _best(pcfg)[0] == _best(jcfg)[0]
    np.testing.assert_allclose(pres.best_val, jres.best_val, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pres.test_metrics["loss"], jres.test_metrics["loss"],
                               rtol=LOSS_RTOL)
    assert _log_keys(pcfg) == _log_keys(jcfg)


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """agtt on packed ZINC rows with the warmup-cosine schedule and the
    bf16 first moment (the default); also feeds the resume test."""
    tmp = str(tmp_path_factory.mktemp("packed"))
    config = _config(tmp, "x", True, scheduler="cosine_with_warmup",
                     num_warmup_epochs=1)
    return tmp, config, _both(tmp, "packed", "agtt", config, limit=48)


def test_trainers_agree_packed_zinc(packed_runs):
    _, _, runs = packed_runs
    _assert_same_run(runs)
    assert "seg" in runs["port"][0].bundle.splits["train"]


def test_trainers_agree_unpacked_zinc(tmp_path):
    config = _config(str(tmp_path), "x", False, mu_dtype="float32")
    _assert_same_run(_both(str(tmp_path), "unpacked", "ibtt", config, limit=40))


def _classification_bundle(cls):
    """A hand-built 3-class token bundle: the label is the second token."""
    rng = np.random.default_rng(0)
    splits = {}
    for split, n in (("train", 40), ("val", 24), ("test", 24)):
        lens = rng.integers(5, 24, size=n)
        ids = rng.integers(5, 20, size=(n, 24)).astype(np.int32)
        ids[:, 0] = 1
        y = rng.integers(0, 3, size=n).astype(np.int32)
        ids[:, 1] = 5 + y
        mask = np.arange(24)[None, :] < lens[:, None]
        ids[~mask] = 0
        splits[split] = {"ids": ids, "mask": mask, "y": y}
    return cls(task="node_degree_sum", kind="tokens", splits=splits, num_classes=3,
               vocab={"<pad>": 0, "<bos>": 1}, vocab_size=20,
               meta={"max_len": 24, "pad_id": 0, "n_examples_train": 40})


def test_trainers_agree_on_cross_entropy(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_trainer, "build_dataset",
                        lambda *a, **k: _classification_bundle(jax_datasets.DatasetBundle))
    monkeypatch.setattr(trainer, "build_dataset",
                        lambda *a, **k: _classification_bundle(datasets.DatasetBundle))
    config = _config(str(tmp_path), "x", False)
    config["dataset"]["task"] = "node_degree_sum"
    runs = _both(str(tmp_path), "ce", "ibtt", config)
    _assert_same_run(runs)
    for key in ("train/acc", "val/acc", "val/f1", "train/precision"):
        np.testing.assert_allclose(runs["port"][0].history[-1][key],
                                   runs["jax"][0].history[-1][key], rtol=1e-6)
    np.testing.assert_array_equal(runs["port"][0].test_metrics["confusion_matrix"],
                                  runs["jax"][0].test_metrics["confusion_matrix"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_in_the_other_trainer(packed_runs, writer):
    """The best checkpoint of ``writer``'s run, resumed by both trainers for
    one more epoch: the same losses, so the moments, Adam's count and the
    schedule's count all crossed."""
    tmp, config, runs = packed_runs
    _, wcfg = runs[writer]
    ckpt = os.path.join(wcfg["output"]["out_dir"], "best_run")
    epoch, _ = _best(wcfg)
    saved = checkpoint.load_checkpoint(ckpt)
    n_params = len(checkpoint._flatten(saved["params"]))
    assert len(saved["opt_state"]) == 2 + 2 * n_params      # schedule count too
    assert saved["opt_state"]["000001"].dtype == torch.bfloat16
    steps = len(runs["port"][0].step_losses[0])             # steps an epoch
    assert int(saved["opt_state"]["000000"]) == steps * epoch
    assert int(saved["opt_state"][sorted(saved["opt_state"])[-1]]) == steps * epoch
    results = {}
    for side in ("jax", "port"):
        cfg = copy.deepcopy(config)
        cfg["output"]["out_dir"] = os.path.join(tmp, f"resume_{writer}_{side}")
        cfg["train"].update(resume=True, resume_path=ckpt, epochs=epoch + 1)
        results[side] = _train(side, cfg, "agtt", 48)
    jh, ph = results["jax"].history, results["port"].history
    assert len(jh) == len(ph) == 1 and ph[0]["epoch"] == jh[0]["epoch"] == epoch + 1
    for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
        np.testing.assert_allclose(ph[0][key], jh[0][key], rtol=LOSS_RTOL, err_msg=key)
    # a fresh optimizer would not have given these losses
    cfg = copy.deepcopy(config)
    cfg["output"]["out_dir"] = os.path.join(tmp, f"resume_{writer}_fresh")
    cfg["train"].update(resume=True, resume_path=ckpt, epochs=epoch + 1,
                        scheduler="none")      # leaf count differs: fresh state
    fresh = trainer.train(cfg, "agtt", limit=48, verbose=False, device="cpu")
    assert abs(fresh.history[0]["train/loss"] - ph[0]["train/loss"]) > 1e-3


# ---------------------------------------------------------------------------
# the port's trainer alone
# ---------------------------------------------------------------------------

def _port_run(tmp, name, limit=32, **overrides):
    config = _config(str(tmp), name, True)
    config["model"]["dropout"] = overrides.pop("dropout", 0.1)
    config["train"].update(overrides)
    return trainer.train(config, "agtt", limit=limit, verbose=False, device="cpu"), config


def test_dropout_run_is_reproducible_from_its_seed(tmp_path):
    a, _ = _port_run(tmp_path, "a")
    b, _ = _port_run(tmp_path, "b")
    off, _ = _port_run(tmp_path, "off", dropout=0.0)
    for ha, hb, ho in zip(a.history, b.history, off.history):
        assert ha["train/loss"] == hb["train/loss"] and ha["val/loss"] == hb["val/loss"]
    assert a.history[0]["train/loss"] != off.history[0]["train/loss"]
    np.testing.assert_array_equal(a.step_losses[0], b.step_losses[0])
    other_seed, _ = _port_run(tmp_path, "c", seed=1)
    assert other_seed.history[0]["train/loss"] != a.history[0]["train/loss"]


def test_chip_smoke_rebuilds_the_first_steps_of_a_run(tmp_path):
    """``chip_smoke.py`` repeats a run's first steps on the CPU from
    ``first_epoch``: the same weights, batches and dropout masks as
    ``train()`` starts with, so the same per-step losses, bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    run, config = _port_run(tmp_path, "a", epochs=1)
    bs = trainer.train_batch_size(run.bundle, config["train"]["batch_size"])
    n_rows, n_ex = run.bundle.n("train"), run.bundle.meta["n_examples_train"]
    assert bs == max(1, round(16 * n_rows / n_ex)) and bs < 16       # packed rows
    model, opt, arrays, idx, valid, gen = smoke.first_epoch(run.bundle, config, "cpu")
    assert idx.shape[1] == bs
    _, losses = trainer.train_epoch(model, opt, arrays, idx, valid, run.bundle, gen,
                                    max_steps=2)
    np.testing.assert_array_equal(losses.numpy(), run.step_losses[0][:2])


def test_epochs_per_dispatch_is_exact_and_rounds_up(tmp_path):
    one, _ = _port_run(tmp_path, "k1", dropout=0.0, epochs=3)
    two, cfg = _port_run(tmp_path, "k2", dropout=0.0, epochs=3, epochs_per_dispatch=2)
    assert len(one.history) == 3 and len(two.history) == 4     # whole blocks of K
    for h1, h2 in zip(one.history, two.history):
        assert h1["train/loss"] == h2["train/loss"] and h1["val/loss"] == h2["val/loss"]
    vals = [h["val/mae"] for h in two.history]
    assert _best(cfg) == (int(np.argmin(vals)) + 1, min(vals))
    assert two.best_val == min(vals)


def test_eval_only_and_remat(tmp_path):
    first, cfg = _port_run(tmp_path, "a", dropout=0.0)
    cfg = copy.deepcopy(cfg)
    cfg["train"].update(resume=True, epochs=0)
    again = trainer.train(cfg, "agtt", limit=32, verbose=False, device="cpu")
    assert again.history == [] and again.best_val == first.best_val
    np.testing.assert_allclose(again.test_metrics["mae"], first.test_metrics["mae"],
                               rtol=1e-6)
    remat, _ = _port_run(tmp_path, "r", dropout=0.1)
    cfg2 = _config(str(tmp_path), "r2", True)
    cfg2["model"].update(dropout=0.1, remat=True)
    with_remat = trainer.train(cfg2, "agtt", limit=32, verbose=False, device="cpu")
    assert with_remat.model.remat and not remat.model.remat
    for ha, hb in zip(remat.history, with_remat.history):
        assert ha["train/loss"] == hb["train/loss"]


def test_trainer_refuses_what_is_not_ported(tmp_path):
    config = _config(str(tmp_path), "x", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(config, "agtt", limit=8, verbose=False)     # default: cuda
    # one process holds no second rank: an axis asked for raises, never
    # runs unsharded
    for key in ("model_axis", "seq_shards", "pipe_stages"):
        bad = {**config, "parallel": {key: 2}}
        if key == "seq_shards":
            bad["dataset"] = {**config["dataset"], "pack": False}
        with pytest.raises(ValueError, match="do not divide"):
            trainer.train(bad, "agtt", limit=8, verbose=False, device="cpu")
    bad = {**config, "parallel": {"expert_shards": 2},
           "model": {**config["model"], "moe_experts": 2}}
    with pytest.raises(ValueError, match="do not divide"):
        trainer.train(bad, "agtt", limit=8, verbose=False, device="cpu")
    bad = copy.deepcopy(config)
    bad["train"]["mu_dtype"] = "float16"
    with pytest.raises(ValueError, match="mu_dtype"):
        trainer.train(bad, "agtt", limit=8, verbose=False, device="cpu")
    bad = {**config, "parallel": {"expert_shards": 1, "ep_manual": True}}
    with pytest.raises(ValueError, match="ep_manual requires"):
        trainer.train(bad, "agtt", limit=8, verbose=False, device="cpu")


def test_make_batches_matches_jax():
    for n, bs, pad in ((10, 4, None), (8, 4, None), (5, 8, 3), (0, 4, None)):
        a = trainer.make_batches(n, bs, np.random.default_rng(3), pad_to_nb=pad)
        b = jax_trainer.make_batches(n, bs, np.random.default_rng(3), pad_to_nb=pad)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_train_cli_and_served_checkpoint(tmp_path):
    """``python -m glearning_benchmark_tpu_torch.train`` on the CPU, then the
    checkpoint it wrote through the port's Predictor."""
    config = _config(str(tmp_path), "cli", True)
    config["train"]["epochs"] = 5
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "glearning_benchmark_tpu_torch.train", "--model",
         "agtt", "--config", str(path), "--epochs", "1", "--limit", "24",
         "--device", "cpu"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "epoch 001 | train" in out.stdout and "epoch 002" not in out.stdout
    assert "TEST RESULTS" in out.stdout
    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.serve import Predictor
    ckpt = os.path.join(config["output"]["out_dir"], "best_run")
    graphs = load_zinc_split(config["dataset"]["zinc_root"], "val", limit=6)
    served = Predictor.from_checkpoint(ckpt, device="cpu").predict_graphs(graphs)
    # a checkpoint without its serve block is rebuilt from the stored config
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    del meta["serve"]
    meta["config"]["dataset"]["zinc_root"] = config["dataset"]["zinc_root"]
    with open(ckpt + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="model_name"):
        Predictor.from_checkpoint(ckpt, device="cpu")
    rebuilt = Predictor.from_checkpoint(ckpt, model_name="agtt", device="cpu")
    assert rebuilt.serve["meta"]["max_nodes"] >= max(g.num_nodes for g in graphs)
    np.testing.assert_allclose(rebuilt.predict_graphs(graphs)["pred"], served["pred"],
                               atol=1e-6)
