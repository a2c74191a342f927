"""Data-parallel training of the port on two gloo ranks, CPU.

The ranks are child processes that import torch and the port, never JAX;
they rendezvous through a file under ``tmp_path`` and each has a time
limit of its own. The JAX reference runs here, in the parent, on two of the
virtual CPU devices ``tests/conftest.py`` forces.

- With dropout on (so every mask must be the rank's rows of the global
  mask): ibtt on packed cycle_check rows, agtt on packed ZINC rows, the
  Switch MoE agtt on packed ZINC rows, MPNN and GPS on cycle_check, each
  against the port's single-process run of the same global batch and seed.
  The token models: per-epoch train and val loss within rtol 1e-5, the
  final parameters within atol 1e-5, except the attention key bias, whose
  gradient is zero in exact arithmetic (a per-query constant under the
  softmax): AdamW divides its rounding noise by its own magnitude, so it
  moves by up to the learning rate a step on either side, and is held to
  that bound. The first moment is stored in f32 in these runs: in bf16 a
  gradient one f32 rounding apart can round the moment to a neighbouring
  bf16 value, a step difference of about 2^-8 of the learning rate. The
  graph models: the train loss within rtol 1e-4 (many of their gradient
  elements are zero in exact arithmetic, see ``test_torch_train_graph.py``),
  and, in a run at learning rate 0 where every step sees the initial
  weights, the per-epoch train and val loss and the gradient norm within
  rtol 1e-5 and the BatchNorm running statistics within rtol 1e-6 and
  atol 1e-7 (f32 sums of the same O(1) terms in another order).
- A minibatch that does not divide over the ranks runs unsharded: every
  rank computes all of it (the ranks average their gradients, which on the
  CPU are equal), and the run equals the single-process one.
- With dropout off, agtt on packed ZINC against the JAX trainer on a
  2-device 'data' mesh from the same initial checkpoint: per-epoch losses,
  gradient norm and learning rate within rtol 1e-4 (``LOSS_RTOL`` of
  ``test_torch_train.py``), the same best epoch.
- ``distributed_vocab_counts``, ``multiprocess_vocab_build`` and
  ``multiprocess_zinc_vocab`` over the two ranks' contiguous shards:
  id-identical to the JAX package's host builds and to its
  ``distributed_vocab_counts`` on the virtual mesh, with ``min_freq`` and
  the cap.
- The CLI on two ranks (``--device cpu``, ``--dist-init file://``); and a
  rank that dies makes the other rank's run fail, never carry on alone.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import yaml

from glearning_benchmark_tpu.data.zinc import _synth_molecule as jax_synth_molecule
from glearning_benchmark_tpu.parallel import dist as jax_dist
from glearning_benchmark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glearning_benchmark_tpu.tokenization.ibtt import tokenize_zinc_molecule as jax_tokenize
from glearning_benchmark_tpu.tokenization.ibtt_fast import (
    build_zinc_vocab_fast as jax_zinc_vocab)
from glearning_benchmark_tpu.tokenization.vocab import build_vocab_from_texts
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import batch_stats_to_flax, params_to_flax
from glearning_benchmark_tpu_torch.data import generator
from glearning_benchmark_tpu_torch.train import checkpoint, trainer

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
CHILD_TIMEOUT = 240          # seconds a rank may take for all its jobs
TOKEN_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAPH_RTOL = 1e-4
LR0_RTOL = 1e-5
STATS_RTOL = 1e-6            # f32 sums over the nodes in another order;
STATS_ATOL = 1e-7            # a mean near 0 keeps only the absolute error
LOSS_RTOL = 1e-4             # against the JAX trainer, as test_torch_train.py
N_MOLS = 60
VOCAB_CASES = ((None, 1), (30, 1), (None, 3), (25, 2))   # (max_tokens, min_freq)

CHILD = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from glearning_benchmark_tpu_torch.parallel import (
        distributed_vocab_counts, host_shard_bounds, initialize_distributed, make_mesh)
    from glearning_benchmark_tpu_torch.parallel.multiproc import (
        multiprocess_vocab_build, multiprocess_zinc_vocab)

    spec = json.load(open(sys.argv[1]))
    initialize_distributed("cpu", init_method=spec["init"])
    rank = torch.distributed.get_rank()
    if spec.get("die_rank") == rank:
        os._exit(3)
    out = {}
    for job in spec["jobs"]:
        if job["kind"] == "train":
            from glearning_benchmark_tpu_torch.train.trainer import train
            res = train(job["config"], job["model"], limit=job.get("limit"),
                        verbose=False, device="cpu")
            out[job["name"]] = {
                "history": res.history,
                "steps": [s.tolist() for s in res.step_losses],
                "state": {k: v.clone() for k, v in res.model.state_dict().items()}}
        else:
            from glearning_benchmark_tpu_torch.data.zinc import _synth_molecule
            from glearning_benchmark_tpu_torch.tokenization.ibtt import (
                tokenize_zinc_molecule)
            start, end = host_shard_bounds(job["n_mols"])
            mols = [_synth_molecule(4242 + i) for i in range(start, end)]
            texts = [tokenize_zinc_molecule(m) for m in mols]
            mesh = make_mesh()
            out["vocab"] = {
                "zinc": multiprocess_zinc_vocab(mols),
                "cases": [[distributed_vocab_counts(texts, mesh, cap, freq)[0],
                           multiprocess_vocab_build(texts, cap, freq)[0]]
                          for cap, freq in job["cases"]]}
    torch.save(out, spec["out"] + f".{rank}")
    torch.distributed.destroy_process_group()
""")


def _spawn(tmp, name, argv_of, env_extra=None):
    """Start the ranks, one child process each, rendezvous through a file."""
    init = f"file://{tmp}/{name}.rdzv"
    procs = []
    for rank in range(RANKS):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(RANKS),
               "LOCAL_RANK": str(rank), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
               **(env_extra or {})}
        env.pop("MASTER_ADDR", None)
        env.pop("MASTER_PORT", None)
        procs.append(subprocess.Popen(argv_of(init), env=env, cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def _wait(procs):
    """(returncode, stdout, stderr) of every rank; a hang fails the test at
    the rank's time limit instead of holding the suite."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _run_ranks(tmp, name, jobs, die_rank=None):
    spec = {"init": "", "jobs": jobs, "out": os.path.join(tmp, name)}
    spec_path = os.path.join(tmp, f"{name}.json")

    def argv(init):
        spec["init"] = init
        if die_rank is not None:
            spec["die_rank"] = die_rank
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        return [sys.executable, "-c", CHILD, spec_path]

    return _spawn(tmp, name, argv)


def _gt_config(root, out, model_name, model, **train_extra):
    cfg = {"dataset": {"task": "cycle_check", "graph_token_root": root,
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "num_graphs": 10, "num_pairs_per_graph": 3, "max_len": 256,
                       "max_vocab": 600, "generate_num_graphs": 10,
                       "pack": model_name in ("ibtt", "agtt"), "cache": False},
           "model": {**model, "compute_dtype": "float32"},
           "train": {"batch_size": 12, "epochs": 2, "lr": 1e-3, "weight_decay": 1e-2,
                     "seed": 0, "mu_dtype": "float32", **train_extra},
           "output": {"out_dir": out, "run_name": "run"}, "wandb": {"use": False}}
    if model_name == "ggps":
        cfg["gt"] = {"layers": 2, "n_heads": 4, "dim_hidden": 16, "dropout": 0.1,
                     "attn_dropout": 0.1}
    return cfg


def _zinc_config(root, out, model=None, **train_extra):
    return {"dataset": {"task": "zinc", "zinc_root": root, "subset": True,
                        "max_len": 1024, "pack": True, "cache": False},
            "model": {"use_flash": False, "d_model": 16, "nhead": 4, "nlayers": 2,
                      "d_ff": 32, "dropout": 0.1, "max_pos": 300,
                      "compute_dtype": "float32", **(model or {})},
            "train": {"batch_size": 16, "epochs": 2, "lr": 3e-3, "weight_decay": 1e-2,
                      "seed": 0, "mu_dtype": "float32", **train_extra},
            "output": {"out_dir": out, "run_name": "run"}, "wandb": {"use": False}}


TOKEN_MODEL = {"d_model": 16, "nhead": 4, "nlayers": 1, "d_ff": 32, "dropout": 0.1,
               "max_pos": 600, "use_flash": False}
GRAPH_MODEL = {"hidden_dim": 16, "num_layers": 2, "dropout": 0.1}
ZINC_LIMIT = 48


def _runs(tmp):
    """{name: (model, config, limit)} of the data-parallel runs."""
    gt = os.path.join(tmp, "graph-token")
    zinc = os.path.join(tmp, "zinc")
    out = os.path.join(tmp, "out")
    runs = {
        "ibtt_cc": ("ibtt", _gt_config(gt, out, "ibtt", TOKEN_MODEL), None),
        "agtt_zinc": ("agtt", _zinc_config(zinc, out), ZINC_LIMIT),
        "moe_zinc": ("agtt", _zinc_config(zinc, out, {"moe_experts": 2}), ZINC_LIMIT),
        "mpnn_cc": ("mpnn", _gt_config(gt, out, "mpnn", GRAPH_MODEL), None),
        "gps_cc": ("ggps", _gt_config(gt, out, "ggps", {"graph_pooling": "mean"}), None),
        "mpnn_cc_lr0": ("mpnn", _gt_config(gt, out, "mpnn", GRAPH_MODEL, lr=0.0,
                                           epochs=1), None),
        "gps_cc_lr0": ("ggps", _gt_config(gt, out, "ggps", {"graph_pooling": "mean"},
                                          lr=0.0, epochs=1), None),
        # 15 rows do not divide over 2 ranks: every rank runs the whole batch
        "mpnn_unsharded": ("mpnn", _gt_config(gt, out, "mpnn", GRAPH_MODEL,
                                              batch_size=15), None),
    }
    for name, (_, cfg, _) in runs.items():
        cfg["output"]["out_dir"] = os.path.join(out, name)
    return runs


def _jax_config(tmp):
    """Dropout off, both trainers resuming one initial checkpoint."""
    cfg = _zinc_config(os.path.join(tmp, "zinc"), "", {"dropout": 0.0},
                       scheduler="cosine_with_warmup", num_warmup_epochs=1,
                       resume=True, resume_path=os.path.join(tmp, "init"))
    cfg["train"].pop("mu_dtype")
    return cfg


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every two-rank job in one pair of processes, the single-process runs
    and the JAX reference here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    generator.ensure_corpus(os.path.join(tmp, "graph-token"), tasks=("cycle_check",),
                            algorithms=("ba", "sbm", "sfn"), number_of_graphs=10,
                            test_graphs=6)
    runs = _runs(tmp)
    jcfg = _jax_config(tmp)
    bundle = trainer.build_dataset("agtt", jcfg["dataset"], 0, limit=ZINC_LIMIT)
    model = trainer.build_model("agtt", jcfg, bundle,
                                generator=torch.Generator().manual_seed(7))
    checkpoint.save_checkpoint(jcfg["train"]["resume_path"],
                               {"params": params_to_flax(model.state_dict()),
                                "batch_stats": batch_stats_to_flax(model.state_dict()),
                                "epoch": 0})
    port_jcfg = copy.deepcopy(jcfg)
    port_jcfg["output"]["out_dir"] = os.path.join(tmp, "out", "nodrop_port")
    jobs = [{"kind": "train", "name": name, "model": m, "config": cfg, "limit": limit}
            for name, (m, cfg, limit) in runs.items()]
    jobs += [{"kind": "train", "name": "nodrop", "model": "agtt", "config": port_jcfg,
              "limit": ZINC_LIMIT},
             {"kind": "vocab", "n_mols": N_MOLS, "cases": VOCAB_CASES}]
    procs = _run_ranks(tmp, "dp", jobs)
    try:
        single = {}
        for name, (m, cfg, limit) in runs.items():
            cfg = copy.deepcopy(cfg)
            cfg["output"]["out_dir"] += "_single"
            single[name] = trainer.train(cfg, m, limit=limit, verbose=False, device="cpu")
        jcfg["output"]["out_dir"] = os.path.join(tmp, "out", "nodrop_jax")
        jres = jax_trainer.train(jcfg, "agtt", limit=ZINC_LIMIT, verbose=False,
                                 mesh=jax_make_mesh(devices=jax.devices()[:RANKS]))
    finally:
        outs = _wait(procs)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    ranks = [torch.load(os.path.join(tmp, f"dp.{r}"), weights_only=False)
             for r in range(RANKS)]
    return {"tmp": tmp, "runs": runs, "single": single, "ranks": ranks,
            "jax": (jres, jcfg), "port_jcfg": port_jcfg}


def _metrics(history):
    """A history without its clock readings, which differ between ranks."""
    return [{k: v for k, v in h.items()
             if not k.startswith(("time/", "throughput/", "efficiency/"))}
            for h in history]


def _assert_same_on_every_rank(dp, name):
    first = dp["ranks"][0][name]
    for other in dp["ranks"][1:]:
        assert _metrics(other[name]["history"]) == _metrics(first["history"])
        for k, v in first["state"].items():
            assert torch.equal(other[name]["state"][k], v), k
    return first


def _key_bias(state, key, d_model):
    """The attention key bias of a ``qkv.bias`` (q | k | v order)."""
    return state[key][d_model:2 * d_model]


@pytest.mark.parametrize("name", ["ibtt_cc", "agtt_zinc", "moe_zinc"])
def test_token_models_with_dropout_equal_one_process(dp, name):
    got = _assert_same_on_every_rank(dp, name)
    want = dp["single"][name]
    model, cfg, _ = dp["runs"][name]
    assert len(got["history"]) == len(want.history) == 2
    for g, w in zip(got["history"], want.history):
        for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOKEN_RTOL, err_msg=key)
    steps = sum(len(s) for s in got["steps"])
    lr, d = cfg["train"]["lr"], cfg["model"]["d_model"]
    for k, w in want.model.state_dict().items():
        g = got["state"][k]
        if k.endswith("qkv.bias"):
            key_g, key_w = _key_bias(got["state"], k, d), _key_bias(
                want.model.state_dict(), k, d)
            assert float((key_g - key_w).abs().max()) <= 2 * lr * steps, k
            g = torch.cat([g[:d], g[2 * d:]])
            w = torch.cat([w[:d], w[2 * d:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
    if name == "moe_zinc":
        assert "layer_0.moe.w1" in got["state"]


@pytest.mark.parametrize("name", ["mpnn_cc", "gps_cc", "mpnn_unsharded"])
def test_graph_models_with_dropout_equal_one_process(dp, name):
    got = _assert_same_on_every_rank(dp, name)
    want = dp["single"][name]
    assert len(got["history"]) == len(want.history) == 2
    for g, w in zip(got["history"], want.history):
        np.testing.assert_allclose(g["train/loss"], w["train/loss"], rtol=GRAPH_RTOL)
    # the first step sees the same weights: forward and loss agree tightly
    np.testing.assert_allclose(got["steps"][0][0], want.step_losses[0][0], rtol=1e-6)
    if name == "mpnn_unsharded":
        # unsharded: every rank computed the whole batch, as one process does
        for g, w in zip(got["history"], want.history):
            assert g["train/loss"] == w["train/loss"]


@pytest.mark.parametrize("name", ["mpnn_cc_lr0", "gps_cc_lr0"])
def test_graph_models_gradient_and_batch_stats_at_lr0(dp, name):
    """At learning rate 0 every step sees the initial weights, so the
    global-batch loss, the all-reduced gradient's norm and the BatchNorm
    statistics reduced over both ranks can be held tightly."""
    got = _assert_same_on_every_rank(dp, name)
    want = dp["single"][name]
    for g, w in zip(got["history"], want.history):
        for key in ("train/loss", "val/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=LR0_RTOL, err_msg=key)
    np.testing.assert_allclose(np.concatenate(got["steps"]),
                               np.concatenate(want.step_losses), rtol=LR0_RTOL)
    stats = [k for k in want.model.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got["state"][k].numpy(),
                                   want.model.state_dict()[k].numpy(),
                                   rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)


def test_dropout_off_equals_the_jax_trainer_on_a_data_mesh(dp):
    got = _assert_same_on_every_rank(dp, "nodrop")
    jres, jcfg = dp["jax"]
    assert len(got["history"]) == len(jres.history) == 2
    for g, w in zip(got["history"], jres.history):
        assert g.keys() == w.keys()
        for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)
    best = []
    for cfg in (dp["port_jcfg"], jcfg):
        with open(os.path.join(cfg["output"]["out_dir"], "best_run.json")) as f:
            best.append(json.load(f)["epoch"])
    assert best[0] == best[1]


def test_vocab_builds_are_id_identical_to_the_host_build(dp):
    mols = [jax_synth_molecule(4242 + i) for i in range(N_MOLS)]
    texts = [jax_tokenize(m) for m in mols]
    mesh = jax_make_mesh(devices=jax.devices()[:RANKS])
    half = N_MOLS // 2
    for rank in dp["ranks"]:
        assert rank["vocab"]["zinc"] == jax_zinc_vocab(mols)
        for (cap, freq), (dist_vocab, mp_vocab) in zip(VOCAB_CASES, rank["vocab"]["cases"]):
            host, _ = build_vocab_from_texts(texts, min_freq=freq, max_tokens=cap)
            on_mesh, _ = jax_dist.distributed_vocab_counts(
                [texts[:half], texts[half:]], mesh, max_tokens=cap, min_freq=freq)
            assert dist_vocab == mp_vocab == host == on_mesh, (cap, freq)
    # the cases differ: the cap and min_freq each cut the table
    sizes = [len(v[0]) for v in dp["ranks"][0]["vocab"]["cases"]]
    assert sizes[0] > sizes[1] and sizes[0] > sizes[2]


def test_cli_on_two_ranks(tmp_path):
    root = str(tmp_path / "graph-token")
    cfg = _gt_config(root, str(tmp_path / "runs"), "mpnn", GRAPH_MODEL)
    cfg["dataset"]["cache"] = True
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    procs = _spawn(str(tmp_path), "cli", lambda init: [
        sys.executable, "-m", "glearning_benchmark_tpu_torch.train", "--model", "mpnn",
        "--config", str(path), "--epochs", "1", "--device", "cpu", "--dist-init", init])
    outs = _wait(procs)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    assert "epoch 001 | train" in outs[0][1] and "TEST RESULTS" in outs[0][1]
    assert "epoch 001" not in outs[1][1]          # rank 0 alone reports
    saved = checkpoint.load_checkpoint(str(tmp_path / "runs" / "best_run"))
    assert saved["epoch"] == 1 and saved["batch_stats"] is not None


def test_a_dead_rank_fails_the_run(tmp_path):
    """Rank 1 leaves after joining; rank 0's first collective raises and its
    run exits non-zero instead of training on alone."""
    cfg = _gt_config(str(tmp_path / "graph-token"), str(tmp_path / "out"), "mpnn",
                     GRAPH_MODEL)
    outs = _wait(_run_ranks(str(tmp_path), "dead", [
        {"kind": "train", "name": "mpnn", "model": "mpnn", "config": cfg, "limit": None}],
        die_rank=1))
    assert outs[1][0] == 3
    assert outs[0][0] != 0
    assert not os.path.exists(os.path.join(tmp_path, "dead.0"))
