"""Tensor parallelism of the port (the 'model' axis), CPU, on gloo ranks.

The ranks are child processes that import torch and the port, never JAX;
they rendezvous through a file under ``tmp_path``, each has a time limit,
and one pool of ranks runs every job of a file. This file also holds that
pool (``run_ranks``), which ``test_torch_sp.py``, ``test_torch_pp.py`` and
``test_torch_ep.py`` use. The JAX reference runs in the parent, on the
virtual CPU devices ``tests/conftest.py`` forces.

- The shard rule, leaf by leaf, against the JAX package's
  ``param_shard_spec`` on ('data', 'model') and ('data', 'expert') meshes of
  two devices, for the converted trees of agtt with MoE, MPNN (GINE) and
  GPS.
- Against the JAX trainer, dropout off, f32: agtt on packed ZINC rows on
  two ranks as a ('data' 1, 'model' 2) mesh, against the JAX trainer on
  the same mesh from the same initial checkpoint: per-epoch losses within
  rtol 1e-4 (``LOSS_RTOL`` of ``test_torch_train.py``), the same best epoch.
- Against the port's one-process run, dropout on: agtt (packed ZINC), MPNN
  and GPS (cycle_check) on two 'model' ranks, and agtt on four ranks as
  data 2 x model 2. Token models: the first 4 step losses and every
  epoch's train and val loss within rtol 1e-5, as ``test_torch_dp.py``
  holds DP (TP sums each 'model'-split layer's input gradient over the
  ranks in another order: f32 rounding, which these short runs keep below
  the bound). Graph models: the train loss within rtol 1e-4, the first
  step within 1e-6 (``test_torch_dp.py``'s bounds: many of their gradient
  elements are zero in exact arithmetic, and AdamW turns their rounding
  noise into steps of about the learning rate).
- A checkpoint written by the sharded run holds the whole parameters, loads
  in one process, and serves the logits of the model the trainer returns
  (1e-6); every rank returns the same whole model. Resumed on the ranks
  (each takes its shards of the parameters and moments again) and on one
  process, it trains on alike (the token bounds above).
"""

import copy
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glearning_benchmark_tpu.parallel.mesh import param_shard_spec as jax_spec
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import (batch_stats_to_flax, load_flax_params,
                                                   params_to_flax)
from glearning_benchmark_tpu_torch.data import generator
from glearning_benchmark_tpu_torch.parallel.mesh import Mesh, param_shard_spec
from glearning_benchmark_tpu_torch.train import checkpoint, trainer

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 300          # seconds a rank may take for all its jobs
TOKEN_RTOL = 1e-5
GRAPH_RTOL = 1e-4
LOSS_RTOL = 1e-4             # against the JAX trainer, as test_torch_train.py
SERVE_ATOL = 1e-6
ZINC_LIMIT = 24

# the ranks' side: every job of a pool, through the port's entry points
CHILD = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from glearning_benchmark_tpu_torch.parallel import initialize_distributed, make_mesh

    spec = torch.load(sys.argv[1], weights_only=False)
    initialize_distributed("cpu", init_method=spec["init"])
    rank = torch.distributed.get_rank()
    out = {}
    for job in spec["jobs"]:
        kind, name = job["kind"], job["name"]
        if kind == "train":
            from glearning_benchmark_tpu_torch.train import trainer
            res = trainer.train(job["config"], job["model"], limit=job.get("limit"),
                                verbose=False, device="cpu")
            rows = {k: torch.from_numpy(v[:8]) for k, v in res.bundle.splits["val"].items()}
            with torch.no_grad():
                logits = trainer._apply_model(res.model.eval(), rows, res.bundle)
            out[name] = {"history": res.history,
                         "steps": [s.tolist() for s in res.step_losses],
                         "state": {k: v.clone() for k, v in res.model.state_dict().items()},
                         "logits": logits}
        elif kind == "ring":
            from glearning_benchmark_tpu_torch.ops.ring_attention import ring_attention
            mesh = make_mesh(seq_shards=2)
            axis = mesh.axis("seq")
            q, k, v, mask, cot = (torch.from_numpy(job[key])
                                  for key in ("q", "k", "v", "mask", "cot"))
            ls = q.shape[1] // axis.size
            part = slice(axis.index * ls, (axis.index + 1) * ls)
            ins = [t[:, part].clone().requires_grad_() for t in (q, k, v)]
            o = ring_attention(axis, *ins, mask[:, part], job["p"], job["seed"])
            grads = torch.autograd.grad((o * cot[:, part]).sum(), ins)
            out[name] = {"out": o.detach(), "grads": grads, "part": part}
        elif kind == "pp":
            from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer
            from glearning_benchmark_tpu_torch.parallel.pipeline import pp_transformer_forward
            model = SimpleTransformer(**job["model"])
            model.load_state_dict(job["state"])
            model.eval()
            mesh = make_mesh(pipe_stages=2)
            ins = {k: torch.from_numpy(v) for k, v in job["inputs"].items()}
            with torch.no_grad():
                out[name] = pp_transformer_forward(mesh, model, n_micro=job["n_micro"],
                                                   q_token_id=job["q"], **ins)
        elif kind == "moe":
            from glearning_benchmark_tpu_torch.models.moe import SwitchFFN
            from glearning_benchmark_tpu_torch.parallel.mesh import shard_batch_spec, shard_params
            mesh = make_mesh(expert_shards=2)
            x, valid = torch.from_numpy(job["x"]), torch.from_numpy(job["valid"])
            ffn = SwitchFFN(x.shape[-1], job["d_ff"], job["experts"], p_drop=0.0,
                            ep_mesh=mesh if job["manual"] else None)
            ffn.load_state_dict(job["state"])
            ffn.eval()

            class Holder(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.layer_0 = torch.nn.Module()
                    self.layer_0.moe = ffn

            shard_params(mesh, Holder())
            shard = shard_batch_spec(mesh, x.shape[0],
                                     mesh.axis("data", "expert") if job["manual"] else None)
            if job["manual"]:
                x, valid = x[shard.start:shard.stop], valid[shard.start:shard.stop]
            with torch.no_grad():
                out[name] = {"out": ffn(x, valid, shard=shard)[0], "start": shard.start,
                             "experts": ffn.w1.shape[0]}
    torch.save(out, spec["out"] + f".{rank}")
    torch.distributed.destroy_process_group()
""")


def run_ranks(tmp, name, jobs, ranks=2):
    """Start a pool of ``ranks`` child processes that run ``jobs`` (see
    CHILD); returns a function that waits for them (each rank's time limit
    holds) and returns every rank's results."""
    spec_path = os.path.join(tmp, f"{name}.spec")
    out = os.path.join(tmp, name)
    torch.save({"init": f"file://{tmp}/{name}.rdzv", "jobs": jobs, "out": out}, spec_path)
    procs = []
    for rank in range(ranks):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(ranks),
               "LOCAL_RANK": str(rank), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        env.pop("MASTER_ADDR", None)
        env.pop("MASTER_PORT", None)
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD, spec_path], env=env,
                                      cwd=tmp, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))

    def wait():
        outs = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=CHILD_TIMEOUT)
                outs.append((p.returncode, stderr))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rc, err in outs:
            assert rc == 0, err[-4000:]
        return [torch.load(f"{out}.{r}", weights_only=False) for r in range(ranks)]

    return wait


def zinc_config(root, out, model=None, pack=True, parallel=None, **train_extra):
    return {"dataset": {"task": "zinc", "zinc_root": root, "subset": True,
                        "max_len": 1024, "pack": pack, "cache": False},
            "model": {"use_flash": False, "d_model": 16, "nhead": 4, "nlayers": 2,
                      "d_ff": 32, "dropout": 0.1, "max_pos": 300,
                      "compute_dtype": "float32", **(model or {})},
            "parallel": dict(parallel or {}),
            "train": {"batch_size": 8, "epochs": 2, "lr": 3e-3, "weight_decay": 1e-2,
                      "seed": 0, "mu_dtype": "float32", **train_extra},
            "output": {"out_dir": out, "run_name": "run"}, "wandb": {"use": False}}


def metrics(history):
    """A history without its clock readings, which differ between ranks."""
    return [{k: v for k, v in h.items()
             if not k.startswith(("time/", "throughput/", "efficiency/"))}
            for h in history]


def same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for other in ranks[1:]:
        assert metrics(other[name]["history"]) == metrics(first["history"])
        for k, v in first["state"].items():
            assert torch.equal(other[name]["state"][k], v), k
    return first


def assert_token_run_equal(got, want):
    """A sharded token run against the one-process run of the same config
    (module docstring's bounds)."""
    assert len(got["history"]) == len(want.history) > 0
    np.testing.assert_allclose(got["steps"][0][:4], want.step_losses[0][:4],
                               rtol=TOKEN_RTOL)
    for g, w in zip(got["history"], want.history):
        for key in ("train/loss", "val/loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=TOKEN_RTOL, err_msg=key)


def one_process(cfg, model, limit):
    cfg = copy.deepcopy(cfg)
    cfg.pop("parallel")
    cfg["output"]["out_dir"] += "_single"
    return trainer.train(cfg, model, limit=limit, verbose=False, device="cpu")


def _gt_config(root, out, model_name, model):
    cfg = {"dataset": {"task": "cycle_check", "graph_token_root": root,
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "num_graphs": 10, "num_pairs_per_graph": 3, "max_len": 256,
                       "max_vocab": 600, "generate_num_graphs": 10, "cache": False},
           "model": {**model, "compute_dtype": "float32"},
           "parallel": {"model_axis": 2},
           "train": {"batch_size": 12, "epochs": 2, "lr": 1e-3, "weight_decay": 1e-2,
                     "seed": 0, "mu_dtype": "float32"},
           "output": {"out_dir": out, "run_name": "run"}, "wandb": {"use": False}}
    if model_name == "ggps":
        cfg["gt"] = {"layers": 2, "n_heads": 4, "dim_hidden": 16, "dropout": 0.1,
                     "attn_dropout": 0.1}
    return cfg


def _runs(tmp):
    zinc = os.path.join(tmp, "zinc")
    gt = os.path.join(tmp, "graph-token")
    out = os.path.join(tmp, "out")
    tp = {"model_axis": 2}
    return {
        "agtt": ("agtt", zinc_config(zinc, os.path.join(out, "agtt"), parallel=tp),
                 ZINC_LIMIT),
        "mpnn": ("mpnn", _gt_config(gt, os.path.join(out, "mpnn"), "mpnn",
                                    {"hidden_dim": 16, "num_layers": 2, "dropout": 0.1}),
                 None),
        "gps": ("ggps", _gt_config(gt, os.path.join(out, "gps"), "ggps",
                                   {"graph_pooling": "mean"}), None),
    }


def _jax_config(tmp):
    """Dropout off, both trainers resuming one initial checkpoint."""
    cfg = zinc_config(os.path.join(tmp, "zinc"), "", {"dropout": 0.0},
                      parallel={"model_axis": 2}, scheduler="cosine_with_warmup",
                      num_warmup_epochs=1, resume=True,
                      resume_path=os.path.join(tmp, "init"))
    cfg["train"].pop("mu_dtype")
    return cfg


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
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
    jobs.append({"kind": "train", "name": "nodrop", "model": "agtt", "config": port_jcfg,
                 "limit": ZINC_LIMIT})
    # the sharded run's checkpoint resumed by the ranks (each takes its shards
    # of the parameters and the AdamW moments again) for a third epoch
    resume = copy.deepcopy(runs["agtt"][1])
    resume["train"].update(epochs=3, resume=True, resume_path=os.path.join(
        resume["output"]["out_dir"], "best_run"))
    resume["output"]["out_dir"] += "_resumed"
    jobs.append({"kind": "train", "name": "resumed", "model": "agtt", "config": resume,
                 "limit": ZINC_LIMIT})
    # data 2 x model 2: 32 examples in 13 packed rows, row batches of 4 that
    # divide over 'data' (one process and the ranks run the same batches)
    four = ("agtt", zinc_config(os.path.join(tmp, "zinc"), os.path.join(tmp, "out", "dm"),
                                parallel={"model_axis": 2}, batch_size=10), 32)
    wait2 = run_ranks(tmp, "tp", jobs)
    wait4 = run_ranks(tmp, "tp4", [{"kind": "train", "name": "agtt", "model": "agtt",
                                    "config": four[1], "limit": four[2]}], ranks=4)
    try:
        single = {name: one_process(cfg, m, limit)
                  for name, (m, cfg, limit) in {**runs, "four": four}.items()}
        jcfg["output"]["out_dir"] = os.path.join(tmp, "out", "nodrop_jax")
        jres = jax_trainer.train(jcfg, "agtt", limit=ZINC_LIMIT, verbose=False,
                                 mesh=jax_make_mesh(devices=jax.devices()[:2], model_axis=2))
    finally:
        ranks, four = wait2(), wait4()
    single["resumed"] = one_process({**resume, "parallel": {}}, "agtt", ZINC_LIMIT)
    return {"runs": runs, "single": single, "ranks": ranks, "four": four,
            "jax": (jres, jcfg), "port_jcfg": port_jcfg}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model_name,model_cfg", [
    ("agtt", {"moe_experts": 4, "d_model": 16, "nhead": 4, "nlayers": 2, "d_ff": 32}),
    ("mpnn", {"hidden_dim": 16, "num_layers": 2, "edge_features": True}),
    ("ggps", {}),
])
def test_shard_rule_matches_jax_leaf_by_leaf(tmp_path, model_name, model_cfg):
    """The rule on every parameter of the port's model, on ('data','model')
    and ('data','expert') meshes of two devices, equals the JAX package's
    spec of the converted flax leaf, read in the port's layout (a kernel's
    spec reversed), and ``param_shards`` splits exactly those."""
    from glearning_benchmark_tpu_torch.convert import flax_path
    from glearning_benchmark_tpu_torch.parallel.mesh import param_shards

    cfg = zinc_config(str(tmp_path / "zinc"), str(tmp_path / "out"), model_cfg, pack=False)
    cfg["gt"] = {"layers": 2, "n_heads": 4, "dim_hidden": 16}
    bundle = trainer.build_dataset(model_name, cfg["dataset"], 0, limit=16)
    model = trainer.build_model(model_name, cfg, bundle)
    tree = dict(_leaves(params_to_flax(model.state_dict())))
    for kw, axes in (({"model_axis": 2}, (("data", 1), ("model", 2))),
                     ({"expert_shards": 2}, (("data", 1), ("expert", 2)))):
        jmesh = jax_make_mesh(devices=jax.devices()[:2], **kw)
        mesh = Mesh(0, 2, axes)
        split = {}
        for key, p in model.named_parameters():
            path, transposed = flax_path(key)
            jpath = tuple(jax.tree_util.DictKey(k) for k in path)
            want = tuple(jax_spec(jmesh, jpath, np.asarray(tree[path])).spec)
            got = param_shard_spec(mesh, path, p)
            assert got == (tuple(reversed(want)) if transposed else want), (key, kw)
            if want:
                split[key] = got.index(axes[1][0])
        assert {k: sh.dim for k, sh in param_shards(mesh, model).items()} == split
        if "expert_shards" in kw:
            assert bool(split) == (model_name == "agtt")
        else:
            assert split


def test_tp_trainer_matches_jax_on_a_model_mesh(tp):
    got = same_on_every_rank(tp["ranks"], "nodrop")
    jres, jcfg = tp["jax"]
    assert len(got["history"]) == len(jres.history) == 2
    for g, w in zip(got["history"], jres.history):
        for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)
    best = []
    for cfg in (tp["port_jcfg"], jcfg):
        best.append(checkpoint.load_checkpoint(
            os.path.join(cfg["output"]["out_dir"], "best_run"))["epoch"])
    assert best[0] == best[1]


@pytest.mark.parametrize("name", ["agtt", "mpnn", "gps", "resumed"])
def test_tp_with_dropout_equals_one_process(tp, name):
    """``resumed``: the checkpoint of the sharded agtt run, resumed on the
    ranks and on one process, trains on alike."""
    got = same_on_every_rank(tp["ranks"], name)
    want = tp["single"][name]
    if name == "resumed":
        assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want.history]
    if name in ("agtt", "resumed"):
        assert_token_run_equal(got, want)
        return
    for g, w in zip(got["history"], want.history):
        np.testing.assert_allclose(g["train/loss"], w["train/loss"], rtol=GRAPH_RTOL)
    np.testing.assert_allclose(got["steps"][0][0], want.step_losses[0][0], rtol=1e-6)


def test_data_by_model_on_four_ranks_equals_one_process(tp):
    got = same_on_every_rank(tp["four"], "agtt")
    assert_token_run_equal(got, tp["single"]["four"])


@pytest.mark.parametrize("name", ["agtt", "gps"])
def test_sharded_checkpoint_serves_in_one_process(tp, name):
    """The best checkpoint of a 'model'-sharded run holds the whole
    parameters; loaded into a one-process model it gives the logits of the
    model the trainer returned."""
    model_name, cfg, limit = tp["runs"][name]
    saved = checkpoint.load_checkpoint(os.path.join(cfg["output"]["out_dir"], "best_run"))
    bundle = trainer.build_dataset(model_name, cfg["dataset"], 0, limit=limit)
    model = trainer.build_model(model_name, cfg, bundle)
    load_flax_params(model, saved["params"], saved.get("batch_stats"))
    assert saved["opt_state"]
    rows = {k: torch.from_numpy(v[:8]) for k, v in bundle.splits["val"].items()}
    with torch.no_grad():
        logits = trainer._apply_model(model.eval(), rows, bundle)
    got = tp["ranks"][0][name]
    # the returned model is the best epoch's, as the checkpoint is
    np.testing.assert_allclose(logits.numpy(), got["logits"].numpy(), atol=SERVE_ATOL,
                               rtol=0)
