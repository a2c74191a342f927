"""Expert parallelism of the port (the 'expert' axis), CPU, on gloo ranks
(the pool of ``test_torch_tp.py``), and the trainer's guards on every
``parallel.*`` key.

- The Switch MoE FFN on a ('data' 1, 'expert' 2) mesh against the JAX
  package's, f32, deterministic, from the same parameters: the auto path
  (each rank computes its two of the four experts for its rows, the combine
  summed over 'expert') and the manual all-to-all dispatch
  (``_manual_ep_ffn``: each rank holds half the rows), within 1e-6.
- Training with dropout on, agtt with four experts on packed ZINC rows, two
  'expert' ranks, auto and manual, against the port's one-process run: the
  first 4 step losses and every epoch's losses within rtol 1e-5.
- Every guard of the JAX trainer on the ``parallel`` block raises the same
  ``ValueError`` message in the port: the config guards through
  ``train()`` in one process, the mesh and batch guards through the
  trainer's layout on a mesh of two ranks.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from glearning_benchmark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import params_from_flax
from glearning_benchmark_tpu_torch.models.moe import _manual_ep_ffn
from glearning_benchmark_tpu_torch.parallel.mesh import Mesh
from glearning_benchmark_tpu_torch.train import trainer

from test_torch_tp import (assert_token_run_equal, one_process, run_ranks,
                           same_on_every_rank, zinc_config)

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

ATOL = 1e-6
B, L, D, F, E = 8, 8, 8, 16, 4


def _ffn_inputs():
    x = np.random.default_rng(2).normal(size=(B, L, D)).astype(np.float32)
    valid = np.random.default_rng(3).random((B, L)) > 0.2
    return x, valid


def _jax_ffn(mesh=None):
    return JaxSwitchFFN(d_model=D, d_ff=F, n_experts=E, capacity_factor=1.25,
                        ep_mesh=mesh)


def _jax_params():
    x, valid = _ffn_inputs()
    return _jax_ffn().init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid),
                           True)["params"]


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ep"))
    x, valid = _ffn_inputs()
    state = params_from_flax(jax.tree.map(np.asarray, _jax_params()))
    jobs = [{"kind": "moe", "name": f"ffn_{manual}", "manual": manual, "x": x,
             "valid": valid, "state": state, "d_ff": F, "experts": E}
            for manual in (False, True)]
    zinc = os.path.join(tmp, "zinc")
    # 32 examples in 13 packed rows, row batches of 4 (data x expert divides)
    runs = {name: ("agtt", zinc_config(zinc, os.path.join(tmp, "out", name),
                                       {"moe_experts": E}, parallel=par, batch_size=10), 32)
            for name, par in (("auto", {"expert_shards": 2}),
                              ("manual", {"expert_shards": 2, "ep_manual": True}))}
    jobs += [{"kind": "train", "name": name, "model": m, "config": cfg, "limit": limit}
             for name, (m, cfg, limit) in runs.items()]
    wait = run_ranks(tmp, "ep", jobs)
    try:
        single = {name: one_process(cfg, m, limit) for name, (m, cfg, limit) in runs.items()}
    finally:
        ranks = wait()
    return {"ranks": ranks, "single": single}


@pytest.mark.parametrize("manual", [False, True])
def test_expert_parallel_ffn_matches_jax(ep, manual):
    x, valid = _ffn_inputs()
    mesh = jax_make_mesh(devices=jax.devices()[:2], expert_shards=2) if manual else None
    ffn = _jax_ffn(mesh)
    want, _ = jax.jit(lambda p: ffn.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid),
                                          True, mutable=["losses"]))(_jax_params())
    want = np.asarray(want)
    for rank in ep["ranks"]:
        got = rank[f"ffn_{manual}"]
        assert got["experts"] == E // 2                 # this rank's experts only
        rows = slice(got["start"], got["start"] + len(got["out"]))
        np.testing.assert_allclose(got["out"].numpy(), want[rows], atol=ATOL, rtol=0)
    if manual:
        assert [r["ffn_True"]["start"] for r in ep["ranks"]] == [0, B // 2]


@pytest.mark.parametrize("name", ["auto", "manual"])
def test_ep_with_dropout_equals_one_process(ep, name):
    got = same_on_every_rank(ep["ranks"], name)
    assert "layer_0.moe.w1" in got["state"] and got["state"]["layer_0.moe.w1"].shape[0] == E
    assert_token_run_equal(got, ep["single"][name])


def test_manual_dispatch_guards():
    mesh = Mesh(0, 2, (("data", 1), ("model", 2)))
    x = torch.zeros(2, 4, D)
    with pytest.raises(ValueError, match="needs a \\('data','expert'\\) mesh"):
        _manual_ep_ffn(mesh, x, None, None, None, None, None, None, dtype=torch.float32,
                       p_drop=0.0)
    mesh = Mesh(0, 2, (("data", 1), ("expert", 2)))
    with pytest.raises(ValueError, match="batch 3 must divide over data\\*expert = 1\\*2"):
        _manual_ep_ffn(mesh, torch.zeros(3, 4, D), torch.zeros(3, 4, E, 2), None,
                       torch.zeros(2, D, F), None, None, None, dtype=torch.float32,
                       p_drop=0.0)
    with pytest.raises(ValueError, match="n_experts 3 must divide over expert_shards 2"):
        _manual_ep_ffn(mesh, torch.zeros(2, 4, D), torch.zeros(2, 4, 3, 2), None,
                       torch.zeros(2, D, F), None, None, None, dtype=torch.float32,
                       p_drop=0.0)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


# configs the JAX trainer refuses before it builds a mesh: (model, parallel
# block, model block overrides, dataset overrides)
CONFIG_GUARDS = [
    ("mpnn", {"seq_shards": 2}, {}, {}),
    ("agtt", {"seq_shards": 2}, {}, {"pack": True}),
    ("mpnn", {"pipe_stages": 2}, {}, {}),
    ("mpnn", {"expert_shards": 2}, {}, {}),
    ("agtt", {"expert_shards": 2}, {}, {}),
    ("agtt", {"expert_shards": 2}, {"moe_experts": 3}, {}),
    ("agtt", {"ep_manual": True}, {}, {}),
    ("agtt", {"pipe_stages": 2}, {"moe_experts": 2}, {}),
]


@pytest.mark.parametrize("model_name,par,model,data", CONFIG_GUARDS)
def test_config_guards_match_jax(tmp_path, model_name, par, model, data):
    cfg = zinc_config(str(tmp_path / "zinc"), str(tmp_path / "out"), model, parallel=par)
    cfg["dataset"].update(data)
    jcfg = copy.deepcopy(cfg)
    want = _message(lambda: jax_trainer.train(jcfg, model_name, limit=8, verbose=False,
                                              mesh=None))
    got = _message(lambda: trainer.train(cfg, model_name, limit=8, verbose=False,
                                         device="cpu"))
    assert got == want


# guards on the mesh and the batches: (mesh kwargs, parallel block, model
# block, batch size, packed rows)
MESH_GUARDS = [
    ({"expert_shards": 2}, {"expert_shards": 2, "ep_manual": True}, {"moe_experts": 2},
     15, False),
    ({"pipe_stages": 2}, {"pipe_stages": 2}, {"nlayers": 3}, 16, False),
    ({"pipe_stages": 2}, {"pipe_stages": 2, "pipe_microbatches": 3}, {}, 16, False),
    ({"pipe_stages": 2}, {"pipe_stages": 2, "pipe_microbatches": 4}, {}, 16, True),
]


@pytest.mark.parametrize("mesh_kw,par,model,batch,packed", MESH_GUARDS)
def test_mesh_guards_match_jax(tmp_path, mesh_kw, par, model, batch, packed):
    cfg = zinc_config(str(tmp_path / "zinc"), str(tmp_path / "out"), model, pack=packed,
                      parallel=par, batch_size=batch)
    jcfg = copy.deepcopy(cfg)
    want = _message(lambda: jax_trainer.train(
        jcfg, "agtt", limit=16, verbose=False,
        mesh=jax_make_mesh(devices=jax.devices()[:2], **mesh_kw)))
    mesh = Mesh(0, 2, (("data", 1), next(iter(
        {"expert_shards": ("expert", 2), "pipe_stages": ("pipe", 2)}[k]
        for k in mesh_kw))))
    bundle = trainer.build_dataset("agtt", cfg["dataset"], 0, limit=16)
    model = trainer.build_model("agtt", cfg, bundle)
    par = trainer._check_parallel(cfg, "agtt")
    got = _message(lambda: trainer._layout(mesh, par, model, batch,
                                           trainer.train_batch_size(bundle, batch),
                                           packed))
    assert got == want
