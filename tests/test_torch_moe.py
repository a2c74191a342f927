"""Port parity of the Switch MoE FFN (``models/moe.py``), CPU, f32.

- ``SwitchFFN`` with the flax module's weights through ``convert.py``:
  outputs within atol 1e-5 and the aux loss within rtol 1e-6 of flax's, at
  several expert counts and capacity factors, with invalid tokens and
  overflow; the gradients of the parameters (router included, reached
  through the combine weights and the aux loss) within atol 1e-5.
- E = 1 is the dense FFN exactly (softmax over one logit is 1, and the
  capacity covers every token), as ``tests/test_moe.py`` holds for flax.
- Capacity and validity, and the aux loss's floor: the cases of
  ``tests/test_moe.py``.
- The trainers with ``moe_experts`` 2 and 4 on packed ZINC rows, dropout
  off, from one initial checkpoint: per-epoch losses, gradient norm and
  learning rate within rtol 1e-4 (``LOSS_RTOL``), so the aux loss is added
  with the reference's weight on the training forwards only.
- An MoE checkpoint written by either trainer serves in both packages'
  Predictors with the same predictions (atol 1e-5), and its optimizer
  state maps onto the other package's parameters.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.data.zinc import load_zinc_split
from glearning_benchmark_tpu.models.moe import SwitchFFN as FlaxSwitchFFN
from glearning_benchmark_tpu.serve import Predictor as JaxPredictor
from glearning_benchmark_tpu.train import trainer as jax_trainer
from glearning_benchmark_tpu_torch.convert import (opt_state_to_torch, params_from_flax,
                                                   params_to_flax)
from glearning_benchmark_tpu_torch.models.moe import SwitchFFN
from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer
from glearning_benchmark_tpu_torch.serve import Predictor
from glearning_benchmark_tpu_torch.train import checkpoint, trainer

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

OUT_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-4
PRED_ATOL = 1e-5


def _inputs(b, l, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    valid = np.arange(l)[None] < rng.integers(l // 2, l + 1, size=(b, 1))
    return x, valid


def _pair(d, f, e, cf, x, valid, seed):
    flax_ffn = FlaxSwitchFFN(d_model=d, d_ff=f, n_experts=e, capacity_factor=cf)
    params = jax.jit(lambda k, x, v: flax_ffn.init(k, x, v, True))(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(valid))["params"]
    port = SwitchFFN(d, f, e, cf)
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return flax_ffn, params, port


@pytest.mark.parametrize("e,cf", [(2, 1.25), (4, 1.25), (4, 0.5), (3, 2.0)])
def test_switch_ffn_matches_flax(e, cf):
    d, f = 8, 16
    x, valid = _inputs(3, 20, d, e)
    flax_ffn, params, port = _pair(d, f, e, cf, x, valid, e)

    def jax_loss(p):
        out, state = flax_ffn.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid),
                                    True, mutable=["losses"])
        aux = jax.tree.leaves(state["losses"])[0]
        return (out ** 2).sum() + aux, (out, aux)

    (_, (want, want_aux)), jgrads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)
    port.train()
    out, aux = port(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=AUX_RTOL)
    grads = torch.autograd.grad((out ** 2).sum() + aux, list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    want_grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)
    assert float(want_grads["router.weight"].abs().max()) > 0     # routing is trained
    # eval mode: no aux loss; the same output
    port.eval()
    out_eval, no_aux = port(torch.from_numpy(x), torch.from_numpy(valid))
    assert no_aux is None and torch.equal(out_eval, out.detach())
    # the parameters convert back to the flax tree
    back = params_to_flax(port.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_switch_ffn_aux_loss_matches_flax_at_bf16():
    """At bf16 compute flax counts the valid tokens in bf16 (601 rounds to
    600): the port's aux loss and its gradient through the f32 router match
    flax's (the aux loss within rtol 1e-6, its gradient within rtol 1e-5 and
    atol 1e-8 of f32 sums over 601 tokens in another order; with the count
    unrounded the aux loss is 3.3e-3 off), and its output flax's within bf16
    rounding."""
    d, f, e = 8, 16, 4
    x, _ = _inputs(2, 320, d, 7)
    valid = np.arange(320)[None] < np.array([[301], [300]])
    xb = jnp.asarray(x, jnp.bfloat16)
    flax_ffn = FlaxSwitchFFN(d_model=d, d_ff=f, n_experts=e, dtype=jnp.bfloat16)
    params = jax.jit(lambda k, x, v: flax_ffn.init(k, x, v, True))(
        jax.random.PRNGKey(7), xb, jnp.asarray(valid))["params"]
    port = SwitchFFN(d, f, e, dtype=torch.bfloat16)
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))

    def jax_aux(p):
        out, state = flax_ffn.apply({"params": p}, xb, jnp.asarray(valid), True,
                                    mutable=["losses"])
        return jax.tree.leaves(state["losses"])[0], out

    (want_aux, want), jgrads = jax.jit(jax.value_and_grad(jax_aux, has_aux=True))(params)
    port.train()
    out, aux = port(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(valid))
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=AUX_RTOL)
    got = torch.autograd.grad(aux, [port.router.weight, port.router.bias])
    want_grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    for g, name in zip(got, ("router.weight", "router.bias")):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=name)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


def _model(moe):
    return SimpleTransformer(vocab_size=100, d_model=16, nhead=4, nlayers=2, d_ff=64,
                             p_drop=0.1, max_pos=64, use_query_nodes=False,
                             task="cycle_check", bos_id=1, moe_experts=moe,
                             generator=torch.Generator().manual_seed(0))


def test_single_expert_is_the_dense_ffn():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(7, 100, size=(8, 32)))
    ids[:, 0] = 1
    mask = torch.arange(32)[None] < torch.from_numpy(rng.integers(24, 33, size=(8, 1)))
    dense, moe1 = _model(0), _model(1)
    state = dense.state_dict()
    for i in range(2):
        pre = f"layer_{i}."
        state[pre + "moe.w1"] = state.pop(pre + "ff1.weight").T[None]
        state[pre + "moe.b1"] = state.pop(pre + "ff1.bias")[None]
        state[pre + "moe.w2"] = state.pop(pre + "ff2.weight").T[None]
        state[pre + "moe.b2"] = state.pop(pre + "ff2.bias")[None]
        state[pre + "moe.router.weight"] = moe1.state_dict()[pre + "moe.router.weight"]
        state[pre + "moe.router.bias"] = moe1.state_dict()[pre + "moe.router.bias"]
    moe1.load_state_dict(state)
    dense.eval()
    moe1.eval()
    with torch.no_grad():
        assert torch.equal(dense(ids, mask), moe1(ids, mask))


def test_capacity_and_validity():
    """Tokens past an expert's capacity and invalid tokens get no MoE
    output (the encoder's residual carries them)."""
    ffn = SwitchFFN(8, 16, 2, capacity_factor=0.25)
    ffn.reset_parameters(torch.Generator().manual_seed(0))
    ffn.eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 8)).astype(np.float32))
    with torch.no_grad():
        out, _ = ffn(x, torch.ones(2, 8, dtype=torch.bool))
        # per-row capacity 0.25 * 8 / 2 = 1 slot an expert a row: at most
        # B * E * C = 4 routed tokens
        assert int((out.abs().reshape(16, 8).sum(-1) > 0).sum()) <= 4
        out0, _ = ffn(x, torch.zeros(2, 8, dtype=torch.bool))
    assert torch.equal(out0, torch.zeros_like(out0))


def test_aux_loss_balanced_floor():
    """E * sum(f_e * p_e) is about 1 when routing is uniform and at least 1
    in general."""
    ffn = SwitchFFN(8, 16, 4, capacity_factor=2.0)
    ffn.reset_parameters(torch.Generator().manual_seed(1))
    ffn.train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 16, 8)).astype(np.float32))
    _, aux = ffn(x, torch.ones(4, 16, dtype=torch.bool))
    assert float(aux) >= 0.99


MODEL = {"use_flash": False, "d_model": 16, "nhead": 4, "nlayers": 2, "d_ff": 32,
         "dropout": 0.0, "max_pos": 300, "compute_dtype": "float32"}


def _config(root, moe):
    return {"dataset": {"task": "zinc", "zinc_root": os.path.join(root, "zinc"),
                        "subset": True, "max_len": 1024, "pack": True, "cache": False},
            "model": {**MODEL, "moe_experts": moe, "moe_aux_weight": 0.05},
            "train": {"batch_size": 16, "epochs": 2, "lr": 3e-3, "weight_decay": 1e-2,
                      "seed": 0},
            "output": {"out_dir": "", "run_name": "run"}, "wandb": {"use": False}}


@pytest.fixture(scope="module", params=[2, 4], ids=["E2", "E4"])
def moe_runs(request, tmp_path_factory):
    """Both trainers from one initial checkpoint of the port's MoE model."""
    tmp = str(tmp_path_factory.mktemp(f"moe{request.param}"))
    config = _config(tmp, request.param)
    init = os.path.join(tmp, "init")
    bundle = trainer.build_dataset("agtt", config["dataset"], 0, limit=40)
    model = trainer.build_model("agtt", config, bundle,
                                generator=torch.Generator().manual_seed(7))
    checkpoint.save_checkpoint(init, {"params": params_to_flax(model.state_dict()),
                                      "epoch": 0})
    runs = {}
    for side in ("jax", "port"):
        cfg = copy.deepcopy(config)
        cfg["output"]["out_dir"] = os.path.join(tmp, side)
        cfg["train"].update(resume=True, resume_path=init)
        if side == "port":
            res = trainer.train(cfg, "agtt", limit=40, verbose=False, device="cpu")
        else:
            with pytest.MonkeyPatch.context() as mp:   # one device: no mesh
                mp.setattr(jax_trainer, "make_mesh", lambda **kwargs: None)
                res = jax_trainer.train(cfg, "agtt", limit=40, verbose=False)
        runs[side] = (res, cfg)
    return tmp, runs


def test_moe_trainer_matches_jax(moe_runs):
    _, runs = moe_runs
    (jres, _), (pres, _) = runs["jax"], runs["port"]
    assert len(pres.history) == len(jres.history) == 2
    for ph, jh in zip(pres.history, jres.history):
        for key in ("train/loss", "val/loss", "train/grad_norm", "lr"):
            np.testing.assert_allclose(ph[key], jh[key], rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(pres.test_metrics["loss"], jres.test_metrics["loss"],
                               rtol=LOSS_RTOL)
    assert "moe" in pres.params["layer_0"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_checkpoints_serve_in_both_packages(moe_runs, writer):
    tmp, runs = moe_runs
    _, cfg = runs[writer]
    path = os.path.join(cfg["output"]["out_dir"], "best_run")
    graphs = load_zinc_split(os.path.join(tmp, "zinc"), "val", limit=12)
    ref = JaxPredictor.from_checkpoint(path, max_batch=8).predict_graphs(graphs)
    got = Predictor.from_checkpoint(path, max_batch=8, device="cpu").predict_graphs(graphs)
    assert np.isfinite(got["pred"]).all()
    np.testing.assert_allclose(got["pred"], ref["pred"], atol=PRED_ATOL, rtol=0)
    # the optimizer state's moments map onto the parameters by name
    saved = checkpoint.load_checkpoint(path)
    names = [n for n, _ in runs["port"][0].model.named_parameters()]
    state = opt_state_to_torch(saved["opt_state"], names, with_schedule=False)
    assert state is not None
    shapes = dict((n, p.shape) for n, p in runs["port"][0].model.named_parameters())
    assert [m.shape for m in state["mu"]] == [shapes[n] for n in names]
