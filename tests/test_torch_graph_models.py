"""Port parity: the graph-native models (MPNN/GIN, GPS) against flax, CPU.

The flax model is initialised, its ``params`` and ``batch_stats`` loaded
into the port's model through ``convert.py``, and both run on the same
seeded padded graph batch (ragged node counts, ZINC-like bond types), with
dropout off:

- eval logits (running statistics), f32 compute: within 1e-5 times the
  largest logit (at least 1; the ``add`` pool of GPS gives logits of
  tens);
- a training forward (batch statistics): logits as above; every
  parameter's gradient of a fixed linear loss within 1e-5 of the largest
  gradient of its leaf, or of a tenth of the model's largest gradient where
  that is more (a bias that feeds a BatchNorm, or the key bias before a
  softmax, has a zero gradient in exact arithmetic, and both sides return
  rounding noise); the BatchNorm running mean and variance
  after the step within 1e-6;
- bf16 compute: logits within 3e-2 on the scale above; every gradient
  within 5e-2 of the model's largest gradient; running statistics within
  3e-2. The two sides round the same bf16 operands but
  at different places (flax rounds each ``Dense`` product and then its bias
  add; torch's bf16 GEMM rounds once; GPS's bf16 softmax), so the
  differences are bf16 roundings carried through several layers;
- padding invariance: more pad nodes change no logit or statistic.

Also ``ops/segment.py`` against the JAX package's masked reductions, the
parameter and ``batch_stats`` mappings both ways, and the port's
counter-hash dropout (exact rate, reproducible, CPU only here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.models.gps import GPSModel as FlaxGPS
from glearning_benchmark_tpu.models.mpnn import MPNN as FlaxMPNN
from glearning_benchmark_tpu.ops import segment as jax_segment
from glearning_benchmark_tpu_torch.convert import (batch_stats_from_flax,
                                                   batch_stats_to_flax,
                                                   load_flax_params, params_from_flax,
                                                   params_to_flax)
from glearning_benchmark_tpu_torch.models.gps import GPSModel
from glearning_benchmark_tpu_torch.models.mpnn import MPNN
from glearning_benchmark_tpu_torch.ops import segment
from glearning_benchmark_tpu_torch.ops.attention import hash_dropout
from glearning_benchmark_tpu_torch.train.checkpoint import _flatten

B, N, F_IN, C = 6, 11, 3, 4
# grad_floor: the share of the model's largest gradient below which a leaf
# is measured against that share instead of its own largest gradient
TOL = {"float32": dict(logit=1e-5, grad=1e-5, grad_floor=0.1),
       "bfloat16": dict(logit=3e-2, grad=5e-2, grad_floor=1.0)}
STATS_ATOL = 1e-6


def _batch(n_pad=N, seed=0):
    """Seeded graphs of 3..N nodes, padded to ``n_pad`` (>= N)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, N + 1, size=B)
    counts[0] = N
    x = np.zeros((B, n_pad, F_IN), np.float32)
    adj = np.zeros((B, n_pad, n_pad), np.float32)
    et = np.zeros((B, n_pad, n_pad), np.uint8)
    mask = np.zeros((B, n_pad), bool)
    for b, k in enumerate(counts):
        x[b, :k] = rng.normal(size=(k, F_IN))
        mask[b, :k] = True
        upper = np.triu(rng.random((k, k)) < 0.35, 1)
        types = rng.integers(1, 5, size=(k, k)) * upper
        adj[b, :k, :k] = upper | upper.T
        et[b, :k, :k] = types + types.T
    return x, adj, et, mask


def _models(kind, compute_dtype, edge_features, task="shortest_path"):
    ncls = 1 if task == "zinc" else C
    common = dict(in_dim=F_IN, num_classes=ncls, task=task, compute_dtype=compute_dtype,
                  edge_features=edge_features)
    if kind == "mpnn":
        kw = dict(hidden_dim=16, num_layers=3, dropout=0.0, pooling="mean", **common)
        return FlaxMPNN(**kw), MPNN(**kw)
    kw = dict(dim=16, num_layers=2, n_heads=4, dropout=0.0, attn_dropout=0.0,
              pooling="add", **common)
    return FlaxGPS(**kw), GPSModel(**kw)


@functools.lru_cache(maxsize=None)
def _flax_variables(kind, compute_dtype, edge_features, task):
    fmodel, _ = _models(kind, compute_dtype, edge_features, task)
    x, adj, et, mask = _batch()
    variables = jax.jit(lambda r: fmodel.init(r, x, adj, mask, etype=et))(
        jax.random.PRNGKey(3))
    # move the running statistics off their init so eval uses real values
    rng = np.random.default_rng(1)
    bs = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                      .astype(np.float32), variables["batch_stats"])
    return fmodel, {"params": variables["params"], "batch_stats": bs}


def _setup(kind, compute_dtype, edge_features, task="shortest_path"):
    fmodel, variables = _flax_variables(kind, compute_dtype, edge_features, task)
    _, tmodel = _models(kind, compute_dtype, edge_features, task)
    load_flax_params(tmodel, variables["params"], variables["batch_stats"])
    return fmodel, tmodel, variables, _batch()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _logits_close(got, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


CASES = [("mpnn", False), ("mpnn", True), ("ggps", False), ("ggps", True)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,edge_features", CASES)
def test_eval_logits_match_flax(kind, edge_features, compute_dtype):
    fmodel, tmodel, variables, (x, adj, et, mask) = _setup(kind, compute_dtype,
                                                           edge_features)
    ref = np.asarray(jax.jit(lambda v: fmodel.apply(v, x, adj, mask, deterministic=True,
                                                    etype=et))(variables))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(*_t(x, adj, mask), etype=torch.from_numpy(et)).numpy()
    assert got.shape == ref.shape == (B, C)
    _logits_close(got, ref, TOL[compute_dtype]["logit"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,edge_features", CASES)
def test_train_step_grads_and_running_stats_match_flax(kind, edge_features, compute_dtype):
    fmodel, tmodel, variables, (x, adj, et, mask) = _setup(kind, compute_dtype,
                                                           edge_features)
    w = np.random.default_rng(2).normal(size=(B, C)).astype(np.float32)

    def loss_fn(p):
        out, upd = fmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                x, adj, mask, deterministic=False, etype=et,
                                mutable=["batch_stats"])
        return (out * w).sum(), (out, upd["batch_stats"])

    (_, (ref_logits, ref_stats)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tmodel.train()
    logits = tmodel(*_t(x, adj, mask), etype=torch.from_numpy(et))
    (logits * torch.from_numpy(w)).sum().backward()
    tol = TOL[compute_dtype]
    _logits_close(logits.detach().numpy(), np.asarray(ref_logits), tol["logit"])
    grads = _flatten(params_to_flax({k: p.grad for k, p in tmodel.named_parameters()}))
    ref_flat = _flatten(jax.tree.map(np.asarray, ref_grads))
    assert sorted(grads) == sorted(ref_flat)
    gmax = max(np.abs(g).max() for g in ref_flat.values())
    for path, g in ref_flat.items():
        assert grads[path].shape == g.shape, path
        scale = max(np.abs(g).max(), tol["grad_floor"] * gmax)
        err = np.abs(grads[path].numpy().astype(np.float64) - g).max()
        assert err <= tol["grad"] * scale, (path, err, scale)
    stats = _flatten(batch_stats_to_flax(tmodel.state_dict()))
    ref_s = _flatten(jax.tree.map(np.asarray, ref_stats))
    assert sorted(stats) == sorted(ref_s)
    for path, v in ref_s.items():
        np.testing.assert_allclose(stats[path].numpy(), v,
                                   atol=STATS_ATOL if compute_dtype == "float32"
                                   else tol["logit"], rtol=0, err_msg=path)


@pytest.mark.parametrize("kind", ["mpnn", "ggps"])
def test_padding_invariance(kind):
    _, tmodel, _, (x, adj, et, mask) = _setup(kind, "float32", True, task="zinc")
    x2, adj2, et2, mask2 = _batch(n_pad=N + 7)
    np.testing.assert_array_equal(x2[:, :N], x)
    outs = []
    for mode in ("eval", "train"):
        for xx, aa, ee, mm in ((x, adj, et, mask), (x2, adj2, et2, mask2)):
            tmodel.load_state_dict(dict(tmodel.state_dict()))
            getattr(tmodel, mode)()
            before = {k: v.clone() for k, v in tmodel.state_dict().items()}
            with torch.no_grad():
                out = tmodel(*_t(xx, aa, mm), etype=torch.from_numpy(ee))
            outs.append((out, {k: v.clone() for k, v in tmodel.state_dict().items()}))
            tmodel.load_state_dict(before)
    for a, b in ((outs[0], outs[1]), (outs[2], outs[3])):
        assert a[0].shape == (B,)
        torch.testing.assert_close(a[0], b[0], atol=1e-5, rtol=0)
        for k in a[1]:
            torch.testing.assert_close(a[1][k], b[1][k], atol=1e-6, rtol=0)


def test_param_and_stats_mappings_round_trip():
    fmodel, tmodel, variables, _ = _setup("ggps", "float32", True)
    flat = _flatten(jax.tree.map(np.asarray, variables["params"]))
    back = _flatten(params_to_flax(tmodel.state_dict()))
    assert sorted(back) == sorted(flat)
    for path, v in flat.items():
        assert back[path].numpy().tobytes() == v.tobytes(), path
    assert "gps_0/local_gin/eps" in flat and flat["gps_0/local_gin/eps"].shape == ()
    assert flat["gps_0/local_gin/edge_emb"].shape == (4, 16)
    stats = _flatten(batch_stats_to_flax(tmodel.state_dict()))
    assert sorted(stats) == sorted(_flatten(variables["batch_stats"]))
    assert "gps_1/bn_ff/var" in stats
    state = params_from_flax(variables["params"]) | batch_stats_from_flax(
        variables["batch_stats"])
    assert set(state) == set(tmodel.state_dict())
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(tmodel, {k: v for k, v in variables["params"].items()
                                  if k != "post_mp"})


@pytest.mark.parametrize("fn", ["masked_sum", "masked_mean", "masked_max"])
def test_segment_reductions_match_jax(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 7, 5)).astype(np.float32)
    mask = rng.random((4, 7)) < 0.6
    mask[1] = False                                  # an all-pad row
    mask[2, 3] = True
    x[2, 3] = x[2].max() + 1                          # a tie below for max
    x[2, 4] = x[2, 3]
    mask[2, 4] = True
    ref = getattr(jax_segment, fn)(jnp.asarray(x), jnp.asarray(mask))
    xt = torch.from_numpy(x).requires_grad_()
    got = getattr(segment, fn)(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    w = rng.normal(size=got.shape).astype(np.float32)
    ref_g = jax.grad(lambda a: (getattr(jax_segment, fn)(a, jnp.asarray(mask)) * w).sum())(
        jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-7)


def test_hash_dropout_rate_and_seed():
    x = torch.ones(64, 50, 64)
    a = hash_dropout(5, x, 0.1)
    assert torch.equal(a, hash_dropout(5, x, 0.1))
    assert not torch.equal(a, hash_dropout(6, x, 0.1))
    kept = (a > 0).float().mean().item()
    assert abs(kept - 0.9) < 5e-3
    torch.testing.assert_close(a[a > 0], torch.full_like(a[a > 0], 1 / 0.9))
    assert hash_dropout(5, x, 0.0) is x


@pytest.mark.parametrize("kind", ["mpnn", "ggps"])
def test_dropout_is_drawn_from_the_generator(kind):
    model = (MPNN(in_dim=F_IN, hidden_dim=16, num_layers=2, dropout=0.3) if kind == "mpnn"
             else GPSModel(in_dim=F_IN, dim=16, num_layers=2, dropout=0.2,
                           attn_dropout=0.3))
    x, adj, mask = _t(*_batch()[:2], _batch()[3])
    model.train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for seed in (1, 1, 2):
        model.load_state_dict(state)
        outs.append(model(x, adj, mask, generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator"):
        model(x, adj, mask)
    model.eval()
    assert torch.equal(model(x, adj, mask), model(x, adj, mask))
