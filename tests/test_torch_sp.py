"""Sequence parallelism of the port (the 'seq' axis), CPU, on gloo ranks
(the pool of ``test_torch_tp.py``).

- ``dropout_keep_mask`` (threefry2x32, partitionable ``jax.random.bits``)
  equals the JAX package's bit for bit, for several keys, shapes (a last
  axis that is not a multiple of 4 among them) and rates.
- ``ring_attention`` on a ('data' 1, 'seq' 2) mesh against the JAX
  package's, f32, dropout off: forward and the gradients of q, k, v within
  1e-5, with a row whose keys are all masked (zeros out, zero gradients).
- With dropout, the ring against the port's flash attention on one process
  (its plain version, the stream of the kernels) at the same seed: the
  rows of valid queries, and the gradients, within 1e-5. A pad query
  attends the valid keys in the ring (the reference's semantics) and
  nothing in the kernel; it reaches no readout, so in the model its
  cotangent is zero, as here.
- Training with dropout on: agtt on unpacked ZINC rows on two 'seq' ranks,
  and the same with a Switch MoE FFN, against the port's one-process run:
  the first 4 step losses and every epoch's losses within rtol 1e-5.
- The guards: packed rows and a row that does not split are refused with
  the JAX package's messages.
"""

import os

import jax
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.ops.attention import dropout_keep_mask as jax_keep_mask
from glearning_benchmark_tpu.ops.ring_attention import ring_attention as jax_ring
from glearning_benchmark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glearning_benchmark_tpu_torch.ops.attention import dropout_keep_mask
from glearning_benchmark_tpu_torch.ops.flash_attention import flash_attention
from glearning_benchmark_tpu_torch.ops.ring_attention import seq_block
from glearning_benchmark_tpu_torch.parallel.mesh import Axis
from glearning_benchmark_tpu_torch.train import trainer

from test_torch_tp import (ZINC_LIMIT, assert_token_run_equal, one_process, run_ranks,
                           same_on_every_rank, zinc_config)

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

ATOL = 1e-5
B, L, H, D = 2, 16, 2, 8
P_DROP, SEED = 0.25, 1234


def _ring_inputs():
    rng = np.random.default_rng(0)
    q, k, v, cot = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, L), bool)
    mask[0, 11:] = False           # a ragged row
    mask[1, :] = False             # every key masked: zeros
    cot[~mask] = 0.0               # pad queries reach no loss
    return q, k, v, mask, cot


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp"))
    q, k, v, mask, cot = _ring_inputs()
    ring = {"q": q, "k": k, "v": v, "mask": mask, "cot": cot}
    zinc = os.path.join(tmp, "zinc")
    runs = {name: ("agtt", zinc_config(zinc, os.path.join(tmp, "out", name), model,
                                       pack=False, parallel={"seq_shards": 2},
                                       batch_size=6), ZINC_LIMIT)
            for name, model in (("agtt", None), ("moe", {"moe_experts": 2}))}
    jobs = [{"kind": "ring", "name": "ring", "p": 0.0, "seed": None, **ring},
            {"kind": "ring", "name": "ring_drop", "p": P_DROP, "seed": SEED, **ring}]
    jobs += [{"kind": "train", "name": name, "model": m, "config": cfg, "limit": limit}
             for name, (m, cfg, limit) in runs.items()]
    wait = run_ranks(tmp, "sp", jobs)
    try:
        single = {name: one_process(cfg, m, limit) for name, (m, cfg, limit) in runs.items()}
    finally:
        ranks = wait()
    return {"ranks": ranks, "single": single, "runs": runs}


def _gathered(ranks, name, what):
    """The ranks' blocks of a ring output, along the sequence."""
    return np.concatenate([r[name][what].numpy() if what == "out" else
                           np.stack([g.numpy() for g in r[name]["grads"]])
                           for r in ranks], axis=1 if what == "out" else 2)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 4, 16), (1, 1, 3), (6, 10)])
@pytest.mark.parametrize("rate", [0.1, 26 / 256, 0.5])
def test_dropout_keep_mask_matches_jax_bit_for_bit(seed, shape, rate):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want, want_rate = jax_keep_mask(key, shape, rate)
    got, got_rate = dropout_keep_mask(np.asarray(jax.random.key_data(key)).tolist(),
                                      shape, rate)
    assert got_rate == want_rate
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_matches_jax_forward_and_gradients(sp):
    q, k, v, mask, cot = _ring_inputs()
    mesh = jax_make_mesh(devices=jax.devices()[:2], seq_shards=2)

    def ring(q, k, v):
        return jax_ring(mesh, q, k, v, mask)

    want = np.asarray(jax.jit(ring)(q, k, v))
    grads = jax.jit(jax.grad(lambda *a: (ring(*a) * cot).sum(), (0, 1, 2)))(q, k, v)
    want_grads = np.stack([np.asarray(g) for g in grads])
    np.testing.assert_allclose(_gathered(sp["ranks"], "ring", "out"), want, atol=ATOL)
    np.testing.assert_allclose(_gathered(sp["ranks"], "ring", "grads"), want_grads,
                               atol=ATOL)
    assert not _gathered(sp["ranks"], "ring", "out")[1].any()     # fully masked row


def test_ring_with_dropout_draws_the_kernels_masks(sp):
    q, k, v, mask, cot = (torch.from_numpy(a) for a in _ring_inputs())
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ins, mask, p_drop=P_DROP, seed=SEED)
    grads = torch.autograd.grad((out * cot).sum(), ins)
    got = _gathered(sp["ranks"], "ring_drop", "out")
    valid = mask.numpy()
    np.testing.assert_allclose(got[valid], out.detach().numpy()[valid], atol=ATOL)
    np.testing.assert_allclose(_gathered(sp["ranks"], "ring_drop", "grads"),
                               np.stack([g.numpy() for g in grads]), atol=ATOL)
    # dropout did act: the undropped ring differs on the valid rows
    assert not np.allclose(got[valid], _gathered(sp["ranks"], "ring", "out")[valid])


@pytest.mark.parametrize("name", ["agtt", "moe"])
def test_sp_with_dropout_equals_one_process(sp, name):
    assert_token_run_equal(same_on_every_rank(sp["ranks"], name), sp["single"][name])


def test_sp_guards(tmp_path):
    with pytest.raises(ValueError, match="L=10 not divisible by seq axis size 4"):
        seq_block(10, Axis(("seq",), 4, 0, (0, 1, 2, 3)))
    cfg = zinc_config(str(tmp_path / "zinc"), str(tmp_path / "out"),
                      parallel={"seq_shards": 2})
    with pytest.raises(ValueError, match="requires dataset.pack: false"):
        trainer.train(cfg, "agtt", limit=8, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="graph-native models have no sequence axis"):
        trainer.train(cfg, "mpnn", limit=8, verbose=False, device="cpu")
