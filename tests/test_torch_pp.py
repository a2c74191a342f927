"""Pipeline parallelism of the port (the 'pipe' axis), CPU, on gloo ranks
(the pool of ``test_torch_tp.py``).

- ``pp_transformer_forward`` on two stages against the JAX package's on a
  ('data' 1, 'pipe' 2) mesh, f32, deterministic, from the same parameters:
  (stages, microbatches) (2, 2) and (2, 4), unpacked rows with the query
  readout and packed rows with the slot readout; every stage's logits
  within 1e-5.
- Training with dropout on, two stages against the port's one-process run:
  agtt on packed ZINC rows (2 microbatches) and on unpacked rows (3): the
  first 4 step losses and every epoch's losses within rtol 1e-5; every
  stage ends with the same parameters.
- The guards of ``pipeline.py:171-183`` with the JAX package's messages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.models.transformer import SimpleTransformer as JaxTransformer
from glearning_benchmark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glearning_benchmark_tpu.parallel.pipeline import pp_transformer_forward as jax_pp
from glearning_benchmark_tpu.tokenization.pack import pack_examples
from glearning_benchmark_tpu_torch.convert import params_from_flax
from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer
from glearning_benchmark_tpu_torch.parallel.pipeline import check_pipeline

from test_torch_tp import (ZINC_LIMIT, assert_token_run_equal, one_process, run_ranks,
                           same_on_every_rank, zinc_config)

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

ATOL = 1e-5
MODEL = dict(vocab_size=100, d_model=16, nhead=4, nlayers=2, d_ff=32, max_pos=64,
             num_classes=7, bos_id=1, query_offsets=(2, 3), compute_dtype="float32")
CASES = [(2, False), (4, False), (2, True), (4, True)]     # (microbatches, packed)


def _inputs(packed):
    rng = np.random.default_rng(1)
    if not packed:
        b, l = 8, 24
        ids = rng.integers(7, 100, size=(b, l)).astype(np.int32)
        ids[:, 0] = 1
        ids[np.arange(b), rng.integers(5, 18, size=b)] = 3       # '<q>'
        mask = np.arange(l)[None] < rng.integers(20, l + 1, size=(b, 1))
        return {"x": ids, "attn_mask": mask}
    seqs = [np.concatenate([[1], rng.integers(7, 100, size=rng.integers(6, 14))])
            .astype(np.int32) for _ in range(20)]
    pk = pack_examples(seqs, bucket=24, pad_id=0)
    rows = {k: np.concatenate([pk[k]] * 8)[:8] for k in
            ("ids", "seg", "pos", "pos_bos", "pos_u", "pos_v")}
    return {"x": rows.pop("ids"), "attn_mask": rows["seg"] > 0, **rows}


def _jax_model(packed):
    task = "cycle_check" if packed else "shortest_path"
    return JaxTransformer(use_query_nodes=not packed, task=task, p_drop=0.1, **MODEL)


def _port_model(packed):
    task = "cycle_check" if packed else "shortest_path"
    return dict(use_query_nodes=not packed, task=task, p_drop=0.1, **MODEL)


def _jax_params(packed):
    ins = _inputs(packed)
    kw = {k: jnp.asarray(v) for k, v in ins.items() if k not in ("x", "attn_mask")}
    return _jax_model(packed).init(jax.random.PRNGKey(0), jnp.asarray(ins["x"]),
                                   jnp.asarray(ins["attn_mask"]), q_token_id=3,
                                   deterministic=True, **kw)["params"]


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pp"))
    jobs = []
    for m, packed in CASES:
        state = params_from_flax(jax.tree.map(np.asarray, _jax_params(packed)))
        jobs.append({"kind": "pp", "name": f"fwd_{m}_{packed}", "model": _port_model(packed),
                     "state": state, "inputs": _inputs(packed), "n_micro": m,
                     "q": None if packed else 3})
    zinc = os.path.join(tmp, "zinc")
    # row batches of 4 (packed: 32 examples in 13 rows, batch 10) and 6
    runs = {"packed": ("agtt", zinc_config(zinc, os.path.join(tmp, "out", "packed"),
                                           parallel={"pipe_stages": 2,
                                                     "pipe_microbatches": 2},
                                           batch_size=10), 32),
            "unpacked": ("agtt", zinc_config(zinc, os.path.join(tmp, "out", "unpacked"),
                                             pack=False, batch_size=6,
                                             parallel={"pipe_stages": 2,
                                                       "pipe_microbatches": 3}), ZINC_LIMIT)}
    jobs += [{"kind": "train", "name": name, "model": m, "config": cfg, "limit": limit}
             for name, (m, cfg, limit) in runs.items()]
    wait = run_ranks(tmp, "pp", jobs)
    try:
        single = {name: one_process(cfg, m, limit) for name, (m, cfg, limit) in runs.items()}
    finally:
        ranks = wait()
    return {"ranks": ranks, "single": single}


@pytest.mark.parametrize("n_micro,packed", CASES)
def test_pipeline_forward_matches_jax(pp, n_micro, packed):
    ins = _inputs(packed)
    kw = {k: jnp.asarray(v) for k, v in ins.items() if k not in ("x", "attn_mask")}
    mesh = jax_make_mesh(devices=jax.devices()[:2], pipe_stages=2)
    model = _jax_model(packed)
    want = jax.jit(lambda p: jax_pp(mesh, model, p, jnp.asarray(ins["x"]),
                                    jnp.asarray(ins["attn_mask"]),
                                    q_token_id=None if packed else 3,
                                    deterministic=True, n_micro=n_micro, **kw))(
        _jax_params(packed))
    for rank in pp["ranks"]:
        np.testing.assert_allclose(rank[f"fwd_{n_micro}_{packed}"].numpy(),
                                   np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["packed", "unpacked"])
def test_pp_with_dropout_equals_one_process(pp, name):
    assert_token_run_equal(same_on_every_rank(pp["ranks"], name), pp["single"][name])


def test_pipeline_guards():
    model = SimpleTransformer(**{**_port_model(False), "nlayers": 3})
    with pytest.raises(ValueError, match=r"model.nlayers=3 must divide over pipe_stages=2"):
        check_pipeline(model, 2, 8, 2)
    model = SimpleTransformer(**_port_model(False))
    with pytest.raises(ValueError, match="batch 6 not divisible by pipe microbatches 4"):
        check_pipeline(model, 2, 6, 4)
    moe = SimpleTransformer(**_port_model(False), moe_experts=2)
    with pytest.raises(ValueError, match="does not compose with MoE FFNs"):
        check_pipeline(moe, 2, 8, 2)
