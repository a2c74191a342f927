"""The port's data axis in one process, CPU: the shard layout against the
JAX package's, the mesh helpers, and dropout masks placed in the global
index space.

Under a 'data' mesh the JAX package draws every dropout mask over the
whole global tensor, and a device holds rows of it. So a data-parallel
rank's masks must be its rows of the global mask, bit for bit: the
blocked-byte helpers (``hash_keep_mask``, ``cheap_dropout``, with the MoE
expert tensor's batch on axis 1 as well as axis 0), ``hash_dropout``,
``dropout_keep_reference`` and the kernels' plain versions (forward and
backward) with a ``bh_offset``, and the models' training forwards handed
the rank's shard: a rank's rows of a token model's logits equal those rows
of the one-process forward, dropout on. With one process every offset is
0 and nothing changes (the other test files).
"""

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.parallel.data import host_shard_bounds as jax_bounds
from glearning_benchmark_tpu_torch import parallel
from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer
from glearning_benchmark_tpu_torch.ops import flash_attention as fa
from glearning_benchmark_tpu_torch.ops.attention import (cheap_dropout, hash_dropout,
                                                         hash_keep_mask,
                                                         multi_head_attention)
from glearning_benchmark_tpu_torch.parallel.mesh import BatchShard, Mesh


def test_host_shard_bounds_match_jax():
    for n in range(51):
        for count in range(1, 6):
            for index in range(count):
                got = parallel.host_shard_bounds(n, index, count)
                assert got == jax_bounds(n, index, count), (n, index, count)
                items = list(range(n))
                assert parallel.shard_for_host(items, index, count) == items[slice(*got)]
    assert parallel.host_shard_bounds(7) == (0, 7)       # no group: one process


def test_mesh_is_the_data_axis_only():
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    assert parallel.replicated_spec(mesh) is None
    for key in ("model_axis", "seq_shards", "pipe_stages", "expert_shards"):
        with pytest.raises(NotImplementedError, match="next slice"):
            parallel.make_mesh(**{key: 2})
    with pytest.raises(NotImplementedError, match="next slice"):
        parallel.param_shard_spec(mesh, (), torch.zeros(2))
    with pytest.raises(NotImplementedError, match="next slice"):
        parallel.shard_params(mesh, {})
    # rank r's contiguous block, as P("data") gives device r
    blocks = [parallel.shard_batch_spec(Mesh(r, 4), 12) for r in range(4)]
    assert [(s.start, s.stop, s.total, s.size) for s in blocks] == \
        [(0, 3, 12, 4), (3, 6, 12, 4), (6, 9, 12, 4), (9, 12, 12, 4)]
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch_spec(Mesh(0, 4), 10)


def test_initialize_distributed_one_process_and_failures(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.initialize_distributed("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.initialize_distributed("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="gloo"):
        parallel.initialize_distributed("cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="rendezvous"):   # raises, never swallowed
        parallel.initialize_distributed("cpu", init_method="nonsense://x")


def _ranks(total, size):
    per = total // size
    return [(r * per, (r + 1) * per) for r in range(size)]


@pytest.mark.parametrize("rate", [0.1, 26 / 256, 0.5])
def test_blocked_byte_masks_are_rows_of_the_global_mask(rate):
    seed = 0x9E3779B9
    full, p_full = hash_keep_mask(seed, (6, 4, 9, 13), rate)
    x = torch.randn(5, 6, 7, 10, generator=torch.Generator().manual_seed(1))
    for start, stop in _ranks(6, 3):
        part, p_part = hash_keep_mask(seed, (stop - start, 4, 9, 13), rate,
                                      batch_offset=start)
        assert p_part == p_full and torch.equal(part, full[start:stop])
    # the MoE expert tensor [E, B, C, f]: the batch is axis 1, so a rank's
    # words are strided runs of the global tensor's
    full_x = cheap_dropout(seed, x, rate)
    for start, stop in _ranks(6, 2):
        part = cheap_dropout(seed, x[:, start:stop], rate, batch_axis=1,
                             batch_offset=start, batch_total=6)
        assert torch.equal(part, full_x[:, start:stop])
    with pytest.raises(ValueError, match="batch_total"):
        hash_keep_mask(seed, (5, 3, 7, 10), rate, batch_axis=1, batch_offset=3)


def test_hash_dropout_and_attention_masks_are_rows_of_the_global_mask():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(8, 5, 6, generator=gen)
    full = hash_dropout(77, x, 0.3)
    q, k, v = (torch.randn(8, 7, 2, 4, generator=gen) for _ in range(3))
    mask = torch.rand(8, 7, generator=gen) > 0.2
    mask[:, 0] = True
    attn = multi_head_attention(q, k, v, key_mask=mask, dropout_rate=0.1,
                                dropout_seed=5)
    for start, stop in _ranks(8, 4):
        assert torch.equal(hash_dropout(77, x[start:stop], 0.3, start), full[start:stop])
        part = multi_head_attention(q[start:stop], k[start:stop], v[start:stop],
                                    key_mask=mask[start:stop], dropout_rate=0.1,
                                    dropout_seed=5, batch_offset=start)
        assert torch.equal(part, attn[start:stop])


@pytest.mark.parametrize("p_drop", [26 / 256, 0.1])
def test_kernel_plain_versions_with_a_bh_offset_are_rows_of_the_global_run(p_drop):
    """``dropout_keep_reference`` and the plain forward and backward of the
    three kernels (their CPU path) at a non-zero ``bh_offset``."""
    gen = torch.Generator().manual_seed(3)
    b, l, h, d = 4, 24, 2, 8
    q, k, v, do = (torch.randn(b, l, h, d, generator=gen) for _ in range(4))
    seg = torch.ones(b, l, dtype=torch.int32)
    seg[:, 15:] = 2
    seg[1, 20:] = 0
    keep = fa.dropout_keep_reference(11, b * h, l, l, p_drop)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, 11)
    grads = fa.flash_attention_bwd(q, k, v, seg, o, lse, do, p_drop, 11)
    for start, stop in _ranks(b, 2):
        rows = slice(start, stop)
        off = start * h
        assert torch.equal(fa.dropout_keep_reference(11, (stop - start) * h, l, l, p_drop,
                                                     bh_offset=off),
                           keep[start * h:stop * h])
        args = (q[rows], k[rows], v[rows], seg[rows])
        po, plse = fa.flash_attention_fwd(*args, p_drop, 11, bh_offset=off)
        assert torch.equal(po, o[rows]) and torch.equal(plse, lse[rows])
        dq, delta = fa.flash_attention_bwd_dq(*args, po, plse, do[rows], p_drop, 11,
                                              bh_offset=off)
        dk, dv = fa.flash_attention_bwd_dkv(*args, po, plse, do[rows], delta, p_drop, 11,
                                            bh_offset=off)
        for got, want in zip((dq, dk, dv), grads):
            assert torch.equal(got, want[rows])
        # through autograd, as the model calls it
        qs, ks, vs = (t[rows].clone().requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(qs, ks, vs, seg=seg[rows], p_drop=p_drop, seed=11,
                                 bh_offset=off)
        assert torch.equal(out, o[rows])
        for got, want in zip(torch.autograd.grad(out, (qs, ks, vs), do[rows]), grads):
            assert torch.equal(got, want[rows])
    with pytest.raises(ValueError, match="u32"):
        fa.flash_attention_fwd(q, k, v, seg, p_drop, 11, bh_offset=2**32 - 1)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_a_ranks_training_forward_is_rows_of_the_global_one(packed):
    """Dropout on at every site (attention probabilities in the kernels'
    plain versions, the three blocked-byte sites): each rank's shard of a
    training forward gives exactly its rows of the one-process logits."""
    torch.manual_seed(0)
    model = SimpleTransformer(vocab_size=30, d_model=16, nhead=4, nlayers=2, d_ff=32,
                              p_drop=0.2, max_pos=64, use_query_nodes=False,
                              task="cycle_check", generator=torch.Generator().manual_seed(4))
    model.train()
    gen = torch.Generator().manual_seed(5)
    b, l = 6, 20
    ids = torch.randint(5, 30, (b, l), generator=gen)
    ids[:, 0] = 1
    lens = torch.randint(8, l + 1, (b,), generator=gen)
    mask = torch.arange(l)[None] < lens[:, None]
    kw = {}
    if packed:
        seg = torch.where(mask, 1 + (torch.arange(l)[None] >= 10).to(torch.int64), 0)
        pos = torch.where(torch.arange(l)[None] >= 10, torch.arange(l)[None] - 10,
                          torch.arange(l)[None]).expand(b, l)
        slots = torch.tensor([[0, 10]] * b)
        kw = dict(seg=seg, pos=pos, pos_bos=slots, pos_u=torch.zeros_like(slots),
                  pos_v=torch.zeros_like(slots))
        mask = seg > 0
    full = model(ids, mask, generator=torch.Generator().manual_seed(9), **kw)
    for start, stop in _ranks(b, 3):
        part_kw = {k: t[start:stop] for k, t in kw.items()}
        part = model(ids[start:stop], mask[start:stop],
                     generator=torch.Generator().manual_seed(9),
                     shard=BatchShard(start, stop, b, 3), **part_kw)
        assert torch.equal(part, full[start:stop])
    # without its offset, a rank would draw other masks
    wrong = model(ids[2:4], mask[2:4], generator=torch.Generator().manual_seed(9),
                  **{k: t[2:4] for k, t in kw.items()})
    assert not torch.equal(wrong, full[2:4])
    np.testing.assert_array_equal(np.isfinite(full.detach().numpy()), True)
