"""Head dims the JAX package runs: the port's attention takes every head dim
(kernel instances at 4, 8, 16, 32, 64 and 128, any other head dim up to 128
zero-padded to the next instance; above 128 the three kernels' wgmma
instance at 256, bf16 129-256 zero-padded to it, the three kernels'
wgmma_chunks instances at 320, 384, 448 and 512, bf16 257-512 zero-padded
to the next multiple of 64, and f32 above 128 and bf16 above 512 unpadded
in the kernels' wide route).

- The port's ``SimpleTransformer`` against the flax one at head dims 12,
  24, 128, 160 and 256 (weights through ``convert.py``, f32, one layer,
  L = 16; the flax side on its XLA path): logits within 1e-5, as
  ``tests/test_torch_transformer.py`` holds them (the two sides differ only
  in summation order), and the gradients of a loss within 1e-5 of each
  leaf's largest gradient.
- ``pad_head_dim`` with the plain version in place of the kernel: O, LSE,
  dQ, dK and dV equal the unpadded plain version's within 1e-5 absolute at
  head dims 12 and 100 with dropout on (the padded einsums sum zeros in
  another order: measured 5e-7), and at 160 and 320, which pass unpadded.
- Head dims 129-512 in f32 run at themselves in the wide route, in all
  three kernels; in bf16 the three kernels run 129-256 in their wgmma
  instance at 256, 257-512 in their wgmma_chunks instances at 320, 384,
  448 and 512 and above 512 the wide route.
- The bf16 forward's padding to 256, with the plain version in place of the
  kernel: LSE within 1e-5 of the unpadded version's, O within one bf16
  rounding (with dropout).
- On the card (``cuda`` marker, skipped here): the kernels at padded head
  dims against their plain version, with the tolerances of
  ``tests/test_torch_attention_bwd.py``.
"""

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu_torch.convert import flax_path, load_flax_params
from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer
from glearning_benchmark_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

VOCAB, L = 30, 16
BF16_RTOL, F32_RTOL, ATOL = 4e-3, 1e-4, 1e-5


def _kwargs(d_model, nhead):
    return dict(vocab_size=VOCAB, d_model=d_model, nhead=nhead, nlayers=1,
                d_ff=32, p_drop=0.0, max_pos=L, task="cycle_check",
                use_query_nodes=False, num_classes=2, compute_dtype="float32")


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, L + 1, size=3)
    lens[0] = L
    ids = rng.integers(3, VOCAB, size=(3, L)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.arange(L)[None, :] < lens[:, None]
    ids[~mask] = 2
    labels = rng.integers(0, 2, size=3).astype(np.int32)
    return ids, mask, labels


@pytest.mark.parametrize("d_model,nhead", [(48, 4), (48, 2), (256, 2), (160, 1), (512, 2)],
                         ids=["head_dim_12", "head_dim_24", "head_dim_128", "head_dim_160",
                              "head_dim_256"])
def test_transformer_matches_flax_at_head_dim(d_model, nhead):
    # flax is imported here: the card's machine runs this file's cuda tests
    # without it
    import jax
    import jax.numpy as jnp

    from glearning_benchmark_tpu.models.transformer import (
        SimpleTransformer as FlaxTransformer,
    )

    kw = _kwargs(d_model, nhead)
    fmodel = FlaxTransformer(**kw)
    ids, mask, labels = _batch(d_model + nhead)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: fmodel.init(key, ids, mask))(jax.random.PRNGKey(nhead))["params"])

    def flax_loss(p):
        logits = fmodel.apply({"params": p}, ids, mask, deterministic=True)
        loss = -jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1).mean()
        return loss, logits

    (_, ref_logits), ref_grads = jax.jit(jax.value_and_grad(flax_loss, has_aux=True))(params)
    ref_logits = np.asarray(ref_logits)

    model = SimpleTransformer(**kw)
    load_flax_params(model, params)
    model.eval()
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=1e-5, rtol=0)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    for name, p in model.named_parameters():
        path, transposed = flax_path(name)
        ref = np.asarray(_leaf(ref_grads, path))
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _inputs(d, seed, b=2, l=40, h=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32))
                   for _ in range(4))
    seg = np.zeros((b, l), np.int32)
    seg[0, :15], seg[0, 15:33] = 1, 2      # two segments and a pad tail
    seg[1, :] = 1
    return q, k, v, do, torch.from_numpy(seg)


@pytest.mark.parametrize("d", [12, 100, 160, 320])
def test_padding_wrapper_equals_unpadded_plain_version(d):
    q, k, v, do, seg = _inputs(d, seed=d)
    kw = dict(p_drop=0.1, seed=7, bh_offset=2)
    o, lse = fa.flash_attention_reference(q, k, v, seg, **kw)
    po, plse = fa.pad_head_dim(fa.flash_attention_reference, q, k, v, seg, **kw)
    assert po.shape == o.shape
    for got, ref in ((po, o), (plse, lse)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    ref_grads = fa.flash_attention_bwd_reference(q, k, v, seg, o, lse, do, **kw)
    got_grads = fa.pad_head_dim(fa.flash_attention_bwd_reference, q, k, v, seg, o, lse,
                                do, **kw)
    for got, ref in zip(got_grads, ref_grads):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,inst", [(1, 4), (5, 8), (12, 16), (17, 32), (48, 64),
                                    (100, 128), (128, 128)])
def test_padded_head_dim_is_the_next_instance(d, inst):
    assert fa.padded_head_dim(d) == inst


KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


@pytest.mark.parametrize("d", [129, 130, 136, 144, 160, 192, 200, 255, 256, 257, 300, 320,
                               321, 383, 384, 385, 448, 511, 512, 513, 640])
def test_head_dims_above_128_route_by_input_type(d):
    """f32, in every kernel: unpadded, in the wide route. bf16, in every
    kernel: the wgmma instance at 256 up to 256; above 256 the
    wgmma_chunks instances (320-512, every 64) up to 512, the wide route
    above. Without a kernel's name: the wide route's head dim."""
    assert fa.padded_head_dim(d) == d
    for name in KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.bfloat16:
                if d <= fa.WGMMA_WIDE:
                    padded, design = fa.WGMMA_WIDE, "wgmma"
                elif d <= fa.CHUNKS_WIDE:
                    padded, design = -(-d // 64) * 64, "wgmma_chunks"
                else:
                    padded, design = d, "wide"
                assert fa.padded_head_dim(d, name, dtype) == padded
                assert fa.design(name, d, dtype) == design
            else:
                assert fa.padded_head_dim(d, name, dtype) == d
                assert fa.design(name, d, dtype) == "wide"


@pytest.mark.parametrize("d,dtype,designs", [
    (16, torch.bfloat16, ("mma", "mma", "mma")),
    (64, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (100, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (64, torch.float32, ("f32", "f32", "f32")),
    (128, torch.float32, ("wide", "wide", "wide"))])
def test_design_by_head_dim_and_type(d, dtype, designs):
    assert tuple(fa.design(name, d, dtype) for name in KERNELS) == designs


@pytest.mark.parametrize("d", [129, 160, 200, 255])
def test_forward_padding_to_the_wgmma_instance_equals_unpadded_plain_version(d):
    """The bf16 forward pads 129-256 to its instance at 256: with the plain
    version in place of the kernel (which sees head dim 256), LSE equals the
    unpadded f32 plain version's within 1e-5 (the padded einsums sum zeros
    in another order) and the bf16 O is within one bf16 rounding of it."""
    q, k, v, _, seg = (t.bfloat16() if t.is_floating_point() else t
                       for t in _inputs(d, seed=d))
    kw = dict(p_drop=0.1, seed=7, bh_offset=2)
    o, lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, **kw)
    seen = []

    def plain(*args, **kwargs):
        seen.append(args[0].shape[-1])
        return fa.flash_attention_reference(*args, **kwargs)

    po, plse = fa.pad_head_dim(plain, q, k, v, seg, name="flash_attn_fwd", **kw)
    assert seen == [fa.WGMMA_WIDE] and po.shape == o.shape and po.dtype == torch.bfloat16
    assert ((po.float() - o).abs() <= BF16_RTOL * o.abs() + ATOL).all()
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [12, 24, 48, 100, 200])
def test_kernels_at_padded_head_dims_match_plain(d, dtype):
    """The forward, dQ and dK/dV kernels at a head dim between instances,
    on q, k, v views of one fused qkv output, with dropout: within one bf16
    rounding (bf16) or 1e-4 relative (f32) of the plain version at the true
    head dim; pad rows zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    rtol = BF16_RTOL if dt == torch.bfloat16 else F32_RTOL
    b, l, h = 3, 130, 2
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * h * d)).astype(np.float32))
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.to("cuda", dt).split(h * d, dim=-1))
    do = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32)).to("cuda", dt)
    seg = _inputs(d, seed=0, b=b, l=l)[4]
    seg[2, 70:] = 0
    seg = seg.cuda()
    kw = dict(p_drop=0.1, seed=11)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, **kw)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, **kw)
    assert ((o.float() - ro).abs() <= rtol * ro.abs() + ATOL).all()
    assert (lse - rl).abs().max().item() <= 1e-4
    grads = fa.flash_attention_bwd(q, k, v, seg, o, lse, do, **kw)
    refs = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg, o, lse,
                                            do.float(), **kw)
    pad = seg == 0
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape
        assert ((got.float() - ref).abs() <= rtol * ref.abs() + ATOL).all()
        assert (got[pad] == 0).all()
    assert (o[pad] == 0).all()
