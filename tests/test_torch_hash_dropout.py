"""The hash-dropout kernel's wrapper (``ops/hash_dropout.py``) against the
plain int64 path and the JAX package.

On the CPU:
- the kernel's index arithmetic, done here in numpy from the ``Site`` the
  wrapper hands the kernel (the merged axes, the base, 32-bit wrap), gives
  the keep bits of ``hash_keep_mask`` / ``hash_dropout_reference`` at every
  placement the sites use (DP's batch offset, MoE's batch on axis 1 and its
  expert block, SP's token block), on last axes that are not multiples of
  4 and where the global index crosses 2**32;
- ``cheap_dropout``, ``hash_dropout`` and the attention-probability dropout,
  which run ``HashDropoutFunction``'s CPU path, equal the plain functions
  bit for bit, outputs and gradients, and save no tensor of x's size;
- the same functions at those placements equal the block of the JAX
  package's global mask, at f32.
On the card (``cuda`` marker, skipped here): the kernel against the plain
path, forward and backward, bit for bit.
"""

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu_torch.ops import attention as attn
from glearning_benchmark_tpu_torch.ops import hash_dropout as hd
from glearning_benchmark_tpu_torch.ops.flash_attention import _keep_threshold

U32 = np.uint64(0xFFFFFFFF)
# (shape, placement of cheap_dropout): one process, DP, MoE [E, B, C, f]
# (batch on axis 1), EP's expert block, SP's token block, a last axis of 1,
# two placed axes, and a global index that crosses 2**32 inside the block
BLOCKED = [
    ((4, 6, 10), {}),
    ((4, 6, 10), {"batch_offset": 3}),
    ((3, 5, 7, 13), {"batch_axis": 1, "batch_offset": 2, "batch_total": 9}),
    ((3, 5, 7, 13), {"batch_axis": 1, "batch_offset": 2, "batch_total": 9,
                     "place": {0: (1, 6)}}),
    ((2, 6, 30), {"batch_offset": 4, "place": {1: (12, 24)}}),
    ((2, 3, 4, 1), {"batch_offset": 5}),
    ((2, 2, 5, 9), {"place": {1: (1, 4), 2: (5, 20)}}),
    ((2, 4, 64), {"batch_offset": 2**26 - 1, "batch_total": 2**26 + 1}),
]
# (shape, batch_offset) of hash_dropout; the last crosses 2**32
ELEMENT = [((5, 7), 0), ((3, 4, 9), 11), ((2, 64), 2**26 - 1)]
RATES = [0.1, 26 / 256, 0.5]


def _ids(cases):
    return [f"{shape}-{place}" for shape, place in cases]


def _hash(seed: int, idx: np.ndarray) -> np.ndarray:
    x = idx.astype(np.uint32) * np.uint32(0x9E3779B1) + np.uint32(seed)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _kernel_keep(site: hd.Site) -> np.ndarray:
    """The keep bits csrc/hash_dropout.cu computes from ``site``, in numpy."""
    rows, per_row = hd.words(site)
    s = site.shape[-1]
    word = np.arange(rows * per_row, dtype=np.uint64)
    row, w = word // np.uint64(per_row), word % np.uint64(per_row)
    if not site.blocked:
        return (_hash(site.seed, (np.uint64(site.base) + word) & U32)
                >= site.thresh).reshape(site.shape)
    if not site.axes:
        idx = np.uint64(site.base) + word
    else:
        idx, r = np.uint64(site.base) + w, row.copy()
        for size, gstride in reversed(site.axes):
            idx += (r % np.uint64(size)) * np.uint64(gstride)
            r //= np.uint64(size)
    h = _hash(site.seed, idx & U32)
    keep = np.zeros((rows, s), bool)
    for j in range(4):
        e = w + np.uint64(j * per_row)
        ok = e < s
        keep[row[ok], e[ok]] = ((h[ok] >> np.uint32(8 * j)) & np.uint32(0xFF)) >= site.thresh
    return keep.reshape(site.shape)


@pytest.mark.parametrize("shape,place", BLOCKED, ids=_ids(BLOCKED))
def test_kernel_index_math_gives_the_plain_blocked_bits(shape, place):
    for seed, rate in ((0, 0.1), (2**32 - 1, 0.5), (12345, 26 / 256)):
        thresh = attn._quantised_threshold(rate)
        site = hd.blocked_site(shape, seed, thresh, 1 - thresh / 256, **place)
        assert len(site.axes) <= hd.MAX_AXES
        want, _ = attn.hash_keep_mask(seed, shape, rate, **place)
        np.testing.assert_array_equal(_kernel_keep(site), want.numpy())


def test_sites_merge_axes_that_nest():
    one_run = hd.blocked_site((4, 6, 10), 1, 26, 0.9, batch_offset=3)
    assert one_run.axes == () and one_run.base == 3 * 6 * 3
    moe = hd.blocked_site((3, 5, 7, 13), 1, 26, 0.9, batch_axis=1, batch_offset=2,
                          batch_total=9)
    assert moe.axes == ((3, 9 * 7 * 4), (35, 4))      # B and C merge; E strides 9 rows
    with pytest.raises(ValueError, match="batch_total"):
        hd.blocked_site((5, 3, 7, 10), 1, 26, 0.9, batch_axis=1, batch_offset=3)


@pytest.mark.parametrize("shape,offset", ELEMENT, ids=_ids(ELEMENT))
def test_kernel_index_math_gives_the_plain_element_bits(shape, offset):
    x = torch.ones(shape)
    for seed, rate in ((0, 0.1), (2**32 - 1, 0.5), (77, 0.3)):
        site = hd.element_site(shape, seed, _keep_threshold(rate), 1 - rate, offset)
        want = attn.hash_dropout_reference(seed, x, rate, offset) != 0
        np.testing.assert_array_equal(_kernel_keep(site), want.numpy())


def _saved_numels(fn, x):
    """Output of fn(x) and the sizes of the tensors autograd saved for it."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(x)
    return out, sizes


def _same_bits(fn, ref, shape, dtype, seed):
    """fn and ref give equal outputs and gradients; fn keeps no tensor of
    x's size for its backward."""
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    x, xr = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    out, saved = _saved_numels(fn, x)
    want = ref(xr)
    assert out.dtype == dtype and torch.equal(out, want)
    assert all(n < x.numel() for n in saved), saved
    out.backward(g)
    want.backward(g)
    assert torch.equal(x.grad, xr.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,place", BLOCKED, ids=_ids(BLOCKED))
def test_cheap_dropout_equals_plain_outputs_and_grads(shape, place, dtype):
    for seed, rate in zip((5, 2**32 - 1, 9), RATES):
        _same_bits(lambda t: attn.cheap_dropout(seed, t, rate, **place),
                   lambda t: attn.cheap_dropout_reference(seed, t, rate, **place),
                   shape, dtype, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,offset", ELEMENT, ids=_ids(ELEMENT))
def test_hash_dropout_equals_plain_outputs_and_grads(shape, offset, dtype):
    for seed, rate in zip((5, 2**32 - 1, 9), RATES):
        _same_bits(lambda t: attn.hash_dropout(seed, t, rate, offset),
                   lambda t: attn.hash_dropout_reference(seed, t, rate, offset),
                   shape, dtype, seed)


def test_attention_probability_dropout_equals_plain():
    """``multi_head_attention``'s probability dropout (GPS) through the
    autograd function: the plain formula of the probabilities, kept bits
    rescaled, at a batch offset; outputs and gradients equal."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 6, 2, 4)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    mask = torch.from_numpy(rng.random((2, 6)) < 0.8)
    mask[:, 0] = True
    out = attn.multi_head_attention(q, k, v, key_mask=mask, dropout_rate=0.1,
                                    dropout_seed=7, batch_offset=3)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    logits = torch.einsum("blhd,bshd->bhls", qr, kr) * (1.0 / torch.sqrt(torch.tensor(4.0)))
    logits = torch.where(mask[:, None, None, :], logits, torch.finfo(logits.dtype).min)
    probs = torch.where(mask[:, None, None, :], torch.softmax(logits, dim=-1), 0.0)
    keep, p_eff = attn.hash_keep_mask(7, probs.shape, 0.1, batch_offset=3)
    probs = torch.where(keep, probs / (1.0 - p_eff), 0.0)
    want = torch.einsum("bhls,bshd->blhd", probs, vr)
    assert torch.equal(out, want)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    want.backward(g)
    for a, b in ((q, qr), (k, kr), (v, vr)):
        assert torch.equal(a.grad, b.grad)


def test_rate_edges():
    x = torch.ones(4, 8)
    for rate in (0.0, 0.001):                 # 0.001 rounds to 0/256
        assert attn.cheap_dropout(3, x, rate) is x
    assert attn.hash_dropout(3, x, 0.0) is x
    with pytest.raises(ValueError, match="256"):
        attn.cheap_dropout(3, x, 255.9 / 256)
    with pytest.raises(ValueError, match="CUDA"):
        hd.launch(x, hd.blocked_site(x.shape, 3, 26, 0.9))


@pytest.mark.parametrize("shape,place", BLOCKED[:5] + BLOCKED[-1:],
                         ids=_ids(BLOCKED[:5] + BLOCKED[-1:]))
def test_cheap_dropout_block_equals_jax_global_mask(shape, place):
    """A placed block's dropout is that block of the JAX package's
    ``cheap_dropout`` formula over the global tensor (f32, same seed word)."""
    import jax.numpy as jnp

    from glearning_benchmark_tpu.ops import attention as jax_attn

    big = {0: 2**26 + 1}       # the 2**32 case: a global tensor too large to draw
    at = hd.placement(shape, place.get("batch_axis", 0), place.get("batch_offset", 0),
                      place.get("batch_total"), place.get("place"))
    if any(total in big.values() for _, total in at.values()):
        # hash the crossing rows only: their words are one run from the base
        site = hd.blocked_site(shape, 11, 26, 1 - 26 / 256, **place)
        idx = (site.base + np.arange(int(np.prod(shape[:-1])) * ((shape[-1] + 3) // 4),
                                     dtype=np.uint64)) & U32
        words = np.asarray(jax_attn._hash1_u32(jnp.uint32(11), jnp.asarray(
            idx.astype(np.uint32)))).reshape(shape[:-1] + ((shape[-1] + 3) // 4,))
        keep = np.concatenate([((words >> s) & 0xFF) >= 26 for s in (0, 8, 16, 24)],
                              axis=-1)[..., :shape[-1]]
    else:
        gshape = tuple(at.get(ax, (0, size))[1] for ax, size in enumerate(shape))
        gkeep, _ = jax_attn.hash_keep_mask(jnp.uint32(11), gshape, 0.1)
        block = tuple(slice(at.get(ax, (0, 0))[0], at.get(ax, (0, 0))[0] + size)
                      for ax, size in enumerate(shape))
        keep = np.asarray(gkeep)[block]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.where(keep, np.asarray(jnp.asarray(x) / (1.0 - 26 / 256)), 0.0)
    got = attn.cheap_dropout(11, torch.from_numpy(x), 0.1, **place)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,offset", ELEMENT, ids=_ids(ELEMENT))
def test_hash_dropout_rows_equal_jax_hash(shape, offset):
    """``hash_dropout`` keeps element i where the JAX package's
    ``_hash1_u32`` of its global index clears the 32-bit threshold."""
    import jax.numpy as jnp

    from glearning_benchmark_tpu.ops import attention as jax_attn

    n = int(np.prod(shape))
    idx = ((np.uint64(offset) * np.uint64(n // shape[0]) + np.arange(n, dtype=np.uint64))
           & U32).astype(np.uint32)
    h = np.asarray(jax_attn._hash1_u32(jnp.uint32(5), jnp.asarray(idx))).reshape(shape)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.where(h >= _keep_threshold(0.3), np.asarray(jnp.asarray(x) / (1.0 - 0.3)), 0.0)
    got = attn.hash_dropout(5, torch.from_numpy(x), 0.3, offset)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hash-dropout kernel has no CPU mode")


def _card_same_bits(fn, ref, shape, dtype):
    x = torch.randn(shape, device="cuda").to(dtype).requires_grad_()
    xr = x.detach().clone().requires_grad_()
    g = torch.randn(shape, device="cuda").to(dtype)
    hd.reset_launches()
    out = fn(x)
    out.backward(g)
    assert hd.LAUNCHES["hash_dropout"] == 2          # forward and backward
    want = ref(xr)
    want.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(x.grad, xr.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,place", BLOCKED, ids=_ids(BLOCKED))
def test_cuda_cheap_dropout_kernel_equals_plain(shape, place, dtype):
    _card()
    for seed, rate in zip((5, 2**32 - 1, 9), RATES):
        _card_same_bits(lambda t: attn.cheap_dropout(seed, t, rate, **place),
                        lambda t: attn.cheap_dropout_reference(seed, t, rate, **place),
                        shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,offset", ELEMENT, ids=_ids(ELEMENT))
def test_cuda_hash_dropout_kernel_equals_plain(shape, offset, dtype):
    _card()
    for seed, rate in zip((5, 2**32 - 1, 9), RATES):
        _card_same_bits(lambda t: attn.hash_dropout(seed, t, rate, offset),
                        lambda t: attn.hash_dropout_reference(seed, t, rate, offset),
                        shape, dtype)


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_strided_view():
    _card()
    x = torch.randn(8, 16, device="cuda")[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        attn.cheap_dropout(1, x, 0.1)
