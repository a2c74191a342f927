"""The encoder layer's residual site (``ops/residual_norm.py``): the
residual dropout, the f32 add, LayerNorm and the copy for the next GEMM.

On the CPU:
- :func:`residual_norm` takes its plain path on CPU tensors and equals the
  composition the encoder layer ran before (``cheap_dropout`` on the
  branch, the f32 add, the norm, then the next GEMM's cast) bit for bit,
  forward and every gradient, dropout on and off, at a batch offset and a
  sequence-parallel token block; it counts plain calls and no fused ones;
- the kernels' arithmetic written in torch (:func:`forward_reference`,
  :func:`backward_reference` here) matches the composition and autograd
  through it at d 16, 64 and 1024;
- the kernel's keep bits, from the ``Site`` the wrapper hands it (element e
  of a row is byte e / sq of word e % sq, from the row's first word), are
  ``hash_keep_mask``'s, done here in numpy;
- a training forward of the token transformer sends both residual sites of
  every layer through the op;
- the kernels' input check refuses what they cannot take.
On the card (``cuda`` marker, skipped here): the kernels against the
composition, forward and backward, the bf16 copy bit-equal to the cast of
the kernel's own output, and the dropout's zeros where ``cheap_dropout``
has them; strided inputs through the kernels; a site they cannot take
raises rather than running the composition.
"""

import numpy as np
import pytest
import torch
from torch import nn

from glearning_benchmark_tpu_torch.models.transformer import LN_EPS, SimpleTransformer
from glearning_benchmark_tpu_torch.ops import attention as attn
from glearning_benchmark_tpu_torch.ops import hash_dropout as hd
from glearning_benchmark_tpu_torch.ops import residual_norm as rn

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

U32 = np.uint64(0xFFFFFFFF)
RATE = 26 / 256          # the training path's residual rate (0.1, quantised)
# placements of the branch: one process, a DP rank's rows, an SP token block
PLACES = [{}, {"batch_offset": 5}, {"batch_offset": 2, "place": {1: (6, 18)}}]


def _site_inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = torch.randn(shape, generator=g)
    y = torch.randn(shape, generator=g).to(dtype)
    norm = nn.LayerNorm(d, eps=LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.5 * torch.randn(d, generator=g))
        norm.bias.copy_(0.5 * torch.randn(d, generator=g))
    return x, y, norm, torch.randn(shape, generator=g), torch.randn(shape, generator=g)


def _composition(x, y, norm, seed, rate, copy_dtype, place):
    """The encoder layer's residual site as it ran before the op: the
    dropout after the branch's GEMM, the add and the norm, and the next
    GEMM's cast of the result."""
    if seed is not None:
        y = attn.cheap_dropout(seed, y, rate, **place)
    out = norm((x + y.float()).float())
    return out, None if copy_dtype == torch.float32 else out.to(copy_dtype)


def _grads(fn, x, y, norm, g_out, g_copy):
    """Outputs of fn and the gradients of x, y, the weight and the bias
    under the loss sum(out * g_out) + sum(copy * g_copy)."""
    x, y = x.clone().requires_grad_(), y.clone().requires_grad_()
    norm.zero_grad()
    out, copy = fn(x, y, norm)
    loss = (out * g_out).sum()
    if copy is not None:
        loss = loss + (copy.float() * g_copy).sum()
    loss.backward()
    return out, copy, x.grad, y.grad, norm.weight.grad.clone(), norm.bias.grad.clone()


@pytest.mark.parametrize("place", PLACES, ids=str)
@pytest.mark.parametrize("seed", [None, 7, 2**31 - 2], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plain_path_equals_the_composition(dtype, seed, place):
    x, y, norm, g_out, g_copy = _site_inputs((4, 6, 16), dtype)
    rn.reset_calls()
    got = _grads(lambda x, y, n: rn.residual_norm(x, y, n, seed, RATE, copy_dtype=dtype,
                                                  **place), x, y, norm, g_out, g_copy)
    assert rn.CALLS == {"fused": 0, "fused_backward": 0, "plain": 1}
    want = _grads(lambda x, y, n: _composition(x, y, n, seed, RATE, dtype, place),
                  x, y, norm, g_out, g_copy)
    if dtype == torch.float32:
        assert got[1] is None            # the f32 stream serves the next GEMM itself
        got, want = got[:1] + got[2:], want[:1] + want[2:]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def forward_reference(x, y, weight, bias, eps, drop):
    """(out, mean, rstd) as the forward kernel forms them: ``drop`` is the
    site's dropout on a tensor of y's type (``cheap_dropout_reference`` with
    the site's arguments, or the identity); the mean, then the biased
    variance about it."""
    v = x + drop(y).float()
    mean = v.mean(-1)
    rstd = torch.rsqrt(((v - mean[..., None]) ** 2).mean(-1) + eps)
    return (v - mean[..., None]) * rstd[..., None] * weight + bias, mean, rstd


def backward_reference(x, y, weight, mean, rstd, g_out, g_copy, drop):
    """(dx, dy, dweight, dbias) as the backward kernels form them from the
    forward's saved x, y, mean and rstd and the gradients of out and of its
    copy (either may be None): the sum recomputed, g = g_out + g_copy
    widened, dv = rstd (g w - mean(g w) - xhat mean(g w xhat)); dx = dv, dy
    the dropout of dv rounded to y's type."""
    v = x + drop(y).float()
    xhat = (v - mean[..., None]) * rstd[..., None]
    g = torch.zeros_like(x)
    if g_out is not None:
        g = g + g_out
    if g_copy is not None:
        g = g + g_copy.float()
    gw = g * weight
    dv = rstd[..., None] * (gw - gw.mean(-1, keepdim=True)
                            - xhat * (gw * xhat).mean(-1, keepdim=True))
    rows = tuple(range(x.dim() - 1))
    return dv, drop(dv.to(y.dtype)), (g * xhat).sum(rows), g.sum(rows)


def _drop(seed, rate, place):
    if seed is None:
        return lambda t: t
    return lambda t: attn.cheap_dropout_reference(seed, t, rate, **place)


@pytest.mark.parametrize("d", [16, 64, 1024])
@pytest.mark.parametrize("seed", [None, 11], ids=str)
def test_kernel_formulas_match_autograd(d, seed):
    """The forward's statistics and output, and the backward's dx, dy and
    the weight and bias gradients as the kernels form them, against the
    composition and autograd through it (f32 sums in another order)."""
    place = {"batch_offset": 3}
    x, y, norm, g_out, g_copy = _site_inputs((3, 5, d), torch.bfloat16, seed=d)
    out, copy, dx, dy, dw, db = _grads(
        lambda x, y, n: _composition(x, y, n, seed, RATE, torch.bfloat16, place),
        x, y, norm, g_out, g_copy)
    drop = _drop(seed, RATE, place)
    w, b = norm.weight.detach(), norm.bias.detach()
    ref_out, mean, rstd = forward_reference(x, y, w, b, LN_EPS, drop)
    torch.testing.assert_close(ref_out, out, rtol=1e-5, atol=1e-5)
    rdx, rdy, rdw, rdb = backward_reference(x, y, w, mean, rstd, g_out,
                                            g_copy.to(torch.bfloat16), drop)
    # the copy's gradient reaches the sum as bf16: autograd's cast back
    for a, e in ((rdx, dx), (rdw, dw), (rdb, db)):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)
    assert rdy.dtype == dy.dtype == torch.bfloat16
    assert torch.equal(rdy == 0, dy == 0)
    torch.testing.assert_close(rdy.float(), dy.float(), rtol=1e-2, atol=1e-3)


def test_backward_formula_takes_either_gradient_alone():
    x, y, norm, g_out, _ = _site_inputs((2, 3, 64), torch.float32)
    w = norm.weight.detach()
    _, mean, rstd = forward_reference(x, y, w, norm.bias.detach(), LN_EPS, lambda t: t)
    one = backward_reference(x, y, w, mean, rstd, g_out, None, lambda t: t)
    other = backward_reference(x, y, w, mean, rstd, None, g_out.bfloat16(), lambda t: t)
    both = backward_reference(x, y, w, mean, rstd, g_out, torch.zeros_like(g_out).bfloat16(),
                              lambda t: t)
    for a, b in zip(one, both):
        assert torch.equal(a, b)
    torch.testing.assert_close(other[0], one[0], rtol=1e-2, atol=1e-2)


def _hash(seed: int, idx: np.ndarray) -> np.ndarray:
    x = idx.astype(np.uint32) * np.uint32(0x9E3779B1) + np.uint32(seed)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _kernel_keep(site: hd.Site) -> np.ndarray:
    """The keep bits csrc/residual_norm.cu computes from ``site``, in
    numpy: a row's first word (``row_base``), then element e of the row
    from byte e / sq of word e % sq."""
    d = site.shape[-1]
    sq = d // 4
    rows = int(np.prod(site.shape[:-1]))
    row = np.arange(rows, dtype=np.uint64)
    if not site.axes:
        base = np.uint64(site.base) + row * np.uint64(sq)
    else:
        base, r = np.full(rows, site.base, np.uint64), row.copy()
        for size, gstride in reversed(site.axes):
            base += (r % np.uint64(size)) * np.uint64(gstride)
            r //= np.uint64(size)
    e = np.arange(d, dtype=np.uint64)
    w, q = e % np.uint64(sq), e // np.uint64(sq)
    h = _hash(site.seed, (base[:, None] + w[None, :]) & U32)
    byte = (h >> (np.uint32(8) * q.astype(np.uint32))[None, :]) & np.uint32(0xFF)
    return (byte >= site.thresh).reshape(site.shape)


@pytest.mark.parametrize("place", PLACES + [{"batch_offset": 2**26 - 1,
                                             "batch_total": 2**26 + 1}], ids=str)
@pytest.mark.parametrize("d", [8, 16, 24, 64, 1024])
def test_kernel_index_math_gives_cheap_dropouts_bits(d, place):
    shape = (2, 6, d)
    for seed, rate in ((0, 0.1), (2**32 - 1, 0.5), (12345, RATE)):
        thresh = attn._quantised_threshold(rate)
        site = hd.blocked_site(shape, seed, thresh, 1 - thresh / 256, **place)
        want, _ = attn.hash_keep_mask(seed, shape, rate, **place)
        np.testing.assert_array_equal(_kernel_keep(site), want.numpy())


def test_a_training_forward_sends_every_residual_site_through_the_op():
    layers = 2
    model = SimpleTransformer(40, d_model=16, nhead=2, nlayers=layers, d_ff=32,
                              compute_dtype="bfloat16", use_query_nodes=False,
                              task="zinc", num_classes=1,
                              generator=torch.Generator().manual_seed(0)).train()
    ids = torch.randint(3, 40, (2, 8), generator=torch.Generator().manual_seed(1))
    rn.reset_calls()
    out = model(ids, torch.ones(2, 8, dtype=torch.bool),
                generator=torch.Generator().manual_seed(2))
    out.sum().backward()
    assert rn.CALLS == {"fused": 0, "fused_backward": 0, "plain": 2 * layers}


# sites the kernels cannot take: (shape, branch dtype, copy dtype, norm dtype)
REFUSED = {"width_12": ((2, 3, 12), torch.bfloat16, torch.bfloat16, torch.float32),
           "width_4104": ((1, 1, 4104), torch.bfloat16, torch.bfloat16, torch.float32),
           "fp16_branch": ((2, 3, 64), torch.float16, torch.float16, torch.float32),
           "bf16_norm": ((2, 3, 64), torch.bfloat16, torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("case", REFUSED)
def test_kernel_input_check_refuses_what_the_kernels_cannot_take(case):
    shape, dtype, copy_dtype, norm_dtype = REFUSED[case]
    x, y, norm, _, _ = _site_inputs(shape, dtype)
    with pytest.raises(ValueError, match="residual_norm"):
        rn.check_kernel_inputs(x, y, norm.to(norm_dtype), copy_dtype)
    rn.check_kernel_inputs(*_site_inputs((2, 3, 64), torch.bfloat16)[:3], torch.bfloat16)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the residual-norm kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("place", PLACES, ids=str)
@pytest.mark.parametrize("d", [16, 64, 72, 1024, 2560])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_cuda_kernels_match_the_composition(dtype, d, place):
    _card()
    x, y, norm, g_out, g_copy = (t.cuda() for t in _site_inputs((64, 6, d), dtype))
    for seed in (None, 9):
        rn.reset_calls()
        got = _grads(lambda x, y, n: rn.residual_norm(x, y, n, seed, RATE, copy_dtype=dtype,
                                                      **place), x, y, norm, g_out, g_copy)
        assert rn.CALLS == {"fused": 1, "fused_backward": 1, "plain": 0}
        want = _grads(lambda x, y, n: _composition(x, y, n, seed, RATE, dtype, place),
                      x, y, norm, g_out, g_copy)
        torch.cuda.synchronize()
        out, copy, dx, dy, dw, db = got
        torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)
        if dtype == torch.bfloat16:
            assert torch.equal(copy, out.to(torch.bfloat16))
        for a, e in ((dx, want[2]), (dw, want[4]), (db, want[5])):
            torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)
        # dy is 0 where the dropout drops, else only where dx is 0 in y's type
        keep = (attn.cheap_dropout(seed, torch.ones_like(y), RATE, **place) != 0
                if seed is not None else torch.ones_like(y, dtype=torch.bool))
        for gx, gy in ((dx, dy), (want[2], want[3])):
            assert torch.equal(gy == 0, ~keep | (gx.to(gy.dtype) == 0))
        # rounded to bf16 twice (the cast, the scale): two steps apart at most
        torch.testing.assert_close(dy.float(), want[3].float(), rtol=1 / 64, atol=1e-3)


@pytest.mark.cuda
def test_cuda_kernels_take_strided_inputs():
    """A stream that is a column view of a wider tensor (not contiguous)
    and a branch that starts one element into its storage (not 16-byte
    aligned) run the kernels on copies, with the same bits."""
    _card()
    shape = (8, 6, 72)
    x, y, norm, g_out, g_copy = (t.cuda() for t in _site_inputs(shape, torch.bfloat16))
    wide_x = torch.zeros(8, 6, 73, device="cuda")
    wide_x[..., 1:] = x
    flat_y = torch.zeros(y.numel() + 1, device="cuda", dtype=torch.bfloat16)
    flat_y[1:] = y.flatten()
    rn.reset_calls()
    got = _grads(lambda x, y, n: rn.residual_norm(x[..., 1:], y[1:].view(shape), n, 9, RATE,
                                                  copy_dtype=torch.bfloat16),
                 wide_x, flat_y, norm, g_out, g_copy)
    assert rn.CALLS == {"fused": 1, "fused_backward": 1, "plain": 0}
    want = _grads(lambda x, y, n: rn.residual_norm(x, y, n, 9, RATE, copy_dtype=torch.bfloat16),
                  x, y, norm, g_out, g_copy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][..., 1:], want[2]) and not got[2][..., 0].any()
    assert torch.equal(got[3][1:].view(shape), want[3]) and got[3][0] == 0
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("case", REFUSED)
def test_cuda_site_the_kernels_cannot_take_raises(case):
    _card()
    shape, dtype, copy_dtype, norm_dtype = REFUSED[case]
    x, y, norm, _, _ = (t.cuda() for t in _site_inputs(shape, dtype))
    rn.reset_calls()
    with pytest.raises(ValueError, match="residual_norm"):
        rn.residual_norm(x, y, norm.to(norm_dtype), 9, RATE, copy_dtype=copy_dtype)
    assert rn.CALLS == {"fused": 0, "fused_backward": 0, "plain": 0}
