"""Port parity: attention against the JAX package, on the CPU.

- The flash-attention kernel's plain version
  (``flash_attention_reference``) against the Pallas kernel in interpret
  mode: O from ``_flash_fwd`` and LSE from its residuals, with ragged key
  masks, packed segments with a pad tail, L not a block multiple, head dims
  4 and 16, and dropout off and on. Tolerance 1e-5 at f32.
- The torch copy of the counter hash against ``dropout_keep_reference``:
  exactly equal.
- The wrapper's CPU route and ``multi_head_attention`` against JAX's.
- A split of P~ into bf16 hi + lo before P~ V, emulated in plain torch
  (no JAX call), against the tolerance the card holds the kernel to: even
  two terms hold it on these rows (the kernel takes three, hi + mid + lo,
  which is exact for the f32 P~; the cancelling sums of
  ``tests/test_torch_fwd_wgmma.py`` are where two miss).

The CUDA kernel itself runs only on a GPU: the ``cuda``-marked tests skip
here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.ops import pallas_attention as pa
from glearning_benchmark_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from glearning_benchmark_tpu_torch.ops import flash_attention as fa
from glearning_benchmark_tpu_torch.ops.attention import multi_head_attention

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _ragged_seg(b, l, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l + 1, size=b)
    lens[0] = l
    return (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)


def _packed_seg(b, l):
    seg = np.zeros((b, l), np.int32)
    cuts = np.linspace(0, l - l // 5, 4).astype(int)   # 3 segments + pad tail
    for i in range(b):
        for s in range(3):
            seg[i, cuts[s] + i:cuts[s + 1]] = s + 1
    return seg


def _pallas(q, k, v, seg, p_drop, seed):
    """(O [B, L, H, D], LSE [B, H, L]) from the Pallas kernel, interpret mode."""
    b, l, h, _ = q.shape
    seed_arr = jnp.asarray(seed, jnp.int32).reshape(1, 1)
    out, res = pa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(seg), seed_arr, 128, 128, p_drop,
                             True)
    lse = np.asarray(res[6])[: b * h, :l].reshape(b, h, l)
    return np.asarray(out), lse


CASES = [
    # (shape, seg kind, p_drop)
    ((2, 200, 4, 16), "ragged", 0.0),
    ((3, 130, 4, 4), "ragged", 0.0),
    ((2, 256, 2, 16), "packed", 0.0),
    ((2, 100, 4, 4), "packed", 0.0),
    ((2, 130, 2, 16), "ragged", 0.1),
    ((2, 200, 4, 4), "packed", 0.1),
]


@pytest.mark.parametrize("shape,kind,p_drop", CASES,
                         ids=[f"{s[1]}-L{s[0][1]}-D{s[0][3]}-p{s[2]}"
                              for s in CASES])
def test_plain_version_matches_pallas_interpret(shape, kind, p_drop):
    b, l, h, d = shape
    q, k, v = _qkv(shape, seed=l + d)
    seg = _ragged_seg(b, l, seed=d) if kind == "ragged" else _packed_seg(b, l)
    seed = 1234 if p_drop else 0
    ref_o, ref_lse = _pallas(q, k, v, seg, p_drop, seed)
    o, lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg), p_drop, seed)
    np.testing.assert_allclose(o.numpy(), ref_o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-5, rtol=1e-6)
    pad = seg == 0
    assert (o.numpy()[pad] == 0).all()
    assert (lse.numpy().transpose(0, 2, 1)[pad] == np.float32(fa.NEG_INF)).all()


@pytest.mark.parametrize("seed", [0, 1234, -7, 2**31 - 1, -2**31])
@pytest.mark.parametrize("p_drop", [0.1, 0.5])
def test_hash_keep_mask_is_bit_equal(seed, p_drop):
    ref = np.asarray(pa.dropout_keep_reference(seed, 6, 70, 129, p_drop))
    got = fa.dropout_keep_reference(seed, 6, 70, 129, p_drop).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_cpu_route_and_checks():
    """On CPU tensors the wrapper returns the plain version's result; it
    refuses what the kernel does not take."""
    shape = (2, 70, 4, 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=3))
    seg = torch.from_numpy(_ragged_seg(2, 70, seed=3))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, seg)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert fa.LAUNCHES == before          # no kernel launched on the CPU
    o2 = fa.flash_attention(q, k, v, key_mask=seg.bool())
    assert torch.equal(o2, o)
    wide = torch.from_numpy(_qkv((2, 70, 4, 136), seed=4)[0])   # above 128: runs unpadded
    assert torch.equal(fa.flash_attention_fwd(wide, wide, wide, seg)[0],
                       fa.flash_attention_reference(wide, wide, wide, seg)[0])
    empty = torch.zeros(2, 70, 4, 0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(empty, empty, empty, seg)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half(), seg)
    with pytest.raises(ValueError, match="seg"):
        fa.flash_attention_fwd(q, k, v, seg.long())
    with pytest.raises(ValueError, match="p_drop"):
        fa.flash_attention_fwd(q, k, v, seg, p_drop=1.0)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_fwd(q, k, v, seg, p_drop=0.1, seed=2**31)


@pytest.mark.parametrize("masking", ["key_mask", "seg"])
def test_multi_head_attention_matches_jax(masking):
    shape = (2, 90, 4, 16)
    q, k, v = _qkv(shape, seed=9)
    if masking == "seg":
        seg = _packed_seg(2, 90)
        kw_j, kw_t = dict(seg=jnp.asarray(seg)), dict(seg=torch.from_numpy(seg))
        valid = seg > 0
    else:
        mask = _ragged_seg(2, 90, seed=9).astype(bool)
        kw_j = dict(key_mask=jnp.asarray(mask))
        kw_t = dict(key_mask=torch.from_numpy(mask))
        valid = mask
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw_j))
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw_t).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=0)
    # and the flash plain version agrees with it on valid rows
    o, _ = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid.astype(np.int32) if masking == "key_mask"
                         else seg))
    np.testing.assert_allclose(o.numpy()[valid], got[valid], atol=1e-5, rtol=0)


def _edge_segs(b, l):
    """Row 0 packed (3 segments, pad tail); row 1 all pad; row 2 a
    one-token segment, a segment across the 64-row tile border, another
    one-token segment, a long segment, a pad tail."""
    seg = np.zeros((b, l), np.int32)
    seg[0] = _packed_seg(1, l)[0]
    cut = min(100, l - 20)
    seg[2, 0] = 1
    seg[2, 1:cut] = 2
    seg[2, cut] = 3
    seg[2, cut + 1:l - 5] = 4
    return seg


# the elementwise tolerance of the bf16 kernel against the f32 plain version
# (O within one bf16 rounding), as in chip_smoke.py's O_RTOL/O_ATOL
BF16_RTOL, O_ATOL = 4e-3, 1e-5
_LOG2E = 1.4426950408889634


def _hi_lo(x):
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _emulated_tensor_core_fwd(q, k, v, seg, p_drop, seed, split=True):
    """The bf16 route of the forward kernel in plain torch: S in f32 from
    bf16 inputs, scaled to log2 units in f32; the online softmax over chunks
    of 16 keys (running max m, rescale of acc and l by exp2(m_old - m_new),
    p = exp2(x - m) on allowed pairs only, l summing the undropped p); P~ =
    p keep/(1-p) rounded to bf16 hi + lo (``split``; else to bf16 alone)
    before P~ V (f32 sums); O = acc / l rounded to bf16 once, pad rows zero;
    LSE = (m + log2 l) ln 2."""
    b, l, h, d = q.shape
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
    allow = fa._allow_mask(seg).expand(b, h, l, l)
    x = torch.where(allow, s * ((1.0 / d ** 0.5) * _LOG2E), fa.NEG_INF)
    keepf = torch.ones_like(x)
    if p_drop > 0.0:
        keep = fa.dropout_keep_reference(seed, b * h, l, l, p_drop).view(b, h, l, l)
        keepf = keep * (1.0 / (1.0 - p_drop))
    rnd = _hi_lo if split else (lambda t: t.bfloat16().float())
    vt = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, l, 1), fa.NEG_INF)
    lsum = torch.zeros(b, h, l, 1)
    acc = torch.zeros(b, h, l, d)
    for c in range(0, l, 16):
        xc, ac = x[..., c:c + 16], allow[..., c:c + 16]
        m_new = torch.maximum(m, xc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ac, torch.exp2(xc - m_new), 0.0)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + rnd(p * keepf[..., c:c + 16]) @ vt[:, :, c:c + 16]
        m = m_new
    live = (seg != 0)[:, None, :, None] & (lsum > 0)
    safe = torch.where(live, lsum, 1.0)
    o = torch.where(live, acc / safe, 0.0).permute(0, 2, 1, 3).bfloat16()
    lse = torch.where(live, (m + torch.log2(safe)) / _LOG2E, fa.NEG_INF)[..., 0]
    return o, lse


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("d", [4, 16])
def test_hi_lo_rounding_holds_the_bf16_tolerance(d, p_drop):
    """A bf16 hi + lo split of P~ (coarser than the kernel's three terms),
    emulated in plain torch on bf16 rows with edge segments, stays within the elementwise
    tolerance the card holds the kernel to against the f32 plain version;
    pad rows are exactly zero and their LSE -1e30. Rounded to bf16 alone,
    P~ V breaks that tolerance."""
    b, l, h = 3, 130, 2
    rng = np.random.default_rng(100 + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, l, h, d)).astype(np.float32)
                                ).bfloat16() for _ in range(3))
    seg = torch.from_numpy(_edge_segs(b, l))
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg,
                                          p_drop, 21)
    o, lse = _emulated_tensor_core_fwd(q, k, v, seg, p_drop, 21)
    err = (o.float() - ro).abs()
    assert (err <= BF16_RTOL * ro.abs() + O_ATOL).all(), \
        f"worst excess {(err - BF16_RTOL * ro.abs()).max().item():.3e}"
    assert (lse - rl).abs().max().item() <= 1e-4
    pad = seg == 0
    assert (o[pad] == 0).all()
    assert (lse.permute(0, 2, 1)[pad] == np.float32(fa.NEG_INF)).all()
    single, _ = _emulated_tensor_core_fwd(q, k, v, seg, p_drop, 21, split=False)
    assert ((single.float() - ro).abs() > BF16_RTOL * ro.abs() + O_ATOL).any()


def _check_kernel(q, k, v, seg, p_drop, seed, bh_offset=0):
    """The kernel against its plain version on the same inputs: O within one
    bf16 rounding (bf16) or 2e-5 relative (f32), LSE within 1e-4; pad rows
    exactly zero with LSE -1e30."""
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, seed, bh_offset)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg,
                                          p_drop, seed, bh_offset)
    torch.cuda.synchronize()
    rel = BF16_RTOL if q.dtype == torch.bfloat16 else 2e-5
    assert ((o.float() - ro).abs() <= rel * ro.abs() + O_ATOL).all()
    assert (lse - rl).abs().max().item() <= 1e-4
    pad = seg == 0
    assert (o[pad] == 0).all()
    assert (lse.permute(0, 2, 1)[pad] == np.float32(fa.NEG_INF)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop,bh_offset", [(0.0, 0), (0.1, 0), (0.1, 6)])
@pytest.mark.parametrize("l", [300, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_matches_plain(d, dtype, l, p_drop, bh_offset):
    """The CUDA kernel against its plain version on the card, contiguous
    q, k, v: row 0 packed, row 1 all pad, row 2 one-token segments and a
    segment across the 64-row tile border; L not a multiple of 64.
    ``bh_offset`` 6: the rows of rank 1 of two, whose dropout masks are
    rows 6-11 of the global batch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _qkv((3, l, 2, d), seed=d + l))
    seg = torch.from_numpy(_edge_segs(3, l)).cuda()
    _check_kernel(q, k, v, seg, p_drop, 99, bh_offset)


def _fused_qkv_views(shape, seed, device="cpu", dtype=torch.float32):
    """q, k, v as the model makes them: strided [B, L, H, D] views of one
    fused [B, L, 3 H D] qkv output."""
    b, l, h, d = shape
    qkv = np.random.default_rng(seed).standard_normal((b, l, 3 * h * d))
    qkv = torch.from_numpy(qkv.astype(np.float32)).to(device, dtype)
    return tuple(t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))


def test_wrapper_takes_fused_qkv_views():
    """Strided views of the fused qkv output give the same result as their
    contiguous copies (CPU route)."""
    q, k, v = _fused_qkv_views((2, 70, 4, 4), seed=5)
    assert not q.is_contiguous() and q.stride(1) == 3 * 4 * 4
    seg = torch.from_numpy(_ragged_seg(2, 70, seed=5))
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    ro, rl = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), seg)
    assert torch.equal(o, ro) and torch.equal(lse, rl)


@pytest.mark.cuda
@pytest.mark.parametrize("segs", ["edge", "ragged"])
@pytest.mark.parametrize("layout", ["fused", "odd"])
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("l", [300, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_matches_plain_on_fused_qkv_views(d, dtype, l, p_drop, layout, segs):
    """The CUDA kernel reads q, k, v through their strides. ``fused``: views
    of one fused qkv output, as the model passes them (row stride 3 H D);
    ``odd``: views with an odd row stride and offset (no cp.async piece
    fits, so the bf16 kernel stages K and V by plain loads). ``edge``: the
    segments of ``test_kernel_matches_plain``; ``ragged``: one key-mask
    segment a row, as serving sends, row 0 valid up to L - 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    b, h = 3, 4
    if layout == "fused":
        q, k, v = _fused_qkv_views((b, l, h, d), seed=d + l, device="cuda",
                                   dtype=dt)
        assert q.stride(1) == 3 * h * d
    else:
        rng = np.random.default_rng(d + l)
        q, k, v = (torch.from_numpy(rng.normal(size=(b, l, h, d + 1))
                                    .astype(np.float32)).to("cuda", dt)[..., 1:]
                   for _ in range(3))
    seg = _edge_segs(b, l) if segs == "edge" else _ragged_seg(b, l, seed=d)
    _check_kernel(q, k, v, torch.from_numpy(seg).cuda(), p_drop, 99)
