"""Port parity: attention against the JAX package, on the CPU.

- The flash-attention kernel's plain version
  (``flash_attention_reference``) against the Pallas kernel in interpret
  mode: O from ``_flash_fwd`` and LSE from its residuals, with ragged key
  masks, packed segments with a pad tail, L not a block multiple, head dims
  4 and 16, and dropout off and on. Tolerance 1e-5 at f32.
- The torch copy of the counter hash against ``dropout_keep_reference``:
  exactly equal.
- The wrapper's CPU route and ``multi_head_attention`` against JAX's.

The CUDA kernel itself runs only on a GPU: ``test_kernel_matches_plain``
is marked ``cuda`` and skips here.
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
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q[..., :12], k[..., :12], v[..., :12], seg)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_matches_plain(d, dtype):
    """The CUDA kernel against its plain version on the card: O within one
    bf16 rounding (bf16) or 2e-5 (f32), LSE within 1e-4, dropout on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    b, l, h = 3, 300, 2
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _qkv((b, l, h, d), seed=d))
    seg = torch.from_numpy(_packed_seg(b, l)).cuda()
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop=0.1, seed=99)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                          seg, 0.1, 99)
    torch.cuda.synchronize()
    rel = 4e-3 if dtype == "bfloat16" else 2e-5
    assert ((o.float() - ro).abs() <= rel * ro.abs() + 1e-5).all()
    assert (lse - rl).abs().max().item() <= 1e-4


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
@pytest.mark.parametrize("d", [4, 16])
def test_kernel_matches_plain_on_fused_qkv_views(d):
    """The CUDA kernel reads q, k, v through the strides of the fused qkv
    output, as the model passes them; bf16, ragged key mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, l, h = 3, 300, 4
    q, k, v = _fused_qkv_views((b, l, h, d), seed=d, device="cuda",
                               dtype=torch.bfloat16)
    assert q.stride(1) == 3 * h * d
    seg = torch.from_numpy(_ragged_seg(b, l, seed=d)).cuda()
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg)
    torch.cuda.synchronize()
    assert ((o.float() - ro).abs() <= 4e-3 * ro.abs() + 1e-5).all()
    assert (lse - rl).abs().max().item() <= 1e-4
