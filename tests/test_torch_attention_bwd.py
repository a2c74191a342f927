"""Port parity: the flash-attention backward against the JAX package, CPU.

- ``flash_attention_bwd_reference`` (the plain version of the dQ and dK/dV
  kernels), reached through ``flash_attention``'s autograd function on CPU
  tensors, against ``jax.grad`` through the Pallas kernels in interpret
  mode, on the cases of ``tests/test_ops.py`` (ragged key mask at head dim
  4, packed segments with a pad tail, dropout with the same seed), f32,
  atol 1e-5; and against ``torch.autograd.grad`` through the plain forward.
- The wrappers' CPU route, and that no kernel is launched there.
- The bf16 kernels' hi + lo split of their second products, emulated in
  plain torch (no JAX call), against the tolerance the card holds them to.

Every interpret-mode Pallas call is followed by ``jax.block_until_ready``
before any other JAX op is dispatched.

The CUDA kernels run only on a GPU: the ``cuda``-marked tests skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.ops import pallas_attention as pa
from glearning_benchmark_tpu_torch.ops import flash_attention as fa


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(4))


def _ragged(b, l):
    seg = np.ones((b, l), np.int32)
    seg[b - 1, (2 * l) // 3:] = 0
    return seg


def _packed(b, l):
    seg = np.zeros((b, l), np.int32)
    cuts = np.linspace(0, l - l // 6, 4).astype(int)   # 3 segments + pad tail
    for i in range(b):
        for s in range(3):
            seg[i, cuts[s] + 3 * i:cuts[s + 1]] = s + 1
    return seg


def _jax_grads(q, k, v, w, seg, p_drop, seed):
    """(dq, dk, dv) of sum(O * w) from the Pallas kernels, interpret mode."""
    segj, wj = jnp.asarray(seg), jnp.asarray(w)

    def loss(q, k, v):
        return jnp.sum(pa.flash_attention(q, k, v, seg=segj, interpret=True,
                                          p_drop=p_drop, seed=seed) * wj)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.block_until_ready(grads)
    return [np.asarray(g) for g in grads]


def _torch_grads(q, k, v, w, seg, p_drop, seed, through_plain_forward=False):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    segt = torch.from_numpy(seg)
    if through_plain_forward:
        o, _ = fa.flash_attention_reference(qt, kt, vt, segt, p_drop, seed)
    else:
        o = fa.flash_attention(qt, kt, vt, seg=segt, p_drop=p_drop, seed=seed)
    return [g.numpy() for g in
            torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(w))]


CASES = [
    # (shape, seg kind, p_drop, seed): tests/test_ops.py:60-181
    ((2, 130, 4, 4), "ragged", 0.0, 0),
    ((2, 256, 4, 16), "packed", 0.0, 0),
    ((1, 130, 2, 8), "ragged", 0.3, 1234),
    ((2, 200, 2, 16), "packed", 0.1, -7),
]
IDS = [f"{c[1]}-L{c[0][1]}-D{c[0][3]}-p{c[2]}" for c in CASES]


@pytest.mark.parametrize("shape,kind,p_drop,seed", CASES, ids=IDS)
def test_plain_backward_matches_pallas_interpret(shape, kind, p_drop, seed):
    b, l, _, _ = shape
    q, k, v, w = _inputs(shape, seed=l)
    seg = _ragged(b, l) if kind == "ragged" else _packed(b, l)
    ref = _jax_grads(q, k, v, w, seg, p_drop, seed)
    got = _torch_grads(q, k, v, w, seg, p_drop, seed)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=f"d{name}")
    pad = seg == 0
    assert (got[0][pad] == 0).all()       # pad queries: dQ = 0 exactly
    assert (got[1][pad] == 0).all() and (got[2][pad] == 0).all()   # pad keys


@pytest.mark.parametrize("shape,kind,p_drop,seed", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_plain_forward(shape, kind, p_drop,
                                                          seed):
    b, l, _, _ = shape
    q, k, v, w = _inputs(shape, seed=l + 1)
    seg = _ragged(b, l) if kind == "ragged" else _packed(b, l)
    got = _torch_grads(q, k, v, w, seg, p_drop, seed)
    ref = _torch_grads(q, k, v, w, seg, p_drop, seed, through_plain_forward=True)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=f"d{name}")


def test_backward_wrappers_cpu_route():
    """On CPU tensors the per-kernel wrappers return the plain version's
    parts, launch nothing, and take strided qkv views and a strided dO."""
    b, l, h, d = 2, 70, 4, 4
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * h * d)).astype(np.float32))
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    do = torch.from_numpy(rng.normal(size=(b, h, l, d)).astype(np.float32)
                          ).transpose(1, 2)
    seg = torch.from_numpy(_packed(b, l))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, 0.1, 3)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, 0.1, 3)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, 0.1, 3)
    ref = fa.flash_attention_bwd_reference(q, k, v, seg, o, lse, do, 0.1, 3)
    for g, r in zip((dq, dk, dv), ref):
        assert torch.equal(g, r)
    assert torch.equal(delta, fa.flash_attention_delta(o, do))
    again = fa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), seg, o, lse,
                                   do.contiguous(), 0.1, 3)
    for g, r in zip(again, ref):
        assert torch.equal(g, r)
    assert fa.LAUNCHES == before
    assert set(fa.LAUNCHES) == {"flash_attn_fwd", "flash_attn_bwd_dq",
                                "flash_attn_bwd_dkv"}


def test_seg_p_drop_and_seed_take_no_gradient():
    q, k, v, w = (torch.from_numpy(a) for a in _inputs((1, 40, 2, 4), seed=2))
    q.requires_grad_()
    seg = torch.from_numpy(_ragged(1, 40))
    o = fa.flash_attention(q, k, v, seg=seg, p_drop=0.2, seed=11)
    (dq,) = torch.autograd.grad(o, (q,), w)
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    # the dropped forward differs from the undropped one, by the same seed
    o2 = fa.flash_attention(q, k, v, seg=seg, p_drop=0.2, seed=11)
    assert torch.equal(o, o2)
    assert not torch.equal(o, fa.flash_attention(q, k, v, seg=seg))


def _edge_segs(b, l):
    """Row 0 packed (3 segments, pad tail); row 1 all pad; row 2 a
    one-token segment, a segment across the 64-row tile border, another
    one-token segment, a long segment, a pad tail."""
    seg = np.zeros((b, l), np.int32)
    seg[0] = _packed(1, l)[0]
    cut = min(100, l - 20)
    seg[2, 0] = 1
    seg[2, 1:cut] = 2
    seg[2, cut] = 3
    seg[2, cut + 1:l - 5] = 4
    return seg


# hi + lo bf16 rounding of the kernels' second products, emulated on the
# CPU (bf16 inputs; S, P and dS in f32; the tolerances of the cuda twin and
# of chip_smoke.py's G_RTOL/G_ATOL at bf16)
BF16_RTOL, G_ATOL = 4e-3, 1e-5


def _hi_lo(x):
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _emulated_tensor_core_bwd(q, k, v, seg, o, lse, do, p_drop, seed,
                              split=True):
    """The bf16 route of the dQ and dK/dV kernels in plain torch: the first
    products (S, dP) in f32 from bf16 inputs, P, dS and P keep/(1-p) in f32
    and then rounded to bf16 hi + lo (``split``; else to bf16 alone) before
    the second products (f32 sums); outputs rounded to bf16 once."""
    b, l, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    allow = fa._allow_mask(seg)
    s = torch.einsum("blhd,bshd->bhls", qf, kf)
    p = torch.where(allow, torch.exp2(s * (scale * 1.4426950408889634)
                                      - lse[..., None] * 1.4426950408889634), 0.0)
    dp = torch.einsum("blhd,bshd->bhls", dof, vf)
    keepf = torch.ones_like(p)
    if p_drop > 0.0:
        keep = fa.dropout_keep_reference(seed, b * h, l, l, p_drop).view(b, h, l, l)
        keepf = keep * (1.0 / (1.0 - p_drop))
    delta = fa.flash_attention_delta(o, do)[..., None]
    rnd = _hi_lo if split else (lambda x: x.bfloat16().float())
    ds = rnd(p * (dp * keepf - delta))
    pd = rnd(p * keepf)
    dq = torch.einsum("bhls,bshd->blhd", ds, kf) * scale
    dk = torch.einsum("bhls,blhd->bshd", ds, qf) * scale
    dv = torch.einsum("bhls,blhd->bshd", pd, dof)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("d", [4, 16])
def test_hi_lo_rounding_holds_the_bf16_tolerance(d, p_drop):
    """The kernels' bf16 hi + lo split of P keep/(1-p) and dS, emulated in
    plain torch on packed bf16 rows with edge segments, stays within the
    elementwise tolerance the card holds the kernels to against the f32
    plain backward; pad rows stay exactly zero. Rounded to bf16 alone, the
    same products break that tolerance."""
    b, l, h = 3, 130, 2
    rng = np.random.default_rng(100 + d)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs((b, l, h, d), d))
    seg = torch.from_numpy(_edge_segs(b, l))
    o, lse = fa.flash_attention_reference(q, k, v, seg, p_drop, 21)
    do = do * torch.from_numpy(rng.uniform(0.5, 2.0, size=(1, l, 1, 1))
                               .astype(np.float32)).bfloat16()
    got = _emulated_tensor_core_bwd(q, k, v, seg, o, lse, do, p_drop, 21)
    ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg,
                                           o, lse, do.float(), p_drop, 21)
    pad = seg == 0
    for name, g, r in zip("qkv", got, ref):
        err = (g.float() - r).abs()
        assert (err <= BF16_RTOL * r.abs() + G_ATOL).all(), \
            f"d{name}: worst excess {(err - BF16_RTOL * r.abs()).max().item():.3e}"
        assert (g[pad] == 0).all()
    single = _emulated_tensor_core_bwd(q, k, v, seg, o, lse, do, p_drop, 21,
                                       split=False)
    assert any(((g.float() - r).abs() > BF16_RTOL * r.abs() + G_ATOL).any()
               for g, r in zip(single, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "odd"])
@pytest.mark.parametrize("p_drop,bh_offset", [(0.0, 0), (0.1, 0), (0.1, 6)])
@pytest.mark.parametrize("l", [300, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_backward_kernels_match_plain(d, dtype, l, p_drop, bh_offset, layout):
    """The dQ and dK/dV kernels against the plain backward on the card:
    row 0 packed, row 1 all pad, row 2 one-token segments and a segment
    across the 64-row tile border; L not a multiple of 64. ``fused``: q, k,
    v strided views of one qkv output and a transposed dO; ``odd``: every
    operand a view with an odd row stride and offset (no cp.async piece
    fits, so the bf16 kernels stage it by plain loads). Within one bf16
    rounding (bf16) or 1e-4 relative (f32); pad rows exactly zero; dK/dV
    bit-equal on two runs. ``bh_offset`` 6: the rows of rank 1 of two."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    b, h = 3, 2
    rng = np.random.default_rng(d + l)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to("cuda", dt)

    if layout == "fused":
        q, k, v = (t.unflatten(-1, (h, d))
                   for t in normal(b, l, 3 * h * d).split(h * d, dim=-1))
        do = normal(b, h, l, d).transpose(1, 2)
    else:
        q, k, v, do = (normal(b, l, h, d + 1)[..., 1:] for _ in range(4))
    seg = torch.from_numpy(_edge_segs(b, l)).cuda()
    args = (p_drop, 99, bh_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, *args)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg,
                                           o, lse, do.float(), *args)
    torch.cuda.synchronize()
    rel = 4e-3 if dtype == "bfloat16" else 1e-4
    pad = seg == 0
    for g, r in zip((dq, dk, dv), ref):
        assert ((g.float() - r).abs() <= rel * r.abs() + 1e-5).all()
        assert (g[pad] == 0).all()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert (delta - fa.flash_attention_delta(o, do)).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, w = (torch.from_numpy(a).cuda().requires_grad_()
                  for a in _inputs((2, 130, 4, 16), seed=1))
    seg = torch.from_numpy(_packed(2, 130)).cuda()
    fa.reset_launches()
    o = fa.flash_attention(q, k, v, seg=seg, p_drop=0.1, seed=5)
    got = torch.autograd.grad(o, (q, k, v), w.detach())
    assert fa.LAUNCHES == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
                           "flash_attn_bwd_dkv": 1}
    ro, _ = fa.flash_attention_reference(q, k, v, seg, 0.1, 5)
    ref = torch.autograd.grad(ro, (q, k, v), w.detach())
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-4
