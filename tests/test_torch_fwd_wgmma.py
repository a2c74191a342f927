"""The forward's wgmma design (bf16 at head dims 64, 128 and 256; TMA ring,
producer warp): its dispatch, its padding, and its function against the
JAX package and the plain version.

- CPU: ``design("flash_attn_fwd", d, bf16)`` is "wgmma" at 64 and 128 and,
  through the instance at 256 (``padded_head_dim`` of the forward), at
  129-256; "mma" at 4-32; "f32"/"wide" for f32; the backward's designs
  by head dim and type (its own wgmma instance at 256 since the backward's
  redesign above 128, and its wgmma_chunks instances at 320-512,
  ``tests/test_torch_bwd_wgmma.py``). A view TMA cannot
  read (``tma_ok``) takes "mma" at 64 and 128 and the wide route at 256.
  Above 256 the forward leaves this design: "wgmma_chunks" up to 512, for
  any view (its kernel's tests: ``tests/test_torch_fwd_chunks.py``), the
  wide route above.
- CPU: the wrapper's CPU route at head dims 160 and 256 equals the plain
  version; the zero-padding to 256 (the plain version in the kernel's
  place sees head dim 256) keeps LSE within 1e-5 and the bf16 O within one
  bf16 rounding of the unpadded f32 version.
- CPU: the JAX package's flash forward (its Pallas kernel in interpret
  mode, as its own tests run it) at [2, 64, 2, 128] and at head dim 160, on
  bf16 inputs, against the port's CPU route: O within one bf16 rounding
  (rtol 4e-3, atol 1e-5, the tolerance of ``tests/test_torch_head_dims.py``)
  of JAX's f32 O on the same bf16 values, LSE within 1e-4.
- On the card (``cuda`` marker, skipped here): the new instances against
  the plain version at [3, 300, 2, D], D 64, 128, 160 and 256 (packed
  segments, a pad tail, a partial last tile), p 0 and 26/256, ``bh_offset``
  6, on fused-qkv views; a view off the 16-byte grid takes the mma.sync
  design (D 64, 128) or the wide route (256), is counted, and still
  matches; O and LSE bits equal on a second run. (A head dim padded to
  256 is a fresh, aligned copy: it always runs wgmma.)
- The forward's cancelling sum. In one segment of 8 tokens, v[:, -2:, 0,
  0] is picked on the bf16 grid so that O[query 0, col 0] = sum_k P[0, k]
  v[k, 0] cancels to 1e-7-1e-3 of its terms (size ~16). CPU: P~ split into
  bf16 terms before P~ V, emulated in plain torch against an f64 version
  at head dims 64, 128 and 256: hi + lo misses the elementwise bound rtol
  4e-3 + atol 1e-5 there (by more than 2x), hi + mid + lo holds it
  (within 0.2 of it; within 0.8 with P perturbed by 3e-7 relative, the
  kernel's own exp2); the same at head dims 8 and 16, the mma.sync
  forward's. Three rounded terms hold every f32 P~ in (2^-100, 1] exactly.
  On the card (``cuda``): the kernel's O against the f64 version, the wgmma
  forward at 64, 128 and 256 and the mma.sync forward at 8 and 16 (every
  bf16 design takes three terms, csrc ``kSplitTerms``).
"""

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

BF16_RTOL, ATOL, LSE_ATOL = 4e-3, 1e-5, 1e-4
TRAIN_RATE = 26 / 256
FWD = "flash_attn_fwd"
BWD = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")


@pytest.mark.parametrize("d,padded", [(64, 64), (48, 64), (100, 128), (128, 128),
                                      (129, 256), (160, 256), (200, 256), (256, 256)])
def test_bf16_forward_runs_wgmma(d, padded):
    assert fa.padded_head_dim(d, FWD, torch.bfloat16) == padded
    assert fa.design(FWD, d, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("d", [1, 4, 8, 12, 16, 24, 32])
def test_bf16_forward_keeps_mma_below_64(d):
    assert fa.design(FWD, d, torch.bfloat16) == "mma"


@pytest.mark.parametrize("d,design", [(16, "f32"), (64, "f32"), (128, "wide"),
                                      (160, "wide"), (256, "wide"), (300, "wide")])
def test_f32_forward_designs_are_unchanged(d, design):
    assert fa.padded_head_dim(d, FWD, torch.float32) == fa.padded_head_dim(d)
    assert fa.design(FWD, d, torch.float32) == design


@pytest.mark.parametrize("d", [257, 300, 320, 383, 384, 448, 512, 513, 640])
def test_bf16_forward_above_256_takes_the_wide_route(d):
    """Above 256 the bf16 forward leaves the wgmma design: the wgmma_chunks
    instances up to 512 (padded to the next multiple of 64; fed by cp.async,
    they read any view), the wide route, unpadded, above 512; f32 stays on
    the wide route, unpadded."""
    chunks = d <= fa.CHUNKS_WIDE
    assert fa.padded_head_dim(d, FWD, torch.bfloat16) == (-(-d // 64) * 64 if chunks else d)
    for tma in (True, False):
        assert fa.design(FWD, d, torch.bfloat16, tma=tma) == (
            "wgmma_chunks" if chunks else "wide")
    assert fa.padded_head_dim(d, FWD, torch.float32) == d
    assert fa.design(FWD, d, torch.float32) == "wide"


@pytest.mark.parametrize("d,dtype,design,padded", [
    (16, torch.bfloat16, "mma", 16), (64, torch.bfloat16, "wgmma", 64),
    (128, torch.bfloat16, "wgmma", 128), (160, torch.bfloat16, "wgmma", 256),
    (256, torch.bfloat16, "wgmma", 256), (64, torch.float32, "f32", 64),
    (128, torch.float32, "wide", 128), (300, torch.bfloat16, "wgmma_chunks", 320),
    (384, torch.bfloat16, "wgmma_chunks", 384), (448, torch.bfloat16, "wgmma_chunks", 448),
    (640, torch.bfloat16, "wide", 640)])
def test_backward_designs_by_head_dim_and_type(d, dtype, design, padded):
    for name in BWD:
        assert fa.padded_head_dim(d, name, dtype) == padded
        assert fa.design(name, d, dtype) == design


def _fused(b, l, h, d, dtype=torch.bfloat16, offset=0):
    """q, k, v: [B, L, H, D] views of one fused qkv, ``offset`` elements
    into their storage."""
    flat = torch.zeros(b * l * 3 * h * d + offset, dtype=dtype)
    qkv = flat[offset:].view(b, l, 3 * h * d)
    return tuple(t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))


@pytest.mark.parametrize("d,design", [(64, "mma"), (128, "mma"), (256, "wide")])
def test_views_tma_cannot_read_take_another_design(d, design):
    q, k, v = _fused(2, 8, 2, d)
    assert fa.tma_ok(q, k, v)
    assert fa.design(FWD, d, torch.bfloat16, tma=fa.tma_ok(q, k, v)) == "wgmma"
    odd = _fused(2, 8, 2, d, offset=1)           # 2 bytes off the 16-byte grid
    transposed = tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    for views in (odd, transposed):
        assert not fa.tma_ok(*views)
        assert fa.design(FWD, d, torch.bfloat16, tma=fa.tma_ok(*views)) == design


def _inputs(b, l, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32))
               .bfloat16() for _ in range(3))
    seg = np.zeros((b, l), np.int32)
    seg[0, : l // 3], seg[0, l // 3: l - 5] = 1, 2     # two segments and a pad tail
    seg[1, :] = 1
    return q, k, v, torch.from_numpy(seg)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
def test_cpu_route_and_padding_to_256_equal_the_plain_version(d, p_drop):
    q, k, v, seg = _inputs(2, 40, 2, d, seed=d)
    kw = dict(p_drop=p_drop, seed=7, bh_offset=2)
    ro, rl = fa.flash_attention_reference(q, k, v, seg, **kw)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, **kw)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    fo, fl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, **kw)
    seen = []

    def plain(*args, **kwargs):
        seen.append(args[0].shape[-1])
        return fa.flash_attention_reference(*args, **kwargs)

    po, pl = fa.pad_head_dim(plain, q, k, v, seg, name=FWD, **kw)
    assert seen == [256] and po.shape == fo.shape == (2, 40, 2, d)
    assert ((po.float() - fo).abs() <= BF16_RTOL * fo.abs() + ATOL).all()
    np.testing.assert_allclose(pl.numpy(), fl.numpy(), atol=ATOL, rtol=0)


def _pallas_f32(q, k, v, seg, p_drop, seed):
    """(O, LSE) of the JAX package's flash forward (interpret mode) on the
    f32 values of the bf16 inputs. JAX is imported here: the card's machine
    runs this file's cuda tests without it."""
    import jax.numpy as jnp

    from glearning_benchmark_tpu.ops import pallas_attention as pa

    b, l, h, _ = q.shape
    seed_arr = jnp.asarray(seed, jnp.int32).reshape(1, 1)
    out, res = pa._flash_fwd(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                             jnp.asarray(seg.numpy()), seed_arr, 128, 128, p_drop, True)
    lse = np.asarray(res[6])[: b * h, :l].reshape(b, h, l)
    return np.asarray(out), lse


@pytest.mark.parametrize("shape,p_drop", [((2, 64, 2, 128), 0.0), ((2, 64, 2, 128), TRAIN_RATE),
                                          ((2, 48, 1, 160), TRAIN_RATE)],
                         ids=["d128-p0", "d128-train-rate", "d160-train-rate"])
def test_port_cpu_route_matches_jax_flash_forward(shape, p_drop):
    b, l, h, d = shape
    q, k, v, seg = _inputs(b, l, h, d, seed=l + d)
    ref_o, ref_lse = _pallas_f32(q, k, v, seg, p_drop, 1234)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, 1234)
    assert o.dtype == torch.bfloat16
    got = o.float().numpy()
    assert (np.abs(got - ref_o) <= BF16_RTOL * np.abs(ref_o) + ATOL).all()
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=LSE_ATOL, rtol=0)
    pad = seg.numpy() == 0
    assert (got[pad] == 0).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _card_inputs(d, offset, seed):
    """[3, 300, 2, d] bf16 fused-qkv views on the card, ``offset`` elements
    into their storage; packed segments, a pad tail, one-token segments,
    a partial last key tile."""
    b, l, h = 3, 300, 2
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(b * l * 3 * h * d + offset)
                            .astype(np.float32)).to("cuda", torch.bfloat16)
    qkv = flat[offset:].view(b, l, 3 * h * d)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    seg = np.zeros((b, l), np.int32)
    seg[0, :100], seg[0, 100:250] = 1, 2
    seg[1, :] = 1
    seg[2, :3], seg[2, 3:4], seg[2, 4:70], seg[2, 70:200] = 1, 2, 3, 4
    return q, k, v, torch.from_numpy(seg).cuda()


def _check_card(q, k, v, seg, p_drop, bh_offset):
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, 99, bh_offset)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, seg, p_drop, 99, bh_offset)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, p_drop, 99,
                                          bh_offset)
    torch.cuda.synchronize()
    assert ((o.float() - ro).abs() <= BF16_RTOL * ro.abs() + ATOL).all()
    assert (lse - rl).abs().max().item() <= LSE_ATOL
    pad = seg == 0
    assert (o[pad] == 0).all()
    assert (lse.permute(0, 2, 1)[pad] == np.float32(fa.NEG_INF)).all()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_wgmma_forward_matches_plain(d, p_drop):
    _card()
    q, k, v, seg = _card_inputs(d, 0, seed=d)
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == "wgmma"
    _check_card(q, k, v, seg, p_drop, bh_offset=6)


@pytest.mark.cuda
@pytest.mark.parametrize("d,design", [(64, "mma"), (128, "mma"), (256, "wide")])
def test_views_tma_cannot_read_match_plain(d, design):
    _card()
    q, k, v, seg = _card_inputs(d, 1, seed=d + 1)
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == design
    fa.reset_launches()
    _check_card(q, k, v, seg, TRAIN_RATE, bh_offset=6)
    assert fa.TMA_REFUSED[FWD] == 2


# ---------------------------------------------------------------------------
# the cancelling sum: P~ goes into P~ V as three bf16 terms
# ---------------------------------------------------------------------------

FWD_CANCEL_SEEDS = {64: 0, 128: 5, 256: 4}     # the cases below, by head dim
MMA_CANCEL_SEEDS = {8: 1, 16: 2}               # the mma.sync forward's, by head dim


def _split(x: torch.Tensor, terms: int) -> torch.Tensor:
    """x (f32) as the sum of ``terms`` rounded bf16 terms, largest first
    (csrc/flash_attn_common.cuh ``split_bf16x2``)."""
    out, rest = torch.zeros_like(x), x.clone()
    for _ in range(terms):
        t = rest.bfloat16().float()
        out, rest = out + t, rest - t
    return out


def _probs_f64(q, k, seg):
    """P [B, H, q, key] in f64 (one segment a row, no dropout)."""
    s = torch.einsum("blhd,bshd->bhls", q.double(), k.double()) / q.shape[-1] ** 0.5
    return torch.softmax(s.masked_fill(~fa._allow_mask(seg), float("-inf")), dim=-1)


def fwd_cancelling_case(d: int, seed: int, b: int = 4, l: int = 8):
    """q, k, v [b, l, 1, d] bf16 and seg (one segment a row): v[:, -2:, 0, 0]
    picked on the bf16 grid so that sum_k P[0, k] v[k, 0] nearly cancels
    (terms of size ~16)."""
    rng = np.random.default_rng(seed)

    def normal(scale):
        return torch.from_numpy((rng.normal(size=(b, l, 1, d)) * scale).astype(np.float32)
                                ).bfloat16()

    q, k, v = normal(0.7), normal(0.7), normal(16.0)
    seg = torch.ones(b, l, dtype=torch.int32)
    p = _probs_f64(q, k, seg)[:, 0, 0, :]                      # [b, key]: P[query 0, key]
    steps = torch.arange(-40, 41, dtype=torch.float64) * 0.0625
    for i in range(b):
        rest = (p[i, :-2] * v[i, :-2, 0, 0].double()).sum()
        xs = (v[i, -2, 0, 0].double() + steps).bfloat16().double().unique()
        ys = (-(rest + p[i, -2] * xs) / p[i, -1]).bfloat16().double()
        ys = (ys[:, None] + steps[None, 38:43]).bfloat16().double()   # neighbours on the grid
        resid = (rest + p[i, -2] * xs[:, None] + p[i, -1] * ys).abs()
        at = int(resid.argmin())
        v[i, -2, 0, 0] = xs[at // ys.shape[1]]
        v[i, -1, 0, 0] = ys.flatten()[at]
    return q, k, v, seg


def _worst(got, ref):
    """The largest |got - ref| over the bound rtol |ref| + atol."""
    return ((got.double() - ref).abs() / (BF16_RTOL * ref.abs() + ATOL)).max().item()


def test_three_split_terms_hold_p_exactly():
    """Three rounded bf16 terms sum to every f32 P~ in (2^-100, 1] exactly:
    each remainder is exact and the last has at most 8 significant bits."""
    x = torch.exp2(-torch.rand(1 << 16, generator=torch.Generator().manual_seed(0)) * 100)
    assert torch.equal(_split(x, 3).double(), x.double())
    assert not torch.equal(_split(x, 2).double(), x.double())


def _needs_three_terms(d: int, seed: int) -> None:
    q, k, v, seg = fwd_cancelling_case(d, seed)
    p = _probs_f64(q, k, seg)
    ref = torch.einsum("bhls,bshd->blhd", p, v.double())[:, 0, 0, 0]
    assert ref.abs().max().item() < 2e-3             # the sums cancel

    def o(probs):   # O[query 0, col 0] from f32 P split into bf16 terms, cast to bf16
        return torch.einsum("bhls,bshd->blhd", probs.double(), v.double()
                            ).float().bfloat16()[:, 0, 0, 0]

    assert _worst(o(_split(p.float(), 2)), ref) > 2.0
    assert _worst(o(_split(p.float(), 3)), ref) <= 0.2
    sign = torch.from_numpy(np.random.default_rng(d).choice([-1.0, 1.0], p.shape))
    assert _worst(o(_split((p * (1 + 3e-7 * sign)).float(), 3)), ref) <= 0.8


@pytest.mark.parametrize("d", sorted(FWD_CANCEL_SEEDS))
def test_forward_cancelling_sum_needs_three_split_terms(d):
    _needs_three_terms(d, FWD_CANCEL_SEEDS[d])


@pytest.mark.parametrize("d", sorted(MMA_CANCEL_SEEDS))
def test_mma_forward_cancelling_sum_needs_three_split_terms(d):
    """The same construction at the mma.sync forward's head dims 8 and 16."""
    _needs_three_terms(d, MMA_CANCEL_SEEDS[d])


@pytest.mark.cuda
@pytest.mark.parametrize("d", sorted({**FWD_CANCEL_SEEDS, **MMA_CANCEL_SEEDS}))
def test_forward_cancelling_sum_holds_on_the_card(d):
    """The forward on the cancelling-sum case, against the f64 version:
    every element of O within the bound, the wgmma design at head dims 64,
    128 and 256 and the mma.sync design at 8 and 16."""
    _card()
    seed = FWD_CANCEL_SEEDS[d] if d in FWD_CANCEL_SEEDS else MMA_CANCEL_SEEDS[d]
    q, k, v, seg = (t.cuda() for t in fwd_cancelling_case(d, seed))
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == ("wgmma" if d >= 64 else "mma")
    o, _ = fa.flash_attention_fwd(q, k, v, seg)
    ref = torch.einsum("bhls,bshd->blhd", _probs_f64(q, k, seg), v.double())
    torch.cuda.synchronize()
    assert _worst(o, ref) <= 1.0
