"""The backward kernels' redesign (wgmma at head dims 64 and 128), the wide
route (f32 at head dim 128 and every head dim above 128) and the split of
the bf16 route's second products (three bf16 terms at every head dim, csrc
``kSplitTerms``).

- CPU: the cancelling-sum case. In one segment of 8 tokens, column 0 of dO
  is chosen on the bf16 grid so that dV[key 0, col 0] = sum_q P[q, 0]
  dO[q, 0] cancels to about 1e-4 of its terms (size ~16). The kernels'
  split of P~ before the second product, emulated in plain torch against
  an f64 version at head dims 8, 16, 64 and 128: hi + lo misses the
  elementwise bound rtol 4e-3 + atol 1e-5 (by 3.0-5.1x), hi + mid + lo
  holds it (within 0.04 of it; within 0.35 with P perturbed by 3e-7
  relative, the kernels' own exp2 and argument rounding).
- On the card (``cuda`` marker, skipped here), q, k, v strided views of
  one fused qkv output and a transposed dO, the tolerances of
  ``tests/test_torch_attention_bwd.py`` (bf16 rtol 4e-3, f32 1e-4, atol
  1e-5):
  - the backward pair at head dims 64 and 128, bf16 and f32, at [3, 300, 2,
    D] (packed segments, a pad tail, a partial last tile), p 0 and 26/256,
    ``bh_offset`` 6; dQ, dK, dV bit-equal on a second run;
  - all three kernels at head dims 160, 256 and 320 (f32: the wide route,
    unpadded; bf16: the wgmma instance at 256, 160 zero-padded to it, and
    at 320 the three kernels' wgmma_chunks instances);
  - the cancelling-sum case against the f64 version at head dims 8, 16
    (mma.sync), 64 and 128 (wgmma): every bf16 design takes three split
    terms;
  - the design ``fa.design`` chooses has an instance in its source at every
    head dim and type, and an entry point refuses a design it has no
    instance of.
"""

import numpy as np
import pytest
import torch

from glearning_benchmark_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

RTOL = {"bfloat16": 4e-3, "float32": 1e-4}
ATOL = 1e-5
TRAIN_RATE = 26 / 256
CANCEL_SEEDS = {8: 1, 16: 0, 64: 2, 128: 2}     # the cases below, by head dim
THREE_TERMS = fa.HEAD_DIMS       # every bf16 instance: csrc/flash_attn_common.cuh kSplitTerms


def _split(x: torch.Tensor, terms: int) -> torch.Tensor:
    """x (f32) as the sum of ``terms`` bf16 terms, largest first."""
    out, rest = torch.zeros_like(x), x.clone()
    for _ in range(terms):
        t = rest.bfloat16().float()
        out, rest = out + t, rest - t
    return out


def _probs_f64(q, k, lse):
    """P [B, H, q, key] in f64 from the forward's LSE (one segment a row)."""
    s = torch.einsum("blhd,bshd->bhls", q.double(), k.double()) / q.shape[-1] ** 0.5
    return torch.exp(s - lse.double()[..., None])


def cancelling_case(d: int, seed: int, b: int = 4, l: int = 8):
    """q, k, v, dO [b, l, 1, d] bf16 and seg (one segment a row): dO[:, -2:,
    0, 0] picked on the bf16 grid so that sum_q P[q, 0] dO[q, 0] nearly
    cancels (terms of size ~16)."""
    rng = np.random.default_rng(seed)

    def normal(scale):
        return torch.from_numpy((rng.normal(size=(b, l, 1, d)) * scale).astype(np.float32)
                                ).bfloat16()

    q, k, v, do = normal(0.7), normal(0.7), normal(1.0), normal(16.0)
    seg = torch.ones(b, l, dtype=torch.int32)
    _, lse = fa.flash_attention_reference(q, k, v, seg)
    p = _probs_f64(q, k, lse)[:, 0, :, 0]                       # [b, q]: P[q, key 0]
    steps = torch.arange(-40, 41, dtype=torch.float64) * 0.0625
    for i in range(b):
        rest = (p[i, :-2] * do[i, :-2, 0, 0].double()).sum()
        xs = (do[i, -2, 0, 0].double() + steps).bfloat16().double().unique()
        ys = (-(rest + p[i, -2] * xs) / p[i, -1]).bfloat16().double()
        ys = (ys[:, None] + steps[None, 38:43]).bfloat16().double()   # neighbours on the grid
        resid = (rest + p[i, -2] * xs[:, None] + p[i, -1] * ys).abs()
        at = int(resid.argmin())
        do[i, -2, 0, 0] = xs[at // ys.shape[1]]
        do[i, -1, 0, 0] = ys.flatten()[at]
    return q, k, v, do, seg


def _bwd_f64(q, k, v, seg, o, lse, do):
    """(dQ, dK, dV) of the plain backward in f64 (no dropout, one segment a
    row, P from the given LSE)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = _probs_f64(q, k, lse) * fa._allow_mask(seg)
    dp = torch.einsum("blhd,bshd->bhls", dod, vd)
    delta = (dod * o.double()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    return (torch.einsum("bhls,bshd->blhd", ds, kd) * scale,
            torch.einsum("bhls,blhd->bshd", ds, qd) * scale,
            torch.einsum("bhls,blhd->bshd", p, dod))


def _worst(got, ref, rtol):
    """The largest |got - ref| over the bound rtol |ref| + atol."""
    return ((got.double() - ref).abs() / (rtol * ref.abs() + ATOL)).max().item()


@pytest.mark.parametrize("d", sorted(CANCEL_SEEDS))
def test_cancelling_sum_needs_three_split_terms(d):
    q, k, v, do, seg = cancelling_case(d, CANCEL_SEEDS[d])
    _, lse = fa.flash_attention_reference(q, k, v, seg)
    p = _probs_f64(q, k, lse)[:, 0].float()                    # [b, q, key]
    ref = torch.einsum("bqk,bqd->bkd", p.double(), do[:, :, 0].double())
    assert ref[:, 0, 0].abs().max().item() < 2e-3 * 16         # it cancels
    got = {n: torch.einsum("bqk,bqd->bkd", _split(p, n), do[:, :, 0].float())
           for n in (2, 3)}
    assert _worst(got[2], ref, RTOL["bfloat16"]) > 2.0         # hi + lo misses
    assert _worst(got[3], ref, RTOL["bfloat16"]) < 0.25        # hi + mid + lo holds


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _fused(b, l, h, d, dt, rng):
    """q, k, v as views of one fused qkv output, and a transposed dO."""
    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dt)

    q, k, v = (t.unflatten(-1, (h, d)) for t in normal(b, l, 3 * h * d).split(h * d, dim=-1))
    return q, k, v, normal(b, h, l, d).transpose(1, 2)


def _packed_segs(b, l, rng):
    """2-5 segments a row and a pad tail; row 1 ends without one."""
    seg = np.zeros((b, l), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(8, l - 8), size=rng.integers(2, 6), replace=False))
        start = 0
        for s, end in enumerate(cuts, 1):
            seg[i, start:end] = s
            start = end
        if i == 1:
            seg[i, start:] = len(cuts) + 1
    return torch.from_numpy(seg).cuda()


def _check_all(d, dtype, p_drop, bh_offset, seed):
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    b, l, h = 3, 300, 2
    q, k, v, do = _fused(b, l, h, d, dt, rng)
    seg = _packed_segs(b, l, rng)
    args = (p_drop, 99, bh_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, *args)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, *args)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    dq2, _ = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, *args)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    refs = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg, o, lse,
                                            do.float(), *args)
    torch.cuda.synchronize()
    pad = seg == 0
    assert ((o.float() - ro).abs() <= RTOL[dtype] * ro.abs() + ATOL).all()
    assert (lse - rl).abs().max().item() <= 1e-4
    for got, ref in zip((dq, dk, dv), refs):
        assert got.shape == ref.shape
        assert ((got.float() - ref).abs() <= RTOL[dtype] * ref.abs() + ATOL).all()
        assert (got[pad] == 0).all()
    assert (o[pad] == 0).all()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert (delta - fa.flash_attention_delta(o, do)).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_pair_matches_plain(d, dtype, p_drop):
    """The redesigned backward pair (bf16: wgmma; f32 at 128: the wide
    route) against the plain version, with the forward it reads."""
    _check_all(d, dtype, p_drop, bh_offset=6, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [160, 256, 320])
def test_wide_head_dims_match_plain(d, dtype):
    """All three kernels above head dim 128, with dropout: f32 on the wide
    route (column chunks of 128 and a partial last one at 160 and 320), bf16
    on the wgmma instance at 256 (160 zero-padded) and at 320 on the three
    kernels' wgmma_chunks instances."""
    _check_all(d, dtype, TRAIN_RATE, bh_offset=6, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [d for d in THREE_TERMS if d in CANCEL_SEEDS])
def test_cancelling_sum_holds_on_the_card(d):
    """The bf16 kernels (three split terms at every head dim) on the
    cancelling-sum case, against the f64 version with the kernel's own O
    and LSE: mma.sync at 8 and 16, wgmma at 64 and 128."""
    _card()
    q, k, v, do, seg = (t.cuda() for t in cancelling_case(d, CANCEL_SEEDS[d]))
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    got = fa.flash_attention_bwd(q, k, v, seg, o, lse, do)
    refs = _bwd_f64(q, k, v, seg, o, lse, do)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert _worst(g, r, RTOL["bfloat16"]) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", fa.SOURCES)
def test_every_chosen_design_has_an_instance(name):
    """``kernel_attrs`` asks the C entry point for the instance of the design
    ``fa.design`` chooses, for views TMA can read and for views it cannot;
    it raises where the source has none."""
    _card()
    for d in fa.HEAD_DIMS + (160, 256, 257, 300, 320, 384, 448, 512, 513):
        for dtype in (torch.bfloat16, torch.float32):
            for dropout in (False, True):
                for tma in (True, False):
                    assert fa.kernel_attrs(name, d, dtype, dropout, tma=tma)["registers"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("launch,d,dtype,force", [
    ("fwd", 16, "bfloat16", "wgmma"), ("fwd", 128, "float32", "f32"),
    ("fwd", 16, "float32", "mma"), ("dq", 16, "bfloat16", "wgmma"),
    ("dq", 64, "bfloat16", "mma"), ("dkv", 128, "bfloat16", "f32"),
    ("dkv", 160, "bfloat16", "wgmma")])
def test_entry_points_refuse_a_design_without_an_instance(launch, d, dtype, force):
    _card()
    rng = np.random.default_rng(0)
    q, k, v, do = _fused(2, 64, 2, d, getattr(torch, dtype), rng)
    seg = torch.ones(2, 64, dtype=torch.int32, device="cuda")
    kw = {"p_drop": 0.0, "seed": 0, "bh_offset": 0, "scale": d ** -0.5}
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do)   # padded where it must be
    calls = {"fwd": lambda: fa._launch_fwd(q, k, v, seg, force=force, **kw),
             "dq": lambda: fa._launch_dq(q, k, v, seg, o, lse, do, force=force, **kw),
             "dkv": lambda: fa._launch_dkv(q, k, v, seg, o, lse, do, delta, force=force, **kw)}
    with pytest.raises(RuntimeError, match="CUDA error"):
        calls[launch]()
