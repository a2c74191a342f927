"""The bf16 dQ and dK/dV kernels' wgmma designs above head dim 128: bf16
head dims 129-256 run through the instance at 256 (``fa.WGMMA_WIDE``,
zero-padded, as the forward's), 257-512 through the ``wgmma_chunks``
instances at 320, 384, 448 and 512 (``fa.CHUNKS_WIDE``; zero-padded to the
next multiple of ``fa.CHUNK_STEP``; each warpgroup holds a column half of
its block's outputs), f32 above 128 and bf16 above 512 stay on the wide
route.

- CPU: ``design`` is "wgmma" for both backward kernels at bf16 head dims
  129, 160, 200, 255 and 256, each at padded head dim 256; "wgmma_chunks"
  at 257, 300, 320, 383, 384, 385, 448, 449 and 512 (padded to the next
  multiple of 64); "wide" at bf16 513 and 640 (unpadded) and in f32 from
  128.
- CPU: the backward's padding, with the plain version in the kernel's
  place (it sees head dim 256, 320, 384 or 512, bf16 inputs, computing in
  f32): dQ, dK and dV at head dims 160, 200, 257, 300, 330 and 500 equal
  the unpadded
  plain version on the same bf16 values within 1e-5 (the padded einsums
  sum zeros in another order).
- CPU: the port's plain backward at head dim 320 (dropout off, f32, [2, 24,
  2, 320], two segments and a pad tail) against the gradient of the JAX
  package's plain attention (``ops/attention.multi_head_attention``, no
  Pallas call): dQ, dK, dV within 1e-5 absolute (f32; the two differ in
  summation order).
- CPU: the cancelling-sum case of ``tests/test_torch_wide_heads.py`` at
  head dims 256, 320, 384, 448 and 512 (dV[key 0, col 0] cancels to
  about 1e-4 of
  its terms): the kernels' split of P~ emulated in plain torch against an
  f64 version, two bf16 terms miss the elementwise bound rtol 4e-3 + atol
  1e-5 (by more than 2x), three hold it (within 0.25 of it).
- On the card (``cuda`` marker, skipped here), the tolerances of
  ``tests/test_torch_attention_bwd.py``: the three kernels at [3, 300, 2,
  D], D 160, 200, 256, 257, 320, 384, 448 and 512 (packed segments, a pad
  tail, a
  partial last tile), q, k, v views of one fused qkv and a transposed dO,
  p 0 and 26/256, ``bh_offset`` 6, against the plain version, pad rows
  zero, dQ, dK and dV bit-equal on a second run; the cancelling sum at
  256, 320, 384, 448 and 512 against the f64 version.
"""

import pytest
import torch
from test_torch_wide_heads import (RTOL, TRAIN_RATE, _bwd_f64, _card, _check_all,
                                   _probs_f64, _split, _worst, cancelling_case)

from glearning_benchmark_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

BWD = fa.BWD_SOURCES
CANCEL_SEED = 1      # the cancelling-sum case at head dim 256
CHUNK_CANCEL_SEEDS = {320: 1, 384: 3, 448: 1, 512: 7}   # ... and at the wgmma_chunks instances


@pytest.mark.parametrize("d", [129, 160, 200, 255, 256])
def test_bf16_backward_runs_wgmma_at_256(d):
    for name in BWD:
        assert fa.padded_head_dim(d, name, torch.bfloat16) == fa.WGMMA_WIDE
        assert fa.design(name, d, torch.bfloat16) == "wgmma"
        assert fa.design(name, d, torch.bfloat16, tma=False) == "wgmma"   # cp.async: any view


@pytest.mark.parametrize("d", [257, 300, 320, 383, 384, 385, 448, 449, 512, 513, 640])
def test_bf16_backward_above_256_stays_wide(d):
    """Above 256 the bf16 backward stays on wgmma up to ``fa.CHUNKS_WIDE``
    (the wgmma_chunks design, padded to the next multiple of 64) and on the
    wide route, unpadded, above it; so does the forward."""
    chunks = d <= fa.CHUNKS_WIDE
    for name in BWD:
        assert fa.padded_head_dim(d, name, torch.bfloat16) == (
            -(-d // 64) * 64 if chunks else d)
        for tma in (True, False):                   # cp.async: any view
            assert fa.design(name, d, torch.bfloat16, tma=tma) == (
                "wgmma_chunks" if chunks else "wide")
    assert fa.padded_head_dim(d, "flash_attn_fwd", torch.bfloat16) == (
        -(-d // 64) * 64 if chunks else d)
    assert fa.design("flash_attn_fwd", d, torch.bfloat16) == (
        "wgmma_chunks" if chunks else "wide")


@pytest.mark.parametrize("d", [128, 160, 256, 320])
def test_f32_backward_stays_wide(d):
    for name in BWD:
        assert fa.padded_head_dim(d, name, torch.float32) == d
        assert fa.design(name, d, torch.float32) == "wide"


def _inputs(d, seed, b=2, l=40, h=3):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, l, h, d, generator=gen).bfloat16() for _ in range(4))
    seg = torch.zeros(b, l, dtype=torch.int32)
    seg[0, :15], seg[0, 15:33] = 1, 2      # two segments and a pad tail
    seg[1, :] = 1
    return q, k, v, do, seg


def _padding_equals_unpadded(d, padded):
    """The backward's padding of each kernel with the plain version in the
    kernel's place: it sees head dim ``padded``, and dQ, dK, dV equal the
    unpadded plain version's."""
    q, k, v, do, seg = _inputs(d, seed=d)
    kw = dict(p_drop=0.1, seed=7, bh_offset=2)
    o, lse = fa.flash_attention_reference(q, k, v, seg, **kw)
    ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg, o.float(),
                                           lse, do.float(), **kw)
    seen = []

    def plain(q, k, v, seg, o, lse, do, **kwargs):
        seen.append(q.shape[-1])
        return fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg,
                                                o.float(), lse, do.float(), **kwargs)

    for name in BWD:
        got = fa.pad_head_dim(plain, q, k, v, seg, o, lse, do, name=name, **kw)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    assert seen == [padded] * len(BWD)


@pytest.mark.parametrize("d", [160, 200])
def test_backward_padding_to_256_equals_unpadded_plain_version(d):
    _padding_equals_unpadded(d, fa.WGMMA_WIDE)


@pytest.mark.parametrize("d,padded", [(257, 320), (300, 320), (330, 384), (500, 512)])
def test_backward_padding_to_the_chunk_instances_equals_unpadded_plain_version(d, padded):
    _padding_equals_unpadded(d, padded)


def test_plain_backward_matches_jax_plain_attention_at_320():
    """The port's backward on CPU tensors (its plain version, through
    ``fa.flash_attention``'s autograd) against ``jax.grad`` of the JAX
    package's plain attention, f32, no dropout."""
    # JAX is imported here: the card's machine runs this file's cuda tests
    # without it
    import jax
    import jax.numpy as jnp
    import numpy as np

    from glearning_benchmark_tpu.ops.attention import multi_head_attention

    b, l, h, d = 2, 24, 2, 320
    rng = np.random.default_rng(320)
    q, k, v, w = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))
    seg = np.zeros((b, l), np.int32)
    seg[0, :9], seg[0, 9:20] = 1, 2        # two segments and a pad tail
    seg[1, :] = 1
    segj, wj = jnp.asarray(seg), jnp.asarray(w)
    ref = jax.grad(lambda q, k, v: jnp.sum(multi_head_attention(q, k, v, seg=segj) * wj),
                   argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, seg=torch.from_numpy(seg))
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(w))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


def _split_terms_needed(d, seed):
    """The cancelling-sum case at head dim ``d``: the kernels' split of P~
    in plain torch against the f64 dV of its first column; two bf16 terms
    miss the elementwise bound, three hold it."""
    q, k, v, do, seg = cancelling_case(d, seed)
    _, lse = fa.flash_attention_reference(q, k, v, seg)
    p = _probs_f64(q, k, lse)[:, 0].float()                    # [b, q, key]
    ref = torch.einsum("bqk,bqd->bkd", p.double(), do[:, :, 0].double())
    assert ref[:, 0, 0].abs().max().item() < 2e-3 * 16         # it cancels
    got = {n: torch.einsum("bqk,bqd->bkd", _split(p, n), do[:, :, 0].float())
           for n in (2, 3)}
    assert _worst(got[2], ref, RTOL["bfloat16"]) > 2.0         # hi + lo misses
    assert _worst(got[3], ref, RTOL["bfloat16"]) < 0.25        # hi + mid + lo holds


@pytest.mark.parametrize("d", sorted(CHUNK_CANCEL_SEEDS))
def test_cancelling_sum_above_256_needs_three_split_terms(d):
    _split_terms_needed(d, CHUNK_CANCEL_SEEDS[d])


def test_cancelling_sum_at_256_needs_three_split_terms():
    _split_terms_needed(fa.WGMMA_WIDE, CANCEL_SEED)


def _cancelling_sum_on_the_card(d, seed):
    """The kernels on the cancelling-sum case against the f64 version with
    their own O and LSE."""
    _card()
    q, k, v, do, seg = (t.cuda() for t in cancelling_case(d, seed))
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    got = fa.flash_attention_bwd(q, k, v, seg, o, lse, do)
    refs = _bwd_f64(q, k, v, seg, o, lse, do)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert _worst(g, r, RTOL["bfloat16"]) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
@pytest.mark.parametrize("d", [160, 200, 256])
def test_backward_wgmma_at_256_matches_plain(d, p_drop):
    _check_all(d, "bfloat16", p_drop, bh_offset=6, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
@pytest.mark.parametrize("d", [257, 320, 384, 448, 512])
def test_backward_wgmma_chunks_match_plain(d, p_drop):
    """The wgmma_chunks instances at 320 (257 zero-padded to it), 384,
    448 and 512 (16-row tiles)."""
    assert fa.design("flash_attn_bwd_dq", d, torch.bfloat16) == "wgmma_chunks"
    _check_all(d, "bfloat16", p_drop, bh_offset=6, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", sorted(CHUNK_CANCEL_SEEDS))
def test_cancelling_sum_above_256_holds_on_the_card(d):
    _cancelling_sum_on_the_card(d, CHUNK_CANCEL_SEEDS[d])


@pytest.mark.cuda
def test_cancelling_sum_at_256_holds_on_the_card():
    _cancelling_sum_on_the_card(fa.WGMMA_WIDE, CANCEL_SEED)
