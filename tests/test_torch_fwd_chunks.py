"""The bf16 forward's wgmma_chunks design above head dim 256: bf16 head dims
257-512 run through the instances at 320, 384, 448 and 512
(``fa.CHUNKS_WIDE``; zero-padded to the next multiple of ``fa.CHUNK_STEP``,
as the backward's), two warpgroups on 64 query rows each holding a column
half of O, fed by cp.async (any view); bf16 above 512 and f32 above 128
stay on the wide route.

- CPU: the routing (``design``, ``padded_head_dim``) is pinned by
  ``tests/test_torch_fwd_wgmma.py::test_bf16_forward_above_256_takes_the_wide_route``.
- CPU: the forward's padding with the plain version in the kernel's place
  (it sees head dim 320 or 384): at 300 and 330 LSE within 1e-5 of the
  unpadded f32 plain version and the bf16 O within one bf16 rounding of it
  (rtol 4e-3, atol 1e-5), dropout on.
- CPU: the port's plain forward at head dims 320 and 512 (f32, [2, 40, 2,
  D], two segments and a pad tail, no dropout) against the JAX package's
  plain ``multi_head_attention`` (no Pallas call): O within 1e-5 absolute
  (the two differ in summation order).
- CPU: the forward's cancelling sum (``tests/test_torch_fwd_wgmma.py``) at
  320, 384, 448 and 512: P~ split into two bf16 terms misses the
  elementwise bound by more than 2x, three terms hold it.
- On the card (``cuda`` marker, skipped here): the kernel against the plain
  version at [3, 300, 2, D], D 257, 300, 320, 384, 448 and 512 (fused-qkv
  views, 300 rows: a partial last key tile and a fully padded last query
  tile), p 0 and 26/256, ``bh_offset`` 6, pad rows zero, O and LSE bits
  equal on a second run; a view off the 16-byte grid at 320 and 512 takes
  the same design (plain loads) and matches; the cancelling sum against
  the f64 version.
"""

import numpy as np
import pytest
import torch
from test_torch_fwd_wgmma import (ATOL, BF16_RTOL, FWD, TRAIN_RATE, _card, _card_inputs,
                                  _check_card, _needs_three_terms, _probs_f64, _worst,
                                  fwd_cancelling_case)

from glearning_benchmark_tpu_torch.ops import flash_attention as fa

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

CANCEL_SEEDS = {320: 5, 384: 4, 448: 3, 512: 3}   # the cancelling-sum cases, by head dim


def _inputs(b, l, h, d, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32))
               .to(dtype) for _ in range(3))
    seg = np.zeros((b, l), np.int32)
    seg[0, : l // 3], seg[0, l // 3: l - 5] = 1, 2     # two segments and a pad tail
    seg[1, :] = 1
    return q, k, v, torch.from_numpy(seg)


@pytest.mark.parametrize("d,padded", [(300, 320), (330, 384)])
def test_forward_padding_to_the_chunk_instances_equals_unpadded_plain_version(d, padded):
    q, k, v, seg = _inputs(2, 40, 2, d, seed=d)
    kw = dict(p_drop=0.1, seed=7, bh_offset=2)
    o, lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), seg, **kw)
    seen = []

    def plain(*args, **kwargs):
        seen.append(args[0].shape[-1])
        return fa.flash_attention_reference(*args, **kwargs)

    po, plse = fa.pad_head_dim(plain, q, k, v, seg, name=FWD, **kw)
    assert seen == [padded] and po.shape == o.shape and po.dtype == torch.bfloat16
    assert ((po.float() - o).abs() <= BF16_RTOL * o.abs() + ATOL).all()
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [320, 512])
def test_plain_forward_matches_jax_plain_attention(d):
    """The port's forward on CPU tensors (its plain version) against the
    JAX package's plain attention, f32, no dropout."""
    # JAX is imported here: the card's machine runs this file's cuda tests
    # without it
    import jax.numpy as jnp

    from glearning_benchmark_tpu.ops.attention import multi_head_attention

    q, k, v, seg = _inputs(2, 40, 2, d, seed=d, dtype=torch.float32)
    ref = multi_head_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               seg=jnp.asarray(seg.numpy()))
    o, _ = fa.flash_attention_fwd(q, k, v, seg)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", sorted(CANCEL_SEEDS))
def test_forward_cancelling_sum_above_256_needs_three_split_terms(d):
    _needs_three_terms(d, CANCEL_SEEDS[d])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, TRAIN_RATE])
@pytest.mark.parametrize("d", [257, 300, 320, 384, 448, 512])
def test_wgmma_chunks_forward_matches_plain(d, p_drop):
    _card()
    q, k, v, seg = _card_inputs(d, 0, seed=d)
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == "wgmma_chunks"
    _check_card(q, k, v, seg, p_drop, bh_offset=6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 512])
def test_views_off_the_grid_run_wgmma_chunks(d):
    """A view TMA cannot read (2 bytes off the 16-byte grid) runs the same
    design, staged by plain loads, and is not counted as refused."""
    _card()
    q, k, v, seg = _card_inputs(d, 1, seed=d + 1)
    assert not fa.tma_ok(q, k, v)
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == "wgmma_chunks"
    fa.reset_launches()
    _check_card(q, k, v, seg, TRAIN_RATE, bh_offset=6)
    assert fa.TMA_REFUSED[FWD] == 0 and fa.LAUNCHES[FWD] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", sorted(CANCEL_SEEDS))
def test_forward_cancelling_sum_above_256_holds_on_the_card(d):
    _card()
    q, k, v, seg = (t.cuda() for t in fwd_cancelling_case(d, CANCEL_SEEDS[d]))
    assert fa.design(FWD, d, q.dtype, fa.tma_ok(q, k, v)) == "wgmma_chunks"
    o, _ = fa.flash_attention_fwd(q, k, v, seg)
    ref = torch.einsum("bhls,bshd->blhd", _probs_f64(q, k, seg), v.double())
    torch.cuda.synchronize()
    assert _worst(o, ref) <= 1.0
