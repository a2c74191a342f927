"""Port parity: the counter-hash dropout against the JAX package, CPU.

``hash_keep_mask`` is bit-equal to the JAX one for the same u32 seed, over
seeds, rates and shapes (last axes that are not multiples of 4 included);
``cheap_dropout`` gives equal outputs (exactly: one f32 division);
``multi_head_attention`` with attention-probability dropout matches the
JAX one given the same seed, atol 1e-6 at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.ops import attention as jax_attn
from glearning_benchmark_tpu_torch.ops import attention as attn

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

SHAPES = [(7,), (3, 5), (2, 4, 16), (2, 3, 13), (2, 2, 9, 10), (1, 1, 1)]
SEEDS = [0, 1, 12345, 2**31 - 2, 2**32 - 1]


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_hash_keep_mask_is_bit_equal(shape, rate):
    for seed in SEEDS:
        ref, p_ref = jax_attn.hash_keep_mask(jnp.uint32(seed), shape, rate)
        got, p_got = attn.hash_keep_mask(seed, shape, rate)
        assert p_got == p_ref == round(rate * 256) / 256
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hash_keep_mask_rate_edges():
    keep, p = attn.hash_keep_mask(3, (4, 8), 0.001)      # rounds to 0/256
    assert keep.all() and p == 0.0
    with pytest.raises(ValueError, match="256"):
        attn.hash_keep_mask(3, (4, 8), 0.999)            # would need 256 in a u8
    keep, p = attn.hash_keep_mask(3, (64, 64), 255 / 256)
    assert p == 255 / 256 and 0 < keep.float().mean() < 0.02


def _jax_cheap_dropout(seed, x, rate):
    """``cheap_dropout`` of the JAX package with its seed word given (it
    draws that word from a key; everything after is reproduced here from
    its own ``hash_keep_mask``)."""
    keep, p_eff = jax_attn.hash_keep_mask(jnp.uint32(seed), x.shape, rate)
    return jnp.where(keep, x / (1.0 - p_eff), jnp.zeros((), x.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cheap_dropout_outputs_equal(dtype):
    x = np.random.default_rng(0).normal(size=(3, 17, 10)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    for seed, rate in ((5, 0.1), (2**32 - 1, 0.5)):
        ref = np.asarray(_jax_cheap_dropout(seed, xj, rate).astype(jnp.float32))
        got = attn.cheap_dropout(seed, xt, rate)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(got.float().numpy(), ref)
    assert attn.cheap_dropout(5, xt, 0.0) is xt


def test_attention_prob_dropout_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 33, 2, 8)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 33), bool)
    mask[1, 20:] = False
    seed, rate = 777, 0.2
    # the JAX function draws its seed word from a key; apply its own mask
    # generator to its undropped probabilities instead
    scale = 1.0 / np.sqrt(np.float32(8))
    logits = jnp.einsum("blhd,bshd->bhls", q, k) * scale
    logits = jnp.where(mask[:, None, None, :], logits, jnp.finfo(jnp.float32).min)
    probs = jnp.where(mask[:, None, None, :],
                      jnp.exp(logits - logits.max(-1, keepdims=True))
                      / jnp.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True),
                      0.0)
    keep, p_eff = jax_attn.hash_keep_mask(jnp.uint32(seed), probs.shape, rate)
    ref = np.asarray(jnp.einsum("bhls,bshd->blhd",
                                jnp.where(keep, probs / (1.0 - p_eff), 0.0), v))
    got = attn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=torch.from_numpy(mask), dropout_rate=rate, dropout_seed=seed)
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], atol=1e-6, rtol=0)
    plain = attn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=torch.from_numpy(mask))
    assert not torch.equal(got, plain)
