"""Port parity: the torch SimpleTransformer against the flax one.

A flax model is initialised from a seed, its parameters go through
``convert.py`` into the port, and both run the same token batches (made
with numpy) on the CPU. The flax model uses its XLA attention; the port
runs the flash-attention kernel's plain version, which differs only on pad
query rows that no readout reads.

Tolerances: 1e-5 at f32 (the two sides differ only in summation order).
At bf16 compute the two sides round at different places (flax's XLA
softmax runs in bf16, the port's attention in f32 over bf16 inputs); on
these logits of order 0.1 they agree to 5e-3 absolute, about one bf16
rounding of the largest logit (measured: at most 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glearning_benchmark_tpu.models.transformer import (
    SimpleTransformer as FlaxTransformer,
)
from glearning_benchmark_tpu.tokenization.pack import pack_examples
from glearning_benchmark_tpu_torch.convert import (
    load_flax_params,
    params_from_flax,
    params_to_flax,
)
from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

VOCAB, L, Q_ID = 40, 96, 4

# (name, model kwargs, q_token_id)
STYLES = [
    ("ibtt-query", dict(task="shortest_path", use_query_nodes=True, bos_id=1,
                        query_offsets=(2, 3), num_classes=5), Q_ID),
    ("agtt-query", dict(task="shortest_path", use_query_nodes=True, bos_id=0,
                        query_offsets=(1, 2), num_classes=3), Q_ID),
    ("agtt-zinc", dict(task="zinc", use_query_nodes=False, bos_id=0,
                       query_offsets=(1, 2), num_classes=1), None),
]
TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _kwargs(style_kw, compute_dtype, nlayers=2):
    return dict(vocab_size=VOCAB, d_model=16, nhead=4, nlayers=nlayers,
                d_ff=32, p_drop=0.1, max_pos=128, compute_dtype=compute_dtype,
                **style_kw)


def _batch(seed, bos_id, q_id, n=6):
    """Ragged rows starting with <bos>, a '<q> u v' tail on most rows (one
    truncated inside its tail, one without '<q>')."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, L, size=n)
    lens[0] = L
    ids = rng.integers(10, VOCAB, size=(n, L)).astype(np.int32)
    ids[:, 0] = bos_id
    for i, m in enumerate(lens):
        if i == n - 1:
            continue              # no query at all
        q = m - 3 if i != 1 else m - 2   # row 1: v falls past the row end
        ids[i, q] = Q_ID if q_id is not None else 11
    mask = np.arange(L)[None, :] < lens[:, None]
    ids[~mask] = 2
    return ids, mask


def _flax_params(kw, seed=0):
    model = FlaxTransformer(**kw)
    ids = jnp.zeros((2, L), jnp.int32)
    mask = jnp.ones((2, L), bool)
    params = jax.jit(lambda k: model.init(k, ids, mask, q_token_id=Q_ID))(
        jax.random.PRNGKey(seed))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(kw, params):
    model = SimpleTransformer(**kw)
    load_flax_params(model, params)
    return model.eval()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,style,q_id", STYLES, ids=[s[0] for s in STYLES])
def test_logits_match_flax_unpacked(name, style, q_id, compute_dtype):
    kw = _kwargs(style, compute_dtype)
    fmodel, params = _flax_params(kw)
    ids, mask = _batch(1, kw["bos_id"], q_id)
    ref = np.asarray(fmodel.apply({"params": params}, ids, mask,
                                  q_token_id=q_id, deterministic=True))
    with torch.no_grad():
        got = _port(kw, params)(torch.from_numpy(ids), torch.from_numpy(mask),
                                q_token_id=q_id).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL[compute_dtype], rtol=0)


def test_masked_mean_fallback_matches_flax():
    """One row without <bos> flips the whole batch to masked-mean pooling."""
    kw = _kwargs(STYLES[2][1], "float32")
    fmodel, params = _flax_params(kw, seed=3)
    ids, mask = _batch(2, 0, None)
    ids[3, 0] = 12
    ref = np.asarray(fmodel.apply({"params": params}, ids, mask,
                                  deterministic=True))
    with torch.no_grad():
        got = _port(kw, params)(torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,style,q_id", STYLES[1:], ids=[s[0] for s in STYLES[1:]])
def test_logits_match_flax_packed(name, style, q_id, compute_dtype):
    """Packed rows: block-diagonal segments, restarting positions and the
    per-slot readout gathers."""
    kw = _kwargs(style, compute_dtype, nlayers=1)
    fmodel, params = _flax_params(kw, seed=1)
    ids, mask = _batch(4, kw["bos_id"], q_id, n=9)
    seqs = [ids[i, :mask[i].sum()] for i in range(len(ids))]
    pk = pack_examples(seqs, bucket=128, pad_id=2, q_token_id=q_id,
                       query_offsets=kw["query_offsets"])
    assert pk["seg"].max() > 1
    args = dict(seg=pk["seg"], pos=pk["pos"], pos_bos=pk["pos_bos"],
                pos_u=pk["pos_u"], pos_v=pk["pos_v"])
    pmask = pk["seg"] > 0
    ref = np.asarray(fmodel.apply({"params": params}, pk["ids"], pmask,
                                  q_token_id=q_id, deterministic=True, **args))
    with torch.no_grad():
        got = _port(kw, params)(
            torch.from_numpy(pk["ids"]), torch.from_numpy(pmask),
            q_token_id=q_id,
            **{k: torch.from_numpy(v) for k, v in args.items()}).numpy()
    valid = pk["ex_valid"]
    np.testing.assert_allclose(got[valid], ref[valid],
                               atol=TOL[compute_dtype], rtol=0)


def test_convert_round_trip_is_bit_exact():
    kw = _kwargs(STYLES[0][1], "bfloat16")
    model = SimpleTransformer(**kw, generator=torch.Generator().manual_seed(5))
    state = model.state_dict()
    back = params_from_flax(params_to_flax(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # and flax -> port -> flax keeps the flax tree bit for bit
    _, params = _flax_params(kw)
    again = params_to_flax(params_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(again))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path].numpy(), leaf)


def test_port_init_matches_flax_in_distribution():
    """Seeded torch inits follow flax's: std 0.02 cut at 2 std for embed,
    pos and cls; lecun-normal (std 1/sqrt(fan_in), cut at 2 std) for the
    other kernels; zero biases; unit LayerNorm scales."""
    kw = dict(_kwargs(STYLES[0][1], "float32"), d_model=64, d_ff=256)
    model = SimpleTransformer(**kw, generator=torch.Generator().manual_seed(0))
    _, params = _flax_params(kw)
    ours = params_to_flax(model.state_dict())
    for mod in ("embed", "pos"):
        a, b = ours[mod]["embedding"].numpy(), params[mod]["embedding"]
        assert abs(a.std() - b.std()) < 0.1 * b.std()
        assert np.abs(a).max() <= 0.04 + 1e-6
    for name in ("qkv", "out_proj", "ff1", "ff2"):
        a, b = ours["layer_0"][name]["kernel"].numpy(), params["layer_0"][name]["kernel"]
        assert abs(a.std() - b.std()) < 0.1 * b.std(), name
        assert abs(a.std() - 1 / np.sqrt(a.shape[0])) < 0.1 / np.sqrt(a.shape[0])
        assert not ours["layer_0"][name]["bias"].any()
    assert ours["norm"]["scale"].eq(1).all() and not ours["cls"]["bias"].any()
    # the same generator seed gives the same model
    again = SimpleTransformer(**kw, generator=torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# ---------------------------------------------------------------------------
# gradients and dropout (the training slice)
# ---------------------------------------------------------------------------

# gradients of sum(logits * w) with respect to every parameter, dropout off.
# f32: summation order only, 1e-4 absolute on gradients that reach about 20.
# bf16 compute: the two backward passes round at other places (flax's XLA
# softmax runs in bf16, the port's attention in f32 over bf16 inputs), so
# each tensor is held to a relative L2 error of 0.1. Measured against the
# f32 gradient, both sides are off by up to 0.08 (flax) and 0.07 (port),
# and by up to 0.08 from each other (layer_0/qkv/bias, where flax is the
# less accurate side).
GRAD_ATOL = 1e-4
GRAD_REL_L2_BF16 = 0.1


def _flax_grads(fmodel, params, w, *args, **kwargs):
    def loss(p):
        out = fmodel.apply({"params": p}, *args, deterministic=True, **kwargs)
        return jnp.sum(out * w)

    grads = jax.jit(jax.grad(loss))(params)
    return jax.tree_util.tree_map(np.asarray, jax.block_until_ready(grads))


def _port_grads(model, w, *args, **kwargs):
    named = dict(model.state_dict(keep_vars=True))
    out = model(*args, **kwargs)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                list(named.values()))
    return params_to_flax(dict(zip(named, grads)))


def _assert_tree_close(got, ref, compute_dtype):
    from glearning_benchmark_tpu_torch.train.checkpoint import _flatten
    got, ref = _flatten(got), _flatten(ref)
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        g = got[path].numpy()
        if compute_dtype == "float32":
            np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=0, err_msg=path)
        else:
            rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-6)
            assert rel <= GRAD_REL_L2_BF16, (path, rel)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_gradients_match_flax(packed, compute_dtype):
    name, style, q_id = STYLES[1]
    kw = _kwargs(style, compute_dtype)
    fmodel, params = _flax_params(kw, seed=2)
    ids, mask = _batch(5, kw["bos_id"], q_id, n=7)
    rng = np.random.default_rng(0)
    if packed:
        seqs = [ids[i, :mask[i].sum()] for i in range(len(ids))]
        pk = pack_examples(seqs, bucket=128, pad_id=2, q_token_id=q_id,
                           query_offsets=kw["query_offsets"])
        extra = {k: pk[k] for k in ("seg", "pos", "pos_bos", "pos_u", "pos_v")}
        ids, mask = pk["ids"], pk["seg"] > 0
        w = rng.normal(size=pk["ex_valid"].shape + (3,)).astype(np.float32)
        w *= pk["ex_valid"][..., None]
    else:
        extra = {}
        w = rng.normal(size=(len(ids), 3)).astype(np.float32)
    ref = _flax_grads(fmodel, params, w, ids, mask, q_token_id=q_id, **extra)
    port = _port(kw, params).train()          # dropout rates are 0.1 ...
    for layer in port.layers():
        layer.p_attn = layer.p_res = layer.p_ffn = 0.0
    port.has_dropout = False                  # ... and switched off here
    got = _port_grads(port, w, torch.from_numpy(ids), torch.from_numpy(mask),
                      q_token_id=q_id,
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    _assert_tree_close(got, ref, compute_dtype)


def test_remat_gives_the_same_gradients_with_dropout_on():
    """A checkpointed layer is recomputed with the seeds drawn before it
    ran, so remat on and off agree bit for bit, dropout included."""
    name, style, q_id = STYLES[2]
    kw = _kwargs(style, "float32")
    _, params = _flax_params(kw, seed=4)
    ids, mask = _batch(6, kw["bos_id"], q_id)
    w = np.random.default_rng(1).normal(size=(len(ids),)).astype(np.float32)
    grads = []
    for remat in (False, True):
        model = SimpleTransformer(**kw, remat=remat)
        load_flax_params(model, params)
        model.train()
        grads.append(_port_grads(model, w, torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 generator=torch.Generator().manual_seed(3)))
    from glearning_benchmark_tpu_torch.train.checkpoint import _flatten
    a, b = (_flatten(g) for g in grads)
    for path in a:
        assert torch.equal(a[path], b[path]), path


def test_dropout_is_seeded_and_only_in_training():
    name, style, q_id = STYLES[2]
    kw = _kwargs(style, "float32")
    _, params = _flax_params(kw, seed=5)
    ids, mask = (torch.from_numpy(a) for a in _batch(7, kw["bos_id"], q_id))
    model = _port(kw, params)
    with torch.no_grad():
        plain = model(ids, mask)
        assert torch.equal(plain, model(ids, mask))       # eval: deterministic
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(ids, mask)
        a = model(ids, mask, generator=torch.Generator().manual_seed(1))
        b = model(ids, mask, generator=torch.Generator().manual_seed(1))
        c = model(ids, mask, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, plain)
    # the rate split of the reference: attention only, or the other sites only
    only_attn = SimpleTransformer(**kw, mlp_p_drop=0.0)
    assert [(l.p_attn, l.p_res, l.p_ffn) for l in only_attn.layers()] == \
        [(0.1, 0.0, 0.0)] * 2
    split = SimpleTransformer(**kw, attn_p_drop=0.0, resid_p_drop=0.2, ffn_p_drop=0.3)
    assert [(l.p_attn, l.p_res, l.p_ffn) for l in split.layers()] == \
        [(0.0, 0.2, 0.3)] * 2
