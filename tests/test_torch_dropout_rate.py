"""The rate at which the token models drop attention probabilities. The
JAX package's default attention (``model.use_flash`` false or unset) is XLA
attention with ``hash_keep_mask``, whose rate is round(p * 256) / 256 (26/256
at the configs' p = 0.1); with ``use_flash: true`` its Pallas kernel drops at
the exact p. The port hands its attention kernel the same rate: each test
holds it against the JAX package's own functions."""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import pytest
import torch

from glearning_benchmark_tpu.ops import attention as jax_attention
from glearning_benchmark_tpu.ops import pallas_attention as jax_pallas
from glearning_benchmark_tpu_torch.models import transformer
from glearning_benchmark_tpu_torch.ops import flash_attention as port_flash
from glearning_benchmark_tpu_torch.ops.flash_attention import dropout_keep_reference
from glearning_benchmark_tpu_torch.train.datasets import DatasetBundle
from glearning_benchmark_tpu_torch.train.trainer import attention_dropout_rate, build_model
from glearning_benchmark_tpu_torch.utils.config import load_config, normalize_config

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOKEN_CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml")
                       if p.name.split("_")[0] in ("ibtt", "agtt"))
# 1/512 and 3/512 fall on a .5 boundary of p * 256 (round half to even
# gives 0 and 2); 1/512 is dropped altogether by the XLA path
RATES = [0.0, 1 / 512, 3 / 512, 0.05, 0.1, 0.3]


def jax_rate(p: float, use_flash: bool) -> float:
    """The rate the JAX package's attention drops at: the effective rate
    ``hash_keep_mask`` returns (XLA path, 0 where it skips dropout), or p
    itself, which the Pallas kernel takes as it is."""
    if use_flash:
        return p
    return jax_attention.hash_keep_mask(jnp.uint32(0), (1, 4), p)[1]


def _model(name: str, use_flash, p=None):
    config = normalize_config(load_config(str(REPO / "configs" / name)))
    config["model"].pop("use_flash", None)
    if use_flash is not None:
        config["model"]["use_flash"] = use_flash
    if p is not None:
        config["model"]["dropout"] = p
    task = config["dataset"]["task"]
    bundle = DatasetBundle(task=task, kind="tokens", splits={},
                           num_classes=1 if task == "zinc" else 2, vocab={"<bos>": 0},
                           vocab_size=40, meta={"max_len": 64, "bos_id": 0})
    return config, build_model(name.split("_")[0], config, bundle,
                               generator=torch.Generator().manual_seed(0))


def test_every_token_config_is_covered():
    assert TOKEN_CONFIGS == ["agtt_graph_token.yaml", "agtt_zinc.yaml",
                             "ibtt_graph_token.yaml", "ibtt_zinc.yaml"]


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("p", RATES)
def test_rate_equals_the_jax_packages(p, use_flash):
    """The rate, and the kernel's keep threshold, equal the JAX path's: a
    byte threshold of round(p*256) is a u32 threshold of that times 2**24."""
    want = jax_rate(p, use_flash)
    got = attention_dropout_rate(p, use_flash)
    assert got == want
    if use_flash:
        assert port_flash._keep_threshold(got) == int(jax_pallas._keep_threshold(p))
    else:
        assert port_flash._keep_threshold(got) == round(want * 256) << 24
    for layer in _model("agtt_zinc.yaml", use_flash, p)[1].layers():
        assert layer.p_attn == want


@pytest.mark.parametrize("use_flash", [None, False, True])
@pytest.mark.parametrize("name", TOKEN_CONFIGS)
def test_attention_rate_of_each_config(name, use_flash):
    config, model = _model(name, use_flash)
    p = float(config["model"]["dropout"])
    assert p == 0.1
    want = jax_rate(p, bool(use_flash))
    assert want == (p if use_flash else 26 / 256)
    for layer in model.layers():
        assert layer.p_attn == want
        # the residual and FFN sites keep the configured rate (quantised
        # inside cheap_dropout, as in the JAX package)
        assert layer.p_res == layer.p_ffn == p


@pytest.mark.parametrize("use_flash", [False, True])
def test_the_rate_reaches_the_attention_kernel(monkeypatch, use_flash):
    """A training forward hands flash_attention the config's rate."""
    _, model = _model("agtt_zinc.yaml", use_flash)
    seen = []
    real = transformer.flash_attention

    def spy(*args, p_drop=0.0, **kw):
        seen.append(p_drop)
        return real(*args, p_drop=p_drop, **kw)

    monkeypatch.setattr(transformer, "flash_attention", spy)
    model.train()
    ids = torch.randint(0, 40, (2, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 16, dtype=torch.bool)
    model(ids, mask, generator=torch.Generator().manual_seed(2))
    assert seen == [jax_rate(0.1, use_flash)] * len(model.layers())


def test_keep_mask_at_the_quantised_rate():
    """The kernel's plain keep mask at p = 26/256 keeps 230/256 of a large
    tensor, within 3 sigma."""
    keep = dropout_keep_reference(seed=17, bh=8, n_rows=512, n_cols=512, p_drop=26 / 256)
    n = keep.numel()
    p_keep = 230 / 256
    sigma = math.sqrt(p_keep * (1 - p_keep) / n)
    frac = keep.double().mean().item()
    assert abs(frac - p_keep) < 3 * sigma, (frac, p_keep, sigma)
    # the JAX package's XLA keep mask at the configs' p = 0.1 keeps the same share
    jax_keep = jax_attention.hash_keep_mask(jnp.uint32(17), (8, 512, 512), 0.1)[0]
    assert abs(float(jax_keep.mean()) - p_keep) < 3 * sigma
    # the exact-rate mask (p = 0.1, the use_flash rate) keeps a share that
    # this test tells apart
    exact = dropout_keep_reference(seed=17, bh=8, n_rows=512, n_cols=512, p_drop=0.1)
    assert abs(exact.double().mean().item() - p_keep) > 3 * sigma


def test_chip_smoke_checks_the_kernels_at_the_training_rate():
    """``chip_smoke.py`` holds the kernels against their plain versions at
    the rate the training path hands them."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.train_rate() == jax_rate(0.1, False) == 26 / 256
