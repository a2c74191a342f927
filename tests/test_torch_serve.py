"""Port parity: serving.

A flax SimpleTransformer is initialised at small width and saved with the
JAX package's ``save_checkpoint`` plus a ``serve`` block; the JAX
``Predictor`` and the port's ``Predictor`` (``device="cpu"``) then predict
the same stand-in ZINC graphs, AGTT and IBTT, in batches that cross a
bucket boundary. Tolerance 1e-5 at f32 compute; 5e-3 at bf16 compute
(see test_torch_transformer.py). Also: checkpoint dtype rules, the
default device, the prediction CLI, and ``chip_smoke.py``'s model literals.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glearning_benchmark_tpu.data.zinc import load_zinc_split, save_zinc_npz
from glearning_benchmark_tpu.models.transformer import SimpleTransformer
from glearning_benchmark_tpu.serve import Predictor as JaxPredictor
from glearning_benchmark_tpu.tokenization.ibtt import tokenize_zinc_molecule
from glearning_benchmark_tpu.tokenization.vocab import (
    build_fixed_zinc_vocab,
    collect_dynamic_tokens,
    extend_vocab_with_dynamic_tokens,
)
from glearning_benchmark_tpu.train import checkpoint as jax_ckpt
from glearning_benchmark_tpu_torch import serve as port_serve
from glearning_benchmark_tpu_torch.serve import Predictor
from glearning_benchmark_tpu_torch.train import checkpoint as port_ckpt

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 256
N_GRAPHS = 21          # max_batch 8: buckets 8, 8 and 5 -> 8
TOL = {"float32": 1e-5, "bfloat16": 5e-3}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    return list(load_zinc_split(str(tmp_path_factory.mktemp("z")), "val",
                                limit=N_GRAPHS))


def _serve_block(model_name, graphs):
    fixed = build_fixed_zinc_vocab()[0]
    max_nodes = max(g.num_nodes for g in graphs)
    if model_name == "agtt":
        vocab = None
        vocab_size = len(fixed) + max_nodes + 100
        meta = {"max_len": MAX_LEN, "pad_id": fixed["<pad>"], "idx_offset": 6,
                "bos_id": fixed["<bos>"], "max_nodes": max_nodes}
    else:
        texts = [tokenize_zinc_molecule(g, max_len=MAX_LEN) for g in graphs]
        vocab = extend_vocab_with_dynamic_tokens(
            fixed, collect_dynamic_tokens(texts, fixed))
        vocab_size = len(vocab)
        meta = {"max_len": MAX_LEN, "pad_id": vocab["<pad>"]}
    serve = {"model_name": model_name, "task": "zinc", "kind": "tokens",
             "num_classes": 1, "vocab_size": vocab_size, "q_token_id": None,
             "in_dim": 1, "meta": meta}
    return serve, vocab


def _jax_checkpoint(path, model_name, graphs, compute_dtype, seed=0):
    serve, vocab = _serve_block(model_name, graphs)
    cfg = {"model": {"d_model": 16, "nhead": 4, "nlayers": 2, "d_ff": 32,
                     "dropout": 0.1, "max_pos": MAX_LEN,
                     "compute_dtype": compute_dtype}}
    model = SimpleTransformer(
        vocab_size=serve["vocab_size"], d_model=16, nhead=4, nlayers=2,
        d_ff=32, max_pos=MAX_LEN, num_classes=1, use_query_nodes=False,
        task="zinc", compute_dtype=compute_dtype)
    ids = jnp.zeros((1, MAX_LEN), jnp.int32)
    params = jax.jit(lambda k: model.init(k, ids, ids > -1))(
        jax.random.PRNGKey(seed))["params"]
    jax_ckpt.save_checkpoint(path, {"params": params, "config": cfg,
                                    "vocab": vocab, "serve": serve})
    return path


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["agtt", "ibtt"])
def test_predictions_match_jax_predictor(tmp_path, graphs, model_name,
                                         compute_dtype):
    path = _jax_checkpoint(str(tmp_path / "best"), model_name, graphs,
                           compute_dtype)
    ref = JaxPredictor.from_checkpoint(path, max_batch=8).predict_graphs(graphs)
    port = Predictor.from_checkpoint(path, max_batch=8, device="cpu")
    got = port.predict_graphs(graphs)
    assert got["pred"].shape == (N_GRAPHS,) and got["pred"].dtype == np.float32
    np.testing.assert_allclose(got["pred"], ref["pred"],
                               atol=TOL[compute_dtype], rtol=0)
    # request batching does not change the answers
    chunks = [port.predict_graphs(graphs[i:i + 5])["pred"]
              for i in range(0, N_GRAPHS, 5)]
    np.testing.assert_allclose(np.concatenate(chunks), got["pred"],
                               atol=1e-6, rtol=0)
    assert sorted(port.warmup([1, 3, 8])) == [1, 4, 8]


def _synthetic_records(n=13):
    from glearning_benchmark_tpu.data.text_grammar import graph_to_text
    rng = np.random.default_rng(7)
    recs = []
    for i in range(n):
        nodes = int(rng.integers(4, 12))
        edges = np.stack([np.arange(nodes - 1), np.arange(1, nodes)], 1)
        recs.append({"text": graph_to_text(
            edges, nodes, f"shortest_distance 0 {nodes - 1}",
            f"len{1 + i % 4}"), "label": None})
    return recs


@pytest.mark.parametrize("model_name", ["agtt", "ibtt"])
def test_predict_records_synthetic_matches_jax(tmp_path, model_name):
    """Query-task records (shortest_path): the '<q>' readout and the
    class outputs of predict_records agree with the JAX Predictor."""
    from glearning_benchmark_tpu.serve import predict_records as jax_records
    from glearning_benchmark_tpu.tokenization.vocab import build_vocab_from_texts
    from glearning_benchmark_tpu_torch.serve import predict_records

    recs = _synthetic_records()
    if model_name == "agtt":
        max_nodes = 12
        vocab, q_id, bos_id, offsets = None, 6 + max_nodes, 0, (1, 2)
        vocab_size = 6 + max_nodes + 1
        meta = {"max_len": 64, "pad_id": 5, "idx_offset": 6, "bos_id": 0,
                "max_nodes": max_nodes}
    else:
        vocab, _ = build_vocab_from_texts([r["text"] for r in recs])
        q_id, bos_id, offsets = vocab["<q>"], vocab["<bos>"], (2, 3)
        vocab_size = len(vocab)
        meta = {"max_len": 64, "pad_id": vocab["<pad>"]}
    serve = {"model_name": model_name, "task": "shortest_path",
             "kind": "tokens", "num_classes": 4, "vocab_size": vocab_size,
             "q_token_id": q_id, "in_dim": 1, "meta": meta}
    cfg = {"model": {"d_model": 16, "nhead": 4, "nlayers": 1, "d_ff": 32,
                     "max_pos": 64, "compute_dtype": "float32"}}
    model = SimpleTransformer(
        vocab_size=vocab_size, d_model=16, nhead=4, nlayers=1, d_ff=32,
        max_pos=64, num_classes=4, use_query_nodes=True,
        task="shortest_path", bos_id=bos_id, query_offsets=offsets)
    ids = jnp.zeros((1, 64), jnp.int32)
    params = jax.jit(lambda k: model.init(k, ids, ids > -1, q_token_id=q_id))(
        jax.random.PRNGKey(2))["params"]
    path = str(tmp_path / "best")
    jax_ckpt.save_checkpoint(path, {"params": params, "config": cfg,
                                    "vocab": vocab, "serve": serve})
    ref = jax_records(JaxPredictor.from_checkpoint(path, max_batch=8), recs)
    got = predict_records(Predictor.from_checkpoint(path, max_batch=8,
                                                    device="cpu"), recs)
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    np.testing.assert_allclose(got["prob"], ref["prob"], atol=1e-5, rtol=0)


def test_predict_texts_matches_graph_path(tmp_path, graphs):
    path = _jax_checkpoint(str(tmp_path / "best"), "ibtt", graphs, "float32")
    port = Predictor.from_checkpoint(path, max_batch=8, device="cpu")
    texts = [tokenize_zinc_molecule(g, max_len=MAX_LEN) for g in graphs[:6]]
    a = port.predict_texts(texts)["pred"]
    b = port.predict_graphs(graphs[:6])["pred"]
    np.testing.assert_array_equal(a, b)


def test_bf16_leaf_round_trips_without_ml_dtypes(tmp_path, monkeypatch):
    import ml_dtypes

    t = torch.randn(5, 3).to(torch.bfloat16)
    ref = np.asarray(jnp.asarray(np.random.default_rng(0).normal(size=(4,)),
                                 jnp.bfloat16))
    port_ckpt.save_checkpoint(str(tmp_path / "a"), {"params": {"w": t}})
    jax_ckpt.save_checkpoint(str(tmp_path / "b"), {"params": {"w": ref}})
    # the JAX reader takes the port's bf16 leaf back bit for bit
    back = jax_ckpt.load_checkpoint(str(tmp_path / "a"))["params"]["w"]
    assert back.dtype == ml_dtypes.bfloat16
    assert back.view(np.uint16).tobytes() == t.view(torch.int16).numpy().tobytes()
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import now fails
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401,F811
    a = port_ckpt.load_checkpoint(str(tmp_path / "a"))["params"]["w"]
    assert a.dtype == torch.bfloat16 and torch.equal(a, t)
    b = port_ckpt.load_checkpoint(str(tmp_path / "b"))["params"]["w"]
    assert b.dtype == torch.bfloat16
    assert b.view(torch.int16).numpy().tobytes() == ref.view(np.uint16).tobytes()


def test_uint_leaf_without_sidecar_is_refused(tmp_path, graphs):
    """A bf16 leaf whose .json sidecar entry was lost comes back as raw
    uint16; meeting a float parameter it is refused, never cast. A dtype
    name the reader does not know is refused too."""
    path = _jax_checkpoint(str(tmp_path / "best"), "agtt", graphs, "float32")
    ckpt = jax_ckpt.load_checkpoint(path)
    ckpt["params"]["cls"]["kernel"] = np.asarray(
        jnp.asarray(ckpt["params"]["cls"]["kernel"], jnp.bfloat16))
    jax_ckpt.save_checkpoint(path, ckpt)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta.pop("ext_dtypes") == {"params/cls/kernel": "bfloat16"}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    assert port_ckpt.load_checkpoint(path)["params"]["cls"]["kernel"].dtype \
        == torch.uint16
    with pytest.raises(TypeError, match="refusing to cast"):
        Predictor.from_checkpoint(path, device="cpu")
    meta["ext_dtypes"] = {"params/cls/kernel": "float8_e4m3"}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="does not restore"):
        port_ckpt.load_checkpoint(path)


def test_default_device_raises_without_cuda(tmp_path, graphs, monkeypatch):
    path = _jax_checkpoint(str(tmp_path / "best"), "agtt", graphs, "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.resolve_device("cuda")
    assert port_serve.resolve_device("cpu").type == "cpu"


def test_predict_cli_on_cpu(tmp_path, graphs):
    path = _jax_checkpoint(str(tmp_path / "best"), "agtt", graphs, "float32")
    root = tmp_path / "zinc"
    root.mkdir()
    save_zinc_npz(str(root / "zinc_val.npz"), graphs)
    ref = JaxPredictor.from_checkpoint(path).predict_graphs(graphs)["pred"]
    out = subprocess.run(
        [sys.executable, "-m", "glearning_benchmark_tpu_torch.predict",
         "--checkpoint", path + ".npz", "--zinc-split", "val",
         "--zinc-root", str(root), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["index"] for r in rows] == list(range(N_GRAPHS))
    np.testing.assert_allclose([r["pred"] for r in rows], ref, atol=1e-5)


def test_chip_smoke_model_literals_match_configs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, literal in (("agtt_zinc", mod.AGTT_ZINC_MODEL),
                          ("ibtt_zinc", mod.IBTT_ZINC_MODEL)):
        with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        assert literal == cfg["model"], name
        # the training literals hold for both configs (zinc_root, pack,
        # epochs and the output names are set by the script)
        assert mod.ZINC_DATASET.items() <= cfg["dataset"].items(), name
        assert mod.ZINC_TRAIN.items() <= cfg["train"].items(), name
    with open(os.path.join(REPO, "configs", "agtt_zinc.yaml")) as f:
        assert yaml.safe_load(f)["dataset"]["pack"] is True
