"""The port's measurement tools on the CPU, against the JAX package where it
has the same function:

- ``bench``: the pipeline on the first 300 stand-in ZINC graphs gives the
  vocab, ids, lens and packed rows of the JAX package's functions, byte for
  byte, and the last line has the root ``bench.py``'s keys;
- ``mfu_bench.analytic_train_flops`` over the port's parameters equals the
  root ``tools/mfu_bench.py``'s count over the same model's flax parameters;
- ``flash_ab`` and ``serve_bench`` each give one well-formed row at a tiny
  shape (no time is measured on the CPU);
- ``export_zinc``'s PyG conversion on a stand-in ``Data``, through
  ``save_zinc_npz`` and back through ``load_zinc_split``;
- ``graph_stats_report`` equals the root tool's ``summarize`` and
  ``compare_corpora`` through the JAX package's modules, on 8 graphs an
  algorithm;
- ``dropout_microbench``: each variant's drop keeps the bits of its plain
  mask (the threefry blocked bytes, ``jax.random.bernoulli``'s, the counter
  hash), ``ops.attention.bernoulli`` equals ``jax.random.bernoulli`` bit for
  bit, and the tool gives a row a variant at a tiny shape.
"""

import importlib.util
import io
import json
import os
import pathlib
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import torch

from glearning_benchmark_tpu_torch import bench
from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
from glearning_benchmark_tpu_torch.ops import attention
from glearning_benchmark_tpu_torch.tools import (dropout_microbench, flash_ab, graph_stats_report,
                                               mfu_bench, serve_bench)
from glearning_benchmark_tpu_torch.tools.export_zinc import data_to_graph

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = {"name": "cpu", "power_limit": "none"}


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bench_pipeline_equals_the_jax_package():
    from glearning_benchmark_tpu.data.zinc import load_zinc_split as jax_load
    from glearning_benchmark_tpu.tokenization.ibtt_fast import (
        build_zinc_vocab_fast, corpus_ids_best, flatten_zinc_corpus)
    from glearning_benchmark_tpu.tokenization.pack import pack_corpus

    mols = load_zinc_split(split="train", limit=300)
    vocab, ids, lens, packed, mask = bench.pipeline(mols)
    ref_mols = jax_load(split="train", limit=300)
    flat = {k: v for k, v in flatten_zinc_corpus(ref_mols).items() if not k.startswith("_")}
    ref_vocab = build_zinc_vocab_fast(ref_mols, flat=flat)
    ref_ids, ref_lens = corpus_ids_best(ref_mols, ref_vocab, max_len=1024, flat=flat)
    ref_packed, ref_mask = pack_corpus(ref_ids, ref_lens, pad_id=ref_vocab["<pad>"])
    assert vocab == ref_vocab
    for got, ref in ((ids, ref_ids), (lens, ref_lens), (packed, ref_packed), (mask, ref_mask)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_bench_last_line_has_the_reference_keys(tmp_path):
    line = _last_json(bench.main, ["--device", "cpu", "--limit", "300", "--reps", "1",
                                   "--out", str(tmp_path / "bench.json")])
    assert {"metric", "value", "unit", "vs_baseline", "device"} <= set(line)
    assert line["metric"] == "zinc_tokenize_graphs_per_sec" and line["unit"] == "graphs/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0 and line["byte_exact"]
    assert line["device"] == CPU and line["device_encode_graphs_per_sec"] is None
    assert json.loads((tmp_path / "bench.json").read_text()) == line


def test_analytic_train_flops_equals_the_reference_count():
    import jax
    import jax.numpy as jnp

    from glearning_benchmark_tpu.models.transformer import SimpleTransformer as Flax
    from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer

    kw = dict(vocab_size=50, d_model=64, nhead=4, nlayers=2, d_ff=256, p_drop=0.1,
              max_pos=32, num_classes=2, use_query_nodes=False, task="cycle_check",
              compute_dtype="bfloat16")
    ids = jnp.ones((2, 32), jnp.int32)
    params = jax.jit(lambda k: Flax(**kw).init(k, ids, ids > 0, deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    ref = _root_tool("mfu_bench").analytic_train_flops(params, 64, 32, 2, 64)
    got = mfu_bench.analytic_train_flops(SimpleTransformer(**kw), 64, 32, 2, 64)
    assert got == ref


def test_flash_ab_gives_one_row_on_the_cpu(tmp_path):
    row = flash_ab.run_shape(("tiny", 2, 64, 2, 8), torch.device("cpu"), CPU)
    assert row["card"] == CPU and row["skipped"] == {}
    for route in ("kernel", "plain", "sdpa"):
        for var in flash_ab.VARIANTS:
            assert row[f"{route}_{var}_ms"] is None      # not measured without a card
    assert row["max_abs_diff_kernel_vs_sdpa"] <= 2 ** -7   # one bf16 rounding of O


def test_serve_bench_gives_one_row_on_the_cpu(tmp_path):
    from glearning_benchmark_tpu_torch.data import generator
    from glearning_benchmark_tpu_torch.utils.config import load_config, normalize_config

    corpus = str(tmp_path / "graph-token")     # a small corpus in place of 200 graphs
    generator.ensure_corpus(corpus, tasks=("cycle_check",), algorithms=("ba", "sbm", "sfn"),
                            number_of_graphs=10, test_graphs=6)
    config = normalize_config(load_config(str(REPO / serve_bench.config_file("mpnn"))))
    res = serve_bench.bench_family("mpnn", config, torch.device("cpu"), buckets=(1,), reps=2,
                                   epochs=1, out_dir=str(tmp_path / "sb"), corpus_root=corpus)
    (row,) = res["rows"]
    assert row["family"] == "mpnn" and row["batch"] == 1 and row["reps"] == 2
    for key in ("cold_first_call_ms", "warmup_s", "warmed_first_call_ms", "warm_p50_ms",
                "warm_p99_ms", "graphs_per_s_at_p50"):
        assert np.isfinite(row[key]) and row[key] > 0, key
    assert row["warm_p99_ms"] >= row["warm_p50_ms"] and row["card"] == CPU


def test_export_zinc_conversion_round_trips(tmp_path):
    from glearning_benchmark_tpu_torch.data.zinc import save_zinc_npz

    datas = [SimpleNamespace(edge_index=torch.tensor([[0, 1, 1, 2], [1, 0, 2, 1]]),
                             num_nodes=3, y=torch.tensor([0.25 * i]),
                             x=torch.tensor([[1], [5], [2]]),
                             edge_attr=torch.tensor([1, 1, 2, 2]))
             for i in range(3)]
    graphs = [data_to_graph(d) for d in datas]
    g = graphs[1]
    assert g.edges.tolist() == [[0, 1], [1, 0], [1, 2], [2, 1]] and g.edges.dtype == np.int32
    assert (g.num_nodes, g.y) == (3, 0.25)
    assert g.node_labels.tolist() == [1, 5, 2] and g.edge_labels.tolist() == [1, 1, 2, 2]
    save_zinc_npz(str(tmp_path / "zinc_train.npz"), graphs)
    back = load_zinc_split(root=str(tmp_path), split="train")
    for a, b in zip(back, graphs):
        assert np.array_equal(a.edges, b.edges) and a.y == b.y
        assert np.array_equal(a.node_labels, b.node_labels)
        assert np.array_equal(a.edge_labels, b.edge_labels)


def test_graph_stats_report_equals_the_root_tool(tmp_path):
    from glearning_benchmark_tpu.data import generator as jax_gen
    from glearning_benchmark_tpu.eval.graph_stats import compare_corpora

    algos = ["er", "ba", "sfn"]
    rep = graph_stats_report.report(algos, 8, 1234)
    root = _root_tool("graph_stats_report")
    corpora = {a: [jax_gen.generate_graph(a, jax_gen.graph_seed(1234, a, "eval", i))
                   for i in range(8)] for a in algos}
    for a in algos:
        assert rep["summary"][a] == root.summarize(corpora[a])
    ref = compare_corpora(corpora["er"], corpora["sfn"])
    assert rep["mmd"]["er|sfn"] == {k: round(v, 6) for k, v in ref.items() if k.endswith("_mmd")}
    line = _last_json(graph_stats_report.main, ["--algorithms", "er", "ba", "--graphs", "8",
                                                "--out", str(tmp_path / "gs.json")])
    assert line["card"] == CPU and len(line["degree_mmd"]) == 2
    assert os.path.isfile(tmp_path / "gs.json")


def _jax_key(key):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(key, np.uint32))      # a raw threefry key


def test_bernoulli_equals_jax_bits():
    import jax

    for key, p, shape in (((0, 3), 0.9, (4, 33)), ((12345, 2**32 - 1), 0.5, (2, 3, 7))):
        want = np.asarray(jax.random.bernoulli(_jax_key(key), p, shape))
        np.testing.assert_array_equal(attention.bernoulli(key, p, shape).numpy(), want)


def test_dropout_microbench_variants_keep_their_plain_bits():
    import jax

    shape, p = (2, 8, 13), dropout_microbench.P_DROP
    ones = torch.ones(shape, dtype=torch.bfloat16)
    ((key, seed), _), = dropout_microbench.site_keys(7, 1)
    masks = {"where": attention.dropout_keep_mask(key, shape, p)[0].numpy(),
             "bernoulli": np.asarray(jax.random.bernoulli(_jax_key(key), 1.0 - p, shape)),
             "hash": attention.hash_keep_mask(seed, shape, p)[0].numpy()}
    masks["mul"], masks["hash_kernel"] = masks["where"], masks["hash"]
    fns = dropout_microbench.drop_fns(p)
    assert set(fns) == set(masks)
    for name, fn in fns.items():
        np.testing.assert_array_equal((fn(key, seed, ones) != 0).numpy(), masks[name], name)
    assert {fn for fn, _ in dropout_microbench.VARIANTS.values()} == set(fns) | {None}


def test_dropout_microbench_gives_a_row_a_variant(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        dropout_microbench.main(["--d-model", "8", "--batch", "2", "--len", "6", "--iters",
                                 "1", "--device", "cpu", "--out", str(tmp_path / "d.json")])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["variant"] for r in rows[:-1]] == list(dropout_microbench.VARIANTS)
    assert all(r["fwdbwd_ms"] is None and r["card"] == CPU for r in rows[:-1])
    assert rows[-1]["summary"] == "dropout_microbench"
    assert json.loads((tmp_path / "d.json").read_text())["shape"]["d_ff"] == 32
