"""The training step's spans (``utils/trace.py``) under ``torch.profiler``.

A tiny token transformer (2 layers) and a tiny MPNN train on the CPU for
two steps under the profiler; its raw events give the spans (by name),
every aten op, and the autograd nodes of the backward with the sequence
numbers that tie each to the forward op it came from.
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from glearning_benchmark_tpu_torch.data import generator as G
from glearning_benchmark_tpu_torch.train import trainer
from glearning_benchmark_tpu_torch.train.datasets import DatasetBundle
from glearning_benchmark_tpu_torch.utils import trace

torch.set_num_threads(1)

LAYERS, STEPS = 2, 2
PHASES = ("train.forward", "train.backward", "train.update")
LAYER_SPANS = ("layer.attn", "layer.attn_norm", "layer.ffn", "layer.ffn_norm")
NAMES = {"train.step", "model.embed", "model.readout"} | set(PHASES) | set(LAYER_SPANS)


def _token_run(remat=False):
    n, length, vocab = 8, 16, 30
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, vocab, (n, length), generator=g, dtype=torch.int32)
    ids[:, 0] = 0
    arrays = {"ids": ids, "mask": torch.ones(n, length, dtype=torch.bool),
              "y": torch.randn(n, generator=g)}
    empty = {"y": np.zeros(0, np.float32)}
    bundle = DatasetBundle(task="zinc", kind="tokens",
                           splits={"train": {"y": np.zeros(n, np.float32)}, "val": empty,
                                   "test": empty},
                           num_classes=1, vocab_size=vocab,
                           meta={"max_len": length, "pad_id": 2, "bos_id": 0})
    cfg = {"model": {"d_model": 16, "nhead": 2, "nlayers": LAYERS, "d_ff": 32,
                     "dropout": 0.1, "max_pos": 64, "remat": remat}}
    model = trainer.build_model("agtt", cfg, bundle, generator=torch.Generator().manual_seed(0))
    opt, _ = trainer.build_optimizer(model, {"lr": 1e-3}, STEPS)
    idx = torch.arange(n).reshape(STEPS, n // STEPS)
    return (model, opt, arrays, idx, torch.ones_like(idx, dtype=torch.bool), bundle,
            torch.Generator().manual_seed(1))


def _graph_run():
    n, nodes, feat = 8, 6, 3
    g = torch.Generator().manual_seed(0)
    adj = (torch.rand(n, nodes, nodes, generator=g) > 0.5).to(torch.uint8)
    arrays = {"node_feat": torch.randn(n, nodes, feat, generator=g),
              "adj": adj | adj.transpose(1, 2),
              "mask": torch.ones(n, nodes, dtype=torch.bool),
              "y": torch.randint(0, 2, (n,), generator=g)}
    empty = {"y": np.zeros(0, np.int64)}
    bundle = DatasetBundle(task="cycle_check", kind="graphs",
                           splits={"train": {"y": np.zeros(n, np.int64)}, "val": empty,
                                   "test": empty},
                           num_classes=2, in_dim=feat)
    cfg = {"model": {"hidden_dim": 8, "num_layers": 2, "dropout": 0.1,
                     "compute_dtype": "float32"}}
    model = trainer.build_model("mpnn", cfg, bundle, generator=torch.Generator().manual_seed(0))
    opt, _ = trainer.build_optimizer(model, {"lr": 1e-3}, STEPS)
    idx = torch.arange(n).reshape(STEPS, n // STEPS)
    return (model, opt, arrays, idx, torch.ones_like(idx, dtype=torch.bool), bundle,
            torch.Generator().manual_seed(1))


def _profiled(run):
    """The raw profiler events of one ``train_epoch`` call of two steps."""
    trainer.train_epoch(*run)            # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(*run)
    return prof.profiler.kineto_results.events()


def _spans(events):
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if e.name() in NAMES), key=lambda s: (s[1], -s[2]))


def _inside(t, spans, names):
    """The innermost of the spans named ``names`` that holds time ``t``."""
    held = [s for s in spans if s[0] in names and s[1] <= t < s[2]]
    return max(held, key=lambda s: s[1])[0] if held else None


def _innermost(t, spans):
    return _inside(t, spans, {s[0] for s in spans})


@pytest.fixture(scope="module")
def token_events():
    return _profiled(_token_run())


def test_the_step_carries_the_span_tree(token_events):
    spans = _spans(token_events)
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == STEPS
    where = Counter()
    for s in spans:
        if s[0] == "train.step":
            continue
        assert any(a <= s[1] and s[2] <= b for _, a, b in steps), s
        phase = _inside(s[1], spans, set(PHASES))
        if s[0] in PHASES:
            assert phase == s[0]
        else:
            where[s[0], phase] += 1
    for name in PHASES:
        assert sum(s[0] == name for s in spans) == STEPS, name
    # the model's regions in the forward, and their backward in the backward
    # (the embedding's input, token ids, takes no gradient: forward only)
    assert where == {**{(n, "train.forward"): LAYERS * STEPS for n in LAYER_SPANS},
                     **{(n, "train.backward"): LAYERS * STEPS for n in LAYER_SPANS},
                     ("model.embed", "train.forward"): STEPS,
                     ("model.readout", "train.forward"): STEPS,
                     ("model.readout", "train.backward"): STEPS}
    # each phase once a step, in order
    for st in steps:
        inner = [s[0] for s in spans if st[1] <= s[1] and s[2] <= st[2] and s[0] in PHASES]
        assert inner == list(PHASES)


def test_every_aten_op_of_a_step_lies_under_a_phase(token_events):
    spans = _spans(token_events)
    steps = [s for s in spans if s[0] == "train.step"]
    ops = [e for e in token_events if e.name().startswith("aten::")]
    in_steps = [e for e in ops if any(a <= e.start_ns() < b for _, a, b in steps)]
    assert len(in_steps) > 100
    for e in in_steps:
        assert _inside(e.start_ns(), spans, set(PHASES)) is not None, e.name()


def _regions(events, spans, node_names):
    """For each autograd node named in ``node_names``: (the innermost span
    around it, the innermost span around the forward op of the same
    sequence number and thread)."""
    fwd = {}
    for e in events:
        if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            key = (e.sequence_nr(), e.start_thread_id())
            fwd[key] = min(e.start_ns(), fwd.get(key, e.start_ns()))
    out = Counter()
    for e in events:
        if e.name() in node_names and e.fwd_thread_id() > 0:
            assert _inside(e.start_ns(), spans, {"train.backward"}) == "train.backward"
            out[_innermost(e.start_ns(), spans),
                _innermost(fwd[(e.sequence_nr(), e.fwd_thread_id())], spans)] += 1
    return out


def test_backward_nodes_run_in_the_backward_of_their_region(token_events):
    spans = _spans(token_events)

    def same(counts):
        return {(name, name): n for name, n in counts.items()}

    # two norms a layer; the readout's final norm (<bos> pooling) once a step
    assert _regions(token_events, spans, {"NativeLayerNormBackward0"}) == same(
        {"layer.attn_norm": LAYERS * STEPS, "layer.ffn_norm": LAYERS * STEPS,
         "model.readout": STEPS})
    # qkv and out_proj; ff1 and ff2; the head
    assert _regions(token_events, spans, {"AddmmBackward0", "MmBackward0"}) == same(
        {"layer.attn": 2 * LAYERS * STEPS, "layer.ffn": 2 * LAYERS * STEPS,
         "model.readout": STEPS})
    assert _regions(token_events, spans, {"FlashAttentionFunctionBackward"}) == same(
        {"layer.attn": LAYERS * STEPS})
    # the residual sites' casts, the branch's to f32 and the result's copy
    # for the next GEMM: the norm regions' own
    casts = _regions(token_events, spans, {"ToCopyBackward0"})
    for name in ("layer.attn_norm", "layer.ffn_norm"):
        assert casts[name, name] == 2 * LAYERS * STEPS
    assert all(a == b for a, b in casts)


def test_residual_dropouts_run_in_the_norm_regions(token_events):
    """The two residual sites' dropouts run inside their residual site's
    region, forward and backward; the ReLU's inside ``layer.ffn``."""
    spans = _spans(token_events)
    want = {"layer.attn_norm": LAYERS * STEPS, "layer.ffn_norm": LAYERS * STEPS,
            "layer.ffn": LAYERS * STEPS}
    forward = Counter(_innermost(e.start_ns(), spans) for e in token_events
                      if e.name() == "HashDropoutFunction"
                      and _inside(e.start_ns(), spans, {"train.forward"}))
    assert forward == want
    assert _regions(token_events, spans, {"HashDropoutFunctionBackward"}) == {
        (name, name): n for name, n in want.items()}


def test_span_does_nothing_without_a_profiler(monkeypatch):
    def refuse(*args):
        raise AssertionError(f"{args} recorded with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace._Edge, "apply", refuse)
    assert trace.span("a") is trace.span("b")
    _, losses = trainer.train_epoch(*_token_run())
    assert losses.shape == (STEPS,) and torch.isfinite(losses).all()


def test_an_mpnn_step_carries_the_train_spans():
    spans = _spans(_profiled(_graph_run()))
    counts = Counter(s[0] for s in spans)
    assert counts == {name: STEPS for name in ("train.step",) + PHASES}


def test_remat_recomputes_the_layers_inside_the_backward():
    events = _profiled(_token_run(remat=True))
    spans = _spans(events)
    for name in LAYER_SPANS:
        where = Counter(_inside(s[1], spans, set(PHASES)) for s in spans if s[0] == name)
        # the backward holds the recomputed forward and the region's backward
        assert where == {"train.forward": LAYERS * STEPS, "train.backward": 2 * LAYERS * STEPS}


def test_profiled_epoch_trace_holds_the_step_span(tmp_path):
    root = str(tmp_path / "graph-token")
    G.ensure_corpus(root, tasks=("cycle_check",), algorithms=("ba", "sbm", "sfn"),
                    number_of_graphs=10, test_graphs=6)
    cfg = {"dataset": {"task": "cycle_check", "graph_token_root": root,
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "num_graphs": 10, "num_pairs_per_graph": 3,
                       "generate_num_graphs": 10, "cache": False},
           "model": {"hidden_dim": 8, "num_layers": 2, "dropout": 0.1,
                     "compute_dtype": "float32"},
           "train": {"batch_size": 16, "epochs": 1, "lr": 1e-3, "seed": 0,
                     "profile_epochs": [1]},
           "output": {"out_dir": str(tmp_path / "out"), "run_name": "mpnn-spans"},
           "wandb": {"use": False}}
    trainer.train(cfg, "mpnn", limit=40, verbose=False, device="cpu")
    path = tmp_path / "out" / "mpnn-spans_trace" / "epoch_001.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e.get("name") for e in events if e.get("ph") == "X")
    assert names["train.step"] >= 1
    assert names["train.step"] == names["train.forward"] == names["train.update"]
    assert os.path.getsize(path) > 0
