"""The span readers against a hand-built trace of one training step.

The trace holds what ``devtrace.capture`` keeps of a profile, in seconds:
the device operations, and the host ranges, among them the program's spans
(a region of the model once in the forward and once around its backward),
the host ops and the calls that enqueued each device operation, in the
order the device ran them. Times below are microseconds.
"""

import math
from types import SimpleNamespace

import pytest

from portbench import devtrace, harness
from portbench.metrics import _spans

US = 1e-6
SPANS = [("train.step", 0, 100), ("train.forward", 0, 40), ("model.embed", 1, 3),
         ("layer.attn_norm", 10, 20), ("layer.ffn", 20, 30), ("train.backward", 40, 80),
         ("layer.ffn", 42, 49), ("layer.attn_norm", 50, 60), ("train.update", 80, 100)]
HOST = [("aten::embedding", 1, 2), ("aten::native_layer_norm", 11, 15),
        ("aten::addmm", 21, 25), ("aten::add", 6, 9), ("AddmmBackward0", 42, 48),
        ("NativeLayerNormBackward0", 51, 59), ("aten::fill_", 61, 62),
        ("aten::_foreach_mul_", 85, 90), ("aten::copy_", 105, 106)]
# device operations: name, start, end, the enqueueing call's name and start
DEVICE = [("embedding_kernel", 22, 24, "cudaLaunchKernel", 1.5),
          ("attn_fwd_kernel", 24, 26, "cudaLaunchKernelExC", 6.5),
          ("hash_dropout_kernel", 26, 28, "cudaLaunchKernel", 7),
          ("layer_norm_kernel", 30, 33, "cudaLaunchKernel", 12),
          ("gemm_fwd", 33, 40, "cuLaunchKernel", 22),
          ("gemm_bwd", 44, 50, "cuLaunchKernelEx", 43),
          ("layer_norm_grad_kernel", 52, 58, "cudaLaunchKernel", 52),
          ("fill_kernel", 62, 63, "cudaMemsetAsync", 61.5),
          ("multi_tensor_apply_kernel", 88, 95, "cudaLaunchKernel", 86),
          ("Memcpy DtoH", 106, 107, "cudaMemcpyAsync", 105.5)]
OTHER_CALLS = [("cudaStreamIsCapturing", 22.5, 22.6), ("cudaDeviceSynchronize", 107, 108)]


def trace(with_spans: bool, calls=True) -> devtrace.Trace:
    host = [(n, a * US, b * US) for n, a, b in HOST + OTHER_CALLS]
    if calls:
        host += [(call, t * US, (t + 0.3) * US) for _, _, _, call, t in DEVICE]
    if with_spans:
        host += [(n, a * US, b * US) for n, a, b in SPANS]
    return devtrace.Trace(device=[(n, a * US, b * US) for n, a, b, _, _ in DEVICE],
                          host=host, window_s=120 * US, units=1)


def ctx_of(tr):
    return SimpleNamespace(kind="train", arch={"d_model": 8, "heads": 2, "layers": 1, "d_ff": 16},
                           peaks={"bf16_flops": 1e12, "hbm_bytes_s": 1e11},
                           window={"steps": 4, "tokens": 400, "pairs": 4000, "examples": 4,
                                   "enqueue_s": 0.002, "seconds": 0.01},
                           trace=tr, traced={"steps": 1, "tokens": 100, "pairs": 1000},
                           spans={"bundle_s": 1.5})


def read(metric, ctx):
    return harness.reader(SimpleNamespace(bench_dir=harness.HERE), metric)(ctx)


NEW = {"fwd_ms_per_step.train": (2 + 2 + 2 + 3 + 7) * 1e-3,
       "bwd_ms_per_step.train": (6 + 6 + 1) * 1e-3,
       "update_ms_per_step.train": 7e-3,
       "norm_ms_per_step.train": (3 + 6) * 1e-3,
       "host_fwd_ms_per_step.train": 40e-3,
       "host_bwd_ms_per_step.train": 40e-3,
       "host_update_ms_per_step.train": 20e-3}
OLD = ["host_ms_per_step.train", "launches_per_step.train", "gemm_ms_per_step.train",
       "other_ms_per_step.train", "attn_ms_per_step.train", "attn_roofline.train",
       "dropout_ms_per_step.train", "optim_ms_per_step.train", "device_idle_share.train",
       "mfu.train", "bundle_s"]


@pytest.mark.parametrize("metric", sorted(NEW))
def test_span_readers_by_hand(metric):
    assert read(metric, ctx_of(trace(True))) == pytest.approx(NEW[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_span_readers_read_nothing_without_spans(metric):
    assert read(metric, ctx_of(trace(False))) is None
    assert read(metric, ctx_of(None)) is None


@pytest.mark.parametrize("metric", sorted(m for m in NEW if not m.startswith("host_")))
def test_device_readers_refuse_a_trace_whose_calls_do_not_pair(metric):
    assert read(metric, ctx_of(trace(True, calls=False))) is None


def test_each_device_op_finds_its_phase_and_span():
    got = [(name, phase, inner) for (name, *_), (_, phase, inner)
           in zip(DEVICE, _spans.regions(trace(True)))]
    assert got == [("embedding_kernel", "train.forward", "model.embed"),
                   ("attn_fwd_kernel", "train.forward", "train.forward"),
                   ("hash_dropout_kernel", "train.forward", "train.forward"),
                   ("layer_norm_kernel", "train.forward", "layer.attn_norm"),
                   ("gemm_fwd", "train.forward", "layer.ffn"),
                   ("gemm_bwd", "train.backward", "layer.ffn"),
                   ("layer_norm_grad_kernel", "train.backward", "layer.attn_norm"),
                   ("fill_kernel", "train.backward", "train.backward"),
                   ("multi_tensor_apply_kernel", "train.update", "train.update"),
                   ("Memcpy DtoH", None, None)]


@pytest.mark.parametrize("metric", OLD)
def test_existing_readers_read_the_same_with_spans(metric):
    a, b = read(metric, ctx_of(trace(True))), read(metric, ctx_of(trace(False)))
    assert a is not None and math.isfinite(a) and a == b


def test_breakdown_ops_are_the_same_with_spans():
    a, b = trace(True).breakdown(), trace(False).breakdown()
    assert a["device_ops"] == b["device_ops"]
    # a gap where no op of the host runs is named by the program's span
    gaps = dict(a["idle_gaps"])
    assert gaps["train.backward"] == pytest.approx((4 + 25) * US)
    assert gaps["layer.attn_norm"] == pytest.approx(2 * US)
    assert gaps["train.update"] == pytest.approx(11 * US)
    assert "train.backward" not in dict(b["idle_gaps"])
