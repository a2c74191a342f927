#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``glearning_benchmark_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts there.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the last line is printed:

1. Card: its name and power limit (``nvidia-smi``). No CUDA -> exit 1.
2. Build the flash-attention kernel from ``glearning_benchmark_tpu_torch/
   csrc/flash_attn_fwd.cu`` with nvcc for sm_90a.
3. Kernel against its plain version on the card: the AGTT-ZINC shape
   [64, 1024, 4, 16] bf16 with a ragged key mask, packed segments with a
   pad tail, the IBTT-ZINC head dim 4 at L = 600, f32, and dropout
   p = 0.1 (whose keep pattern is read back from the kernel and must equal
   the plain version's bit for bit). Then the served shapes as the model
   builds them: q, k, v as strided views of one fused qkv output, with the
   key masks of the served stand-in ZINC ``val`` rows, at [512, 1024, 4, 16]
   (AGTT-ZINC, the largest request bucket) and [256, 1024, 4, 4]
   (IBTT-ZINC). Then kernel, plain and ``scaled_dot_product_attention``
   times and the kernel's bound at the served AGTT-ZINC rows, B = 256.
4. Serving at full width: an ``agtt_zinc``-width model (the literal below,
   random weights from ``--seed``, bf16 compute) is saved through the
   port's ``save_checkpoint``, restored by ``Predictor.from_checkpoint`` on
   cuda, warmed up and run on the 1,000 stand-in ZINC ``val`` graphs. The
   kernel's launch counter must equal layers x forward batches; every
   prediction must be finite; the first 32 must match the same checkpoint
   served on the CPU. The same, briefly, at ``ibtt_zinc`` width.
5. One JSON line of every kernel (name, launches, errors, times, bound),
   then the result line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# the `model:` blocks of configs/agtt_zinc.yaml and configs/ibtt_zinc.yaml
# (a CPU test holds them equal; the card's machine need not have PyYAML)
AGTT_ZINC_MODEL = {"use_flash": False, "d_model": 64, "nhead": 4,
                   "nlayers": 4, "d_ff": 256, "dropout": 0.1,
                   "max_pos": 1024}
IBTT_ZINC_MODEL = {"use_flash": False, "d_model": 16, "nhead": 4,
                   "nlayers": 2, "d_ff": 128, "dropout": 0.1,
                   "max_pos": 1024}
MAX_LEN = 1024            # configs' dataset.max_len: the served row width
MAX_BATCH = 512           # Predictor default
WARMUP_BUCKETS = (1, 64, 512)
CPU_CHECK_ROWS = 32

# tolerances of the kernel against its plain version (same inputs): O within
# one bf16 rounding (bf16 outputs) or 1e-5 relative (f32); LSE is f32 on
# both sides and differs only by exp2/log2 rounding and summation order
O_RTOL = {torch.bfloat16: 4e-3, torch.float32: 1e-5}
O_ATOL = 1e-5
LSE_ATOL = 1e-4
# served logits, cuda against cpu, both bf16 compute: they round at
# different places (cuBLAS vs CPU bf16 GEMMs, kernel vs plain attention)
LOGIT_ATOL = 5e-3

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores; SFU exp2 16 per SM per clock
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SFU_PER_SM_CLK = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def key_mask_seg(lens: torch.Tensor, l: int) -> torch.Tensor:
    return (torch.arange(l, device=lens.device)[None, :] < lens[:, None]).to(torch.int32)


def packed_seg(b: int, l: int, gen: torch.Generator) -> torch.Tensor:
    """Rows of 2-5 segments of random lengths, then a pad tail."""
    seg = torch.zeros(b, l, dtype=torch.int32)
    for i in range(b):
        n = int(torch.randint(2, 6, (1,), generator=gen))
        cuts = torch.sort(torch.randint(1, l, (n,), generator=gen)).values.tolist()
        start = 0
        for s, end in enumerate(cuts, 1):
            seg[i, start:end] = s
            start = end
    return seg.cuda()


def qkv_views(shape, dtype, gen: torch.Generator) -> tuple:
    """q, k, v as the model hands them to the kernel: strided [B, L, H, D]
    views of one fused [B, L, 3 H D] qkv output (row stride 3 H D)."""
    b, l, h, d = shape
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen).to(dtype)
    return tuple(t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))


def compare(name, fa, q, k, v, seg, p_drop=0.0, seed=0, chunk=64):
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, seed)
    torch.cuda.synchronize()
    if p_drop > 0.0:   # the keep mask hashes absolute b*H+h: no chunking
        chunk = q.shape[0]
    # the plain version is dense in L^2: run it on `chunk` rows at a time
    parts = [fa.flash_attention_reference(q[i:i + chunk].float(),
                                          k[i:i + chunk].float(),
                                          v[i:i + chunk].float(),
                                          seg[i:i + chunk], p_drop, seed)
             for i in range(0, q.shape[0], chunk)]
    ro = torch.cat([p[0] for p in parts])
    rl = torch.cat([p[1] for p in parts])
    del parts
    torch.cuda.synchronize()
    err = (o.float() - ro).abs()
    ok_o = bool((err <= O_RTOL[q.dtype] * ro.abs() + O_ATOL).all())
    err_lse = (lse - rl).abs().max().item()
    pad = seg == 0
    ok_pad = bool((o[pad] == 0).all())
    layout = "contiguous" if q.is_contiguous() else f"strides {list(q.stride())}"
    log(f"[kernel] {name}: shape {list(q.shape)} {str(q.dtype)[6:]} {layout} "
        f"p_drop {p_drop}: max|dO| {err.max().item():.3e} "
        f"(rtol {O_RTOL[q.dtype]:g}), max|dLSE| {err_lse:.3e} "
        f"(atol {LSE_ATOL:g}), pad rows zero {ok_pad}")
    if not (ok_o and err_lse <= LSE_ATOL and ok_pad):
        raise AssertionError(f"kernel disagrees with its plain version: {name}")
    return max(err.max().item(), err_lse)


def dropout_pattern(fa, seed: int, p_drop: float) -> None:
    """Read the kernel's keep pattern back: with q = k = 0 every allowed
    key gets the same probability, and a one-hot v maps key j to output
    column j - 64w of window w; so O > 0 exactly where (row, key) is kept."""
    b, l, h, d = 2, 256, 2, 64
    seg = torch.ones(b, l, dtype=torch.int32, device="cuda")
    seg[1, 200:] = 0
    zeros = torch.zeros(b, l, h, d, device="cuda")
    kept = torch.zeros(b, h, l, l, dtype=torch.bool, device="cuda")
    for w in range(l // d):
        v = torch.zeros(b, l, h, d, device="cuda")
        v[:, w * d:(w + 1) * d] = torch.eye(d, device="cuda")[:, None, :]
        o, _ = fa.flash_attention_fwd(zeros, zeros, v, seg, p_drop, seed)
        kept[..., w * d:(w + 1) * d] = (o > 0).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    ref = fa.dropout_keep_reference(seed, b * h, l, l, p_drop,
                                    device="cuda").view(b, h, l, l)
    allowed = ((seg[:, None, :, None] != 0)
               & (seg[:, None, None, :] != 0)).expand(b, h, l, l)
    same = torch.equal(kept, ref & allowed)
    log(f"[kernel] dropout keep pattern (seed {seed}, p {p_drop}) equals the "
        f"plain version's: {same} (kept share {kept[allowed].float().mean().item():.4f})")
    if not same:
        raise AssertionError("kernel dropout keep pattern differs")


def bound(q, seg) -> dict:
    """Least time the card could take for this call: bytes the data needs
    (q, k, v rows of valid tokens, seg, O and LSE) over HBM bandwidth, and
    the operations on the allowed (query, key) pairs: 4 D FLOPs (q.k and
    p.v) over the input type's peak, one exp over the SFU rate."""
    b, l, h, d = q.shape
    pairs = 0
    for row in seg.cpu():
        counts = torch.bincount(row[row > 0])
        pairs += int((counts.long() ** 2).sum())
    pairs *= h
    valid = int((seg > 0).sum())
    isz = q.element_size()
    nbytes = 3 * valid * h * d * isz + b * l * 4 + b * l * h * d * isz + b * h * l * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    t = {"bytes": nbytes / HBM_BYTES_S * 1e3,
         "flops": 4 * pairs * d / PEAK_FLOPS[q.dtype] * 1e3,
         "exp": pairs / (sms * SFU_PER_SM_CLK * clock_hz) * 1e3}
    by = max(t, key=t.get)
    return {"bound_ms": t[by], "bound_by": "bytes" if by == "bytes" else "operations",
            "parts_ms": t, "pairs": pairs, "bytes": nbytes}


def time_kernel(fa, q, k, v, seg, label: str) -> dict:
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, seg), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, seg), 3)
    b, l, h, d = q.shape
    allow = ((seg[:, None, :, None] == seg[:, None, None, :])
             & (seg[:, None, None, :] != 0))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allow), 20)
    del allow
    bd = bound(q, seg)
    log(f"[kernel] time {label} {list(q.shape)} {str(q.dtype)[6:]}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (bytes "
        f"{bd['parts_ms']['bytes']:.4f}, flops {bd['parts_ms']['flops']:.4f}, "
        f"exp {bd['parts_ms']['exp']:.4f} ms; {bd['pairs']} allowed pairs)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bd}


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def serve_checkpoint(tmp: str, model_name: str, model_cfg: dict, graphs,
                     seed: int) -> str:
    from glearning_benchmark_tpu_torch.convert import params_to_flax
    from glearning_benchmark_tpu_torch.tokenization.ibtt import tokenize_zinc_molecule
    from glearning_benchmark_tpu_torch.tokenization.vocab import (
        build_fixed_zinc_vocab, collect_dynamic_tokens,
        extend_vocab_with_dynamic_tokens)
    from glearning_benchmark_tpu_torch.train.checkpoint import save_checkpoint
    from glearning_benchmark_tpu_torch.train.datasets import SPLITS, DatasetBundle
    from glearning_benchmark_tpu_torch.train.trainer import build_model

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
    bundle = DatasetBundle(task="zinc", kind="tokens",
                           splits={s: {} for s in SPLITS}, num_classes=1,
                           vocab=vocab, vocab_size=vocab_size, meta=meta)
    config = {"model": dict(model_cfg)}
    model = build_model(model_name, config, bundle,
                        generator=torch.Generator().manual_seed(seed))
    path = os.path.join(tmp, f"{model_name}_zinc")
    save_checkpoint(path, {"params": params_to_flax(model.state_dict()),
                           "config": config, "vocab": vocab, "serve": serve})
    return path


def encode_rows(pred, graphs) -> dict:
    """The padded [N, MAX_LEN] id and mask rows that ``predict_graphs``
    builds for these graphs."""
    from glearning_benchmark_tpu_torch.tokenization.ibtt import tokenize_zinc_molecule

    if pred.model_name == "agtt":
        return pred._encode_trail_rows(graphs)
    return pred._encode_token_rows(
        [tokenize_zinc_molecule(g, max_len=MAX_LEN) for g in graphs])


def served_seg(pred, graphs) -> torch.Tensor:
    """Key mask of the served rows of ``graphs`` as kernel segment ids."""
    mask = encode_rows(pred, graphs)["mask"]
    return torch.from_numpy(mask).to(device="cuda", dtype=torch.int32)


def serve_phase(fa, path, cpu, model_cfg, graphs, card) -> tuple:
    """Serve ``graphs`` from the checkpoint at ``path`` on cuda; hold the
    first rows against ``cpu``, the same checkpoint served on the CPU."""
    from glearning_benchmark_tpu_torch.serve import Predictor

    model_name = cpu.model_name
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cuda")
    warm = pred.warmup(WARMUP_BUCKETS)
    t1 = time.perf_counter()
    out = pred.predict_graphs(graphs)["pred"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = fa.LAUNCHES
    n_batches = len(warm) + math.ceil(len(graphs) / MAX_BATCH)
    nlayers = int(model_cfg["nlayers"])
    log(f"[serve] {model_name}-zinc d{model_cfg['d_model']} h{model_cfg['nhead']} "
        f"L{MAX_LEN} x{nlayers} layers: {len(graphs)} graphs in {t2 - t1:.3f} s "
        f"= {len(graphs) / (t2 - t1):.1f} graphs/s on {card} (load + warmup "
        f"{t1 - t0:.3f} s, buckets {warm}); kernel launches {launches} "
        f"(expected {nlayers} x {n_batches})")
    if launches != nlayers * n_batches:
        raise AssertionError(f"{model_name}: {launches} kernel launches, "
                             f"expected {nlayers * n_batches}")
    if out.shape != (len(graphs),) or not torch.isfinite(torch.from_numpy(out)).all():
        raise AssertionError(f"{model_name}: predictions not finite / wrong shape")
    ref = cpu.predict_graphs(graphs[:CPU_CHECK_ROWS])["pred"]
    err = float(abs(out[:CPU_CHECK_ROWS] - ref).max())
    log(f"[serve] {model_name}: first {CPU_CHECK_ROWS} predictions cuda vs cpu "
        f"max|d| {err:.3e} (atol {LOGIT_ATOL:g}); pred range "
        f"[{out.min():.4f}, {out.max():.4f}]")
    if err > LOGIT_ATOL:
        raise AssertionError(f"{model_name}: cuda and cpu predictions differ")
    return pred, launches


def time_breakdown(pred, graphs) -> None:
    """Where one served request of all graphs spends its time: host
    encoding alone, then the whole call under torch.profiler for the
    device's kernel time by name and its busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    rows = encode_rows(pred, graphs)
    t_enc = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred._batched(rows, len(graphs))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
    dev = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    total_us = sum(us for _, us in dev)
    log(f"[time] {pred.model_name}: host encode {t_enc * 1e3:.2f} ms, batched "
        f"forward {t_fwd * 1e3:.2f} ms wall (profiled), device kernels "
        f"{total_us / 1e3:.3f} ms = {total_us / 1e3 / (t_fwd * 1e3):.3f} of the "
        f"forward's wall time" if total_us else
        f"[time] {pred.model_name}: host encode {t_enc * 1e3:.2f} ms, batched "
        f"forward {t_fwd * 1e3:.2f} ms; device time not measured (profiler "
        f"saw no device activity)")
    for name, us in dev[:8]:
        log(f"[time]   {us / 1e3:9.3f} ms  {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.ops import flash_attention as fa
    from glearning_benchmark_tpu_torch.serve import Predictor

    # phase 1: the card
    card = nvidia_smi("name,power.limit")
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    build_s = fa.build_seconds()
    log(f"[build] flash_attn_fwd for sm_90a in {build_s:.1f} s")

    # phase 3: the kernel against its plain version
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cgen = torch.Generator().manual_seed(args.seed)

    def rand(shape, dtype):
        return tuple(torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for _ in range(3))

    errs = []
    lens = torch.randint(1, 1025, (64,), device="cuda", generator=gen)
    lens[0] = 1024
    errs.append(compare("agtt-zinc ragged", fa, *rand((64, 1024, 4, 16), torch.bfloat16),
                        key_mask_seg(lens, 1024)))
    errs.append(compare("packed", fa, *rand((16, 1024, 4, 16), torch.bfloat16),
                        packed_seg(16, 1024, cgen)))
    lens = torch.randint(1, 601, (64,), device="cuda", generator=gen)
    errs.append(compare("ibtt-zinc D4 L600", fa, *rand((64, 600, 4, 4), torch.bfloat16),
                        key_mask_seg(lens, 600)))
    lens = torch.randint(1, 1025, (16,), device="cuda", generator=gen)
    errs.append(compare("f32 ragged", fa, *rand((16, 1024, 4, 16), torch.float32),
                        key_mask_seg(lens, 1024)))
    errs.append(compare("dropout packed", fa, *rand((8, 600, 4, 16), torch.bfloat16),
                        packed_seg(8, 600, cgen), p_drop=0.1, seed=1234))
    dropout_pattern(fa, seed=1234, p_drop=0.1)

    graphs = load_zinc_split(split="val")   # stand-in unless ./data/ZINC has an export
    ibtt_graphs = graphs[:256]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"agtt": serve_checkpoint(tmp, "agtt", AGTT_ZINC_MODEL, graphs, args.seed),
                 "ibtt": serve_checkpoint(tmp, "ibtt", IBTT_ZINC_MODEL, ibtt_graphs,
                                          args.seed)}
        cpu = {name: Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cpu")
               for name, path in paths.items()}

        # the kernel at the shapes, layout and masks the served path gives it:
        # q, k, v as views of the fused qkv output; key masks of the served rows
        agtt_seg = served_seg(cpu["agtt"], graphs[:MAX_BATCH])
        ibtt_seg = served_seg(cpu["ibtt"], ibtt_graphs)
        for name, seg in (("agtt", agtt_seg), ("ibtt", ibtt_seg)):
            lens = seg.sum(1)
            log(f"[kernel] {name}-zinc served rows: {int(lens.min())}-{int(lens.max())} "
                f"tokens (mean {lens.float().mean().item():.1f}) of {MAX_LEN}")
        errs.append(compare("agtt-zinc served", fa,
                            *qkv_views((MAX_BATCH, MAX_LEN, 4, 16), torch.bfloat16, gen),
                            agtt_seg))
        errs.append(compare("ibtt-zinc served", fa,
                            *qkv_views((len(ibtt_graphs), MAX_LEN, 4, 4), torch.bfloat16,
                                       gen), ibtt_seg))

        q, k, v = qkv_views((256, MAX_LEN, 4, 16), torch.bfloat16, gen)
        timing = time_kernel(fa, q, k, v, agtt_seg[:256].contiguous(), "agtt-zinc served")
        time_kernel(fa, q, k, v, torch.ones(256, MAX_LEN, dtype=torch.int32, device="cuda"),
                    "agtt-zinc dense")
        del q, k, v
        torch.cuda.empty_cache()

        # phase 4: serving at full width (launch counts read per path)
        agtt, launches = serve_phase(fa, paths["agtt"], cpu["agtt"], AGTT_ZINC_MODEL,
                                     graphs, card)
        ibtt, _ = serve_phase(fa, paths["ibtt"], cpu["ibtt"], IBTT_ZINC_MODEL,
                              ibtt_graphs, card)
        time_breakdown(agtt, graphs)
        time_breakdown(ibtt, ibtt_graphs)

    # phase 5: the kernels line, then the result
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "glearning_benchmark_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "glearning_benchmark_tpu/ops/pallas_attention.py:114",
        "launches": launches, "max_abs_err": max(errs),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
