#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``glearning_benchmark_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts there.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the last line is printed:

1. Card: its name and power limit (``nvidia-smi``). No CUDA -> exit 1.
2. Build the three flash-attention kernels (forward, dQ, dK/dV) and the
   hash-dropout kernel from ``glearning_benchmark_tpu_torch/csrc/*.cu``
   with nvcc for sm_90a, one compiler per source, side by side; each
   attention library's SASS must hold HMMA (mma.sync) and HGMMA (wgmma)
   instructions.
3. Forward kernel against its plain version on the card: the AGTT-ZINC shape
   [64, 1024, 4, 16] bf16 with a ragged key mask, packed segments with a
   pad tail, the IBTT-ZINC head dim 4 at L = 600, f32, and dropout
   p = 0.1 (the ``use_flash`` rate). The keep pattern is read back from the
   kernel at 0.1 and at 26/256, the rate the training path hands the kernels
   (``train_rate``: the JAX package's quantised XLA rate), through the f32
   route, the bf16 tensor-core routes at head dims 64, 128 and 256
   (wgmma) and 16 and 4 (mma.sync), views TMA cannot read (mma.sync at 64
   and 128, the wide route at 256) and the wgmma_chunks design at 320 (a
   view off the 16-byte grid too) and 512, and must equal the plain
   version's bit for bit. Every forward held to its plain version also runs twice and
   must give the same O and LSE bits. Then the served shapes as the model
   builds them: q, k, v as strided views of one fused qkv output, with the
   key masks of the served stand-in ZINC ``val`` rows, at [512, 1024, 4, 16]
   (AGTT-ZINC, the largest request bucket) and [256, 1024, 4, 4]
   (IBTT-ZINC). And the shapes the training path gives it, again on fused
   qkv views: the first packed stand-in ``train`` rows at the trainer's row
   batch ([49, 256, 4, 16] bf16) with p = 26/256, the first IBTT ``train``
   batch ([128, 256, 4, 4]) with p = 26/256, and the first ``val`` batch of
   each model with its key masks. Then kernel, plain and
   ``scaled_dot_product_attention`` times and the kernel's bound at the
   served AGTT-ZINC rows, B = 256, at the served IBTT-ZINC rows and dense;
   and the forward breakdown (below). Every time is read twice; the lower
   reading is kept and both are printed, with the device kernels that the
   library call ran as.
4. Backward kernels against their plain version on the card: the same
   packed AGTT training rows, p = 0 and p = 26/256, q/k/v as strided views of
   a fused qkv and a non-contiguous dO; the same IBTT training rows, bf16,
   p = 26/256; f32; L = 600 (not a multiple of the tiles; p = 0.1). Once
   (dq, dk, dv) of the kernels against ``torch.autograd.grad`` through the
   plain FORWARD in f32. Two runs of the dK/dV kernel must give equal bits.
   Then each backward kernel's time at the AGTT and at the IBTT training
   rows beside its bound, the plain version and the backward of
   ``scaled_dot_product_attention``, and the forward kernel's time there
   beside its bound, its plain version and SDPA's forward; and the
   backward kernels' times on rows that split the cost (p 0 against 26/256,
   all pad, one segment a row). The forward kernel's breakdown splits its
   time the same way, at the packed train rows and at the served AGTT
   rows.
4b. The hash-dropout kernel (``csrc/hash_dropout.cu``). First which
   rounding the plain path's ``x / c`` takes on the card and on the CPU
   (the kernel multiplies by the f32 reciprocal; the card's plain path must
   too). Then every entry point (``cheap_dropout``, ``hash_dropout``, the
   attention-probability dropout's ``cheap_dropout`` over [B, H, L, L]) on
   the shapes and placements of every site at agtt_zinc width (the
   transformer's [B, L, d] and [B, L, d_ff], a DP rank's batch offset, MoE's
   [E, B, C, f] with its batch on axis 1 and an expert block, an SP token
   block, graph nodes [N, F] at a row offset), last axes of 30 and 1, and
   two [2, 1024, 1024] tensors whose global index crosses 2**32, in bf16
   and f32 at p 0.1, 26/256 and 0.5: one launch forward and one backward,
   outputs and gradients equal to the plain version bit for bit; rate 0 is a
   no-op with no launch and 255.9/256 raises. One agtt_zinc-width training
   step (the first minibatch, from the config's seed) through the kernel,
   twice, and through ``cheap_dropout_reference``: equal loss and
   gradients, bit for bit, 6 launches a layer. Then the kernel, the plain
   int64 path and the kernel's bound at [64, 1024, 1024] and [64, 1024,
   4096] bf16 (mfu_bench's d_model 1024 rows), and ``tools.dropout_microbench``
   at its default shape with 3 iterations. Every training phase below also
   requires the kernel's launches (a token model's: 6 a layer and step).
5. Serving at full width: an ``agtt_zinc``-width model (the literal below,
   random weights from ``--seed``, bf16 compute) is saved through the
   port's ``save_checkpoint``, restored by ``Predictor.from_checkpoint`` on
   cuda, warmed up and run on the 1,000 stand-in ZINC ``val`` graphs. The
   forward kernel's launch counter must equal layers x forward batches;
   every prediction must be finite; the first 32 must match the same
   checkpoint served on the CPU. The same, briefly, at ``ibtt_zinc`` width.
6. Training at full width: the port's ``train()`` on cuda with the
   ``agtt_zinc`` config (literal below: packed rows, batch 128, dropout
   0.1, bf16 compute, bf16 first moment) on the 10,000/1,000/1,000 stand-in
   ZINC splits for 3 epochs. Losses must be finite and fall; the launch
   counters must equal layers x forward batches (forward kernel) and
   layers x train steps (each backward kernel); the best checkpoint must
   serve, its predictions on the first 32 ``val`` graphs equal to the
   trainer's own eval logits (1e-6); and the first 3 steps repeated on the
   CPU (same seed, dropout on) must give the card's per-step losses within
   2e-3. Then one
   epoch at ``ibtt_zinc`` width on 2,000 graphs, and ``[time]`` lines for
   steady AGTT train steps under ``torch.profiler``.
7. The graph-token slice (``configs/*_graph_token.yaml``, ``gps_zinc.yaml``):
   ``ensure_corpus`` writes the configs' corpus (cycle_check and
   shortest_path on ba, sbm and sfn, 500 train graphs each) into a temp
   root, timed, and its sha256 must be the expected one. The three kernels
   against their plain versions at the first packed train row batch of
   agtt_graph_token (head dim 8) and of ibtt_graph_token (head dim 4), p
   26/256, and at ibtt_graph_token's test batch with the most tokens, each
   timed beside its bound and SDPA. Then 3 epochs on cuda of ibtt and agtt
   on cycle_check, agtt and mpnn on shortest_path, mpnn and GPS on
   cycle_check and GPS on the stand-in ZINC, the configs' full widths:
   losses finite and falling, the attention kernels' launch counters equal
   to layers x batches (zero for the graph models), the first three step
   losses within 2e-3 of the CPU's (the graph models: the first step at
   their bf16 compute, and three steps at f32 compute on both sides; see
   ``first_steps_on_cpu``), examples/s, seconds an epoch, launches a step
   and the device's busy share of steady steps. The trained MPNN and GPS
   checkpoints serve the sfn test graphs with the trainer's own eval logits
   (1e-6) and within 5e-3 of the CPU on the first rows.
8. Host tokenization: the native library (``csrc/host/*.cpp``, built with
   g++ at first use) must be available, its two build times printed. On the
   12,000 stand-in ZINC graphs (all three splits): the scalar
   ``tokenize_zinc_corpus_ids``, the numpy ``corpus_ids_vectorized``, the
   native ``corpus_ids_best`` and the torch ``device_encode_corpus`` on
   cuda give equal lens and equal ids over them, pad beyond;
   ``build_zinc_vocab_fast`` equals the string-path vocab; the native
   ``pack_corpus`` equals the numpy one. The native SENT tokenizer equals
   the Python ``TrailTokenizer`` on phase 7's shortest_path graphs and on
   ZINC (labeled); the native corpus scan gives the examples of the Python
   parse for the files phase 7's configs read (both tasks); native orbit
   counts equal the numpy ones on 200 ZINC graphs; the agtt shortest_path
   and ibtt cycle_check bundles rebuilt without the cache equal phase 7's
   (cycle_check's also without the native library). Each path's graphs/s
   (the faster paths read three times, ``pack_corpus`` five times
   interleaved with numpy; every reading printed), the device encoder's
   device ms (CUDA events), its kernels and its host-to-device copy, the
   scan and the bundle seconds are printed beside the card.
9. Data parallelism and the Switch MoE FFN. The three kernels against
   their plain versions at a non-zero ``bh_offset`` (rank 1's place in a
   global batch of two packed AGTT train row batches, p 26/256), in bf16
   and in f32. Then, each
   through ``train()``, one process against two ranks: spawned processes
   that join one process group as torchrun would describe it, over NCCL
   when each has a card of its own and otherwise over gloo with CUDA
   tensors (NCCL refuses two ranks on one card). The runs: agtt_zinc width
   (packed, dropout 0.1) on the full stand-in splits for 2 epochs at f32
   and at bf16, with a batch size near 128 whose row batch divides over the
   ranks, and MPNN cycle_check at f32. Each run must shard; every rank
   must report the same metrics and the one process's kernel launches, with
   finite, falling losses; the first 4 step losses within 1e-4 relative of
   the one process's (f32) or 2e-3 (bf16). Each epoch's losses and
   examples/s are printed for both, two ranks sharing one card (not a
   scaling figure), beside a second one-process f32 run: the card's own
   run-to-run spread, which later epochs are not held against. The ranks
   also build the ZINC vocab over their
   shards of the 12,000 stand-in graphs, which must equal the one-process
   vocab. Last, agtt_zinc width with ``moe_experts: 4`` trains 3 epochs on
   the full splits (launch counts as in phase 6), its first 3 steps are held
   against the CPU's (2e-3), its best checkpoint serves the trainer's own
   logits, and ``[time]`` lines profile its steady train steps.
10. The other mesh axes, each through ``train()`` on two spawned ranks (as
   in phase 9) against one process, at f32 and at bf16, 2 epochs:
   tensor parallelism (``model_axis: 2``) at agtt_zinc width on packed
   rows; sequence parallelism (``seq_shards: 2``, the ring) at ibtt_zinc
   width on unpacked rows (``max_len`` 1024; the stand-in's longest row
   sets the width, 256); the pipeline (``pipe_stages: 2``,
   ``pipe_microbatches: 2``) at agtt_zinc width; expert parallelism at
   agtt_zinc width with ``moe_experts: 4`` and ``expert_shards: 2``, auto
   and ``ep_manual``. Each run: every rank reports the same metrics; the
   kernels' launch counters on each rank are what the schedule implies
   (TP, PP and EP: the one process's; SP: none, the ring runs no kernel);
   losses finite and falling; the first 4 step losses within 1e-4
   relative (f32) or 2e-3 (bf16) of the one process's, where the bf16 EP
   runs (auto and manual), whose top-1 routing can flip at router margins
   near 1e-6, hold step 1 so and each of steps 2-4 against one process's
   step from the ranks' own state before it (parameters, AdamW moments and
   counts, the dropout seeds' position; the free-running losses are
   printed beside them); the best checkpoint,
   gathered whole by the ranks, served on cuda by one process within 1e-6 of
   the logits of the model the ranks' ``train()`` returned. Examples/s and
   seconds an epoch are printed beside the card. On four cards or more the
   ranks run over NCCL, a card each, and a four-rank run of data 2 x model
   2 (agtt_zinc width, f32) is held to one process the same way.
11. The tools. Every instance of the three kernels that the launchers can
   choose (each head dim with an instance, the three kernels' wgmma
   instances at 256, their wgmma_chunks instances at 320, 384, 448 and 512,
   and the wide route, bf16 and f32, views TMA can and cannot read, with
   and without dropout, and the forward's short-hash instances):
   its design, shared memory, registers and spills as
   ``cudaFuncGetAttributes`` reports them; every instance but the f32
   design's (mma.sync, whose second products take three split terms at
   every head dim, wgmma, the wide route) must spill nothing. At the
   mfu_bench rows [64, 1024, 8, D] with packed segments at p 26/256: head
   dims 128 and 64
   (bf16: wgmma; f32: the wide route at 128, the f32 design at 64), a head
   dim between instances (12, zero-padded to 16) and above 128 (256; 160:
   bf16 the three kernels' wgmma instances at 256, 160 zero-padded, f32
   the wide route, a chunk and a part), bf16 and f32 (16 batch rows for
   f32 above 128); the bf16 kernels on the dense mfu rows (every token
   valid) at 128 and 64, on the dense attention of mfu_bench's d_model
   2048 step [16, 1024, 8, 256], and at flash_ab's xl [4, 4096, 8, 64]
   with its ragged key mask; bf16 above the wgmma instances at 256 (320, 16
   batch rows, and 512, 8 batch rows: the three kernels' wgmma_chunks
   instances, each design logged and required; and the forward alone at
   384, 8 batch rows). Each row is held to the plain versions (the
   tolerances of phases 3-4) and its inputs then timed beside the plain
   versions and SDPA; above 256 the forward is also timed on the wide
   route on the same inputs (the launcher's ``force``: the design the
   wgmma_chunks forward replaced). The
   backward's padding copies at a head dim between wgmma_chunks instances
   (300 on the d320 row's segments, padded to 320) are timed beside the
   whole backward call.
   Views TMA cannot read (an odd element offset) run the forward's mma.sync
   design at 64 and 128 and the wide route at 256, are counted, held to the
   plain version and timed. The
   f32 design against the wide route on the same f32 inputs (agtt-zinc
   packed train rows at head dim 16, packed mfu rows at 64): outputs held
   together, each kernel timed under both. Then
   ``glearning_benchmark_tpu_torch.bench`` whole (its last line
   must parse with a positive value, the byte-exactness checks held and the
   device encoder timed); ``tools.mfu_bench`` at d_model 256, 512 and 1024
   with a block of 4 steps (every row ``valid`` with 0 < mfu <= 1, the
   attention kernels launched), then at d_model 2048, batch 16 (head dim
   256: the backward's wgmma instances at 256; valid, each attention
   kernel launched), then at d_model 2560, 8 heads, 2 layers, batch 8
   (head dim 320: the three kernels' wgmma_chunks instances; the launch
   counts set to 0 before it and read after, each attention kernel
   launched and its design required); ``tools.flash_ab`` at ibtt-zinc, agtt-zinc
   and xl; ``tools.serve_bench`` for agtt and MPNN at buckets 1 and 256
   (1-epoch checkpoints on phase 7's corpus, 3 warm requests);
   ``tools.scaling_bench`` at N = 1 and 2 (1,000 molecules a host, vocab
   and ids held to one process's), one ``tools.run_benchmarks`` run
   (mpnn-cycle, 1 epoch, on phase 7's corpus), ``tools.roofline`` on its
   result (the card's data-sheet peaks) and
   ``examples.gcn_vs_gat`` (20 epochs; the hash-dropout kernel launched).
12. One JSON line of every kernel (name, launches, errors, times, bound,
   every instance with its design and resources), then the result line
   ``{"ok": true, "device": {...}}``.

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
from concurrent.futures import ThreadPoolExecutor

import torch

from glearning_benchmark_tpu_torch.ops import hash_dropout as hd
from glearning_benchmark_tpu_torch.ops.flash_attention import allowed_pairs, bound, bound_bwd
from glearning_benchmark_tpu_torch.utils.card import cuda_ms, nvidia_smi

# the `model:` blocks of configs/agtt_zinc.yaml and configs/ibtt_zinc.yaml
# (a CPU test holds them equal; the card's machine need not have PyYAML)
AGTT_ZINC_MODEL = {"use_flash": False, "d_model": 64, "nhead": 4,
                   "nlayers": 4, "d_ff": 256, "dropout": 0.1,
                   "max_pos": 1024}
IBTT_ZINC_MODEL = {"use_flash": False, "d_model": 16, "nhead": 4,
                   "nlayers": 2, "d_ff": 128, "dropout": 0.1,
                   "max_pos": 1024}
# the other blocks of configs/agtt_zinc.yaml (the same test holds them)
ZINC_DATASET = {"task": "zinc", "subset": True, "max_len": 1024}
ZINC_TRAIN = {"batch_size": 128, "lr": 0.001, "weight_decay": 1.0e-5, "seed": 0}
TRAIN_EPOCHS = 3
# the configs/*_graph_token.yaml and configs/gps_zinc.yaml blocks as train()
# reads them (after utils.config.normalize_config; the same test holds them).
# The script sets graph_token_root / zinc_root, the task, the epochs and the
# output names.
GRAPH_TOKEN_DATASET = {"graph_token_root": "data/graph-token", "task": "cycle_check",
                       "train_algorithms": ["ba", "sbm"], "test_algorithm": "sfn",
                       "use_split_tasks_dirs": True, "num_graphs": 100,
                       "num_pairs_per_graph": 10, "generate_num_graphs": 500}
GT_BLOCK = {"layer_type": "GIN+Transformer", "layers": 4, "n_heads": 4, "dim_hidden": 32,
            "dropout": 0.0, "attn_dropout": 0.1, "layer_norm": False, "batch_norm": True}
GPS_TRAIN = {"batch_size": 128, "seed": 0, "lr": 0.001, "weight_decay": 1e-05,
             "epochs": 100, "scheduler": "cosine_with_warmup", "num_warmup_epochs": 5}
GRAPH_CONFIGS = {
    "ibtt_graph_token": {
        "dataset": {**GRAPH_TOKEN_DATASET, "pack": True, "num_graphs": 500,
                    "max_len": 600, "max_vocab": 600},
        "model": {"d_model": 16, "nhead": 4, "nlayers": 2, "d_ff": 128, "dropout": 0.1,
                  "max_pos": 600},
        "train": {"batch_size": 128, "epochs": 100, "lr": 0.001, "weight_decay": 0.0001,
                  "seed": 0}},
    "agtt_graph_token": {
        "dataset": {**GRAPH_TOKEN_DATASET, "pack": True, "max_len": 600},
        "model": {"d_model": 32, "nhead": 4, "nlayers": 4, "d_ff": 128, "dropout": 0.1,
                  "max_pos": 600},
        "train": {"batch_size": 128, "epochs": 100, "lr": 0.001, "weight_decay": 0.0001,
                  "seed": 0}},
    "mpnn_graph_token": {
        "dataset": dict(GRAPH_TOKEN_DATASET),
        "model": {"in_dim": 1, "hidden_dim": 64, "num_layers": 5, "dropout": 0.1,
                  "pooling": "mean"},
        "train": {"batch_size": 128, "epochs": 100, "lr": 0.001, "weight_decay": 1e-05,
                  "seed": 0}},
    "gps_graph_token": {
        "dataset": dict(GRAPH_TOKEN_DATASET), "model": {"graph_pooling": "mean"},
        "gt": dict(GT_BLOCK), "train": dict(GPS_TRAIN)},
    "gps_zinc": {
        "dataset": {"task": "zinc", "zinc_root": "./data/ZINC", "subset": True},
        "model": {"graph_pooling": "mean"}, "gt": {**GT_BLOCK, "attn_dropout": 0.5},
        "train": dict(GPS_TRAIN)},
}


def train_rate() -> float:
    """The dropout rate the training path hands the attention kernels: the
    token configs' 0.1 through the trainer's ``attention_dropout_rate``
    (26/256 without ``use_flash``, as the JAX package's XLA attention
    drops)."""
    from glearning_benchmark_tpu_torch.train.trainer import attention_dropout_rate

    rates = {attention_dropout_rate(m["dropout"], m.get("use_flash", False))
             for m in (AGTT_ZINC_MODEL, IBTT_ZINC_MODEL,
                       GRAPH_CONFIGS["ibtt_graph_token"]["model"],
                       GRAPH_CONFIGS["agtt_graph_token"]["model"])}
    if len(rates) != 1:
        raise AssertionError(f"the token configs drop attention at several rates: {rates}")
    return rates.pop()
# the runs of the graph-token phase: (model, config, task), 3 epochs each
GRAPH_RUNS = (("ibtt", "ibtt_graph_token", "cycle_check"),
              ("agtt", "agtt_graph_token", "cycle_check"),
              ("agtt", "agtt_graph_token", "shortest_path"),
              ("mpnn", "mpnn_graph_token", "shortest_path"),
              ("mpnn", "mpnn_graph_token", "cycle_check"),
              ("ggps", "gps_graph_token", "cycle_check"),
              ("ggps", "gps_zinc", "zinc"))
GRAPH_EPOCHS = 3
CORPUS_TASKS = ("cycle_check", "shortest_path")
CORPUS_ALGORITHMS = ("ba", "sbm", "sfn")
# sha256 over the sorted relative paths and bytes of the corpus the configs
# generate (both tasks, ba/sbm/sfn, 500 train graphs each, seed 1234): the
# generator is byte-stable, so every run on every host writes this corpus
CORPUS_SHA256 = "c02147248dc59f93f3e93addeb5396f9412fea4601a8789a4ca90992dff1a792"
IBTT_TRAIN_LIMIT = 2000
CPU_CHECK_STEPS = 4
# the card's first steps repeated on the CPU: the plain attention's int64
# dropout hash makes a CPU step of the token models cost 10-20 s, the
# slowest part of the script (at four steps these runs took 237.5 s in all
# on the host of an H100 machine)
CPU_REF_STEPS = 3
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
# gradients, kernel against plain version (same inputs, O and LSE from the
# forward kernel): bf16 outputs within one bf16 rounding; f32 sums run over
# up to 600 terms in another order, so 1e-4 relative
G_RTOL = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
G_ATOL = 1e-5
# kernels (O, LSE from the forward kernel) against autograd through the
# plain forward in f32: two different routes to the same gradient
AUTOGRAD_ATOL = 1e-4
# per-step training loss, cuda against cpu, bf16 compute on both, over the
# first steps of one run (losses lie around 1.5). The two round at different
# places; the gap measured on an H100 is 5e-4, and a wrong dropout mask at
# one site or a wrong gradient scale moves a step's loss by more than 2e-3
STEP_LOSS_ATOL = 2e-3
# served logits, cuda against cpu, both bf16 compute: they round at
# different places (cuBLAS vs CPU bf16 GEMMs, kernel vs plain attention)
LOGIT_ATOL = 5e-3
# the trained checkpoint served on cuda against the trainer's own model on
# cuda: the same weights through the same kernels at the same bf16 widths,
# in batches of another size; the logits are f32 of magnitude about 1
SERVED_LOGIT_ATOL = 1e-6

def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches(fa) -> None:
    """Every kernel's launch counter to 0."""
    fa.reset_launches()
    hd.reset_launches()


def launches_now(fa) -> dict:
    """Every kernel's launches since the last :func:`reset_launches`."""
    return {**fa.LAUNCHES, **hd.LAUNCHES}


def attention_launches(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k != "hash_dropout"}


def fmt_ms(readings: list) -> str:
    return f"{min(readings):.4f} ms (readings {', '.join(f'{r:.4f}' for r in readings)})"


def device_kernels(fn) -> str:
    """The device kernels one call of ``fn`` launches, by device time, from
    torch.profiler: says which backend a library call chose and where its
    device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    if not dev:
        return "not seen by the profiler"
    return (f"{sum(n for _, n, _ in dev)} kernels, {sum(us for us, _, _ in dev) / 1e3:.4f} "
            f"ms in all: " + "; ".join(f"{name[:70]} x{n} {us / 1e3:.4f} ms"
                                       for us, n, name in dev))


def sdpa_flags() -> str:
    b = torch.backends.cuda
    return (f"flash {b.flash_sdp_enabled()}, mem_efficient "
            f"{b.mem_efficient_sdp_enabled()}, math {b.math_sdp_enabled()}, "
            f"cudnn {b.cudnn_sdp_enabled()}")


def tensor_core_sass(fa) -> None:
    """The kernels' bf16 route runs on the tensor cores: every kernel
    library's machine code (``cuobjdump -sass``) holds HMMA (mma.sync)
    instructions and HGMMA (wgmma) ones."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        raise AssertionError("cuobjdump not found: the tensor-core instructions cannot be checked")
    for name, lib in fa.build().items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout.splitlines()
        hmma = sum("HMMA" in line for line in sass)
        hgmma = sum("HGMMA" in line for line in sass)
        log(f"[build] {name}: {hmma} HMMA and {hgmma} HGMMA instructions in its SASS")
        if hmma == 0:
            raise AssertionError(f"{name}: no tensor-core (HMMA) instruction in its SASS")
        if hgmma == 0:
            raise AssertionError(f"{name}: no wgmma (HGMMA) instruction in its SASS")


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


def compare(name, fa, q, k, v, seg, p_drop=0.0, seed=0, chunk=64, bh_offset=0):
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, seed, bh_offset)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, seg, p_drop, seed, bh_offset)
    torch.cuda.synchronize()
    same_bits = torch.equal(o, o2) and torch.equal(lse, lse2)
    del o2, lse2
    # the plain version is dense in L^2: run it on `chunk` rows at a time,
    # each chunk at its own place in the batch*head index space
    h = q.shape[2]
    parts = [fa.flash_attention_reference(q[i:i + chunk].float(),
                                          k[i:i + chunk].float(),
                                          v[i:i + chunk].float(),
                                          seg[i:i + chunk], p_drop, seed,
                                          bh_offset + i * h)
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
    design = fa.design("flash_attn_fwd", q.shape[-1], q.dtype, fa.tma_ok(q, k, v))
    log(f"[kernel] {name}: shape {list(q.shape)} {str(q.dtype)[6:]} {layout} "
        f"({design}) p_drop {p_drop} bh_offset {bh_offset}: max|dO| {err.max().item():.3e} "
        f"(rtol {O_RTOL[q.dtype]:g}), max|dLSE| {err_lse:.3e} "
        f"(atol {LSE_ATOL:g}), pad rows zero {ok_pad}, O/LSE bits equal on a second run "
        f"{same_bits}")
    if not (ok_o and err_lse <= LSE_ATOL and ok_pad and same_bits):
        raise AssertionError(f"kernel disagrees with its plain version: {name}")
    return max(err.max().item(), err_lse)


def off_grid(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element past a 16-byte boundary: TMA
    cannot read it (``tma_ok``), so the forward runs another design."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def dropout_pattern(fa, seed: int, p_drop: float) -> None:
    """Read the kernel's keep pattern back, through the f32 route, the bf16
    tensor-core routes (wgmma at 64, 128 and 256, mma.sync at 16 and 4,
    wgmma_chunks at 320 and 512), views TMA cannot read (mma.sync at 64 and
    128, the wide route at 256, wgmma_chunks at 320): with q = k = 0 every allowed
    key gets p = 1, and a one-hot v maps key j to output column j - D w of
    window w; so O > 0 exactly where (row, key) is kept. L = 300 ends in a
    partial key tile."""
    b, l, h = 2, 300, 2
    seg = torch.ones(b, l, dtype=torch.int32, device="cuda")
    seg[1, 200:] = 0
    ref = fa.dropout_keep_reference(seed, b * h, l, l, p_drop,
                                    device="cuda").view(b, h, l, l)
    allowed = ((seg[:, None, :, None] != 0)
               & (seg[:, None, None, :] != 0)).expand(b, h, l, l)
    bf16 = torch.bfloat16
    for dtype, d, design, place in (
            (torch.float32, 64, "f32", torch.clone), (bf16, 64, "wgmma", torch.clone),
            (bf16, 128, "wgmma", torch.clone), (bf16, 256, "wgmma", torch.clone),
            (bf16, 16, "mma", torch.clone), (bf16, 4, "mma", torch.clone),
            (bf16, 64, "mma", off_grid), (bf16, 128, "mma", off_grid),
            (bf16, 256, "wide", off_grid), (bf16, 320, "wgmma_chunks", torch.clone),
            (bf16, 320, "wgmma_chunks", off_grid), (bf16, 512, "wgmma_chunks", torch.clone)):
        zeros = place(torch.zeros(b, l, h, d, device="cuda", dtype=dtype))
        eye = torch.eye(d, device="cuda", dtype=dtype)[:, None, :]
        kept = torch.zeros(b, h, l, l, dtype=torch.bool, device="cuda")
        for j0 in range(0, l, d):
            n = min(d, l - j0)
            v = torch.zeros(b, l, h, d, device="cuda", dtype=dtype)
            v[:, j0:j0 + n] = eye[:n]
            v = place(v)
            if fa.design("flash_attn_fwd", d, dtype, fa.tma_ok(zeros, zeros, v)) != design:
                raise AssertionError(f"keep pattern {dtype} D {d}: not the {design} design")
            o, _ = fa.flash_attention_fwd(zeros, zeros, v, seg, p_drop, seed)
            kept[..., j0:j0 + n] = (o[..., :n] > 0).permute(0, 2, 1, 3)
        torch.cuda.synchronize()
        same = torch.equal(kept, ref & allowed)
        where = "" if place is torch.clone else ", a view off the 16-byte grid"
        log(f"[kernel] dropout keep pattern {str(dtype)[6:]} D {d} ({design}{where}) "
            f"(seed {seed}, p {p_drop}) equals the plain version's: {same} "
            f"(kept share {kept[allowed].float().mean().item():.4f})")
        if not same:
            raise AssertionError(f"kernel dropout keep pattern differs: {dtype} D {d}{where}")


def fmt_bound(bd: dict) -> str:
    return (f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} (bytes "
            f"{bd['parts_ms']['bytes']:.4f}, flops {bd['parts_ms']['flops']:.4f}, "
            f"exp {bd['parts_ms']['exp']:.4f} ms; {bd['pairs']} allowed pairs)")


def time_kernel(fa, q, k, v, seg, label: str) -> dict:
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, seg), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, seg), 3)
    b, l, h, d = q.shape
    allow = ((seg[:, None, :, None] == seg[:, None, None, :])
             & (seg[:, None, None, :] != 0))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow)

    lib_ms = cuda_ms(sdpa, 20)
    log(f"[kernel] sdpa forward ran as: {device_kernels(sdpa)} ({sdpa_flags()})")
    del allow
    bd = bound(q, seg)
    log(f"[kernel] time {label} {list(q.shape)} {str(q.dtype)[6:]}: kernel "
        f"{fmt_ms(ms)}, plain {fmt_ms(plain_ms)}, sdpa {fmt_ms(lib_ms)}, "
        f"{fmt_bound(bd)}")
    return {"ms": min(ms), "plain_ms": min(plain_ms), "library_ms": min(lib_ms), **bd}


# ---------------------------------------------------------------------------
# phase 4: the backward kernels against their plain version
# ---------------------------------------------------------------------------

def strided_do(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """A non-contiguous dO: the [B, L, H, D] view of a [B, H, L, D] tensor."""
    b, l, h, d = shape
    return torch.randn(b, h, l, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)


def compare_bwd(name, fa, q, k, v, seg, do, p_drop=0.0, seed=0, bh_offset=0,
                chunk=None) -> dict:
    """Both backward kernels against ``flash_attention_bwd_reference`` on
    the same inputs (O and LSE from the forward kernel), the plain version
    on ``chunk`` rows at a time (all at once by default), each at its place
    in the batch*head index space. Returns the max abs error per kernel."""
    args = (p_drop, seed, bh_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, *args)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, *args)
    torch.cuda.synchronize()
    chunk = chunk or q.shape[0]
    h = q.shape[2]
    parts = [fa.flash_attention_bwd_reference(
        q[i:i + chunk].float(), k[i:i + chunk].float(), v[i:i + chunk].float(),
        seg[i:i + chunk], o[i:i + chunk], lse[i:i + chunk], do[i:i + chunk].float(),
        p_drop, seed, bh_offset + i * h) for i in range(0, q.shape[0], chunk)]
    rq, rk, rv = (torch.cat([p[j] for p in parts]) for j in range(3))
    del parts
    rdelta = fa.flash_attention_delta(o, do)
    errs, ok = {}, True
    for what, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        err = (got.float() - ref).abs()
        errs[what] = err.max().item()
        ok &= bool((err <= G_RTOL[q.dtype] * ref.abs() + G_ATOL).all())
    err_delta = (delta - rdelta).abs().max().item()
    pad = seg == 0
    ok_pad = bool((dq[pad] == 0).all() and (dk[pad] == 0).all() and (dv[pad] == 0).all())
    same_bits = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    layout = "contiguous" if q.is_contiguous() else f"strides {list(q.stride())}"
    log(f"[kernel] bwd {name}: shape {list(q.shape)} {str(q.dtype)[6:]} {layout}, "
        f"dO {'contiguous' if do.is_contiguous() else 'strided'}, p_drop {p_drop} "
        f"bh_offset {bh_offset}: "
        f"max|d dQ| {errs['dq']:.3e}, |d dK| {errs['dk']:.3e}, |d dV| {errs['dv']:.3e} "
        f"(rtol {G_RTOL[q.dtype]:g}), |d delta| {err_delta:.3e} (atol {LSE_ATOL:g}), "
        f"pad rows zero {ok_pad}, dK/dV bits equal on a second run {same_bits}")
    if not (ok and ok_pad and same_bits and err_delta <= LSE_ATOL):
        raise AssertionError(f"backward kernels disagree with their plain version: {name}")
    return {"flash_attn_bwd_dq": errs["dq"],
            "flash_attn_bwd_dkv": max(errs["dk"], errs["dv"])}


def compare_bwd_autograd(fa, seg, gen: torch.Generator, p_drop: float, seed: int) -> None:
    """(dq, dk, dv) of the kernels against torch.autograd.grad through the
    plain FORWARD, f32: checks the plain backward's formulae too."""
    b, l = seg.shape
    q, k, v = (torch.randn(b, l, 4, 16, device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    do = torch.randn(b, l, 4, 16, device="cuda", generator=gen)
    ro, _ = fa.flash_attention_reference(q, k, v, seg, p_drop, seed)
    ref = torch.autograd.grad(ro, (q, k, v), do)
    o, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), seg, p_drop, seed)
    got = fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), seg, o, lse, do,
                                 p_drop, seed)
    plain = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), seg,
                                             o, lse, do, p_drop, seed)
    torch.cuda.synchronize()
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    err_plain = max((g - r).abs().max().item() for g, r in zip(plain, ref))
    log(f"[kernel] bwd against autograd through the plain forward, f32 {[b, l, 4, 16]} "
        f"p_drop {p_drop}: kernels max|d| {err:.3e}, plain backward max|d| "
        f"{err_plain:.3e} (atol {AUTOGRAD_ATOL:g})")
    if err > AUTOGRAD_ATOL or err_plain > AUTOGRAD_ATOL:
        raise AssertionError("backward disagrees with autograd through the plain forward")


def time_bwd(fa, q, k, v, seg, do, p_drop: float, seed: int, label: str,
             iters: int = 50, plain_iters: int = 5) -> dict:
    """Times of the two backward kernels, of the plain backward (one
    function for dQ, dK and dV together) and of the backward of
    ``scaled_dot_product_attention`` with the same boolean mask (also all
    three gradients; no dropout, its stream could not match); and of the
    forward, the plain forward and SDPA's forward. ``iters`` calls of each
    kernel and of SDPA a reading, ``plain_iters`` of each plain version."""
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, seed)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, p_drop, seed)
    ms = {"flash_attn_bwd_dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(
              q, k, v, seg, o, lse, do, p_drop, seed), iters),
          "flash_attn_bwd_dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv(
              q, k, v, seg, o, lse, do, delta, p_drop, seed), iters)}
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, seg, o, lse, do, p_drop, seed), plain_iters)
    allow = ((seg[:, None, :, None] == seg[:, None, None, :])
             & (seg[:, None, None, :] != 0))
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow)
    dot = do.transpose(1, 2)
    def sdpa_bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    lib_ms = cuda_ms(sdpa_bwd, iters)
    log(f"[kernel] sdpa backward ran as: {device_kernels(sdpa_bwd)} ({sdpa_flags()})")
    res = {}
    for name, which in (("flash_attn_bwd_dq", "dq"), ("flash_attn_bwd_dkv", "dkv")):
        bd = bound_bwd(q, seg, which)
        log(f"[kernel] time {name} {label} {list(q.shape)} {str(q.dtype)[6:]} p_drop "
            f"{p_drop}: kernel {fmt_ms(ms[name])}, plain backward (dQ, dK, dV together) "
            f"{fmt_ms(plain_ms)}, sdpa backward (all three) {fmt_ms(lib_ms)}, "
            f"{fmt_bound(bd)}")
        res[name] = {"ms": min(ms[name]), "plain_ms": min(plain_ms),
                     "library_ms": min(lib_ms), **bd}
    del out, qt, kt, vt, allow
    res["flash_attn_fwd"] = time_fwd(fa, q, k, v, seg, p_drop, seed, label, iters, plain_iters)
    return res


def time_fwd(fa, q, k, v, seg, p_drop: float, seed: int, label: str, iters: int,
             plain_iters: int) -> dict:
    """Times of the forward kernel, the plain forward and SDPA's forward
    with the same boolean mask (no dropout), as in :func:`time_bwd`."""
    fwd_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, seg, p_drop, seed), iters)
    fwd_plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, seg, p_drop, seed),
                           plain_iters)
    allow = ((seg[:, None, :, None] == seg[:, None, None, :])
             & (seg[:, None, None, :] != 0))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow), iters)
    bd = bound(q, seg)
    log(f"[kernel] time flash_attn_fwd {label} {list(q.shape)} {str(q.dtype)[6:]} p_drop "
        f"{p_drop}: kernel {fmt_ms(fwd_ms)}, plain {fmt_ms(fwd_plain_ms)}, sdpa forward "
        f"(same mask, no dropout) {fmt_ms(lib_fwd_ms)}, {fmt_bound(bd)}")
    return {"ms": min(fwd_ms), "plain_ms": min(fwd_plain_ms),
            "library_ms": min(lib_fwd_ms), **bd}


def bwd_breakdown(fa, seg_train: torch.Tensor, gen: torch.Generator, p: float) -> None:
    """Where the backward kernels' time goes at the AGTT training shape: the
    packed train rows with p 0 and ``p`` (the dropout hash), every token pad
    (launch and prologue only: no pair is computed), one segment a row
    (every pair computed); and one launch of a one-element add (the floor
    of a launch)."""
    b, l = seg_train.shape
    shape = (b, l, 4, 16)
    q, k, v = qkv_views(shape, torch.bfloat16, gen)
    do = strided_do(shape, torch.bfloat16, gen)
    segs = {"packed train rows": seg_train,
            "all pad": torch.zeros(b, l, dtype=torch.int32, device="cuda"),
            "one segment": torch.ones(b, l, dtype=torch.int32, device="cuda")}
    for name, seg in segs.items():
        for p_drop in ((p,) if name == "all pad" else (0.0, p)):
            o, lse = fa.flash_attention_fwd(q, k, v, seg, p_drop, 3)
            _, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, p_drop, 3)
            t_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, seg, o, lse, do, p_drop, 3), 50)
            t_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, seg, o, lse, do, delta, p_drop, 3), 50)
            log(f"[kernel] bwd breakdown {list(shape)} bfloat16 {name} p_drop {p_drop}: "
                f"dQ {fmt_ms(t_dq)}, dK/dV {fmt_ms(t_dkv)}; "
                f"{allowed_pairs(seg, shape[2])} allowed pairs")
    one = torch.zeros(1, device="cuda")
    log(f"[kernel] bwd breakdown: one launch of a one-element add "
        f"{fmt_ms(cuda_ms(lambda: one.add_(1), 50))}")


def fwd_breakdown(fa, rows: dict, gen: torch.Generator, p: float) -> None:
    """Where the forward kernel's time goes, bf16 at head dim 16 on fused
    qkv views, for each ``rows`` entry (its name and the [B, L] segment ids
    of its real rows): the real rows at p 0 and ``p`` (the dropout hash),
    every token pad (launch and empty-tile exit only: no pair is computed),
    one segment a row (every pair computed)."""
    for where, seg_real in rows.items():
        b, l = seg_real.shape
        shape = (b, l, 4, 16)
        q, k, v = qkv_views(shape, torch.bfloat16, gen)
        segs = {"real rows": seg_real,
                "all pad": torch.zeros(b, l, dtype=torch.int32, device="cuda"),
                "one segment": torch.ones(b, l, dtype=torch.int32, device="cuda")}
        for name, seg in segs.items():
            for p_drop in ((p,) if name == "all pad" else (0.0, p)):
                t = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, seg, p_drop, 3), 30)
                log(f"[kernel] fwd breakdown {where} {list(shape)} bfloat16 {name} "
                    f"p_drop {p_drop}: {fmt_ms(t)}; {allowed_pairs(seg, shape[2])} "
                    f"allowed pairs")


# ---------------------------------------------------------------------------
# phase 4b: the hash-dropout kernel against its plain version
# ---------------------------------------------------------------------------

DROP_RATES = (0.1, 26 / 256, 0.5)
# mfu_bench's d_model 1024 rows: the transformer's [B, L, d] and [B, L, d_ff]
DROP_TIME_SHAPES = ((64, 1024, 1024), (64, 1024, 4096))
DROP_MICROBENCH_ITERS = 3


def dropout_cases(row_bs: int, l: int) -> list:
    """(label, kind, shape, placement) of every dropout site's tensor at
    agtt_zinc width (d 64, d_ff 256, 4 experts of capacity 32 for MoE):
    "blocked" runs ``cheap_dropout``, "element" ``hash_dropout``; the last
    two place the tensor so that its global index crosses 2**32."""
    half = l // 2
    return [
        ("transformer [B, L, d]", "blocked", (row_bs, l, 64), {}),
        ("transformer [B, L, d_ff]", "blocked", (row_bs, l, 256), {}),
        ("DP rank 1 of 2", "blocked", (row_bs, l, 64),
         {"batch_offset": row_bs, "batch_total": 2 * row_bs}),
        ("MoE [E, B, C, f], DP rank 1, EP rank 1", "blocked", (2, row_bs, 32, 256),
         {"batch_axis": 1, "batch_offset": row_bs, "batch_total": 2 * row_bs,
          "place": {0: (2, 4)}}),
        ("SP token block 1 of 2, DP rank 1", "blocked", (row_bs, half, 64),
         {"batch_offset": row_bs, "place": {1: (half, l)}}),
        ("last axis 30", "blocked", (64, 128, 30), {}),
        ("last axis 1", "blocked", (64, 128, 1), {"batch_offset": 3}),
        ("GPS probabilities [B, H, L, L], rows 16..", "blocked", (16, 4, 128, 128),
         {"batch_offset": 16}),
        ("graph nodes [N, F], rows 4096..", "element", (4096, 64), {"batch_offset": 4096}),
        ("[2, 1024, 1024] across 2**32", "blocked", (2, 1024, 1024),
         {"batch_offset": 16383, "batch_total": 16385}),
        ("[2, 1024, 1024] across 2**32", "element", (2, 1024, 1024), {"batch_offset": 4095}),
    ]


def dropout_fns(kind: str, seed: int, rate: float, place: dict) -> tuple:
    """(the entry point, its plain version) of a case."""
    from glearning_benchmark_tpu_torch.ops import attention as at

    if kind == "element":
        off = place["batch_offset"]
        return (lambda t: at.hash_dropout(seed, t, rate, off),
                lambda t: at.hash_dropout_reference(seed, t, rate, off))
    return (lambda t: at.cheap_dropout(seed, t, rate, **place),
            lambda t: at.cheap_dropout_reference(seed, t, rate, **place))


def scale_rounding_probe(gen: torch.Generator) -> None:
    """Which rounding of ``x / c`` (c a Python float, x a tensor) the plain
    path takes: on the card x * (1 / c), the reciprocal once in f32, or a
    true f32 division; on the CPU the same question. The kernel multiplies
    by the f32 reciprocal (``hash_dropout.inverse_scale``); the card's plain
    path must round the same."""
    rows = []
    for dev in ("cuda", "cpu"):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(1 << 20, device="cuda", generator=gen).to(dev, dt)
            for c in (1 - 26 / 256, 0.9, 0.7, 0.5):
                plain = x / c
                mul = (x.float() * hd.inverse_scale(c)).to(dt)
                div = (x.float() / torch.tensor(c, dtype=torch.float32, device=dev)).to(dt)
                rows.append((dev, dt, c, int((plain != mul).sum()), int((plain != div).sum())))
    for dev, dt, c, n_mul, n_div in rows:
        log(f"[dropout] scale rounding on {dev}, {str(dt)[6:]}, x / {c}: differs from "
            f"x * f32(1 / c) at {n_mul} and from f32 x / c at {n_div} of {1 << 20} elements")
    if any(n_mul for dev, _, _, n_mul, _ in rows if dev == "cuda"):
        raise AssertionError("the card's x / c does not round as x * (1 / c) in f32, "
                             "which the kernel computes")


def dropout_same_bits(label: str, fn, ref, shape, dtype, gen: torch.Generator) -> None:
    """The entry point (one kernel launch forward, one backward) against
    its plain version on the same x and gradient: equal outputs and
    gradients, bit for bit."""
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    hd.reset_launches()
    out = fn(x)
    (gx,) = torch.autograd.grad(out, x, g)
    launches = hd.LAUNCHES["hash_dropout"]
    xr = x.detach().requires_grad_()
    want = ref(xr)
    (gr,) = torch.autograd.grad(want, xr, g)
    torch.cuda.synchronize()
    if launches != 2 or not (torch.equal(out, want) and torch.equal(gx, gr)):
        raise AssertionError(
            f"hash dropout {label} {list(shape)} {dtype}: launches {launches} (want 2), "
            f"{int((out != want).sum())} outputs and {int((gx != gr).sum())} gradients differ")


def dropout_train_step(bundle, config: dict) -> None:
    """One training step at agtt_zinc width (the first minibatch of the
    run ``config`` describes, from its seed) through the kernel, twice, and
    through the plain version (``cheap_dropout_reference`` in the
    transformer's place): equal losses and gradients, bit for bit. The step
    runs under ``torch.use_deterministic_algorithms`` (warnings only): a
    gradient summed by atomics in another order on each run (the backward
    of a gather) would part even two runs of the same step."""
    import warnings
    from unittest import mock

    from glearning_benchmark_tpu_torch.models import transformer
    from glearning_benchmark_tpu_torch.ops.attention import cheap_dropout_reference
    from glearning_benchmark_tpu_torch.train.trainer import Layout, _batch_loss

    def step():
        model, opt, arrays, idx, valid, gen = first_epoch(bundle, config, "cuda")
        hd.reset_launches()
        loss, _, _ = _batch_loss(model, arrays, idx[0], valid[0], bundle, gen, Layout(), 0.01)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        torch.cuda.synchronize()
        return loss, dict(zip(opt.names, grads)), hd.LAUNCHES["hash_dropout"]

    def differ(a, b) -> list:
        return ([] if torch.equal(a[0], b[0]) else ["loss"]) + [
            k for k, g in a[1].items()
            if not ((g is None and b[1][k] is None) or torch.equal(g, b[1][k]))]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [step(), step()]
            with mock.patch.object(transformer, "cheap_dropout", cheap_dropout_reference):
                runs.append(step())
    finally:
        torch.use_deterministic_algorithms(False)
    nlayers = int(config["model"]["nlayers"])
    again, plain = differ(runs[0], runs[1]), differ(runs[0], runs[2])
    ops = sorted({str(w.message).split(" does not have")[0][:80] for w in caught})
    log(f"[dropout] one agtt_zinc-width training step (deterministic algorithms; ops "
        f"without a deterministic form: {ops or 'none'}): loss {runs[0][0].item():.6f} "
        f"through the kernel ({runs[0][2]} launches), {runs[2][0].item():.6f} through the "
        f"plain version ({runs[2][2]} launches); the kernel's step again: "
        f"{'bit-equal' if not again else f'differs in {again}'}; the plain step, loss and "
        f"{len(runs[0][1])} gradients: {'bit-equal' if not plain else f'differs in {plain}'}")
    if [r[2] for r in runs] != [6 * nlayers, 6 * nlayers, 0] or again or plain:
        raise AssertionError("the training step through the hash-dropout kernel differs "
                             "from the plain one")


def time_dropout(gen: torch.Generator, card: str) -> dict:
    """Kernel, plain version and bound of ``cheap_dropout`` at 26/256 on
    bf16 tensors of ``DROP_TIME_SHAPES`` (held bit-equal first). Returns
    {"BxLxD": times}."""
    from glearning_benchmark_tpu_torch.ops.attention import cheap_dropout_reference

    out = {}
    for shape in DROP_TIME_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        site = hd.blocked_site(shape, 7, 26, 1 - 26 / 256)
        kernel = lambda: hd.launch(x, site)                       # noqa: E731
        plain = lambda: cheap_dropout_reference(7, x, 26 / 256)   # noqa: E731
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f"hash dropout {shape}: kernel and plain differ")
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        bd = hd.bound(x, site)
        out["x".join(map(str, shape))] = {
            "ms": min(ms), "plain_ms": min(plain_ms), "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": None}
        log(f"[dropout] time {list(shape)} bf16 p 26/256: kernel {fmt_ms(ms)} ms "
            f"(bound {bd['bound_ms']:.4f} ms, {bd['bound_by']}: {bd['bytes'] / 1e9:.3f} GB; "
            f"{bd['bound_ms'] / min(ms):.2f} of it), plain int64 ops {fmt_ms(plain_ms)} ms "
            f"({min(plain_ms) / min(ms):.1f}x), no library call computes this hash; on {card}")
        del x
    torch.cuda.empty_cache()
    return out


def dropout_phase(gen: torch.Generator, bundle, config: dict, row_bs: int, l: int,
                  tmp: str, card: str) -> dict:
    """Phase 4b (module docstring). Returns the timings by shape."""
    from glearning_benchmark_tpu_torch.ops import attention as at
    from glearning_benchmark_tpu_torch.tools import dropout_microbench

    t0 = time.perf_counter()
    scale_rounding_probe(gen)
    n = 0
    for label, kind, shape, place in dropout_cases(row_bs, l):
        if shape[-1] == 1024:            # the 2**32 cases: check the crossing
            site = (hd.blocked_site(shape, 0, 26, 0.9, **place) if kind == "blocked" else
                    hd.element_site(shape, 0, 1, 0.9, place["batch_offset"]))
            first = ((place["batch_offset"] * math.prod(shape[1:]))
                     // (4 if kind == "blocked" else 1))
            rows, per_row = hd.words(site)
            if not first < 2**32 < first + rows * per_row or site.base != first % 2**32:
                raise AssertionError(f"{label} {kind}: its index does not cross 2**32")
        for dt in (torch.bfloat16, torch.float32):
            for i, rate in enumerate(DROP_RATES):
                dropout_same_bits(f"{label} ({kind}) p {rate:.4f}",
                                  *dropout_fns(kind, 1000 + 7 * i, rate, place), shape, dt, gen)
                n += 1
    x = torch.randn(8, 16, device="cuda", generator=gen)
    hd.reset_launches()
    if not (at.cheap_dropout(1, x, 0.0) is x and at.cheap_dropout(1, x, 0.001) is x
            and at.hash_dropout(1, x, 0.0) is x and hd.LAUNCHES["hash_dropout"] == 0):
        raise AssertionError("rate 0 (or one that rounds to 0/256) is not a no-op")
    try:
        at.cheap_dropout(1, x, 255.9 / 256)
        raise AssertionError("a rate that rounds to 256/256 did not raise")
    except ValueError:
        pass
    log(f"[dropout] {n} cases bit-equal to the plain version, forward and backward "
        f"(each site's shape and placement, bf16 and f32, p {DROP_RATES}), the index "
        f"across 2**32 included; rate 0 no launch; 255.9/256 raises; "
        f"{time.perf_counter() - t0:.1f} s")
    dropout_train_step(bundle, config)
    timing = time_dropout(gen, card)
    t1 = time.perf_counter()
    rows = captured(dropout_microbench.main, [
        "--iters", str(DROP_MICROBENCH_ITERS), "--out", os.path.join(tmp, "dropout_mb.json")])
    variants = [r["variant"] for r in rows[:-1]]
    if variants != list(dropout_microbench.VARIANTS) or not all(
            r["fwdbwd_ms"] > 0 for r in rows[:-1]):
        raise AssertionError(f"dropout_microbench: unexpected rows {rows}")
    log(f"[dropout] dropout_microbench ({DROP_MICROBENCH_ITERS} iterations): {time.perf_counter() - t1:.1f} s")
    log(f"[phase] hash dropout {time.perf_counter() - t0:.1f} s")
    return timing


# ---------------------------------------------------------------------------
# phase 5: serving
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
    fa.reset_launches()
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cuda")
    warm = pred.warmup(WARMUP_BUCKETS)
    t1 = time.perf_counter()
    out = pred.predict_graphs(graphs)["pred"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = fa.LAUNCHES["flash_attn_fwd"]
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


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def train_config(model_name: str, model_cfg: dict, zinc_root: str, out_dir: str,
                 pack: bool, epochs: int, **train_extra) -> dict:
    return {"dataset": {**ZINC_DATASET, "zinc_root": zinc_root, "pack": pack},
            "model": dict(model_cfg),
            "train": {**ZINC_TRAIN, "epochs": epochs, **train_extra},
            "output": {"out_dir": out_dir, "run_name": f"{model_name}-zinc"},
            "wandb": {"use": False}}


def train_phase(fa, model_name: str, config: dict, limit, card: str) -> tuple:
    """``train()`` of the port on cuda; checks the losses and the launch
    counters (a graph model launches no attention kernel; every model with
    dropout launches the hash-dropout kernel, a token model 6 times a layer
    and step: three sites, forward and backward). Returns (result,
    launches)."""
    from glearning_benchmark_tpu_torch.train.trainer import train, train_batch_size

    reset_launches(fa)
    t0 = time.perf_counter()
    res = train(config, model_name, limit=limit, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launches_now(fa)
    bundle = res.bundle
    tr = bundle.splits["train"]
    task = config["dataset"]["task"]
    bs = int(config["train"]["batch_size"])
    steps = sum(len(l) for l in res.step_losses)
    eval_batches = (len(res.history) * math.ceil(bundle.n("val") / bs)
                    + math.ceil(bundle.n("test") / bs))
    if bundle.kind == "tokens":
        nlayers = int(config["model"]["nlayers"])
        heads = int(config["model"]["nhead"])
        row_bs = train_batch_size(bundle, bs)
        shape = [row_bs, tr["ids"].shape[1], heads,
                 int(config["model"]["d_model"]) // heads]
        log(f"[train] {model_name}-{task} d{config['model']['d_model']} x{nlayers} layers, "
            f"{'packed' if 'seg' in tr else 'unpacked'} rows: attention sees "
            f"{shape} in training, [{bs}, {bundle.splits['val']['ids'].shape[1]}, ...] in "
            f"eval; {bundle.meta['n_examples_train']} examples in {bundle.n('train')} "
            f"rows, {len(res.step_losses[0])} steps an epoch; whole call {secs:.1f} s on "
            f"{card}")
        want = {"flash_attn_fwd": nlayers * (steps + eval_batches),
                "flash_attn_bwd_dq": nlayers * steps, "flash_attn_bwd_dkv": nlayers * steps,
                "hash_dropout": 6 * nlayers * steps}
        expect = (f"forward {nlayers} x ({steps} steps + {eval_batches} eval batches), "
                  f"backward {nlayers} x {steps} each, hash dropout 6 x {nlayers} x {steps}")
    else:
        log(f"[train] {model_name}-{task}: graphs [{bs}, {tr['adj'].shape[1]} nodes, "
            f"{bundle.in_dim} features], {bundle.n('train')} train graphs, "
            f"{len(res.step_losses[0])} steps an epoch; whole call {secs:.1f} s on {card}")
        want = {**{name: 0 for name in launches}, "hash_dropout": launches["hash_dropout"]}
        expect = "no attention kernel; the hash-dropout kernel at every dropout site"
    metric = "train/mae" if task == "zinc" else "train/acc"
    for h in res.history:
        log(f"[train] {model_name}-{task} epoch {h['epoch']}: train loss "
            f"{h['train/loss']:.4f}, val loss {h['val/loss']:.4f}, {metric} "
            f"{h[metric]:.4f}, grad norm {h['train/grad_norm']:.3f}, "
            f"{h['time/epoch_duration']:.2f} s, "
            f"{h['throughput/graphs_per_sec']:.1f} examples/s")
    log(f"[train] {model_name}-{task}: kernel launches {launches} (expected {expect}); "
        f"hash dropout {launches['hash_dropout'] / max(steps, 1):.1f} launches a step")
    losses = [v for h in res.history for v in (h["train/loss"], h["val/loss"])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{model_name}: a training or validation loss is not finite")
    if len(res.history) > 1 and not res.history[-1]["train/loss"] < res.history[0]["train/loss"]:
        raise AssertionError(f"{model_name}: the training loss did not fall")
    if launches != want or not launches["hash_dropout"] > 0:
        raise AssertionError(f"{model_name}: kernel launches {launches}, expected {want}")
    return res, launches


def trained_checkpoint_serves(res, config: dict, graphs) -> None:
    """The best checkpoint, restored by the Predictor on cuda, must predict
    what the trainer's own model (the best epoch, reloaded) gives on the
    first val rows."""
    from glearning_benchmark_tpu_torch.serve import Predictor
    from glearning_benchmark_tpu_torch.train.trainer import _apply_model

    out = config["output"]
    path = os.path.join(out["out_dir"], f"best_{out['run_name']}")
    pred = Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cuda")
    served = pred.predict_graphs(graphs[:CPU_CHECK_ROWS])["pred"]
    val = res.bundle.splits["val"]
    batch = {k: torch.from_numpy(v[:CPU_CHECK_ROWS]).cuda() for k, v in val.items()}
    res.model.eval()
    with torch.no_grad():
        own = _apply_model(res.model, batch, res.bundle).float().cpu().numpy()
    err = float(abs(served - own).max())
    log(f"[train] best checkpoint (val mae {res.best_val:.4f}) served on cuda: first "
        f"{CPU_CHECK_ROWS} val predictions against the trainer's eval logits max|d| "
        f"{err:.3e} (atol {SERVED_LOGIT_ATOL:g}); range [{served.min():.4f}, "
        f"{served.max():.4f}]")
    if not (err <= SERVED_LOGIT_ATOL and torch.isfinite(torch.from_numpy(served)).all()):
        raise AssertionError("the trained checkpoint does not serve the trainer's logits")


def first_epoch(bundle, config: dict, device: str, model=None,
                model_name: str = "agtt") -> tuple:
    """What ``train()`` holds when its first epoch starts, rebuilt from the
    config's seed in the same order: the model (initial weights from the
    seeded generator, unless ``model`` is given), the optimizer, the train
    arrays, the first shuffle and the generator of the dropout seeds."""
    import numpy as np

    from glearning_benchmark_tpu_torch.train.trainer import (
        build_model, build_optimizer, make_batches, train_batch_size)

    tc = config["train"]
    gen = torch.Generator().manual_seed(tc["seed"])
    if model is None:
        model = build_model(model_name, config, bundle, generator=gen).to(device)
    n, bs = bundle.n("train"), train_batch_size(bundle, tc["batch_size"])
    opt, _ = build_optimizer(model, tc, max(1, (n + bs - 1) // bs))
    arrays = {k: torch.from_numpy(v).to(device)
              for k, v in bundle.splits["train"].items()}
    idx = make_batches(n, bs, np.random.default_rng(tc["seed"]))[0]
    valid = make_batches(n, bs, None)[1]
    return (model, opt, arrays, torch.from_numpy(idx).to(device),
            torch.from_numpy(valid).to(device), gen)


def first_steps(bundle, config: dict, model_name: str, device: str):
    """Step losses of the first steps (at most ``CPU_REF_STEPS``) of the
    run ``config`` describes, rebuilt from its seed on ``device``."""
    from glearning_benchmark_tpu_torch.train.trainer import train_epoch

    model, opt, arrays, idx, valid, gen = first_epoch(bundle, config, device,
                                                      model_name=model_name)
    _, losses = train_epoch(model, opt, arrays, idx, valid, bundle, gen,
                            max_steps=CPU_REF_STEPS)
    return losses.cpu().numpy()


def first_steps_on_cpu(res, config: dict, model_name: str = "agtt") -> float:
    """The same run's first steps on the CPU (same seed, so the same
    initial weights, batches and dropout masks) against the card's. Returns
    the largest gap.

    The graph models at bf16 compute are held on their first step only:
    cuBLAS and the CPU round bf16 products at different places, and in
    these models (BatchNorm after every layer, near-constant node features)
    AdamW turns the difference of gradient elements that are zero or nearly
    so into steps of the learning rate, so the two trajectories part after
    the first update (measured on an H100: MPNN's step losses 1.1e-2
    apart by step 3). Their first steps are then held at f32 compute, card
    against CPU, where the two agree (measured: within 8.1e-6 over four
    steps)."""
    t0 = time.perf_counter()
    name = f"{model_name}-{config['dataset']['task']}"
    on_cpu = first_steps(res.bundle, config, model_name, "cpu")
    on_card = res.step_losses[0][:len(on_cpu)]
    gaps = abs(on_cpu - on_card)
    held = gaps if model_name in ("ibtt", "agtt") else gaps[:1]
    log(f"[train] {name}: first {len(on_cpu)} step losses, cuda {on_card.tolist()} against "
        f"cpu {on_cpu.tolist()}: |d| {[float(f'{g:.3e}') for g in gaps]}, held "
        f"{'all' if len(held) == len(gaps) else 'the first (bf16, see first_steps_on_cpu)'} "
        f"(atol {STEP_LOSS_ATOL:g}), cpu run {time.perf_counter() - t0:.1f} s")
    err = float(held.max())
    if model_name in ("mpnn", "ggps"):
        import copy

        f32 = copy.deepcopy(config)
        f32["model"]["compute_dtype"] = "float32"
        card32 = first_steps(res.bundle, f32, model_name, "cuda")
        cpu32 = first_steps(res.bundle, f32, model_name, "cpu")
        err32 = float(abs(card32 - cpu32).max())
        log(f"[train] {name} at f32 compute: first {len(cpu32)} step losses, cuda "
            f"{card32.tolist()} against cpu {cpu32.tolist()}: max|d| {err32:.3e} "
            f"(atol {STEP_LOSS_ATOL:g})")
        err = max(err, err32)
    if not err <= STEP_LOSS_ATOL:
        raise AssertionError("cuda and cpu disagree on the first training steps")
    return err


# device kernels of a train step, grouped by what their names say
KERNEL_GROUPS = (
    ("attention fwd kernel", ("attn_fwd_kernel",)),
    ("attention dQ kernel", ("attn_bwd_dq_kernel",)),
    ("attention dK/dV kernel", ("attn_bwd_dkv_kernel",)),
    ("LayerNorm backward", ("layer_norm_grad", "LayerNormBackward", "GammaBeta",
                            "layer_norm_backward")),
    ("LayerNorm forward", ("layer_norm", "LayerNorm")),
    ("GEMMs", ("nvjet", "gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("optimizer (foreach)", ("multi_tensor",)),
    ("hash-dropout kernel", ("hash_dropout",)),
    ("int64 elementwise ops", ("Bitwise", "bitwise", "shift", "<long", "long>", "long,")),
)


def train_step_breakdown(res, config: dict, model_name: str = "agtt",
                         steps: int = 10) -> dict:
    """Steady train steps under torch.profiler: wall ms per step,
    device-busy share, launches a step, device ms by kernel group, host ms
    per step. Returns the step's numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glearning_benchmark_tpu_torch.train.trainer import train_epoch

    bundle = res.bundle
    model, opt, arrays, idx, valid, gen = first_epoch(bundle, config, "cuda", res.model,
                                                      model_name=model_name)
    steps = min(steps, idx.shape[0])

    def run(k):
        return train_epoch(model, opt, arrays, idx, valid, bundle, gen, max_steps=k)

    run(min(3, steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    t_host = time.perf_counter() - t0          # enqueue only
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(us for _, us, _ in dev)
    what = (f"[{idx.shape[1]}, {arrays['ids'].shape[1]}] rows" if "ids" in arrays
            else f"[{idx.shape[1]}, {arrays['adj'].shape[1]}] graphs")
    name = f"{model_name}-{config['dataset']['task']}"
    log(f"[time] {name} train step {what}: wall {t_wall / steps * 1e3:.2f} ms a step "
        f"({steps} steps, unprofiled), host enqueue {t_host / steps * 1e3:.2f} ms a step; "
        f"profiled {t_prof / steps * 1e3:.2f} ms a step")
    out = {"wall_ms": t_wall / steps * 1e3, "device_ms": None, "busy": None,
           "launches": None}
    if not total_us:
        log("[time] device time not measured (the profiler saw no device activity)")
        return out
    out.update(device_ms=total_us / steps / 1e3, busy=total_us / 1e6 / t_wall,
               launches=sum(c for _, _, c in dev) / steps)
    log(f"[time] {name} device kernels {out['device_ms']:.3f} ms a step = "
        f"{out['busy']:.3f} of the unprofiled wall time (device-busy share), "
        f"{out['launches']:.0f} kernel launches a step")
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, us, _ in dev:
        for g, pats in KERNEL_GROUPS:
            if any(pat in key for pat in pats):
                groups[g] += us
                break
        else:
            groups["other"] += us
    for g, us in groups.items():
        if us:
            log(f"[time]   {us / steps / 1e3:8.3f} ms a step  {g}")
    for key, us, count in sorted(dev, key=lambda kv: -kv[1])[:10]:
        log(f"[time]   top: {us / steps / 1e3:8.3f} ms a step, {count / steps:5.1f} "
            f"launches  {key[:90]}")
    return out


# ---------------------------------------------------------------------------
# the graph-token phases: corpus, kernels at its rows, training, serving
# ---------------------------------------------------------------------------

def corpus_digest(root: str) -> tuple:
    """(files, bytes, sha256) over the corpus under ``root``: every file's
    relative path and bytes, in sorted order (the bundle cache left out)."""
    import hashlib

    paths = []
    for top, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "processed"]
        paths += [os.path.join(top, f) for f in files]
    h = hashlib.sha256()
    nbytes = 0
    for path in sorted(os.path.relpath(p, root) for p in paths):
        with open(os.path.join(root, path), "rb") as f:
            data = f.read()
        h.update(path.encode() + b"\0" + data)
        nbytes += len(data)
    return len(paths), nbytes, h.hexdigest()


def corpus_phase(root: str) -> None:
    """``ensure_corpus`` with the configs' arguments (``generate_num_graphs:
    500``, seed 1234) for both tasks on ba, sbm and sfn, timed; its digest
    must be the one this script expects."""
    from glearning_benchmark_tpu_torch.data.generator import ensure_corpus

    t0 = time.perf_counter()
    ensure_corpus(root, tasks=CORPUS_TASKS, algorithms=CORPUS_ALGORITHMS,
                  number_of_graphs=GRAPH_TOKEN_DATASET["generate_num_graphs"], seed=1234)
    secs = time.perf_counter() - t0
    files, nbytes, digest = corpus_digest(root)
    log(f"[corpus] {'+'.join(CORPUS_TASKS)} on {'/'.join(CORPUS_ALGORITHMS)}, 500 train + "
        f"100 val + 100 test graphs each: {files} files, {nbytes / 1e6:.1f} MB in "
        f"{secs:.1f} s; sha256 {digest} (expected {CORPUS_SHA256})")
    if digest != CORPUS_SHA256:
        raise AssertionError("the generated corpus is not the expected one")


def graph_config(name: str, task: str, root: str, out_dir: str, epochs: int) -> dict:
    import copy

    cfg = copy.deepcopy(GRAPH_CONFIGS[name])
    ds = cfg["dataset"]
    ds["task"] = task
    ds["zinc_root" if task == "zinc" else "graph_token_root"] = root
    cfg["train"]["epochs"] = epochs
    cfg["output"] = {"out_dir": out_dir, "run_name": f"{name}-{task}"}
    cfg["wandb"] = {"use": False}
    return cfg


def graph_token_rows(fa, bundles: dict, gen: torch.Generator, p: float) -> tuple:
    """The three kernels against their plain versions at the graph-token
    rows: the first packed train row batch of agtt_graph_token (head dim 8)
    and of ibtt_graph_token (head dim 4), at the training rate ``p``, and
    ibtt_graph_token's test batch with the most tokens (p 0 forward, ``p``
    backward); then their
    times beside the bounds and SDPA. Returns (forward errors, backward
    errors, timings by shape)."""
    from glearning_benchmark_tpu_torch.train.trainer import make_batches, train_batch_size

    errs, berrs, timing = [], [], {}
    for name, d in (("agtt_graph_token", 8), ("ibtt_graph_token", 4)):
        b = bundles[name]
        seg_all = b.splits["train"]["seg"]
        row_bs = train_batch_size(b, GRAPH_CONFIGS[name]["train"]["batch_size"])
        seg = torch.from_numpy(seg_all[:row_bs]).cuda().contiguous()
        shape = (row_bs, seg.shape[1], 4, d)
        lens = (seg > 0).sum(1)
        log(f"[kernel] {name} packed train rows: {b.meta['n_examples_train']} examples in "
            f"{len(seg_all)} rows of {seg.shape[1]}, row batch {row_bs}, "
            f"{int(lens.min())}-{int(lens.max())} valid tokens a row")
        label = f"{name} packed train rows"
        errs.append(compare(label, fa, *qkv_views(shape, torch.bfloat16, gen), seg,
                            p_drop=p, seed=11))
        berrs.append(compare_bwd(label, fa, *qkv_views(shape, torch.bfloat16, gen), seg,
                                 strided_do(shape, torch.bfloat16, gen), p, 11))
        timing[f"{name}_train_rows_p{p}"] = time_bwd(
            fa, *qkv_views(shape, torch.bfloat16, gen), seg,
            strided_do(shape, torch.bfloat16, gen), p, 11, label)
    b = bundles["ibtt_graph_token"]
    mask = b.splits["test"]["mask"]
    idx, valid = make_batches(len(mask), GRAPH_CONFIGS["ibtt_graph_token"]["train"]["batch_size"],
                              None)
    tokens = [int(mask[i[v]].sum()) for i, v in zip(idx, valid)]
    rows = idx[tokens.index(max(tokens))]
    seg = torch.from_numpy(mask[rows]).to(device="cuda", dtype=torch.int32)
    shape = (len(rows), seg.shape[1], 4, 4)
    lens = seg.sum(1)
    label = "ibtt_graph_token test rows"
    log(f"[kernel] {label} (sfn, the batch with the most tokens): {list(shape)}, "
        f"{int(lens.min())}-{int(lens.max())} valid tokens a row")
    errs.append(compare(label, fa, *qkv_views(shape, torch.bfloat16, gen), seg))
    berrs.append(compare_bwd(label, fa, *qkv_views(shape, torch.bfloat16, gen), seg,
                             strided_do(shape, torch.bfloat16, gen), p, 13))
    timing["ibtt_graph_token_test_rows"] = time_kernel(
        fa, *qkv_views(shape, torch.bfloat16, gen), seg, label)
    return errs, berrs, timing


def serve_graph_phase(res, config: dict, model_name: str, card: str) -> dict:
    """The best checkpoint of a graph-model run served with
    ``predict_graphs`` on the test (sfn) graphs: the logits must equal the
    trainer's eval forward on the same rows in the same batches (the
    Predictor's power-of-two buckets, pad rows copies of a chunk's first)
    and, for the first rows, the same checkpoint served on the CPU."""
    import numpy as np

    from glearning_benchmark_tpu_torch.data.loader import load_graphs_multi_algorithm
    from glearning_benchmark_tpu_torch.serve import Predictor, _next_pow2
    from glearning_benchmark_tpu_torch.train.trainer import _apply_model

    out = config["output"]
    path = os.path.join(out["out_dir"], f"best_{out['run_name']}")
    ds = config["dataset"]
    # the test split's graphs as the dataset builder loads them
    graphs = load_graphs_multi_algorithm(
        ds["graph_token_root"], ds["task"], [ds["test_algorithm"]], "test",
        use_split_tasks_dirs=ds["use_split_tasks_dirs"], seed=int(config["train"]["seed"]),
        num_graphs=ds["num_graphs"], num_pairs_per_graph=ds["num_pairs_per_graph"])
    test = res.bundle.splits["test"]
    if len(graphs) != len(test["y"]):
        raise AssertionError("the test graphs are not the bundle's test split")
    bs = int(config["train"]["batch_size"])
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(path, max_batch=bs, device="cuda")
    warm = pred.warmup()
    t1 = time.perf_counter()
    served = pred.predict_graphs(graphs)["logits"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    own, i = [], 0
    res.model.eval()
    with torch.no_grad():
        while i < len(graphs):
            take = min(bs, len(graphs) - i)
            rows = np.arange(i, i + take)
            rows = np.concatenate([rows, np.full(_next_pow2(take, bs) - take, i)])
            batch = {k: torch.from_numpy(v[rows]).cuda() for k, v in test.items()}
            own.append(_apply_model(res.model, batch, res.bundle).float().cpu().numpy()[:take])
            i += take
    own = np.concatenate(own)
    err = float(abs(served - own).max())
    cpu = Predictor.from_checkpoint(path, max_batch=bs, device="cpu")
    on_cpu = cpu.predict_graphs(graphs[:CPU_CHECK_ROWS])["logits"]
    # the graph models' eval logits are not of order 1 after a few epochs
    # (running statistics still near their initial values): the tolerance
    # scales with the largest logit
    scale = max(1.0, float(abs(on_cpu).max()))
    err_cpu = float(abs(served[:CPU_CHECK_ROWS] - on_cpu).max())
    name = f"{model_name}-{config['dataset']['task']}"
    log(f"[serve] {name} best checkpoint: {len(graphs)} test graphs in {t2 - t1:.3f} s = "
        f"{len(graphs) / (t2 - t1):.1f} graphs/s on {card} (load + warmup {t1 - t0:.3f} s, "
        f"buckets {warm}); logits against the trainer's eval forward max|d| {err:.3e} "
        f"(atol {SERVED_LOGIT_ATOL:g}), first {CPU_CHECK_ROWS} against the CPU max|d| "
        f"{err_cpu:.3e} (atol {LOGIT_ATOL:g} x {scale:.3g}); logits range "
        f"[{served.min():.3f}, {served.max():.3f}]")
    if not np.isfinite(served).all() or served.shape != own.shape:
        raise AssertionError(f"{name}: served logits not finite / wrong shape")
    if err > SERVED_LOGIT_ATOL or err_cpu > LOGIT_ATOL * scale:
        raise AssertionError(f"{name}: served logits disagree")
    return {"graphs_per_s": len(graphs) / (t2 - t1), "err": err, "err_cpu": err_cpu}


def graph_token_phase(fa, root: str, tmp: str, card: str) -> dict:
    """Train each of ``GRAPH_RUNS`` on cuda (launch counters set to 0 just
    before each run and read just after), repeat its first steps on the
    CPU, profile steady steps, and serve the graph models' checkpoints.
    Returns the launches of each run."""
    from glearning_benchmark_tpu_torch.train.datasets import build_dataset

    zinc_root = os.path.join(tmp, "ZINC")
    launches = {}
    for model_name, name, task in GRAPH_RUNS:
        t0 = time.perf_counter()
        cfg = graph_config(name, task, zinc_root if task == "zinc" else root,
                           os.path.join(tmp, f"runs_{name}_{task}"), GRAPH_EPOCHS)
        build_dataset(model_name, cfg["dataset"], int(cfg["train"]["seed"]))
        log(f"[data] {model_name}-{task} ({name}) bundle in "
            f"{time.perf_counter() - t0:.1f} s (train() reads it from the cache)")
        res, launches[f"train_{name}_{task}"] = train_phase(fa, model_name, cfg, None, card)
        first_steps_on_cpu(res, cfg, model_name)
        if model_name in ("mpnn", "ggps") and task != "zinc":
            serve_graph_phase(res, cfg, model_name, card)
        # steps more on the trained model: after the serving check
        step = train_step_breakdown(res, cfg, model_name)
        h = res.history
        log(f"[graph] {model_name}-{task} ({name}): "
            f"{sum(x['throughput/graphs_per_sec'] for x in h) / len(h):.1f} examples/s, "
            f"{sum(x['time/epoch_duration'] for x in h) / len(h):.3f} s an epoch (mean of "
            f"{len(h)}), {step['launches']} launches a step, device busy share "
            f"{step['busy']} of a steady step, attention kernel launches "
            f"{launches[f'train_{name}_{task}']} on {card}")
        log(f"[phase] {model_name}-{task} {time.perf_counter() - t0:.1f} s")
        del res
    return launches


# ---------------------------------------------------------------------------
# phase 8: the host tokenization paths against their Python counterparts
# ---------------------------------------------------------------------------

def python_paths():
    """Within this context the native library is unavailable, so every
    caller takes its Python path."""
    from unittest import mock

    from glearning_benchmark_tpu_torch import native

    return mock.patch.object(native, "get_lib", lambda: None)


def timed(fn) -> tuple:
    """(fn(), host seconds), the device synchronised at the end."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_readings(fn, n: int) -> tuple:
    """(fn()'s last result, the host seconds of ``n`` calls)."""
    secs = []
    for _ in range(n):
        out, t = timed(fn)
        secs.append(t)
    return out, secs


def fmt_graphs_s(secs: list, n: int) -> str:
    """``n`` graphs over the best of ``secs``: graphs/s, then every reading."""
    return (f"{n / min(secs):.1f} graphs/s ({min(secs) * 1e3:.3f} ms; readings "
            f"{', '.join(f'{t * 1e3:.3f}' for t in secs)} ms)")


def same_rows(name: str, got, want, pad: int) -> None:
    """Equal lens, equal ids over each row's lens and pad beyond, whatever
    the two matrices' widths."""
    import numpy as np

    (ids, lens), (ref, ref_lens) = ([np.asarray(x.cpu() if torch.is_tensor(x) else x)
                                     for x in pair] for pair in (got, want))
    width = max(ids.shape[1], ref.shape[1])
    full = [np.pad(x, ((0, 0), (0, width - x.shape[1])), constant_values=pad)
            for x in (ids, ref)]
    beyond = np.arange(width)[None, :] >= lens[:, None]
    if not (np.array_equal(lens, ref_lens) and np.array_equal(full[0], full[1])
            and (full[0][beyond] == pad).all()):
        raise AssertionError(f"{name}: ids or lens differ from the reference path")


def zinc_host_paths(card: str) -> None:
    """The ZINC tokenization paths on the 12,000 stand-in graphs, held
    against the scalar path, timed."""
    import numpy as np

    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.tokenization.ibtt import (
        tokenize_zinc_corpus, tokenize_zinc_corpus_ids)
    from glearning_benchmark_tpu_torch.tokenization.ibtt_fast import (
        build_zinc_vocab_fast, corpus_ids_best, corpus_ids_vectorized,
        device_encode_corpus, device_encoder_inputs, flatten_zinc_corpus,
        make_device_encoder)
    from glearning_benchmark_tpu_torch.tokenization.pack import pack_corpus
    from glearning_benchmark_tpu_torch.tokenization.vocab import (
        build_fixed_zinc_vocab, collect_dynamic_tokens, extend_vocab_with_dynamic_tokens)

    mols, secs = timed(lambda: [m for split in ("train", "val", "test")
                                for m in load_zinc_split(split=split)])
    n = len(mols)
    log(f"[host] {n} stand-in ZINC graphs (train, val, test) made in {secs:.2f} s")
    vocab, t_fast = timed_readings(lambda: build_zinc_vocab_fast(mols), 3)
    fixed, _ = build_fixed_zinc_vocab()
    string_vocab, t_str = timed(lambda: extend_vocab_with_dynamic_tokens(
        fixed, collect_dynamic_tokens(tokenize_zinc_corpus(mols), fixed)))
    if vocab != string_vocab:
        raise AssertionError("build_zinc_vocab_fast differs from the string-path vocab")
    pad = vocab["<pad>"]
    scalar, t_scalar = timed(lambda: tokenize_zinc_corpus_ids(mols, vocab))
    with python_paths():
        vec, t_vec = timed_readings(lambda: corpus_ids_vectorized(mols, vocab), 3)
    best, t_best = timed_readings(lambda: corpus_ids_best(mols, vocab), 3)
    dev, t_dev = timed_readings(lambda: device_encode_corpus(mols, vocab, device="cuda"), 3)
    if dev[0].device.type != "cuda":
        raise AssertionError("device_encode_corpus did not run on the card")
    for name, got in (("corpus_ids_vectorized", vec), ("corpus_ids_best", best),
                      ("device_encode_corpus", dev)):
        same_rows(name, got, scalar, pad)
    log(f"[host] ZINC vocab, {n} graphs: build_zinc_vocab_fast (native) "
        f"{fmt_graphs_s(t_fast, n)}, string path {n / t_str:.1f} graphs/s ({t_str:.4f} s); "
        f"equal, {len(vocab)} tokens; on {card}")
    log(f"[host] ZINC ids, {n} graphs, equal over lens (max {int(scalar[1].max())}): "
        f"scalar {n / t_scalar:.1f} graphs/s ({t_scalar:.4f} s), numpy vectorized "
        f"{fmt_graphs_s(t_vec, n)}, native best {fmt_graphs_s(t_best, n)}, device encoder "
        f"end to end {fmt_graphs_s(t_dev, n)}; on {card}")
    # the device encoder alone: its inputs' copy to the card, then the encode
    flat = flatten_zinc_corpus(mols)
    l_max, max_nodes, host_args = device_encoder_inputs(flat)
    nbytes = sum(a.numel() * a.element_size() for a in host_args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    args = [a.to("cuda") for a in host_args]
    end.record()
    torch.cuda.synchronize()
    copy_ms = start.elapsed_time(end)
    enc = make_device_encoder(l_max, vocab, max_nodes, "cuda")
    same_rows("make_device_encoder", enc(*args), scalar, pad)
    enc_ms = cuda_ms(lambda: enc(*args), iters=20)
    log(f"[host] device encoder on {card}: {l_max} wide, encode {fmt_ms(enc_ms)} on the "
        f"device (CUDA events) = {n / (min(enc_ms) / 1e3):.1f} graphs/s; its inputs' "
        f"host-to-device copy {copy_ms:.4f} ms for {nbytes / 1e6:.2f} MB "
        f"({nbytes / copy_ms / 1e6:.2f} GB/s, pageable)")
    log(f"[host] device encoder's kernels (torch.profiler): "
        f"{device_kernels(lambda: enc(*args))}")
    ids, lens = best
    t_pack, t_pack_np = [], []
    for _ in range(5):      # interleaved: the host's load falls on both alike
        packed, t = timed(lambda: pack_corpus(ids, lens, pad_id=pad))
        t_pack.append(t)
        with python_paths():
            packed_np, t = timed(lambda: pack_corpus(ids, lens, pad_id=pad))
        t_pack_np.append(t)
    if not all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(packed, packed_np)):
        raise AssertionError("pack_corpus: the native pass differs from numpy")
    log(f"[host] pack_corpus {list(packed[0].shape)}, equal: native "
        f"{fmt_graphs_s(t_pack, n)}, numpy {fmt_graphs_s(t_pack_np, n)}; on {card}")


def sent_host_paths(graphs, max_len: int, labeled: bool, label: str, card: str) -> None:
    """The native batched SENT tokenizer against the Python TrailTokenizer."""
    import numpy as np

    from glearning_benchmark_tpu_torch import native
    from glearning_benchmark_tpu_torch.tokenization.sent import TrailTokenizer

    tok = TrailTokenizer(max_length=max_len, truncation_length=max_len,
                         labeled_graph=labeled, undirected=True)
    tok.set_num_nodes(max(g.num_nodes for g in graphs))
    kw = {"labeled": labeled}
    if labeled:
        tok.set_num_node_and_edge_types(9, 4)
        kw.update(node_idx_offset=tok.node_idx_offset, edge_idx_offset=tok.edge_idx_offset)
    py, t_py = timed(lambda: [tok(g) for g in graphs])
    (ids, lens), t_nat = timed(lambda: native.sent_tokenize_batch_native(
        graphs, tok.idx_offset, max_len, **kw))
    for i, want in enumerate(py):
        if lens[i] != len(want) or not np.array_equal(ids[i, :lens[i]], want) \
                or (ids[i, lens[i]:] != TrailTokenizer.pad).any():
            raise AssertionError(f"SENT {label}: native trail {i} differs from Python")
    n = len(graphs)
    log(f"[host] SENT {label}, {n} graphs, equal: native {n / t_nat:.1f} graphs/s "
        f"({t_nat:.4f} s), Python {n / t_py:.1f} graphs/s ({t_py:.4f} s) on {card}")


def host_tokenization_phase(gt_root: str, card: str) -> None:
    """Every native host path against its Python counterpart (see the
    module docstring, phase 8)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import numpy as np

    from glearning_benchmark_tpu_torch import native
    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.eval import graph_stats
    from glearning_benchmark_tpu_torch.train import datasets

    if not (native.available() and native.gstats_available()):
        raise AssertionError("the native host library did not build on this machine")
    secs = native.build_seconds()
    log(f"[build] host library (g++ -O3 -march=native, at first use): libgtok "
        f"{secs['gtok']:.2f} s, libgstats {secs['gstats']:.2f} s")
    zinc_host_paths(card)

    sp = graph_config("agtt_graph_token", "shortest_path", gt_root, "", 1)
    sp_graphs = datasets._load_synthetic_graphs(sp["dataset"], 0)
    sent_host_paths([g for s in datasets.SPLITS for g in sp_graphs[s]],
                    int(sp["dataset"]["max_len"]), False, "shortest_path graphs", card)
    sent_host_paths(load_zinc_split(split="val"), 1024, True, "ZINC val (labeled)", card)

    cc = graph_config("ibtt_graph_token", "cycle_check", gt_root, "", 1)
    for cfg in (cc, sp):
        ds = cfg["dataset"]
        fast, t_fast = timed(lambda: datasets._load_synthetic_examples(ds, 0))
        with python_paths():
            slow, t_slow = timed(lambda: datasets._load_synthetic_examples(ds, 0))
        if fast != slow:
            raise AssertionError(f"corpus scan {ds['task']}: examples differ from Python")
        n = sum(len(v) for v in fast.values())
        log(f"[host] corpus scan {ds['task']} ({n} examples, train/val/test as the "
            f"{ds['num_graphs']}-graph config reads them): native {t_fast:.3f} s, Python "
            f"{t_slow:.3f} s, equal; on {card}")

    mols = load_zinc_split(split="val")[:200]
    edges, nodes = [m.edges for m in mols], [m.num_nodes for m in mols]
    counts, t_nat = timed(lambda: graph_stats.orbit_counts_batch(edges, nodes))
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=get_context("spawn")) as pool:
        plain, t_np = timed(lambda: list(pool.map(graph_stats._orbit_counts_numpy,
                                                  edges, nodes)))
    if not all(np.array_equal(a, b) for a, b in zip(counts, plain)):
        raise AssertionError("orbit counts: native differs from numpy")
    log(f"[host] orbit counts, 200 ZINC val graphs: native {t_nat * 1e3:.2f} ms, numpy "
        f"{t_np:.2f} s (process pool), equal; on {card}")

    # the Python rebuild of the shortest_path bundle would repeat the Python
    # scan and trails held above (about 18 s): only cycle_check's is rebuilt
    for model_name, cfg, also_python in (("agtt", sp, False), ("ibtt", cc, True)):
        ds = cfg["dataset"]
        ref = datasets.build_dataset(model_name, ds, 0)          # phase 7's, cached
        build = getattr(datasets, f"build_{model_name}_dataset")
        got, t_nat = timed(lambda: build(ds, 0))
        built = [got]
        if also_python:
            with python_paths():
                py, t_py = timed(lambda: build(ds, 0))
            built.append(py)
        for b in built:
            for split in datasets.SPLITS:
                for k, v in ref.splits[split].items():
                    w = b.splits[split][k]
                    if w.dtype != v.dtype or w.shape != v.shape or not np.array_equal(w, v):
                        raise AssertionError(f"{model_name} {ds['task']} bundle: {split} "
                                             f"{k} differs from phase 7's")
            if (b.vocab, b.vocab_size, b.meta) != (ref.vocab, ref.vocab_size, ref.meta):
                raise AssertionError(f"{model_name} {ds['task']} bundle: meta differs")
        python = f", Python {t_py:.2f} s" if also_python else ""
        log(f"[data] {model_name} {ds['task']} bundle rebuilt without the cache: native "
            f"{t_nat:.2f} s{python}, arrays equal to phase 7's; on {card}")


# ---------------------------------------------------------------------------
# phase 9: data parallelism and the Switch MoE FFN
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_EPOCHS = 2
DP_TIMEOUT = 600          # seconds the ranks may take together
MOE_EXPERTS = 4
# two ranks against one process at f32, the same global batches, seed and
# masks: the first steps see (nearly) the same weights, so their losses
# agree to f32 rounding (sums in another order, cuBLAS kernels picked by row
# count); later epochs are not held, since on the card even two
# one-process runs part (atomic adds in the embedding backward, amplified by
# AdamW on near-zero gradients) and the script prints that spread beside
DP_STEP_RTOL = 1e-4


def even_row_batch(bundle, near: int) -> int:
    """The config batch size nearest ``near`` that, with its packed row
    batch, divides over the ranks: the batches then shard (else every rank
    runs them whole, as in the reference), and one process and the ranks
    run the same global batches (a row batch that does not divide is
    rounded down under data parallelism, as the reference does)."""
    from glearning_benchmark_tpu_torch.train.trainer import train_batch_size

    for delta in range(near):
        for bs in (near - delta, near + delta):
            if bs > 0 and bs % DP_RANKS == 0 \
                    and train_batch_size(bundle, bs) % DP_RANKS == 0:
                return bs
    raise AssertionError("no batch size gives a row batch that divides over the ranks")


def dp_worker(rank: int, world: int, backend: str, init: str, jobs: list,
              out: str) -> None:
    """One rank of phase 9, a spawned process: joins the group as torchrun
    would describe it, runs ``jobs`` through the port's own entry points
    (``train()``; the multi-process ZINC vocab on its shard of the 12,000
    stand-in graphs) and saves what they gave."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.ops import flash_attention as fa
    from glearning_benchmark_tpu_torch.parallel import host_shard_bounds, initialize_distributed
    from glearning_benchmark_tpu_torch.parallel.multiproc import multiprocess_zinc_vocab
    from glearning_benchmark_tpu_torch.train.trainer import _apply_model, train

    dev = initialize_distributed("cuda", backend, init)
    results = {"device": str(dev), "backend": dist.get_backend()}
    for job in jobs:
        t0 = time.perf_counter()
        if job["kind"] == "vocab":
            mols = [m for split in ("train", "val", "test") for m in load_zinc_split(split=split)]
            start, end = host_shard_bounds(len(mols))
            results["vocab"] = multiprocess_zinc_vocab(mols[start:end])
            results["vocab_s"] = time.perf_counter() - t0
            continue
        fa.reset_launches()
        hd.reset_launches()
        states = []
        restore = record_states(states, CPU_CHECK_STEPS) if job.get("stepwise") else None
        try:
            res = train(job["config"], job["model"], limit=job["limit"], verbose=False,
                        device=dev)
        finally:
            if restore is not None:
                restore()
        torch.cuda.synchronize()
        launches = {**fa.LAUNCHES, **hd.LAUNCHES}
        # the model train() returned (whole, on this rank) on the first val rows
        val = res.bundle.splits["val"]
        batch = {k: torch.from_numpy(v[:CPU_CHECK_ROWS]).to(dev) for k, v in val.items()}
        res.model.eval()
        with torch.no_grad():
            logits = _apply_model(res.model, batch, res.bundle).float().cpu()
        results[job["name"]] = {
            "history": res.history, "steps": [s.tolist() for s in res.step_losses],
            "launches": launches, "seconds": time.perf_counter() - t0,
            "sharded": sharding(res.bundle, job["config"], world), "logits": logits,
            "states": states if rank == 0 else []}
    torch.save(results, f"{out}.{rank}")
    dist.destroy_process_group()


def sharding(bundle, config: dict, ranks: int) -> tuple:
    """(whether a run's minibatches shard over the 'data' axis that
    ``ranks`` leave the config's other axes, as ``train()`` decides it, and
    a line that says so)."""
    from glearning_benchmark_tpu_torch.train.trainer import (data_parallel_rows,
                                                             train_batch_size)

    other = math.prod(int(v) for k, v in config.get("parallel", {}).items()
                      if k in ("model_axis", "seq_shards", "pipe_stages", "expert_shards"))
    bs = int(config["train"]["batch_size"])
    rows, sharded = data_parallel_rows(ranks // other, bs, train_batch_size(bundle, bs),
                                       "seg" in bundle.splits["train"])
    return sharded, (f"{'sharded' if sharded else 'NOT sharded'}: batch {bs}, train "
                     f"rows {rows} over a data axis of {ranks // other}")


def run_ranks(jobs: list, tmp: str, ranks: int = DP_RANKS, name: str = "dp") -> list:
    """Run ``jobs`` on ``ranks`` spawned ranks: NCCL when every rank has
    a card of its own, else gloo with CUDA tensors (NCCL refuses two ranks
    on one card). Any rank's failure fails the phase; no rank outlives it."""
    import multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    init = f"file://{tmp}/{name}.rdzv"
    out = os.path.join(tmp, f"{name}_result")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_worker, args=(r, ranks, backend, init, jobs, out))
             for r in range(ranks)]
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    log(f"[{name}] {ranks} ranks over {backend} on {torch.cuda.device_count()} visible "
        f"card(s): exit codes {codes}, {time.perf_counter() - t0:.1f} s")
    if codes != [0] * ranks:
        raise AssertionError(f"a rank failed: exit codes {codes}")
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(ranks)]


def record_states(store: list, steps: int):
    """Wrap the trainer's ``_batch_loss`` and ``_batch_grads`` so that the
    state each of the training steps 2 to ``steps`` starts from is appended
    to ``store``: the parameters, the AdamW moments and counts (split
    tensors gathered whole: a collective every rank makes alike) and the
    position of the dropout seeds' generator, all on the host. Nothing of
    the run changes. Returns the function that takes the wrappers out."""
    from glearning_benchmark_tpu_torch.train import trainer

    batch_loss, batch_grads = trainer._batch_loss, trainer._batch_grads
    seen = {"step": 0}

    def loss_hook(model, arrays, idx_b, valid_b, bundle, generator, *rest):
        seen["model"], seen["gen"] = model, generator.get_state()
        return batch_loss(model, arrays, idx_b, valid_b, bundle, generator, *rest)

    def grads_hook(loss, opt, layout):
        seen["step"] += 1
        if 1 < seen["step"] <= steps:      # before this step's update
            snap = trainer._whole(trainer._snapshot(seen["model"], opt), opt.names,
                                  layout.shards)
            store.append({"step": seen["step"], "gen": seen["gen"],
                          "params": {k: v.cpu() for k, v in snap["params"].items()},
                          "opt": {**snap["opt"], **{w: [t.cpu() for t in snap["opt"][w]]
                                                    for w in ("mu", "nu")}}})
        return batch_grads(loss, opt, layout)

    trainer._batch_loss, trainer._batch_grads = loss_hook, grads_hook

    def restore() -> None:
        trainer._batch_loss, trainer._batch_grads = batch_loss, batch_grads

    return restore


def steps_from_states(bundle, config: dict, model_name: str, states: list,
                      device: str = "cuda") -> list:
    """One process takes each step that ``record_states`` recorded from that
    state (parameters, moments and counts, the dropout seeds' position) on
    the same batch of the first epoch: its step losses, in order."""
    from glearning_benchmark_tpu_torch.train.trainer import train_epoch

    model, opt, arrays, idx, valid, gen = first_epoch(bundle, config, device,
                                                      model_name=model_name)
    aux = float(config["model"].get("moe_aux_weight", 0.01))
    out = []
    for st in states:
        model.load_state_dict(st["params"])
        opt.load_state(st["opt"])
        gen.set_state(st["gen"])
        b = st["step"] - 1
        _, loss = train_epoch(model, opt, arrays, idx[b:b + 1], valid[b:b + 1], bundle, gen,
                              moe_aux_weight=aux)
        out.append(float(loss[0]))
    return out


def _metrics(history: list) -> list:
    return [{k: v for k, v in h.items()
             if not k.startswith(("time/", "throughput/", "efficiency/", "memory/"))}
            for h in history]


def dp_against_single(name: str, ranks: list, single, single_launches: dict,
                      card: str, step_atol=None) -> None:
    """The ranks' run against the one-process run of the same config: the
    run sharded; equal metrics on every rank; kernel launches on each rank
    equal to the one process's (every rank takes every step on its rows);
    losses finite and falling; the first ``CPU_CHECK_STEPS`` step losses
    within ``DP_STEP_RTOL`` of the one process's or, with ``step_atol``
    (bf16), within that absolute gap."""
    import numpy as np

    got = [r[name] for r in ranks]
    for r, g in enumerate(got[1:], 1):
        for mine, first in zip(_metrics(g["history"]), _metrics(got[0]["history"])):
            differ = {k: (first[k], v) for k, v in mine.items() if first.get(k) != v}
            if differ:
                raise AssertionError(f"{name}: rank {r} disagrees with rank 0 on "
                                     f"(rank 0, rank {r}) {differ}")
    for r, g in enumerate(got):
        if (attention_launches(g["launches"]) != attention_launches(single_launches)
                or not g["launches"]["hash_dropout"] > 0):
            raise AssertionError(f"{name}: rank {r} kernel launches {g['launches']}, "
                                 f"one process {single_launches}")
    layout = (f"{len(got)} ranks sharing one card (not a scaling figure)"
              if torch.cuda.device_count() < len(got) else f"{len(got)} ranks, a card each")
    for h, w in zip(got[0]["history"], single.history):
        log(f"[dp] {name} epoch {h['epoch']}: train loss {h['train/loss']:.6f} "
            f"(one process {w['train/loss']:.6f}), val loss {h['val/loss']:.6f} "
            f"({w['val/loss']:.6f}), grad norm {h['train/grad_norm']:.4f} "
            f"({w['train/grad_norm']:.4f}); {h['throughput/graphs_per_sec']:.1f} "
            f"examples/s on {layout} (one process "
            f"{w['throughput/graphs_per_sec']:.1f}) on {card}")
    steps = np.array(got[0]["steps"][0][:CPU_CHECK_STEPS])
    want_steps = np.asarray(single.step_losses[0][:CPU_CHECK_STEPS])
    log(f"[dp] {name}: first {len(steps)} step losses {steps.tolist()} against one "
        f"process {want_steps.tolist()}; launches a rank {got[0]['launches']}; rank 0 "
        f"call {got[0]['seconds']:.1f} s; {got[0]['sharded'][1]}")
    if not got[0]["sharded"][0]:
        raise AssertionError(f"{name}: the run did not shard over the ranks")
    finite = all(math.isfinite(v) for g in got for h in g["history"]
                 for v in (h["train/loss"], h["val/loss"]))
    hist = got[0]["history"]
    falls = len(hist) < 2 or hist[-1]["train/loss"] < hist[0]["train/loss"]
    if step_atol is None:
        ok = bool(np.allclose(steps, want_steps, rtol=DP_STEP_RTOL, atol=0))
    else:
        ok = bool(np.abs(steps - want_steps).max() <= step_atol)
    if not (finite and falls and ok and len(hist) == len(single.history)):
        raise AssertionError(f"{name}: two ranks disagree with one process")


def dp_moe_phase(fa, tmp: str, gt_root: str, graphs, seg_train, gen, p: float,
                 card: str) -> tuple:
    """Phase 9 (module docstring). Returns (kernel errors at a non-zero
    bh_offset, backward kernel errors, launches by path)."""
    import copy

    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split
    from glearning_benchmark_tpu_torch.tokenization.ibtt_fast import build_zinc_vocab_fast
    from glearning_benchmark_tpu_torch.train.datasets import build_dataset

    # the kernels at rank 1's place in a global batch of two row batches,
    # bf16 (the mma kernels) and f32 (the FP32-pipe kernels)
    b, l = seg_train.shape
    shape = (b, l, 4, 16)
    offset = b * shape[2]
    errs, berrs = [], []
    for dt in (torch.bfloat16, torch.float32):
        errs.append(compare("agtt-zinc packed train rows, rank 1 of 2", fa,
                            *qkv_views(shape, dt, gen), seg_train, p_drop=p,
                            seed=4321, bh_offset=offset))
        berrs.append(compare_bwd("agtt-zinc packed train rows, rank 1 of 2", fa,
                                 *qkv_views(shape, dt, gen), seg_train,
                                 strided_do(shape, dt, gen), p, 4321, offset))

    launches = {}
    zinc_root = os.path.join(tmp, "ZINC")
    out = os.path.join(tmp, "runs_dp")
    ds = train_config("agtt", AGTT_ZINC_MODEL, zinc_root, out, True, 1)["dataset"]
    bs = even_row_batch(build_dataset("agtt", ds, ZINC_TRAIN["seed"]),
                        ZINC_TRAIN["batch_size"])
    runs = {f"agtt_dp_{dt}": ("agtt", train_config(
        "agtt", {**AGTT_ZINC_MODEL, "compute_dtype": dt}, zinc_root,
        os.path.join(out, dt), True, DP_EPOCHS, batch_size=bs), None)
        for dt in ("float32", "bfloat16")}
    mpnn = graph_config("mpnn_graph_token", "cycle_check", gt_root,
                        os.path.join(out, "mpnn"), GRAPH_EPOCHS)
    mpnn["model"]["compute_dtype"] = "float32"
    runs["mpnn_dp_float32"] = ("mpnn", mpnn, None)
    log(f"[dp] agtt-zinc width on the stand-in splits, batch size {bs} (its "
        f"packed row batch divides over {DP_RANKS} ranks), {DP_EPOCHS} epochs, f32 and "
        f"bf16; mpnn cycle_check f32, {GRAPH_EPOCHS} epochs")
    single = {}
    for name, (model_name, cfg, limit) in runs.items():
        single[name], launches[f"train_{name}_one_process"] = train_phase(
            fa, model_name, cfg, limit, card)
    # the card's own spread: the f32 token run once more in one process
    model_name, cfg, limit = runs["agtt_dp_float32"]
    cfg = copy.deepcopy(cfg)
    cfg["output"]["out_dir"] += "_again"
    again, _ = train_phase(fa, model_name, cfg, limit, card)
    for h, w in zip(again.history, single["agtt_dp_float32"].history):
        log(f"[dp] one process run twice, f32, epoch {h['epoch']}: train loss "
            f"{h['train/loss']:.6f} and {w['train/loss']:.6f}, val loss "
            f"{h['val/loss']:.6f} and {w['val/loss']:.6f} (the card's run-to-run spread)")
    jobs = []
    for name, (model_name, cfg, limit) in runs.items():
        cfg = copy.deepcopy(cfg)
        cfg["output"]["out_dir"] += "_ranks"
        jobs.append({"kind": "train", "name": name, "model": model_name, "config": cfg,
                     "limit": limit})
    jobs.append({"kind": "vocab"})
    ranks = run_ranks(jobs, tmp)
    log(f"[dp] rank devices {[r['device'] for r in ranks]}, backend {ranks[0]['backend']}")
    for name in runs:
        dp_against_single(name, ranks, single[name], launches[f"train_{name}_one_process"],
                          card, STEP_LOSS_ATOL if name.endswith("bfloat16") else None)
        for r, rank in enumerate(ranks):
            launches[f"train_{name}_rank{r}"] = rank[name]["launches"]
    mols = [m for split in ("train", "val", "test") for m in load_zinc_split(split=split)]
    host = build_zinc_vocab_fast(mols)
    same = all(rank["vocab"] == host for rank in ranks)
    log(f"[dp] ZINC vocab over {len(mols)} stand-in graphs on {DP_RANKS} ranks "
        f"({len(host)} ids, rank 0 {ranks[0]['vocab_s']:.2f} s) equals the one-process "
        f"vocab: {same}")
    if not same:
        raise AssertionError("the multi-process ZINC vocab differs from the one-process one")

    # the Switch MoE FFN at agtt_zinc width, one process
    moe_cfg = train_config("agtt", {**AGTT_ZINC_MODEL, "moe_experts": MOE_EXPERTS},
                           zinc_root, os.path.join(tmp, "runs_moe"), True, TRAIN_EPOCHS)
    res, launches["train_agtt_moe"] = train_phase(fa, "agtt", moe_cfg, None, card)
    first_steps_on_cpu(res, moe_cfg)
    trained_checkpoint_serves(res, moe_cfg, graphs)
    train_step_breakdown(res, moe_cfg)
    return errs, berrs, launches


# ---------------------------------------------------------------------------
# phase 10: the other mesh axes (TP, the SP ring, PP, EP)
# ---------------------------------------------------------------------------

MESH_EPOCHS = 2
MESH_LIMIT = 2048         # ZINC train graphs of the TP, PP and EP runs
SP_LIMIT = 512            # of the SP runs (ibtt_zinc width, unpacked)
SP_BATCH = 32
MESH_STEP_RTOL = 1e-4     # f32 first steps, as phase 9 (bf16: STEP_LOSS_ATOL)
# the bf16 runs whose top-1 routing can flip: their steps 2-4 are held step
# by step, each from the ranks' own state (mesh_against_single)
STEPWISE = ("ep_bfloat16", "ep_manual_bfloat16")


def mesh_runs(tmp: str, bs: int) -> dict:
    """{name: (model, config, limit, ranks)} of phase 10; ``bs`` is a batch
    size whose packed row batch divides over two (the pipeline's
    microbatches, the manual EP rows)."""
    zinc_root = os.path.join(tmp, "ZINC")
    out = os.path.join(tmp, "runs_mesh")
    moe = {**AGTT_ZINC_MODEL, "moe_experts": MOE_EXPERTS}
    axes = {"tp": ("agtt", AGTT_ZINC_MODEL, True, {"model_axis": 2}),
            "sp": ("ibtt", IBTT_ZINC_MODEL, False, {"seq_shards": 2}),
            "pp": ("agtt", AGTT_ZINC_MODEL, True, {"pipe_stages": 2, "pipe_microbatches": 2}),
            "ep": ("agtt", moe, True, {"expert_shards": 2}),
            "ep_manual": ("agtt", moe, True, {"expert_shards": 2, "ep_manual": True})}
    runs = {}
    for axis, (model_name, model_cfg, pack, par) in axes.items():
        for dt in ("float32", "bfloat16"):
            name = f"{axis}_{dt}"
            cfg = train_config(model_name, {**model_cfg, "compute_dtype": dt}, zinc_root,
                               os.path.join(out, name), pack, MESH_EPOCHS,
                               batch_size=SP_BATCH if axis == "sp" else bs)
            cfg["parallel"] = par
            runs[name] = (model_name, cfg, SP_LIMIT if axis == "sp" else MESH_LIMIT,
                          DP_RANKS)
    if torch.cuda.device_count() >= 4:
        model_name, cfg, limit, _ = runs["tp_float32"]
        cfg = {**cfg, "output": {**cfg["output"], "out_dir": os.path.join(out, "dm")}}
        runs["data2_model2_float32"] = (model_name, cfg, limit, 4)
    return runs


def mesh_against_single(name: str, ranks: list, cfg: dict, single,
                        single_launches: dict, graphs, card: str, model_name: str) -> None:
    """Phase 10's checks of one run (module docstring). A run of
    ``STEPWISE`` holds its step 1 against the one-process run and each of
    its steps 2-4 against one process's step from the ranks' state before
    it (``record_states``, ``steps_from_states``): two ranks sum the
    router's gradients in another order than one process (2.0e-10 apart
    after step 1), and from step 2 on tokens whose top-1 router margins are
    near 1e-6 take another expert, so free-running runs part by chance, not
    by a fault of the ranks' code. The free-running losses are printed
    beside them."""
    import copy

    import numpy as np

    from glearning_benchmark_tpu_torch.serve import Predictor

    got = [r[name] for r in ranks]
    for r, g in enumerate(got[1:], 1):
        if _metrics(g["history"]) != _metrics(got[0]["history"]):
            raise AssertionError(f"{name}: rank {r} disagrees with rank 0")
    want = attention_launches(single_launches)
    if name.startswith("sp_"):
        want = {k: 0 for k in want}
    for r, g in enumerate(got):
        if attention_launches(g["launches"]) != want or not g["launches"]["hash_dropout"] > 0:
            raise AssertionError(f"{name}: rank {r} kernel launches {g['launches']}, "
                                 f"expected {want} and hash-dropout launches")
    layout = (f"{len(got)} ranks sharing one card (not a scaling figure)"
              if torch.cuda.device_count() < len(got) else f"{len(got)} ranks, a card each")
    for h, w in zip(got[0]["history"], single.history):
        log(f"[mesh] {name} epoch {h['epoch']}: train loss {h['train/loss']:.6f} "
            f"(one process {w['train/loss']:.6f}), val loss {h['val/loss']:.6f} "
            f"({w['val/loss']:.6f}); {h['throughput/graphs_per_sec']:.1f} examples/s, "
            f"{h['time/epoch_duration']:.2f} s an epoch on {layout} (one process "
            f"{w['throughput/graphs_per_sec']:.1f}, {w['time/epoch_duration']:.2f} s) "
            f"on {card}")
    steps = np.array(got[0]["steps"][0][:CPU_CHECK_STEPS])
    want_steps = np.asarray(single.step_losses[0][:CPU_CHECK_STEPS])
    if name.endswith("float32"):
        ok = bool(np.allclose(steps, want_steps, rtol=MESH_STEP_RTOL, atol=0))
    elif name in STEPWISE:
        states = got[0]["states"]
        if [st["step"] for st in states] != list(range(2, len(steps) + 1)):
            raise AssertionError(f"{name}: the ranks recorded the states of steps "
                                 f"{[st['step'] for st in states]}")
        one = copy.deepcopy(cfg)
        one.pop("parallel")
        held = np.array([want_steps[0]] + steps_from_states(single.bundle, one, model_name,
                                                            states))
        gaps = np.abs(steps - held)
        log(f"[mesh] {name} step by step: the ranks' losses {steps.tolist()}; one process "
            f"{held.tolist()} (step 1 from the same initial state, steps 2-"
            f"{len(steps)} each from the ranks' state before it); |d| "
            f"{[float(f'{g:.3e}') for g in gaps]} (atol {STEP_LOSS_ATOL:g}); free-running "
            f"|d| {[float(f'{g:.3e}') for g in np.abs(steps - want_steps)]}, not held")
        ok = bool(gaps.max() <= STEP_LOSS_ATOL)
    else:
        ok = bool(np.abs(steps - want_steps).max() <= STEP_LOSS_ATOL)
    hist = got[0]["history"]
    finite = all(math.isfinite(v) for g in got for h in g["history"]
                 for v in (h["train/loss"], h["val/loss"]))
    falls = hist[-1]["train/loss"] < hist[0]["train/loss"]
    # the best checkpoint the ranks gathered, served by one process
    path = os.path.join(cfg["output"]["out_dir"], f"best_{cfg['output']['run_name']}")
    pred = Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cuda")
    served = pred.predict_graphs(graphs[:CPU_CHECK_ROWS])["pred"]
    err = float(abs(served - got[0]["logits"].numpy()).max())
    log(f"[mesh] {name}: first {len(steps)} step losses {steps.tolist()} against one "
        f"process {want_steps.tolist()}; launches a rank {got[0]['launches']}; the "
        f"gathered best checkpoint served by one process against the ranks' model: "
        f"max|d| {err:.3e} (atol {SERVED_LOGIT_ATOL:g}); rank 0 call "
        f"{got[0]['seconds']:.1f} s; parallel {cfg['parallel']}")
    if not (finite and falls and ok and err <= SERVED_LOGIT_ATOL
            and len(hist) == len(single.history)):
        raise AssertionError(f"{name}: the ranks disagree with one process "
                             f"(finite {finite}, falls {falls}, steps {ok}, served {err})")


def mesh_phase(fa, tmp: str, graphs, card: str) -> dict:
    """Phase 10 (module docstring). Returns the launches by path."""
    import copy

    from glearning_benchmark_tpu_torch.train.datasets import build_dataset

    ds = train_config("agtt", AGTT_ZINC_MODEL, os.path.join(tmp, "ZINC"), "", True, 1)
    bs = even_row_batch(build_dataset("agtt", ds["dataset"], ZINC_TRAIN["seed"],
                                      limit=MESH_LIMIT), ZINC_TRAIN["batch_size"])
    runs = mesh_runs(tmp, bs)
    log(f"[mesh] {len(runs)} runs of {MESH_EPOCHS} epochs: agtt_zinc width on "
        f"{MESH_LIMIT} stand-in graphs a split, batch size {bs}; ibtt_zinc width "
        f"on {SP_LIMIT}, batch size {SP_BATCH}")
    launches, single = {}, {}
    for name, (model_name, cfg, limit, _) in runs.items():
        if name.startswith("data2"):       # the same run as tp_float32's
            single[name] = single["tp_float32"]
            continue
        one = copy.deepcopy(cfg)
        one.pop("parallel")
        one["output"]["out_dir"] += "_one_process"
        single[name], launches[f"train_{name}_one_process"] = train_phase(
            fa, model_name, one, limit, card)
    for world in sorted({r[3] for r in runs.values()}):
        jobs = [{"kind": "train", "name": name, "model": m, "config": cfg, "limit": limit,
                 "stepwise": name in STEPWISE}
                for name, (m, cfg, limit, w) in runs.items() if w == world]
        ranks = run_ranks(jobs, tmp, ranks=world, name=f"mesh{world}")
        log(f"[mesh] rank devices {[r['device'] for r in ranks]}, backend "
            f"{ranks[0]['backend']}")
        for job in jobs:
            name = job["name"]
            one = "tp_float32" if name.startswith("data2") else name
            mesh_against_single(name, ranks, job["config"], single[name],
                                launches[f"train_{one}_one_process"], graphs, card,
                                job["model"])
            for r, rank in enumerate(ranks):
                launches[f"train_{name}_rank{r}"] = rank[name]["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 11: the tools (head dims 128, 64, 12, 256 and 160, the north-star
# bench, the step MFU, the attention A/B, serving)
# ---------------------------------------------------------------------------

MFU_SHAPE = (64, 1024, 8, 128)   # tools/mfu_bench.py's d_model 1024 rows: B, L, H, D
PADDED_HEAD_DIM = 12
WIDE_HEAD_DIMS = (256, 160)      # above 128: bf16 the wgmma instance at 256 (160 zero-padded),
                                 # f32 the wide route (a whole chunk, and one and a partial one)
ABOVE_WGMMA = 320                # bf16 above the wgmma instance at 256: the three kernels'
                                 # wgmma_chunks instance at 320
CHUNK_HEAD_DIMS = (384, 448, 512)    # the other wgmma_chunks instances
ABOVE_CHUNKS = 640               # bf16 above them: the wide route
CHUNKS_ROW = (8, 1024, 8, 512)   # the widest wgmma_chunks instance, packed
CHUNKS_FWD_ROW = (8, 1024, 8, 384)   # the forward alone at the next instance, packed
PADDED_CHUNK_DIM = 300           # padded to 320 by the backward's wrappers
D2560_ARGS = ["--d-model", "2560", "--heads", "8", "--layers", "2", "--batch", "8"]
D2048_SHAPE = (16, 1024, 8, 256) # mfu_bench --d-model 2048 --batch 16: its attention, dense
D2048_ARGS = ["--d-model", "2048", "--batch", "16"]
WIDE_F32_ROWS = 16               # batch rows of the f32 checks above 128 (slow plain version)
XL_SHAPE = (4, 4096, 8, 64)      # tools/flash_ab.py's xl
MFU_STEPS = 4                    # the timed block (and a half block of 2)
AB_SHAPES = "ibtt-zinc,agtt-zinc,xl"
SERVE_FAMILIES = (("agtt", "agtt_graph_token"), ("mpnn", "mpnn_graph_token"))
SERVE_BUCKETS = (1, 256)
SERVE_REPS = 3
SCALING_MOLS = 1000              # molecules a host of the scaling bench
GCN_GAT_EPOCHS = 20


def instances(fa) -> dict:
    """Every instance of the three kernels that ``fa.design`` can choose (the
    head dims with an instance, the three kernels' wgmma instances at 256,
    the wgmma_chunks instances at 320-512, the wide route, each input
    type, views TMA can and cannot read, with and without dropout, and the
    forward's wgmma and wgmma_chunks instances of the short hash):
    its design and its resources as ``cudaFuncGetAttributes`` reports them.
    Every instance of the bf16 route's designs (mma.sync at head dims 4-32,
    whose second products take three split terms, and at 64 and 128 for
    views TMA cannot read; wgmma; the wide route) must spill nothing; only
    the f32 design may."""
    out = {}
    for name in fa.SOURCES:
        for d in fa.HEAD_DIMS + (WIDE_HEAD_DIMS[0], ABOVE_WGMMA) + CHUNK_HEAD_DIMS + (
                ABOVE_CHUNKS,):
            for dtype in (torch.bfloat16, torch.float32):
                for tma in (True, False):
                    design = fa.design(name, d, dtype, tma)
                    forms = [(True, False), (False, False)]
                    if name == "flash_attn_fwd" and design in ("wgmma", "wgmma_chunks"):
                        forms.append((True, True))      # the short-hash instance
                    for drop, short in forms:
                        key = (f"{name}_{design}_d{'>128' if design == 'wide' and d > 128 else d}"
                               f"_{str(dtype)[6:]}" + ("_dropout" if drop else "")
                               + ("_short_hash" if short else ""))
                        attrs = fa.kernel_attrs(name, d, dtype, dropout=drop, short_hash=short,
                                                tma=tma)
                        out[key] = {"design": design, **attrs}
                        if design != "f32" and attrs["local_bytes"] != 0:
                            raise AssertionError(
                                f"{key}: {attrs['local_bytes']} B spilled a thread")
    for key, a in out.items():
        if a["design"] != "f32":
            log(f"[kernel] {key}: {a['static_smem_bytes']} B static + "
                f"{a['dynamic_smem_bytes']} B dynamic shared memory, {a['registers']} "
                f"registers, {a['local_bytes']} B spilled a thread")
    return out


def head_dim_rows(fa, gen: torch.Generator, cgen: torch.Generator, p: float) -> tuple:
    """The kernels at the mfu_bench rows with packed segments at the
    training rate ``p``: head dims 128 and 64 (the wgmma instances in bf16;
    in f32 the wide route at 128, the f32 design at 64), a padded head dim
    (12), and above 128 (256, 160: bf16 the three kernels' wgmma instances
    at 256, 160 zero-padded; f32 the wide route), bf16 and f32; then the
    bf16 kernels on the dense mfu_bench rows (every token valid: the step's
    own shape) at 128 and 64, on the dense attention of the d_model 2048
    step (``D2048_SHAPE``, head dim 256), and at xl (flash_ab's ragged key
    mask); bf16 above the wgmma instances at 256 (320, packed, 16 batch
    rows, and ``CHUNKS_ROW``: the three kernels' wgmma_chunks instances;
    the forward alone at ``CHUNKS_FWD_ROW``; the forward also on the wide
    route, ``wide_forward``) and the backward's padding copies between its
    instances (``padding_share``); then views TMA cannot read (the forward
    at 64, 128 and 256). Every row is held to the plain versions before the same inputs
    are timed. Returns (forward errors, backward errors, timings by
    shape)."""
    from glearning_benchmark_tpu_torch.tools.flash_ab import inputs

    b, l, h, d = MFU_SHAPE
    seg = packed_seg(b, l, cgen)
    errs, berrs, timing = [], [], {}
    for dim in (d, 64, PADDED_HEAD_DIM) + WIDE_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            rows = WIDE_F32_ROWS if dtype == torch.float32 and dim > d else b
            shape, seg_d = (rows, l, h, dim), seg[:rows].contiguous()
            name = f"d{dim} {str(dtype)[6:]}"
            q, k, v = qkv_views(shape, dtype, gen)
            do = strided_do(shape, dtype, gen)
            errs.append(compare(f"mfu rows {name}", fa, q, k, v, seg_d, p_drop=p, seed=11,
                                chunk=8))
            berrs.append(compare_bwd(f"mfu rows {name}", fa, q, k, v, seg_d, do, p, 11,
                                     chunk=8))
            slow = dtype == torch.float32 or dim > d     # the FP32 pipe: fewer calls
            timing[f"mfu_rows_d{dim}_B{rows}_{str(dtype)[6:]}_p{p}"] = time_bwd(
                fa, q, k, v, seg_d, do, p, 11, f"mfu rows {name}",
                iters=5 if slow else 20, plain_iters=2)
            del q, k, v, do
            torch.cuda.empty_cache()
    dense = torch.ones(b, l, dtype=torch.int32, device="cuda")
    for dim in (d, 64):
        shape = (b, l, h, dim)
        args = (*qkv_views(shape, torch.bfloat16, gen), dense,
                strided_do(shape, torch.bfloat16, gen))
        label = f"mfu dense rows d{dim} bfloat16"
        errs.append(compare(label, fa, *args[:4], p_drop=p, seed=11, chunk=8))
        berrs.append(compare_bwd(label, fa, *args, p, 11, chunk=8))
        timing[f"mfu_dense_rows_d{dim}_bfloat16_p{p}"] = time_bwd(
            fa, *args, p, 11, label, iters=20, plain_iters=2)
        del args
        torch.cuda.empty_cache()
    b2, l2, h2, d2 = D2048_SHAPE
    args = (*qkv_views(D2048_SHAPE, torch.bfloat16, gen),
            torch.ones(b2, l2, dtype=torch.int32, device="cuda"),
            strided_do(D2048_SHAPE, torch.bfloat16, gen))
    label = f"d_model 2048 dense rows d{d2} bfloat16"
    errs.append(compare(label, fa, *args[:4], p_drop=p, seed=11, chunk=4))
    berrs.append(compare_bwd(label, fa, *args, p, 11, chunk=4))
    timing[f"d2048_dense_rows_d{d2}_B{b2}_bfloat16_p{p}"] = time_bwd(
        fa, *args, p, 11, label, iters=10, plain_iters=1)
    del args
    torch.cuda.empty_cache()
    q, k, v, seg_xl, _ = inputs(*XL_SHAPE, torch.device("cuda"))
    do = strided_do(XL_SHAPE, torch.bfloat16, gen)
    label = "xl (flash_ab's ragged key mask) bfloat16"
    errs.append(compare(label, fa, q, k, v, seg_xl, p_drop=p, seed=11, chunk=1))
    berrs.append(compare_bwd(label, fa, q, k, v, seg_xl, do, p, 11, chunk=1))
    timing[f"xl_d{XL_SHAPE[3]}_bfloat16_p{p}"] = time_bwd(
        fa, q, k, v, seg_xl, do, p, 11, label, iters=10, plain_iters=2)
    del q, k, v, do
    torch.cuda.empty_cache()
    for rows, dim in ((WIDE_F32_ROWS, ABOVE_WGMMA), (CHUNKS_ROW[0], CHUNKS_ROW[3])):
        shape, seg_d = (rows, l, h, dim), seg[:rows].contiguous()
        q, k, v = qkv_views(shape, torch.bfloat16, gen)
        do = strided_do(shape, torch.bfloat16, gen)
        label = f"mfu rows d{dim} bfloat16"
        designs = {name: fa.design(name, dim, q.dtype, fa.tma_ok(q, k, v)) for name in fa.SOURCES}
        log(f"[kernel] {label} {list(shape)}: designs {designs}")
        if set(designs.values()) != {"wgmma_chunks"}:
            raise AssertionError(f"{label}: not the wgmma_chunks design: {designs}")
        errs.append(compare(label, fa, q, k, v, seg_d, p_drop=p, seed=11, chunk=8))
        berrs.append(compare_bwd(label, fa, q, k, v, seg_d, do, p, 11, chunk=8))
        timing[f"mfu_rows_d{dim}_B{rows}_bfloat16_p{p}"] = t = time_bwd(
            fa, q, k, v, seg_d, do, p, 11, label, iters=5, plain_iters=2)
        wide_forward(fa, q, k, v, seg_d, p, label, t["flash_attn_fwd"])
        del q, k, v, do
        torch.cuda.empty_cache()
    shape = CHUNKS_FWD_ROW
    seg_d = seg[:shape[0]].contiguous()
    q, k, v = qkv_views(shape, torch.bfloat16, gen)
    label = f"mfu rows d{shape[3]} bfloat16"
    if fa.design("flash_attn_fwd", shape[3], q.dtype, fa.tma_ok(q, k, v)) != "wgmma_chunks":
        raise AssertionError(f"{label}: the forward does not take the wgmma_chunks design")
    errs.append(compare(label, fa, q, k, v, seg_d, p_drop=p, seed=11, chunk=8))
    t = time_fwd(fa, q, k, v, seg_d, p, 11, label, iters=20, plain_iters=2)
    timing[f"mfu_rows_d{shape[3]}_B{shape[0]}_bfloat16_p{p}"] = {"flash_attn_fwd": t}
    wide_forward(fa, q, k, v, seg_d, p, label, t)
    del q, k, v
    torch.cuda.empty_cache()
    padding_share(fa, gen, seg[:WIDE_F32_ROWS].contiguous(),
                  (WIDE_F32_ROWS, l, h, PADDED_CHUNK_DIM), p)
    for dim, design in ((64, "mma"), (d, "mma"), (WIDE_HEAD_DIMS[0], "wide")):
        err, ms = tma_refused_view(fa, gen, seg[:8].contiguous(), dim, design, p)
        errs.append(err)
        timing[f"mfu_rows_d{dim}_B8_bfloat16_off_grid_p{p}"] = {"flash_attn_fwd": ms}
    return errs, berrs, timing


def wide_forward(fa, q, k, v, seg, p: float, label: str, t: dict) -> None:
    """The forward on the wide route (the launcher's ``force``) on the
    inputs that ``t`` (``time_fwd``'s result) timed in the wgmma_chunks
    design: the design it replaced, read in the same call."""
    kw = {"p_drop": p, "seed": 11, "bh_offset": 0, "scale": q.shape[3] ** -0.5}
    ms = cuda_ms(lambda: fa._launch_fwd(q, k, v, seg, force="wide", **kw), 3)
    log(f"[kernel] forward {label} {list(q.shape)} bfloat16 p_drop {p}: wgmma_chunks "
        f"{t['ms']:.4f} ms against the wide route's {fmt_ms(ms)} on the same inputs "
        f"({min(ms) / t['ms']:.1f}x), sdpa forward {t['library_ms']:.4f} ms "
        f"({t['ms'] / t['library_ms']:.3f}x), bound {t['bound_ms']:.4f} ms "
        f"({t['ms'] / t['bound_ms']:.1f}x)")


def padding_share(fa, gen: torch.Generator, seg: torch.Tensor, shape: tuple,
                  p: float) -> None:
    """The backward's padding copies (``ROADMAP.md`` B8) at a head dim
    between wgmma_chunks instances: the whole backward call
    (``flash_attention_bwd``: the pads, dQ and dK/dV at the padded head dim)
    and the five ``F.pad`` copies it makes alone, on the same inputs."""
    d = shape[-1]
    pad = fa.padded_head_dim(d, "flash_attn_bwd_dq", torch.bfloat16) - d
    q, k, v = qkv_views(shape, torch.bfloat16, gen)
    do = strided_do(shape, torch.bfloat16, gen)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p, 11)
    call_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, seg, o, lse, do, p, 11), 10)
    pad_ms = cuda_ms(lambda: [torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v, o, do)], 10)
    log(f"[kernel] padding copies {list(shape)} bfloat16 -> head dim {d + pad}: the five pads "
        f"{fmt_ms(pad_ms)} of the backward call's {fmt_ms(call_ms)} (share "
        f"{min(pad_ms) / min(call_ms):.3f})")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def tma_refused_view(fa, gen: torch.Generator, seg: torch.Tensor, d: int, design: str,
                     p: float) -> tuple:
    """The forward's dispatch rule: q, k, v views one element off the
    16-byte grid (TMA cannot read them) run ``design`` at head dim ``d``
    (mma.sync at 64 and 128, the wide route at 256), are counted in
    ``TMA_REFUSED``, are held to the plain version and then timed. Returns
    (the error, the forward's times)."""
    b, l = seg.shape
    h = MFU_SHAPE[2]
    flat = torch.randn(b * l * 3 * h * d + 1, device="cuda", generator=gen).bfloat16()
    qkv = flat[1:].view(b, l, 3 * h * d)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    if fa.tma_ok(q, k, v) or fa.design("flash_attn_fwd", d, q.dtype, tma=False) != design:
        raise AssertionError(f"an odd-offset view at head dim {d} does not take {design}")
    label = f"mfu rows d{d} bfloat16, a view off the 16-byte grid ({design})"
    before = fa.TMA_REFUSED["flash_attn_fwd"]
    err = compare(label, fa, q, k, v, seg, p_drop=p, seed=11, chunk=8)
    refused = fa.TMA_REFUSED["flash_attn_fwd"] - before
    log(f"[kernel] forward dispatch: {refused} launches of a view TMA cannot read took the "
        f"{design} design at head dim {d} (the rule, before the launch; counted in "
        f"TMA_REFUSED)")
    if refused != 2:    # compare's two runs
        raise AssertionError(f"the unaligned view's launches were not counted: {refused}")
    ms = time_fwd(fa, q, k, v, seg, p, 11, label, iters=5 if design == "wide" else 20,
                  plain_iters=2)
    return err, ms


def f32_against_wide(fa, rows: dict, gen: torch.Generator, p: float) -> None:
    """The reading that keeps the f32 design beside the wide route: at each
    of ``rows`` ({label: (shape, seg)}, f32, q, k, v strided views of one
    fused qkv, a strided dO) the three kernels run under both designs
    (the launchers' ``force``), the wide route's O, LSE, dQ, delta, dK and
    dV are held to the f32 design's (the backward tolerance; LSE and delta
    within ``LSE_ATOL``), and each kernel is timed under both."""
    for label, (shape, seg) in rows.items():
        q, k, v = qkv_views(shape, torch.float32, gen)
        do = strided_do(shape, torch.float32, gen)
        kw = {"p_drop": p, "seed": 11, "bh_offset": 0, "scale": shape[3] ** -0.5}
        outs, ms = {}, {}
        for route in ("f32", "wide"):
            o, lse = fa._launch_fwd(q, k, v, seg, force=route, **kw)
            dq, delta = fa._launch_dq(q, k, v, seg, o, lse, do, force=route, **kw)
            dk, dv = fa._launch_dkv(q, k, v, seg, o, lse, do, delta, force=route, **kw)
            outs[route] = {"O": o, "LSE": lse, "dQ": dq, "delta": delta, "dK": dk, "dV": dv}
            ms[route] = [min(cuda_ms(fn, 20)) for fn in (
                lambda: fa._launch_fwd(q, k, v, seg, force=route, **kw),
                lambda: fa._launch_dq(q, k, v, seg, o, lse, do, force=route, **kw),
                lambda: fa._launch_dkv(q, k, v, seg, o, lse, do, delta, force=route, **kw))]
        diffs, ok = [], True
        for what, want in outs["f32"].items():
            got = outs["wide"][what]
            err = (got - want).abs()
            if what in ("LSE", "delta"):
                ok &= bool((err <= LSE_ATOL).all())
            else:
                ok &= bool((err <= G_RTOL[torch.float32] * want.abs() + G_ATOL).all())
            diffs.append(f"{what} {err.max().item():.3e}")
        log(f"[kernel] f32 design against the wide route, {label} {list(shape)} float32 "
            f"p_drop {p}: forward {ms['f32'][0]:.4f} / {ms['wide'][0]:.4f} ms, dQ "
            f"{ms['f32'][1]:.4f} / {ms['wide'][1]:.4f} ms, dK/dV {ms['f32'][2]:.4f} / "
            f"{ms['wide'][2]:.4f} ms (wide / f32: " + ", ".join(
                f"{w / f:.2f}x" for f, w in zip(ms["f32"], ms["wide"]))
            + f"); max|wide - f32| {', '.join(diffs)}")
        if not ok:
            raise AssertionError(f"the wide route disagrees with the f32 design: {label}")
        del q, k, v, do, outs
        torch.cuda.empty_cache()


def captured(fn, argv: list) -> list:
    """The JSON lines ``fn(argv)`` prints, parsed, in order."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def tools_phase(fa, tmp: str, gt_root: str, seg_train: torch.Tensor, gen, cgen, p: float,
                card: str) -> tuple:
    """Phase 11 (module docstring). ``seg_train``: the agtt-zinc packed
    train rows. Returns (forward errors, backward errors, timings by shape,
    every instance's resources, the mfu runs' launches)."""
    from glearning_benchmark_tpu_torch import bench
    from glearning_benchmark_tpu_torch.tools import flash_ab, mfu_bench, serve_bench

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resources = instances(fa)
    errs, berrs, timing = head_dim_rows(fa, gen, cgen, p)
    f32_against_wide(fa, {
        "agtt-zinc packed train rows": ((len(seg_train), seg_train.shape[1], 4, 16), seg_train),
        "packed mfu rows": ((MFU_SHAPE[0], MFU_SHAPE[1], MFU_SHAPE[2], 64),
                            packed_seg(MFU_SHAPE[0], MFU_SHAPE[1], cgen))}, gen, p)
    log(f"[phase] tools: head dims 128, 64, {PADDED_HEAD_DIM} and {WIDE_HEAD_DIMS}, the "
        f"dense mfu rows, xl, the f32 design against the wide route "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    line = captured(bench.main, ["--out", os.path.join(tmp, "bench.json")])[-1]
    if not (line["metric"] == "zinc_tokenize_graphs_per_sec" and line["value"] > 0
            and line["byte_exact"] and line["device_encode_graphs_per_sec"] > 0):
        raise AssertionError(f"bench: unexpected last line {line}")
    log(f"[tools] bench: {line['value']:.1f} graphs/s, vs_baseline {line['vs_baseline']:.2f}, "
        f"device encoder {line['device_encode_graphs_per_sec']:.1f} graphs/s, byte-exact; "
        f"{time.perf_counter() - t0:.1f} s on {card}")

    t0 = time.perf_counter()
    reset_launches(fa)
    rows = captured(mfu_bench.main, ["--steps", str(MFU_STEPS),
                                     "--out", os.path.join(tmp, "mfu.json")])[:-1]
    launches = {"mfu_bench": launches_now(fa)}
    for row in rows:
        if not (row["valid"] and 0 < row["mfu"] <= 1):
            raise AssertionError(f"mfu_bench d_model {row['d_model']}: not a valid row: {row}")
    if [r["d_model"] for r in rows] != [256, 512, 1024]:
        raise AssertionError("mfu_bench did not run the three widths")
    if min(launches["mfu_bench"].values()) == 0:
        raise AssertionError(f"mfu_bench ran no attention or hash-dropout kernel: {launches}")
    log(f"[tools] mfu_bench: " + "; ".join(
        f"d_model {r['d_model']} step {r['step_s'] * 1e3:.2f} ms, mfu {r['mfu']:.4f}, "
        f"mfu_vs_measured {r['mfu_vs_measured']:.4f}" for r in rows)
        + f"; launches {launches['mfu_bench']}; {time.perf_counter() - t0:.1f} s")

    # the reference's largest benched transformer: head dim 256, whose
    # backward runs the dQ and dK/dV kernels' wgmma instances at 256
    t0 = time.perf_counter()
    reset_launches(fa)
    row = captured(mfu_bench.main, D2048_ARGS + ["--steps", str(MFU_STEPS), "--out",
                                                 os.path.join(tmp, "mfu2048.json")])[0]
    launches["mfu_bench_d2048"] = launches_now(fa)
    if not (row["valid"] and 0 < row["mfu"] <= 1 and row["head_dim"] == D2048_SHAPE[3]):
        raise AssertionError(f"mfu_bench d_model 2048: not a valid row: {row}")
    attn = attention_launches(launches["mfu_bench_d2048"])
    if min(attn.values()) == 0:
        raise AssertionError(f"mfu_bench d_model 2048 ran no attention kernel: {attn}")
    designs = {name: fa.design(name, row["head_dim"], torch.bfloat16) for name in attn}
    log(f"[tools] mfu_bench d_model 2048 batch {row['batch']} (head dim {row['head_dim']}): "
        f"step {row['step_s'] * 1e3:.2f} ms, mfu {row['mfu']:.4f}, mfu_vs_measured "
        f"{row['mfu_vs_measured']:.4f}; attention launches {attn}, designs {designs}; "
        f"{time.perf_counter() - t0:.1f} s")

    # a model with few heads above head dim 256: the three kernels'
    # wgmma_chunks instances on the training path
    t0 = time.perf_counter()
    reset_launches(fa)
    row = captured(mfu_bench.main, D2560_ARGS + ["--steps", str(MFU_STEPS), "--out",
                                                 os.path.join(tmp, "mfu2560.json")])[0]
    launches["mfu_bench_d2560"] = launches_now(fa)
    if not (row["valid"] and 0 < row["mfu"] <= 1 and row["head_dim"] == ABOVE_WGMMA):
        raise AssertionError(f"mfu_bench d_model 2560: not a valid row: {row}")
    attn = attention_launches(launches["mfu_bench_d2560"])
    designs = {name: fa.design(name, row["head_dim"], torch.bfloat16) for name in attn}
    if min(attn.values()) == 0 or set(designs.values()) != {"wgmma_chunks"}:
        raise AssertionError(f"mfu_bench d_model 2560: launches {attn}, designs {designs}")
    log(f"[tools] mfu_bench d_model 2560 heads 8 layers {row['layers']} batch {row['batch']} "
        f"(head dim {row['head_dim']}): step {row['step_s'] * 1e3:.2f} ms, mfu "
        f"{row['mfu']:.4f}; attention launches {attn}, designs {designs}; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ab = captured(flash_ab.main, ["--shapes", AB_SHAPES, "--out", os.path.join(tmp, "ab.json")])
    for row in ab[:-1]:
        if not (row["kernel_fwdbwd_ms"] > 0 and row["max_abs_diff_kernel_vs_sdpa"] < 2 ** -6):
            raise AssertionError(f"flash_ab {row['shape']}: {row}")
    log(f"[tools] flash_ab {AB_SHAPES}: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for family, config in SERVE_FAMILIES:
        res = serve_bench.bench_family(
            family, GRAPH_CONFIGS[config], torch.device("cuda"), SERVE_BUCKETS, SERVE_REPS,
            epochs=1, out_dir=os.path.join(tmp, "serve_bench"), corpus_root=gt_root)
        if [r["batch"] for r in res["rows"]] != list(SERVE_BUCKETS):
            raise AssertionError(f"serve_bench {family}: {res}")
    log(f"[tools] serve_bench {[f for f, _ in SERVE_FAMILIES]} buckets {SERVE_BUCKETS}: "
        f"{time.perf_counter() - t0:.1f} s")
    launches.update(late_tools(fa, tmp, gt_root))
    return errs, berrs, timing, resources, launches


def late_tools(fa, tmp: str, gt_root: str) -> dict:
    """The scaling bench at N = 1 and 2 (``SCALING_MOLS`` a host), one run
    of the results campaign (mpnn-cycle, 1 epoch, on phase 7's corpus), the
    roofline tool on its result and the GCN-vs-GAT example
    (``GCN_GAT_EPOCHS``). Returns the example's launches."""
    from glearning_benchmark_tpu_torch.examples import gcn_vs_gat
    from glearning_benchmark_tpu_torch.tools import roofline, run_benchmarks, scaling_bench

    t0 = time.perf_counter()
    line = captured(scaling_bench.main, ["--mols", str(SCALING_MOLS), "--hosts", "1,2",
                                         "--reps", "2", "--out",
                                         os.path.join(tmp, "scaling.json")])[-1]
    eff = line["tokenize_efficiency"]
    if sorted(eff) != ["1", "2"] or not all(v > 0 for v in eff.values()):
        raise AssertionError(f"scaling_bench: {line}")
    log(f"[tools] scaling_bench at N = 1, 2 ({SCALING_MOLS} molecules a host; vocab and "
        f"ids equal to one process's): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out = os.path.join(tmp, "campaign", "results.json")
    line = captured(run_benchmarks.main, [
        "--only", "mpnn-cycle", "--out", out, "--override", "train.epochs=1",
        "--override", f"dataset.graph_token_root={json.dumps(gt_root)}",
        "--override", f"output.out_dir={json.dumps(os.path.join(tmp, 'campaign'))}"])[-1]
    with open(out) as f:
        run = json.load(f)["mpnn-cycle"]
    if line["errors"] or run["epochs"] != 1 or not 0 <= run["best_val"] <= 1:
        raise AssertionError(f"run_benchmarks mpnn-cycle: {run}")
    log(f"[tools] run_benchmarks mpnn-cycle, 1 epoch: best val {run['best_val']:.4f} (JAX "
        f"package, 100 epochs: {run['jax_best_val']}); {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    line = captured(roofline.main, ["--results", out, "--out",
                                    os.path.join(tmp, "campaign", "roofline.json")])[-1]
    if not (line["run"] == "mpnn-cycle" and line["bound_s"] > 0 and line["x_of_bound"] > 0):
        raise AssertionError(f"roofline mpnn-cycle: {line}")
    log(f"[tools] roofline mpnn-cycle: {line['x_of_bound']:.1f}x of its bound "
        f"({line['binding']}, flop {line['flop_bound_s'] * 1e3:.4f} ms, hbm "
        f"{line['hbm_bound_s'] * 1e3:.4f} ms, measured {line['measured_s'] * 1e3:.1f} ms an "
        f"epoch); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reset_launches(fa)
    line = captured(gcn_vs_gat.main, ["--epochs", str(GCN_GAT_EPOCHS),
                                      "--out", os.path.join(tmp, "gcn_vs_gat.json")])[-1]
    launches = launches_now(fa)
    acc = [v for r in line["accuracies"].values() for v in r.values()]
    if not (all(0 <= v <= 1 for v in acc) and launches["hash_dropout"] > 0):
        raise AssertionError(f"gcn_vs_gat: {line}, launches {launches}")
    log(f"[tools] gcn_vs_gat, {GCN_GAT_EPOCHS} epochs: {line['accuracies']}; hash dropout "
        f"{launches['hash_dropout']} launches; {time.perf_counter() - t0:.1f} s")
    return {"gcn_vs_gat": launches}


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
    from glearning_benchmark_tpu_torch.train.datasets import build_dataset
    from glearning_benchmark_tpu_torch.train.trainer import train_batch_size

    p_train = train_rate()

    # phase 1: the card
    card = nvidia_smi("name,power.limit")
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        hd_build = pool.submit(hd.build_seconds)       # beside the attention kernels
        fa_secs = fa.build_seconds()
        fa_secs["hash_dropout"] = hd_build.result()
    for name, secs in fa_secs.items():
        log(f"[build] {name} for sm_90a: nvcc {secs:.1f} s")
    log(f"[build] all kernels built side by side in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tensor_core_sass(fa)

    # phase 3: the forward kernel against its plain version
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
    for p_drop in (p_train, 0.1):       # the training rate and the use_flash one
        dropout_pattern(fa, seed=1234, p_drop=p_drop)

    graphs = load_zinc_split(split="val")   # stand-in unless ./data/ZINC has an export
    ibtt_graphs = graphs[:256]
    with tempfile.TemporaryDirectory() as tmp:
        # the bundles of the training phases (cached under tmp, where
        # train() finds them again): their rows give the kernels' training
        # and eval shapes and masks
        zinc_root = os.path.join(tmp, "ZINC")
        agtt_cfg = train_config("agtt", AGTT_ZINC_MODEL, zinc_root,
                                os.path.join(tmp, "runs_agtt"), True, TRAIN_EPOCHS)
        ibtt_cfg = train_config("ibtt", IBTT_ZINC_MODEL, zinc_root,
                                os.path.join(tmp, "runs_ibtt"), False, 1)
        t0 = time.perf_counter()
        bundle = build_dataset("agtt", agtt_cfg["dataset"], ZINC_TRAIN["seed"])
        ibtt_bundle = build_dataset("ibtt", ibtt_cfg["dataset"], ZINC_TRAIN["seed"],
                                    limit=IBTT_TRAIN_LIMIT)
        train_seg = torch.from_numpy(bundle.splits["train"]["seg"]).cuda()
        seg_lens = (train_seg > 0).sum(1)
        bs = ZINC_TRAIN["batch_size"]
        row_bs = train_batch_size(bundle, bs)     # as train() reckons it
        l_train = train_seg.shape[1]
        log(f"[data] agtt-zinc and ibtt-zinc bundles in {time.perf_counter() - t0:.1f} s: "
            f"{bundle.meta['n_examples_train']} trails packed into {len(train_seg)} rows "
            f"of {l_train}, {int(train_seg.max())} segments at most, "
            f"{int(seg_lens.min())}-{int(seg_lens.max())} valid tokens a row "
            f"(mean {seg_lens.float().mean().item():.1f}); row batch {row_bs}")

        def first_masks(b, split):
            """Key masks of the first batch of ``split`` as segment ids."""
            return torch.from_numpy(b.splits[split]["mask"][:bs]).to(
                device="cuda", dtype=torch.int32)

        # the forward kernel at the shapes, layout and masks the training
        # path gives it: packed train rows with dropout, eval rows without
        seg_train = train_seg[:row_bs].contiguous()
        errs.append(compare(
            "agtt-zinc packed train rows", fa,
            *qkv_views((row_bs, l_train, 4, 16), torch.bfloat16, gen), seg_train,
            p_drop=p_train, seed=4321))
        for name, b, d in (("agtt", bundle, 16), ("ibtt", ibtt_bundle, 4)):
            seg = first_masks(b, "val")
            errs.append(compare(
                f"{name}-zinc eval rows", fa,
                *qkv_views((len(seg), seg.shape[1], 4, d), torch.bfloat16, gen), seg))
        ibtt_seg_train = first_masks(ibtt_bundle, "train")
        ibtt_shape = (len(ibtt_seg_train), ibtt_seg_train.shape[1], 4, 4)
        errs.append(compare(
            "ibtt-zinc train rows", fa, *qkv_views(ibtt_shape, torch.bfloat16, gen),
            ibtt_seg_train, p_drop=p_train, seed=7))

        # phase 4: the backward kernels against their plain version, at the
        # same training rows
        berrs = []
        for p_drop in (0.0, p_train):
            berrs.append(compare_bwd(
                "agtt-zinc packed train rows", fa,
                *qkv_views((row_bs, l_train, 4, 16), torch.bfloat16, gen), seg_train,
                strided_do((row_bs, l_train, 4, 16), torch.bfloat16, gen), p_drop, 4321))
        berrs.append(compare_bwd(
            "ibtt-zinc train rows", fa, *qkv_views(ibtt_shape, torch.bfloat16, gen),
            ibtt_seg_train,
            torch.randn(ibtt_shape, device="cuda", generator=gen).bfloat16(), p_train, 7))
        berrs.append(compare_bwd(
            "f32 packed train rows", fa, *rand((16, l_train, 4, 16), torch.float32),
            train_seg[row_bs:row_bs + 16].contiguous(),
            torch.randn(16, l_train, 4, 16, device="cuda", generator=gen), p_train, 99))
        berrs.append(compare_bwd(
            "L600 packed", fa, *rand((8, 600, 4, 16), torch.bfloat16),
            packed_seg(8, 600, cgen),
            torch.randn(8, 600, 4, 16, device="cuda", generator=gen).bfloat16(), 0.1, 1234))
        compare_bwd_autograd(fa, train_seg[row_bs + 16:row_bs + 20].contiguous(), gen,
                             p_train, 5)
        btiming = time_bwd(fa, *qkv_views((row_bs, l_train, 4, 16), torch.bfloat16, gen),
                           seg_train,
                           strided_do((row_bs, l_train, 4, 16), torch.bfloat16, gen),
                           p_train, 4321, "agtt-zinc packed train rows")
        ibtt_btiming = time_bwd(fa, *qkv_views(ibtt_shape, torch.bfloat16, gen),
                                ibtt_seg_train, strided_do(ibtt_shape, torch.bfloat16, gen),
                                p_train, 7, "ibtt-zinc train rows")
        bwd_breakdown(fa, seg_train, gen, p_train)

        # phase 4b: the hash-dropout kernel against its plain version, one
        # training step through both, its time and the dropout microbench
        drop_timing = dropout_phase(gen, bundle, agtt_cfg, row_bs, l_train, tmp, card)

        paths = {"agtt": serve_checkpoint(tmp, "agtt", AGTT_ZINC_MODEL, graphs, args.seed),
                 "ibtt": serve_checkpoint(tmp, "ibtt", IBTT_ZINC_MODEL, ibtt_graphs,
                                          args.seed)}
        cpu = {name: Predictor.from_checkpoint(path, max_batch=MAX_BATCH, device="cpu")
               for name, path in paths.items()}

        # the forward kernel at the shapes, layout and masks the served path
        # gives it: q, k, v as views of the fused qkv output; key masks of
        # the served rows
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
        dense_timing = time_kernel(
            fa, q, k, v, torch.ones(256, MAX_LEN, dtype=torch.int32, device="cuda"),
            "agtt-zinc dense")
        del q, k, v
        ibtt_timing = time_kernel(
            fa, *qkv_views((len(ibtt_graphs), MAX_LEN, 4, 4), torch.bfloat16, gen),
            ibtt_seg, "ibtt-zinc served")
        torch.cuda.empty_cache()
        fwd_breakdown(fa, {"packed train rows": seg_train,
                           "served rows": agtt_seg[:256].contiguous()}, gen, p_train)

        # phase 5: serving at full width (launch counts read per path)
        t0 = time.perf_counter()
        agtt, serve_launches = serve_phase(fa, paths["agtt"], cpu["agtt"], AGTT_ZINC_MODEL,
                                           graphs, card)
        ibtt, _ = serve_phase(fa, paths["ibtt"], cpu["ibtt"], IBTT_ZINC_MODEL,
                              ibtt_graphs, card)
        time_breakdown(agtt, graphs)
        time_breakdown(ibtt, ibtt_graphs)
        log(f"[phase] serving {time.perf_counter() - t0:.1f} s")
        del agtt, ibtt, cpu

        # phase 6: training at full width (launch counts read per path)
        t0 = time.perf_counter()
        res, train_launches = train_phase(fa, "agtt", agtt_cfg, None, card)
        trained_checkpoint_serves(res, agtt_cfg, graphs)
        first_steps_on_cpu(res, agtt_cfg)
        train_step_breakdown(res, agtt_cfg)
        del res
        train_phase(fa, "ibtt", ibtt_cfg, IBTT_TRAIN_LIMIT, card)
        log(f"[phase] training {time.perf_counter() - t0:.1f} s")

        # phase 7: the graph-token corpus, the kernels at its rows, the four
        # families' training and the graph models' serving
        t0 = time.perf_counter()
        gt_root = os.path.join(tmp, "graph-token")
        corpus_phase(gt_root)
        t1 = time.perf_counter()
        bundles = {name: build_dataset(model_name, graph_config(
            name, "cycle_check", gt_root, "", 1)["dataset"], 0)
            for model_name, name in (("ibtt", "ibtt_graph_token"),
                                     ("agtt", "agtt_graph_token"))}
        log(f"[data] ibtt_graph_token and agtt_graph_token cycle_check bundles in "
            f"{time.perf_counter() - t1:.1f} s")
        gerrs, gberrs, gtiming = graph_token_rows(fa, bundles, gen, p_train)
        errs += gerrs
        berrs += gberrs
        graph_launches = graph_token_phase(fa, gt_root, tmp, card)
        log(f"[phase] graph-token {time.perf_counter() - t0:.1f} s")

        # phase 8: the host tokenization paths against their Python ones
        t0 = time.perf_counter()
        host_tokenization_phase(gt_root, card)
        log(f"[phase] host tokenization {time.perf_counter() - t0:.1f} s")

        # phase 9: data parallelism (the kernels at a bh_offset, two ranks
        # against one process, the ranks' vocab) and the Switch MoE FFN
        t0 = time.perf_counter()
        derrs, dberrs, dp_launches = dp_moe_phase(fa, tmp, gt_root, graphs, seg_train,
                                                  gen, p_train, card)
        errs += derrs
        berrs += dberrs
        log(f"[phase] data parallelism and MoE {time.perf_counter() - t0:.1f} s")

        # phase 10: the other mesh axes (TP, the SP ring, PP, EP), two ranks
        # against one process
        t0 = time.perf_counter()
        dp_launches.update(mesh_phase(fa, tmp, graphs, card))
        log(f"[phase] mesh axes {time.perf_counter() - t0:.1f} s")

        # phase 11: the tools (every instance, head dims 128, 64, 12, 256
        # and 160, bench, mfu_bench, flash_ab, serve_bench)
        t0 = time.perf_counter()
        terrs, tberrs, htiming, resources, tool_launches = tools_phase(
            fa, tmp, gt_root, seg_train, gen, cgen, p_train, card)
        errs += terrs
        berrs += tberrs
        dp_launches.update(tool_launches)
        log(f"[phase] tools {time.perf_counter() - t0:.1f} s")

    # phase 12: the kernels line, then the result
    src = "glearning_benchmark_tpu_torch/csrc/"
    ref = "glearning_benchmark_tpu/ops/pallas_attention.py:"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda", "source": src + "flash_attn_fwd.cu",
        "replaces": ref + "114",
        "launches": train_launches["flash_attn_fwd"], "max_abs_err": max(errs),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "launches_by_path": {"serve_agtt": serve_launches,
                             "train_agtt": train_launches["flash_attn_fwd"],
                             **{path: n["flash_attn_fwd"]
                                for path, n in {**graph_launches, **dp_launches}.items()}},
        "by_shape": {name: {key: t[key] for key in keys} for name, t in (
            (f"agtt_train_rows_p{p_train}", btiming["flash_attn_fwd"]),
            (f"ibtt_train_rows_p{p_train}", ibtt_btiming["flash_attn_fwd"]),
            ("ibtt_served", ibtt_timing), ("agtt_dense", dense_timing),
            *((f"{rows}", t["flash_attn_fwd"]) for rows, t in gtiming.items()
              if "flash_attn_fwd" in t),
            ("ibtt_graph_token_test_rows", gtiming["ibtt_graph_token_test_rows"]),
            *((rows, t["flash_attn_fwd"]) for rows, t in htiming.items()))},
        "instances": {k: v for k, v in resources.items() if k.startswith("flash_attn_fwd_")}}]
    for name, line in (("flash_attn_bwd_dq", "164"), ("flash_attn_bwd_dkv", "204")):
        t = btiming[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + name + ".cu",
            "replaces": ref + line, "launches": train_launches[name],
            "max_abs_err": max(e[name] for e in berrs),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "launches_by_path": {"train_agtt": train_launches[name],
                                 **{path: n[name] for path, n in
                                    {**graph_launches, **dp_launches}.items()}},
            "by_shape": {rows: {key: bt[name][key] for key in keys} for rows, bt in (
                (f"ibtt_train_rows_p{p_train}", ibtt_btiming),
                *((rows, bt) for rows, bt in gtiming.items() if name in bt),
                *((rows, bt) for rows, bt in htiming.items() if name in bt))},
            "instances": {k: v for k, v in resources.items() if k.startswith(name + "_")}})
    t = drop_timing["x".join(map(str, DROP_TIME_SHAPES[-1]))]
    kernels.append({
        "name": "hash_dropout", "route": "cuda", "source": src + "hash_dropout.cu",
        "replaces": "glearning_benchmark_tpu/ops/attention.py:62-153 (XLA-fused, no pallas_call)",
        "launches": train_launches["hash_dropout"], "max_abs_err": 0.0,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launches_by_path": {"train_agtt": train_launches["hash_dropout"],
                             **{path: n["hash_dropout"] for path, n in
                                {**graph_launches, **dp_launches}.items()}},
        "by_shape": drop_timing})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
