"""Training-step MFU of the port: the model-FLOPs utilization of a whole
train step of the token transformer at production widths (the root
``tools/mfu_bench.py`` on the port's ``SimpleTransformer``).

    python -m glearning_benchmark_tpu_torch.tools.mfu_bench \
        [--d-model 256 512 1024] [--steps K] [--attrib] [--device cpu]

The step is what the port's trainer runs: the model's training forward (bf16
compute, dropout 0.1 at the four sites of a layer), the backward through the
three flash-attention kernels, and ``ClippedAdamW`` (global-norm clip 1.0,
AdamW, bf16 first moment). Defaults are the reference's: d_model 256, 512
and 1024, 8 layers, 8 heads (head dims 32, 64, 128), d_ff 4 d, L 1024, batch
64, vocab 2048, every token valid.

    MFU = analytic train FLOPs / (step seconds x datasheet bf16 peak)

- The numerator is the reference's analytic count
  (``analytic_train_flops``): 3 x (2 P_mm tokens + 4 layers B L^2 d), with
  P_mm the parameters outside the embedding and position tables, counted
  over the port's parameters under their flax names.
- The peak is the datasheet bf16 dense peak of the card the run finds, by
  its name (``utils.card.DATASHEET``: H100 SXM5 80GB HBM3, 989.4 TFLOP/s,
  3.35 TB/s). ``mfu_vs_measured`` divides by the ``torch.matmul`` ceiling
  measured at n = 8192 instead (``calibrate_matmul_tflops``).
- Timing: CUDA events around a block of K steps after warm-up steps, and
  around a K/2 block, whose per-step time must agree (0.6 to 1.67 times).
  A row with ``mfu`` > 1, or a step faster than the FLOP bound, is
  ``valid: false`` with the reason, as are rows whose K-scaling fails.

``--attrib`` times the step variants of the reference that the port has,
each changing one thing: no_dropout, f32_mu, remat, attn_dropout_only,
mlp_dropout_only, ffn_dropout_only, resid_dropout_only. The port's model
always runs the kernels, so its base is the JAX package's ``flash_attn``
variant; the reference's XLA-attention base and its ``rbg_keys`` variant
(a JAX PRNG implementation) have no counterpart and give no row.

With ``--device cpu`` the steps run for their losses and FLOP count only:
no time, MFU or validity is measured there. Writes ``--out`` (default
``runs_torch/mfu.json``, ``runs_torch/mfu_attrib.json`` with ``--attrib``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import flax_path
from ..models.transformer import SimpleTransformer
from ..train.optim import ClippedAdamW
from ..utils.card import datasheet, device_info
from ..utils.device import resolve_device
from . import RESULTS_DIR, emit, save

ATTRIB_VARIANTS = (
    ("base", {}),
    ("no_dropout", {"p_drop": 0.0}),
    ("f32_mu", {"mu_dtype": "float32"}),
    ("remat", {"remat": True}),
    ("attn_dropout_only", {"mlp_p_drop": 0.0}),
    ("mlp_dropout_only", {"attn_p_drop": 0.0}),
    ("ffn_dropout_only", {"attn_p_drop": 0.0, "resid_p_drop": 0.0}),
    ("resid_dropout_only", {"attn_p_drop": 0.0, "ffn_p_drop": 0.0}),
)


def analytic_train_flops(model: torch.nn.Module, batch: int, seq: int, layers: int,
                         d_model: int) -> Tuple[float, int]:
    """(train FLOPs a step, matmul parameter count): 2 P_mm FLOPs a token a
    matmul pass plus 4 B L^2 d of attention a layer, times 3 for forward and
    backward (the PaLM appendix B convention of the reference,
    ``tools/mfu_bench.py:136-152``). Embedding and position tables are
    gathers: parameters whose flax path names ``embed`` or ``pos`` are left
    out of P_mm."""
    p_mm = 0
    for name, p in model.named_parameters():
        path = "/".join(flax_path(name)[0]).lower()
        if "embed" in path or "pos" in path:
            continue
        p_mm += p.numel()
    fwd = 2.0 * p_mm * batch * seq + 4.0 * layers * batch * seq * seq * d_model
    return 3.0 * fwd, p_mm


def calibrate_matmul_tflops(n: int = 8192, iters: int = 20) -> float:
    """The card's measured bf16 matmul ceiling, TFLOP/s: best of 3 blocks
    of ``iters`` [n, n] @ [n, n] products, each timed with CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(n, n, device="cuda", generator=gen).bfloat16()
    b = torch.randn(n, n, device="cuda", generator=gen).bfloat16()
    c = torch.empty(n, n, device="cuda", dtype=torch.bfloat16)
    torch.matmul(a, b, out=c)
    best = float("inf")
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(iters):
            torch.matmul(a, b, out=c)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / 1e3 / iters)
    return 2.0 * n ** 3 / best / 1e12


class Step:
    """One training step of the port at a given width: forward with the
    dropout seeds drawn from a CPU generator, cross-entropy, gradients,
    ``ClippedAdamW``."""

    def __init__(self, d_model: int, layers: int, heads: int, d_ff: int, seq: int,
                 batch: int, vocab: int, device: torch.device, p_drop: float = 0.1,
                 mu_dtype: str = "bfloat16", remat: bool = False, **rates):
        gen = torch.Generator().manual_seed(0)
        self.model = SimpleTransformer(
            vocab_size=vocab, d_model=d_model, nhead=heads, nlayers=layers, d_ff=d_ff,
            p_drop=p_drop, max_pos=seq, num_classes=2, use_query_nodes=False,
            task="cycle_check", compute_dtype="bfloat16", remat=remat, generator=gen,
            **rates).to(device).train()
        rng = np.random.default_rng(0)
        ids = rng.integers(2, vocab, size=(batch, seq))
        ids[:, 0] = 1
        self.ids = torch.from_numpy(ids).to(device)
        self.mask = torch.ones(batch, seq, dtype=torch.bool, device=device)
        self.labels = torch.from_numpy(rng.integers(0, 2, size=batch)).to(device)
        named = dict(self.model.named_parameters())
        self.params = list(named.values())
        self.opt = ClippedAdamW(list(named), self.params, 1e-3, weight_decay=1e-5,
                                mu_dtype=mu_dtype)
        self.gen = torch.Generator().manual_seed(1)

    def __call__(self) -> torch.Tensor:
        logits = self.model(self.ids, self.mask, generator=self.gen)
        loss = F.cross_entropy(logits.float(), self.labels)
        self.opt.step(torch.autograd.grad(loss, self.params))
        return loss.detach()


def time_block(step: Step, k: int) -> Tuple[float, float]:
    """(seconds a step over a block of ``k`` steps, the last loss)."""
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(k):
        loss = step()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / 1e3 / k, float(loss)


def run_one(d_model: int, layers: int, heads: int, d_ff: int, seq: int, batch: int,
            steps: int, vocab: int, device: torch.device,
            measured_tflops: Optional[float] = None, warmup: int = 2,
            **variant) -> Dict:
    step = Step(d_model, layers, heads, d_ff, seq, batch, vocab, device, **variant)
    n_params = sum(p.numel() for p in step.params)
    flops, p_mm = analytic_train_flops(step.model, batch, seq, layers, d_model)
    row = {"d_model": d_model, "layers": layers, "heads": heads, "head_dim": d_model // heads,
           "d_ff": d_ff, "seq": seq, "batch": batch, "params": n_params,
           "matmul_params": p_mm, "analytic_train_step_flops": flops, "flash": True,
           "device": device.type}
    if device.type != "cuda":
        losses = [float(step()) for _ in range(steps)]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss at d_model {d_model}: {losses}")
        return {**row, "final_loss": losses[-1], "step_s": None, "mfu": None,
                "mfu_vs_measured": None, "valid": False,
                "invalid_reasons": ["not measured: no card"]}
    peaks = datasheet(torch.cuda.get_device_name(device))
    for _ in range(warmup):
        step()
    dt, loss = time_block(step, steps)
    half = max(1, steps // 2)
    dt_half, _ = time_block(step, half)
    ratio = dt_half / dt
    torch.cuda.reset_peak_memory_stats(device)
    step()
    torch.cuda.synchronize(device)
    peak_mem = torch.cuda.max_memory_allocated(device)
    mfu = flops / (dt * peaks["bf16_flops"])
    flop_bound_s = flops / peaks["bf16_flops"]
    # the step's least HBM traffic: bf16 matmul weights read forward and
    # backward (4 B/param over P_mm), f32 gradients written and read, AdamW
    # moments and f32 parameters read and written (32 B/param over all)
    hbm_bound_s = (32.0 * n_params + 4.0 * p_mm) / peaks["hbm_bytes_s"]
    reasons = []
    if mfu > 1.0:
        reasons.append(f"mfu={mfu:.4f} > 1 is physically impossible")
    if dt < flop_bound_s:
        reasons.append(f"step_s={dt:.6f} below the FLOP bound {flop_bound_s:.6f}")
    if not 0.6 < ratio < 1.67:
        reasons.append(f"K-scaling per-step ratio {ratio:.3f} outside (0.6, 1.67)")
    if not np.isfinite(loss):
        reasons.append(f"non-finite loss {loss}")
    bound = max(flop_bound_s, hbm_bound_s)
    regime = ("overhead-bound" if dt > 3.0 * bound else
              "flops-bound" if flop_bound_s >= hbm_bound_s else "hbm-bound")
    return {**row, "steps_per_block": steps, "step_s": dt, "step_s_half_block": dt_half,
            "k_scaling_ratio_halfK": ratio, "tokens_per_s": batch * seq / dt,
            "peak_tflops": peaks["bf16_flops"] / 1e12, "achieved_tflops": flops / dt / 1e12,
            "mfu": mfu,
            "mfu_vs_measured": (None if measured_tflops is None
                                else flops / (dt * measured_tflops * 1e12)),
            "flop_bound_ms": flop_bound_s * 1e3, "hbm_bound_ms": hbm_bound_s * 1e3,
            "regime": regime, "peak_memory_bytes": peak_mem, "final_loss": loss,
            "valid": not reasons, **({"invalid_reasons": reasons} if reasons else {})}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, nargs="*", default=[256, 512, 1024])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ff-mult", type=int, default=4)
    ap.add_argument("--len", dest="seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20, help="K, the timed block's steps")
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--attrib", action="store_true",
                    help="time the step variants (module docstring) at each --d-model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device_info(device)
    measured = None
    if device.type == "cuda" and not args.no_calibrate:
        measured = calibrate_matmul_tflops()
    variants = ATTRIB_VARIANTS if args.attrib else ATTRIB_VARIANTS[:1]
    rows = []
    for dm in args.d_model:
        for name, kw in variants:
            row = run_one(dm, args.layers, args.heads, args.ff_mult * dm, args.seq,
                          args.batch, args.steps, args.vocab, device, measured, **kw)
            rows.append(emit({"variant": name, **row}, card))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out = args.out or os.path.join(RESULTS_DIR, "mfu_attrib.json" if args.attrib else "mfu.json")
    save(out, {"card": card, "measured_matmul_tflops": measured, "rows": rows})
    return emit({"summary": "mfu_bench", "measured_matmul_tflops": measured,
                 "mfu": {f"{r['variant']}_d{r['d_model']}": r["mfu"] for r in rows},
                 "valid": all(r["valid"] for r in rows), "device": device.type}, card)


if __name__ == "__main__":
    main()
