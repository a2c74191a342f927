"""Where two free-running expert-parallel ranks first part from one
process: the measurement behind ``chip_smoke.py`` phase 10 holding its bf16
EP runs step by step, each step from the ranks' own state.

    python -m glearning_benchmark_tpu_torch.tools.ep_probe

Run from the repository root on one card: it takes ``chip_smoke.py``'s
phase-10 run ``ep_bfloat16`` (agtt_zinc width, 4 experts over two ranks,
bf16, dropout 0.1, the same data and seed), trains it for one epoch on one
process and on two spawned ranks sharing the card (gloo), and prints the
step losses; for each of the first steps, which summed gradients differ in
any bit (the last layers first); and for each MoE layer call, the largest
difference of its input and the tokens routed to another expert than in one
process, with their top-1 router margins there. It records what it needs by
wrapping the trainer's ``_batch_grads`` and ``SwitchFFN.forward`` for the
length of the run, so it is a diagnostic, not a benchmark.
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import os
import sys
import tempfile

import torch

PROBE_STEPS = 3


def _probe_hooks(store: dict) -> None:
    """Record, for the first PROBE_STEPS training steps, the summed
    gradients a step applies and each MoE layer's input and top-2 router
    probabilities (``train.trainer._batch_grads``, ``SwitchFFN.forward``)."""
    from glearning_benchmark_tpu_torch.models import moe
    from glearning_benchmark_tpu_torch.train import trainer

    batch_grads, forward = trainer._batch_grads, moe.SwitchFFN.forward

    def grads_hook(loss, opt, layout):
        g = batch_grads(loss, opt, layout)
        if len(store["grads"]) < PROBE_STEPS:
            store["grads"].append({n: t.detach().float().cpu() for n, t in zip(opt.names, g)})
        return g

    def forward_hook(self, x, valid, seed=None, shard=None):
        if self.training and len(store["grads"]) < PROBE_STEPS:
            with torch.no_grad():
                top2 = torch.softmax(moe.dense(self.router, x.float(), torch.float32),
                                     -1).topk(2, dim=-1)
            store["router"].append({"step": len(store["grads"]), "p": top2.values.cpu(),
                                    "e": top2.indices[..., 0].cpu(), "valid": valid.cpu(),
                                    "x": x.detach().float().cpu()})
        return forward(self, x, valid, seed, shard)

    trainer._batch_grads = grads_hook
    moe.SwitchFFN.forward = forward_hook


def _probe_train(cfg: dict, model_name: str, limit: int, dev, out: str) -> None:
    from glearning_benchmark_tpu_torch.train.trainer import train

    store = {"grads": [], "router": []}
    _probe_hooks(store)
    res = train(cfg, model_name, limit=limit, verbose=False, device=dev)
    store["steps"] = res.step_losses[0][:PROBE_STEPS + 1].tolist()
    torch.save(store, out)


def ep_probe_worker(rank: int, world: int, init: str, cfg: dict, model_name: str,
                    limit: int, out: str) -> None:
    """One rank of the EP probe, a spawned process (gloo, as phase 10 on one
    card)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from glearning_benchmark_tpu_torch.parallel import initialize_distributed

    _probe_train(cfg, model_name, limit, initialize_distributed("cuda", "gloo", init),
                 f"{out}.{rank}")
    dist.destroy_process_group()


def ep_parity_probe(smoke, card: str) -> None:
    """Phase 10's ``ep_bfloat16`` run (agtt_zinc width, 4 experts over two
    ranks, bf16, dropout 0.1), one epoch on one process and on two spawned
    ranks sharing the card: prints the step losses, for each of the first
    steps which summed gradients differ in any bit (the last layers first),
    and for each MoE layer call the largest difference of its input, the
    tokens routed to another expert than one process's and their top-1
    margins (top-1 minus top-2 probability) in the one-process run."""
    from glearning_benchmark_tpu_torch.train.datasets import build_dataset

    with tempfile.TemporaryDirectory() as tmp:
        ds = smoke.train_config("agtt", smoke.AGTT_ZINC_MODEL, os.path.join(tmp, "ZINC"), "",
                                True, 1)
        bs = smoke.even_row_batch(build_dataset("agtt", ds["dataset"],
                                                smoke.ZINC_TRAIN["seed"],
                                                limit=smoke.MESH_LIMIT),
                                  smoke.ZINC_TRAIN["batch_size"])
        model_name, cfg, limit, ranks = smoke.mesh_runs(tmp, bs)["ep_bfloat16"]
        cfg["train"]["epochs"] = 1
        one = copy.deepcopy(cfg)
        one.pop("parallel")
        one["output"]["out_dir"] += "_one_process"
        _probe_train(one, model_name, limit, torch.device("cuda"), os.path.join(tmp, "one"))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=ep_probe_worker,
                             args=(r, ranks, f"file://{tmp}/probe.rdzv", cfg, model_name,
                                   limit, os.path.join(tmp, "ranks")))
                 for r in range(ranks)]
        try:
            for proc in procs:
                proc.start()
            for proc in procs:
                proc.join(timeout=smoke.DP_TIMEOUT)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        if [proc.exitcode for proc in procs] != [0] * ranks:
            raise AssertionError(f"a probe rank failed: {[proc.exitcode for proc in procs]}")
        a = torch.load(os.path.join(tmp, "one"), weights_only=False)
        b = torch.load(os.path.join(tmp, "ranks.0"), weights_only=False)
    print(f"[probe] ep_bfloat16 step losses: one process {a['steps']}, two ranks {b['steps']} "
        f"on {card}")
    for step, (ga, gb) in enumerate(zip(a["grads"], b["grads"]), 1):
        parted = []
        for name in ga:
            x, y = ga[name], gb[name]
            x = x[:y.shape[0]]              # an expert stack: rank 0 holds the first experts
            n = int((x != y).sum())
            if n:
                parted.append(f"{name} {n}/{x.numel()} elements, max|d| "
                              f"{(x - y).abs().max().item():.3e} of max|g| "
                              f"{x.abs().max().item():.3e}")
        print(f"[probe] step {step}: {len(parted)} of {len(ga)} summed gradients differ in any "
            f"bit; the last layers first: " + "; ".join(parted[::-1][:6]))
    for ra, rb in zip(a["router"], b["router"]):
        valid = ra["valid"]
        moved = (ra["e"] != rb["e"]) & valid
        margin = ra["p"][..., 0] - ra["p"][..., 1]
        line = (f"[probe] step {ra['step'] + 1} MoE layer input max|d| "
                f"{(ra['x'] - rb['x']).abs().max().item():.3e}; {int(moved.sum())} of "
                f"{int(valid.sum())} tokens routed to another expert")
        if moved.any():
            line += (f", one-process top-1 margins there from "
                     f"{margin[moved].min().item():.3e} (median "
                     f"{margin[moved].median().item():.3e})")
        print(line)


def main() -> int:
    if not torch.cuda.is_available():
        print("ep_probe: CUDA is not available; this probe needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from glearning_benchmark_tpu_torch.utils.card import nvidia_smi

    ep_parity_probe(chip_smoke, nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
