"""CLI entry point of the port's trainer.

    python -m glearning_benchmark_tpu_torch.train --model {ibtt,agtt,mpnn,ggps}
        [--config configs/X.yaml] [--epochs N] [--limit N] [--resume]
        [--eval-only] [--checkpoint P] [--device cuda|cpu]
        [--dist-init URL]

The flags and default configs (``configs/<model>_graph_token.yaml``) of
the JAX package's root ``train.py``, plus ``--device``. A missing
graph-token corpus is generated first. The run is on the GPU unless
``--device cpu`` is given; without a GPU the default raises.

Data-parallel under torchrun, one rank a card over NCCL (or, with
``--device cpu``, on the CPU over gloo):

    torchrun --nproc_per_node=N -m glearning_benchmark_tpu_torch.train --model agtt ...

``--dist-init`` replaces torchrun's ``env://`` rendezvous (e.g.
``file:///path``, with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set by
the caller). A failed initialisation raises; the run never goes on as one
process.
"""

from __future__ import annotations

import argparse
import os

MODEL_DEFAULT_CONFIGS = {
    "ibtt": "configs/ibtt_graph_token.yaml",
    "mpnn": "configs/mpnn_graph_token.yaml",
    "ggps": "configs/gps_graph_token.yaml",
    "agtt": "configs/agtt_graph_token.yaml",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m glearning_benchmark_tpu_torch.train",
        description="Train IBTT, AGTT, MPNN or GPS (PyTorch/CUDA port)")
    ap.add_argument("--model", required=True, choices=sorted(MODEL_DEFAULT_CONFIGS))
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--epochs", type=int, default=None, help="override train.epochs")
    ap.add_argument("--limit", type=int, default=None,
                    help="cap examples per split (smoke runs)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the best checkpoint (params + optimizer "
                         "state + schedule step)")
    ap.add_argument("--eval-only", action="store_true",
                    help="no training: load the best checkpoint and score "
                         "the val and test splits")
    ap.add_argument("--checkpoint", default=None,
                    help="explicit checkpoint path for --resume/--eval-only "
                         "(default: <output.dir>/best_<run_name>)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--dist-init", default="env://",
                    help="rendezvous of a multi-rank run (default: torchrun's env://)")
    args = ap.parse_args(argv)

    config_path = args.config or MODEL_DEFAULT_CONFIGS[args.model]
    if not os.path.isfile(config_path):
        raise SystemExit(f"config not found: {config_path}")

    from ..utils.config import load_config, normalize_config
    config = normalize_config(load_config(config_path))
    if args.epochs is not None:
        config["train"]["epochs"] = args.epochs
    if args.resume or args.eval_only:
        config["train"]["resume"] = True
    if args.eval_only:
        config["train"]["epochs"] = 0
    if args.checkpoint:
        config["train"]["resume_path"] = args.checkpoint

    from ..parallel.data import initialize_distributed
    rank_device = initialize_distributed(args.device, init_method=args.dist_init)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"Loaded config from: {config_path}")
        print(f"Task: {config['dataset']['task']} | Model: {args.model}")

    from .trainer import train
    train(config, args.model, limit=args.limit, device=rank_device or args.device)
    if rank_device is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
