"""Readings behind a cell's limits: the program, the control and the faults.

    python3 -m portbench.control --workload <name> --seeds 1 2 3

For each seed, on the chip at the cell's own size, the numbers the output
check compares (``check.py``), read three ways against the reference run
from that seed:

- ``program``: the port's timed path, as a run of the cell reads it;
- ``control``: the reference computed one precision below the
  configuration's (float8 e4m3 operands for bf16) in the program's place;
- the faults a cell can have: ``half_batch``, planted in the reference put
  in the program's place (the second half of every batch left out and the
  mean taken over the rest), and ``dv_zeroed``, planted in the program (the
  attention backward returning no dV, as a dK/dV kernel that writes no dV
  would); a state left unchanged reads 1 and needs no run.

One JSON line a seed, and the whole table in ``--out`` (default
``_portbench_cache/control_<workload>.json``). The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def dv_zeroed():
    """The port's attention backward with its dV left out."""
    from glearning_benchmark_tpu_torch.ops import flash_attention as fa

    bwd = fa.flash_attention_bwd

    def faulty(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq, dk, torch.zeros_like(dv)

    fa.flash_attention_bwd = faulty
    try:
        yield
    finally:
        fa.flash_attention_bwd = bwd


def program_readings(cell, seed: int, device):
    """The program's readings over the first steps of a run from ``seed``,
    those steps' rows and the program's train rows."""
    from .drivers.train import Setup

    st = Setup(cell, seed, device)
    program, first = st.first_steps()
    host = st.host
    st.free()
    return program, first, host


def train_readings(cell, seeds: List[int], device) -> List[Dict]:
    from . import check

    out, ref_in = [], None
    for seed in seeds:
        program, first, host = program_readings(cell, seed, device)
        with dv_zeroed():
            faulty, _, _ = program_readings(cell, seed, device)
        if ref_in is None or cell.traffic["rows"] == "dense":   # dense rows come from the seed
            ref_in = check.reference_inputs(cell, host)
        rows, vocab, max_pos, _ = ref_in
        rec = {"seed": seed}
        if cell.traffic["rows"] != "dense":
            rec["rows_differ"] = check.rows_differ(host, rows)
        args = (cell.config, seed, device, rows, first, vocab, max_pos)
        ref = check.train_reference(*args)
        rec["program"] = check.train_gaps(program, ref)
        rec["control"] = check.train_gaps(check.train_reference(*args, precision="fp8"), ref)
        rec["half_batch"] = check.train_gaps(check.train_reference(*args, drop_half=True), ref)
        rec["dv_zeroed"] = check.train_gaps(faulty, ref)
        rec["losses"] = {"program": program["losses"], "reference": ref["losses"]}
        rec["look"] = look(program, ref)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def look(program: Dict, ref: Dict) -> Dict:
    """Where the gaps come from: each step's loss gap, the first step's
    examples on the other side of their target from the reference's
    prediction (their L1 gradient flips sign), the three worst leaves
    of the gradient, of the change and of the change over the elements the
    check keeps (the program's, the reference's and the median leaf's
    norms), and the median leaf's gap of each."""
    from .check import kept_change_norms

    ok = ref["pred_valid"]
    y = ref["targets"][ok]
    side = np.sign(np.asarray(program["preds"], np.float64)[ok] - y) != np.sign(ref["preds"][ok] - y)
    out = {"head": ref["head"], "loss_gaps": [abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                            ref["losses"])],
           # first-step examples whose L1 gradient sign differs from the reference's
           "sign_flips": int(side.sum()), "examples": int(ok.sum())}
    pairs = {"grad_norms": (program["grad_norms"], ref["grad_norms"]),
             "moved": ({k: float(v.norm()) for k, v in program["delta"].items()},
                       {k: float(v.norm()) for k, v in ref["delta"].items()}),
             "moved_kept": kept_change_norms(program, ref)}
    for key, (p, r) in pairs.items():
        med = float(np.median(list(r.values())))
        gaps = {k: abs(p[k] - r[k]) / max(r[k], med) for k in r}
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        out[key] = {"median_ref": med, "median_gap": float(np.median(list(gaps.values()))),
                    "worst": [[k, gaps[k], p[k], r[k]] for k in worst]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from . import harness

    cell = harness.find_cell(ROOT, args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = train_readings(cell, args.seeds, device)
    out = args.out or os.path.join(cell.cache, f"control_{cell.name}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    with open(out, "w") as f:
        json.dump({"workload": cell.name, "card": card, "seeds": rows}, f, indent=1)
    for key in ("program", "control", "half_batch", "dv_zeroed"):
        for num in rows[0][key]:
            vals = [r[key][num] for r in rows]
            print(f"{key:10s} {num:12s} min {min(vals):.4g} median {np.median(vals):.4g} "
                  f"max {max(vals):.4g}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
