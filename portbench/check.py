"""The output check: the program's readings against the plain reference.

A training cell's numbers, each against the reference run from the same
seed over the same first three steps (``reference/``):

- ``rows_differ`` (cells on ZINC rows): elements of the port's packed
  train rows (ids, segments, positions, readout slots, targets) that differ
  from the rows the reference derives from the same corpus; exact;
- ``loss_gap``: the largest |loss - reference loss| / |reference loss| of
  the three steps; ``loss1_gap``: the first step's;
- ``loss1_mean_gap``: |the first step's loss - the mean L1 error of its own
  predictions over every valid example of the batch| / that mean (a loss
  that leaves examples out);
- ``pred1_gap``: the root mean square, over the first step's valid
  examples, of |prediction - reference|, over the norm of the head's
  weights (the scale at which an error of the pooled, normalised features
  reaches a prediction);
- ``grad_gap``: the worst leaf's |first gradient norm - the reference's| /
  max(the reference's, the median leaf's); ``grad_median_gap``: the median
  leaf's;
- ``update_gap``: the same of each leaf's change over the three steps,
  over the elements whose first reference gradient is at least a
  thousandth of the median leaf's root mean square (the others, as a key's
  bias under softmax, move by round-off alone); ``update_median_gap``.

A cell holds the numbers its ``limits/<workload>.json`` names, each to its
limit; the others are read by ``control.py`` only.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import weights
from .reference import model as ref
from .reference import optim as ref_optim
from .reference import pack as ref_pack
from .reference import sent as ref_sent
from .reference import zinc as ref_zinc

BLOCK_ELEMENTS = 1 << 25          # attention scores a block of reference rows holds


def _arch(cfg: Dict) -> ref.Arch:
    m = cfg["model"]
    p = float(m.get("dropout", 0.1))
    # the port drops attention probabilities at round(256 p) / 256 unless
    # use_flash is set (then at p), the other sites at round(256 p) / 256
    p_attn = p if m.get("use_flash", False) else round(p * 256.0) / 256.0
    return ref.Arch(d_model=int(m["d_model"]), heads=int(m["nhead"]), layers=int(m["nlayers"]),
                    d_ff=int(m["d_ff"]), p_attn=p_attn, p_drop=p)


def _block_rows(arch: ref.Arch, length: int) -> int:
    return max(1, BLOCK_ELEMENTS // (arch.heads * length * length))


# ---------------------------------------------------------------------------
# ZINC rows, derived by the reference
# ---------------------------------------------------------------------------

def zinc_trails(cfg: Dict, mols: Dict[str, list]) -> Dict[str, List[np.ndarray]]:
    max_len = int(cfg["dataset"]["max_len"])
    return {s: [ref_sent.trail(m.edges, m.atoms, m.bonds, max_len) for m in ms]
            for s, ms in mols.items()}


def split_buckets(cfg: Dict, trails: Dict[str, List[np.ndarray]]) -> Dict[str, int]:
    cap = int(cfg["dataset"]["max_len"]) + 3

    def bucket(names):
        return ref_sent.bucket(min(max(len(t) for s in names for t in trails[s]), cap))

    return {"train": bucket(["train"]), "eval": bucket(["val", "test"])}


def zinc_vocab(mols: Dict[str, list]) -> int:
    return ref_sent.vocab_size(max(m.num_nodes for ms in mols.values() for m in ms))


def packed_rows(cfg: Dict, mols: Dict[str, list]) -> Tuple[Dict[str, np.ndarray], int, int]:
    """(the packed train rows, the row length, the embedding rows)."""
    trails = zinc_trails(cfg, {"train": mols["train"], "val": mols["val"], "test": mols["test"]})
    buckets = split_buckets(cfg, trails)
    pk = ref_pack.pack(trails["train"], buckets["train"], ref_sent.PAD)
    y = np.asarray([m.y for m in mols["train"]], dtype=np.float32)
    rows = {"ids": pk["ids"], "seg": pk["seg"], "pos": pk["pos"], "pos_bos": pk["pos_bos"],
            "pos_u": np.zeros_like(pk["pos_bos"]), "pos_v": np.zeros_like(pk["pos_bos"]),
            "ex_valid": pk["ex_valid"],
            "y": np.where(pk["ex_valid"], y[pk["ex_index"]], 0).astype(np.float32)}
    return rows, max(buckets.values()), zinc_vocab(mols)


def rows_differ(program: Dict[str, np.ndarray], reference: Dict[str, np.ndarray]) -> int:
    out = 0
    for k, r in reference.items():
        p = program.get(k)
        if p is None or np.shape(p) != r.shape:
            out += r.size
        else:
            out += int((np.asarray(p) != r).sum())
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_reference(cfg: Dict, seed: int, device, rows: Dict[str, np.ndarray],
                    first: Dict[str, np.ndarray], vocab: int, max_pos: int,
                    precision: str = "bf16", drop_half: bool = False) -> Dict:
    """The reference's readings over the first steps: each step's loss, the
    first clipped gradient's leaf norms, each leaf's change. ``drop_half``
    leaves out the second half of every batch's rows (a fault)."""
    arch = _arch(cfg)
    tcfg = cfg["train"]
    w0 = weights.make(ref.param_shapes(arch, vocab, max_pos), seed, device)
    params = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    opt = ref_optim.AdamW(params, float(tcfg.get("lr", 1e-3)),
                          float(tcfg.get("weight_decay", 1e-4)))
    gen = torch.Generator().manual_seed(seed)
    packed = "seg" in rows
    length = rows["ids"].shape[1]
    block = _block_rows(arch, length)
    losses, grad_norms, first_grad, first_preds = [], {}, {}, None
    for step in range(first["idx"].shape[0]):
        idx, valid = first["idx"][step], first["valid"][step].copy()
        if drop_half:
            valid[len(valid) // 2:] = False
        seeds = ref.draw_seeds(gen, arch.layers)
        batch = {k: v[idx] for k, v in rows.items()}
        ex_valid = (valid[:, None] & batch["ex_valid"]) if packed else valid
        count = max(float(ex_valid.sum()), 1.0)
        all_bos = bool((batch["ids"][:, 0] == ref_sent.BOS).all())
        total = 0.0
        step_preds = []
        for r0 in range(0, len(idx), block):
            sl = slice(r0, r0 + block)
            t = {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
                 for k, v in batch.items()}
            if packed:
                seg, pos, readout = t["seg"], t["pos"], {"pos_bos": t["pos_bos"]}
            else:
                seg = t["mask"].to(torch.int32)
                pos = torch.arange(length, device=device)[None].expand_as(seg)
                readout = {"mask": t["mask"], "all_bos": all_bos}
            pred = ref.forward(params, arch, t["ids"], seg, pos, readout=readout, seeds=seeds,
                               row0=r0, precision=precision)
            step_preds.append(pred.detach().float().cpu().numpy())
            vf = torch.from_numpy(ex_valid[sl]).to(device).float()
            s = ((pred.float() - t["y"]).abs() * vf).sum()
            (s / count).backward()
            total += float(s.detach())
        grads = {k: p.grad for k, p in params.items()}
        clipped = opt.step(grads)
        for p in params.values():
            p.grad = None
        losses.append(total / count)
        if step == 0:
            grad_norms = ref_optim.leaf_norms(clipped)
            first_grad = clipped
            first_preds = (np.concatenate(step_preds), ex_valid, batch["y"])
    delta = {k: params[k].detach() - w0[k] for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "grad": first_grad, "delta": delta,
            "preds": first_preds[0], "pred_valid": first_preds[1], "targets": first_preds[2],
            "head": float(w0["cls.weight"].norm())}


def _median_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    med = float(np.median(list(ref.values())))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref]))


def kept_change_norms(program: Dict, reference: Dict) -> Tuple[Dict[str, float],
                                                                Dict[str, float]]:
    """Each leaf's change over the three steps, program's and reference's
    norms, over the elements whose first reference gradient is at least a
    thousandth of the median leaf's root mean square: the others (a key's
    bias under softmax) move by round-off alone."""
    grads = reference["grad"]
    floor = 1e-3 * float(np.median([float(g.norm()) / math.sqrt(g.numel())
                                    for g in grads.values()]))
    pm, rm = {}, {}
    for k, g in grads.items():
        keep = g.abs() >= floor
        if bool(keep.any()):
            pd = program["delta"][k].to(g.device)
            pm[k] = float(pd[keep].norm())
            rm[k] = float(reference["delta"][k][keep].norm())
    return pm, rm


def train_gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """The numbers a training cell compares (module docstring), and the
    median leaf's gaps beside them."""
    inf = {k: math.inf for k in ("loss_gap", "loss1_gap", "loss1_mean_gap", "pred1_gap",
                                 "grad_gap",
                                 "grad_median_gap", "update_gap", "update_median_gap")}
    pl, rl = program["losses"], reference["losses"]
    rg = reference["grad_norms"]
    if (len(pl) != len(rl) or not all(math.isfinite(p) for p in pl)
            or set(program["grad_norms"]) != set(rg) or set(program["delta"]) != set(rg)
            or np.shape(program["preds"]) != np.shape(reference["preds"])):
        return inf
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(pl, rl)]
    pm, rm = kept_change_norms(program, reference)
    ok = reference["pred_valid"]
    preds = np.asarray(program["preds"], np.float64)
    d = (preds - reference["preds"])[ok]
    pred1 = float(np.sqrt(np.mean(d * d))) / reference["head"] if d.size else math.inf
    own = float(np.abs(preds - reference["targets"])[ok].mean()) if d.size else math.nan
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "loss1_mean_gap": abs(pl[0] - own) / own if own > 0 else math.inf,
            "pred1_gap": pred1 if math.isfinite(pred1) else math.inf,
            "grad_gap": ref_optim.worst_leaf_gap(program["grad_norms"], rg, list(rg)),
            "grad_median_gap": _median_gap(program["grad_norms"], rg),
            "update_gap": ref_optim.worst_leaf_gap(pm, rm, list(rm)),
            "update_median_gap": _median_gap(pm, rm)}


def reference_inputs(cell, host: Dict[str, np.ndarray]):
    """(rows, vocab, max_pos, rows_differ or None) of a training cell, the
    rows derived by the reference where the cell's rows come from ZINC."""
    cfg, tr = cell.config, cell.traffic
    max_pos = int(cfg["model"].get("max_pos", 600))
    if tr["rows"] == "dense":
        return host, int(tr["vocab"]), max(max_pos, int(tr["row_len"])), None
    from .drivers.common import zinc_root

    mols = ref_zinc.load_corpus(zinc_root(cell, tr))
    rows, max_len, vocab = packed_rows(cfg, mols)
    return rows, vocab, max(max_pos, max_len), rows_differ(host, rows)


def train(cell, seed: int, device, program: Dict, first: Dict,
          host: Dict[str, np.ndarray]) -> Tuple[Dict[str, Tuple[float, float]], float]:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, vocab, max_pos, differ = reference_inputs(cell, host)
    reading = train_reference(cell.config, seed, device, rows, first, vocab, max_pos)
    gaps = train_gaps(program, reading)
    if differ is not None:
        gaps["rows_differ"] = float(differ)
    return held(gaps, cell.limits), time.perf_counter() - t0


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """{name: (number, limit)} for each number the cell's limits name; a
    limit whose number is missing counts as failed."""
    return {k: (float(numbers.get(k, math.inf)), float(lim)) for k, lim in limits.items()}
