"""Metrics from device-accumulated sufficient statistics.

Port of ``glearning_benchmark_tpu/train/metrics.py`` (numpy, copied): every
metric is derived from statistics summed on the device across an epoch and
read once, so it is exactly sample-weighted; the keys are the reference's
logging schema.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def classification_metrics_from_cm(cm: np.ndarray, task: str,
                                   loss_sum: float, count: float) -> Dict[str, float]:
    cm = np.asarray(cm, dtype=np.float64)
    n = max(cm.sum(), 1.0)
    metrics: Dict[str, float] = {}
    metrics["loss"] = float(loss_sum / max(count, 1.0))
    metrics["accuracy"] = float(np.trace(cm) / n)

    tp = np.diag(cm)
    pred_tot = cm.sum(axis=0)   # predicted counts per class
    true_tot = cm.sum(axis=1)   # true counts per class
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        rec = np.where(true_tot > 0, tp / true_tot, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)

    if task == "cycle_check":
        # binary average: positive class = 1 (sklearn average='binary')
        metrics["precision"] = float(prec[1])
        metrics["recall"] = float(rec[1])
        metrics["f1"] = float(f1[1])
    else:
        metrics["precision_macro"] = float(prec.mean())
        metrics["recall_macro"] = float(rec.mean())
        metrics["f1_macro"] = float(f1.mean())
        w = true_tot / n
        metrics["precision_weighted"] = float((prec * w).sum())
        metrics["recall_weighted"] = float((rec * w).sum())
        metrics["f1_weighted"] = float((f1 * w).sum())

    if task == "shortest_path":
        # ordinal mse/mae treating class ids as values (reference
        # metrics.py:72-77); exact from the confusion matrix
        i = np.arange(cm.shape[0])
        diff = i[None, :] - i[:, None]
        metrics["mse"] = float((cm * diff ** 2).sum() / n)
        metrics["mae"] = float((cm * np.abs(diff)).sum() / n)

    metrics["confusion_matrix"] = cm.astype(np.int64)
    return metrics


def regression_metrics_from_sums(abs_sum: float, sq_sum: float,
                                 loss_sum: float, count: float) -> Dict[str, float]:
    c = max(count, 1.0)
    mse = sq_sum / c
    return {
        "loss": float(loss_sum / c),
        "mae": float(abs_sum / c),
        "mse": float(mse),
        "rmse": float(np.sqrt(mse)),
    }



def class_names(task: str, n: int):
    """Per-task class names. cycle_check and the binary pair-query families
    are yes/no; shortest_path's class i is distance i+1 ('lenK'); a count
    family's class i is the literal count, with that task's grammar
    prefix."""
    from ..data.text_grammar import COUNT_TASKS, PAIR_QUERY_BINARY_TASKS
    if task == "cycle_check" or task in PAIR_QUERY_BINARY_TASKS:
        return ["No", "Yes"][:n]
    if task in COUNT_TASKS:
        p = COUNT_TASKS[task]
        return [f"{p}{i}" for i in range(n)]
    if task == "shortest_path":
        return [f"len{i + 1}" for i in range(n)]
    return [f"c{i}" for i in range(n)]


def format_confusion_matrix(cm: np.ndarray, task: str = "cycle_check") -> str:
    """Text confusion-matrix table (reference: metrics.py:155-182)."""
    if cm.shape[0] > 30:
        # extended count tasks reach C>1000; a C² console table is megabytes
        # of text — summarize instead (the reference only ever renders C∈{2,7})
        diag = int(np.trace(cm))
        total = int(cm.sum())
        return (f"Confusion Matrix: {cm.shape[0]} classes "
                f"(too large to render); diagonal {diag}/{total} "
                f"({diag / max(total, 1):.4f} accuracy)")
    labels = class_names(task, cm.shape[0])
    header = "Confusion Matrix:\nPredicted →\nActual ↓  " + \
        "  ".join(f"{l:>6}" for l in labels) + "\n"
    rows = []
    for i, label in enumerate(labels):
        rows.append(f"{label:>6}  " + "  ".join(f"{int(cm[i, j]):>6}" for j in range(len(labels))))
    return header + "\n".join(rows)
