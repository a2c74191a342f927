"""Per-task class names.

Port of ``glearning_benchmark_tpu/train/metrics.py``: ``class_names`` only
(copied), which the prediction CLI labels its output with. The metric
formulas come with the training slice.
"""

from __future__ import annotations


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
