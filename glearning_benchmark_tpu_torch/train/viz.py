"""Example-graph logging.

Port of ``glearning_benchmark_tpu/train/viz.py``: ``log_graph_examples``
(copied), the text render the trainer prints for the graph models on the
synthetic tasks. The images (graph renders, the confusion-matrix heatmap)
are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from ..data.graphs import Graph


def log_graph_examples(graphs: Sequence[Graph], task: str,
                       num_examples: int = 2) -> str:
    """Text render of example graphs (reference metrics.py:209-253)."""
    lines = ["=" * 80, f"Example Graphs ({task})", "=" * 80, ""]
    for i, g in enumerate(graphs[:num_examples]):
        lines.append(f"Example {i + 1}:")
        lines.append(f"  Nodes: {g.num_nodes}")
        lines.append(f"  Edges: {g.num_edges}")
        if task == "cycle_check":
            lines.append(f"  Label: {'Yes (has cycle)' if g.y == 1 else 'No (no cycle)'}")
        elif task == "shortest_path":
            if g.query_u is not None:
                lines.append(f"  Query: node {g.query_u} → node {g.query_v}")
            lines.append(f"  Path length: len{int(g.y) + 1} (class {int(g.y)})")
        else:
            lines.append(f"  Target: {g.y}")
        lines.append(f"  Edges (first 10): {g.edges[:10].tolist()}")
        lines.append("")
    lines.append("=" * 80)
    return "\n".join(lines)
