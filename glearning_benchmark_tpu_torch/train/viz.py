"""Example-graph logging and the images of a run.

Port of ``glearning_benchmark_tpu/train/viz.py`` (copied): the text render
``log_graph_examples`` the trainer prints for the graph models on the
synthetic tasks, and the images, rendered with matplotlib (Agg), networkx
and PIL: ``visualize_graph``, ``create_graph_visualizations`` and
``create_confusion_matrix_heatmap``, whose class names come from the port's
``train/metrics.class_names``. matplotlib, networkx and PIL are imported
inside the renderers, so the module imports without them.
"""

from __future__ import annotations

from io import BytesIO
from typing import List, Sequence

import numpy as np

from ..data.graphs import Graph
from .metrics import class_names


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


def visualize_graph(g: Graph, task: str = "cycle_check", title: str = "Graph"):
    """Render one graph to a PIL Image (spring layout; query nodes
    highlighted for shortest_path — reference metrics.py:256-330)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx
    from PIL import Image

    G = nx.Graph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from([tuple(map(int, e)) for e in g.edges])

    fig, ax = plt.subplots(figsize=(10, 8))
    pos = nx.spring_layout(G, seed=42, k=1.5, iterations=50)
    colors = ["lightblue"] * g.num_nodes
    sizes = [500] * g.num_nodes
    if task == "shortest_path" and g.query_u is not None:
        colors[g.query_u] = "#ff6b6b"
        colors[g.query_v] = "#4ecdc4"
        sizes[g.query_u] = sizes[g.query_v] = 800
    nx.draw_networkx_nodes(G, pos, node_color=colors, node_size=sizes, alpha=0.9, ax=ax)
    nx.draw_networkx_edges(G, pos, width=1.5, alpha=0.5, edge_color="gray", ax=ax)
    nx.draw_networkx_labels(G, pos, font_size=10, font_weight="bold", ax=ax)
    if task == "cycle_check":
        lab = "Has Cycle" if g.y == 1 else "No Cycle"
        full = f"{title}\nLabel: {lab} | Nodes: {g.num_nodes} | Edges: {g.num_edges}"
    elif task == "shortest_path":
        full = (f"{title}\nQuery: {g.query_u}→{g.query_v} | Distance: len{int(g.y) + 1} "
                f"| Nodes: {g.num_nodes} | Edges: {g.num_edges}")
    else:
        full = f"{title}\nTarget: {g.y} | Nodes: {g.num_nodes} | Edges: {g.num_edges}"
    ax.set_title(full, fontsize=12, fontweight="bold", pad=20)
    ax.axis("off")
    fig.tight_layout()
    buf = BytesIO()
    fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
    buf.seek(0)
    img = Image.open(buf).copy()
    plt.close(fig)
    buf.close()
    return img


def create_graph_visualizations(graphs: Sequence[Graph], task: str,
                                num_examples: int = 3) -> List:
    return [visualize_graph(g, task=task, title=f"Example Graph {i + 1}")
            for i, g in enumerate(graphs[:num_examples])]


def create_confusion_matrix_heatmap(cm: np.ndarray, task: str = "cycle_check",
                                    title: str = "Confusion Matrix"):
    """Heatmap PIL Image of a confusion matrix (reference metrics.py:353-410)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    if task == "cycle_check":
        labels = ["No Cycle", "Has Cycle"]
    else:
        labels = class_names(task, cm.shape[0])
    labels = labels[: cm.shape[0]]

    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(cm, cmap="Blues")
    # Per-cell count annotations only for small class counts: the reference's
    # tasks have C∈{2,7}, but extended count tasks (triangle_count,
    # edge_count) reach C>1000 and C² text artists take tens of minutes and
    # ~10GB of host RAM to render.
    if cm.shape[0] <= 30:
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                val = int(cm[i, j])
                ax.text(j, i, str(val), ha="center", va="center",
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
        ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
        ax.set_yticks(range(len(labels)), labels)
    else:
        step = max(1, cm.shape[0] // 10)
        ticks = list(range(0, cm.shape[0], step))
        ax.set_xticks(ticks, [labels[t] for t in ticks], rotation=45, ha="right")
        ax.set_yticks(ticks, [labels[t] for t in ticks])
    ax.set_xlabel("Predicted Label", fontsize=12, fontweight="bold")
    ax.set_ylabel("True Label", fontsize=12, fontweight="bold")
    ax.set_title(title, fontsize=14, fontweight="bold", pad=20)
    fig.colorbar(im, ax=ax, label="Count")
    fig.tight_layout()
    buf = BytesIO()
    fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
    buf.seek(0)
    img = Image.open(buf).copy()
    plt.close(fig)
    buf.close()
    return img
