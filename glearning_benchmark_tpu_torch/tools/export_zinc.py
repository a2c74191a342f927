"""Export the real PyG ZINC dataset to the port's .npz format (the root
``tools/export_zinc.py``, on the port's ``Graph`` and ``save_zinc_npz``).

    python -m glearning_benchmark_tpu_torch.tools.export_zinc --root ./data/ZINC

Needs ``torch_geometric`` and, at its first run, the network (``ZINC``
downloads the dataset); neither is part of the port's environment. Writes
``<root>/zinc_{train,val,test}.npz``, where ``data.zinc.load_zinc_split``
finds them in place of the deterministic stand-in corpus, and prints one
JSON line a split.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..data.graphs import Graph
from ..data.zinc import save_zinc_npz
from ..utils.card import HOST
from . import emit



def data_to_graph(data) -> Graph:
    """One PyG ZINC ``Data`` (``edge_index`` [2, E], ``num_nodes``, ``y``,
    atom types ``x`` [N, 1], bond types ``edge_attr`` [E]) as a ``Graph``,
    both orientations of each bond kept in PyG's order."""
    e = data.edge_index.numpy()
    return Graph(edges=np.stack([e[0], e[1]], axis=1).astype(np.int32),
                 num_nodes=int(data.num_nodes), y=float(data.y),
                 node_labels=data.x.flatten().numpy().astype(np.int32),
                 edge_labels=data.edge_attr.flatten().numpy().astype(np.int32))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="./data/ZINC")
    ap.add_argument("--subset", action=argparse.BooleanOptionalAction, default=True)
    args = ap.parse_args(argv)

    from torch_geometric.datasets import ZINC  # downloads on its first run

    for split in ("train", "val", "test"):
        graphs = [data_to_graph(d) for d in ZINC(root=args.root, subset=args.subset,
                                                 split=split)]
        path = os.path.join(args.root, f"zinc_{split}.npz")
        save_zinc_npz(path, graphs)
        emit({"split": split, "molecules": len(graphs), "path": path}, HOST)


if __name__ == "__main__":
    main()
