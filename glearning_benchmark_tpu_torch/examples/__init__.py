"""The port's examples, each runnable as ``python -m``:
``examples.gcn_vs_gat`` (GCN against GAT on a citation-network stand-in)."""
