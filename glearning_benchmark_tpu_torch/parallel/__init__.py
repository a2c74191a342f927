"""Parallelism on torch.distributed: the JAX package's mesh and its axes
(data, model, seq, pipe, expert), the differentiable collectives, the shard
layout, the GPipe pipeline, and the distributed reductions and vocab
builds. Port of ``glearning_benchmark_tpu/parallel/``."""

from .data import host_shard_bounds, initialize_distributed, shard_for_host
from .dist import all_reduce_metrics, distributed_vocab_counts, psum_histogram
from .mesh import make_mesh, param_shard_spec, replicated_spec, shard_batch_spec, shard_params
from .pipeline import pp_transformer_forward

__all__ = [
    "make_mesh", "shard_batch_spec", "replicated_spec",
    "param_shard_spec", "shard_params", "pp_transformer_forward",
    "psum_histogram", "distributed_vocab_counts", "all_reduce_metrics",
    "host_shard_bounds", "shard_for_host", "initialize_distributed",
]
