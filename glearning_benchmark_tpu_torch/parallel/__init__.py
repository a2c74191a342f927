"""Data parallelism on torch.distributed: the 'data' axis of the mesh, the
shard layout, and the distributed reductions and vocab builds. Port of
``glearning_benchmark_tpu/parallel/`` except ``pipeline.py`` (PP) and the
TP/SP/EP axes, which come with the next slice."""

from .data import host_shard_bounds, initialize_distributed, shard_for_host
from .dist import all_reduce_metrics, distributed_vocab_counts, psum_histogram
from .mesh import make_mesh, param_shard_spec, replicated_spec, shard_batch_spec, shard_params

__all__ = [
    "make_mesh", "shard_batch_spec", "replicated_spec",
    "param_shard_spec", "shard_params",
    "psum_histogram", "distributed_vocab_counts", "all_reduce_metrics",
    "host_shard_bounds", "shard_for_host", "initialize_distributed",
]
