"""Generation-quality / dataset-characterization evaluation.

Port of ``glearning_benchmark_tpu/eval``. The reference's dependency chain
carries AutoGraph's ORCA (a C++ graphlet orbit counter, compiled at env
setup — reference docs/setup.md:30-36) plus MMD statistics for comparing
graph distributions. This package is the equivalent: native orbit counting
(``csrc/host/gstats.cpp``) and numpy MMD metrics over degree / clustering /
orbit statistics.
"""

from .graph_stats import (  # noqa: F401
    clustering_coefficients,
    compare_corpora,
    degree_histogram,
    mmd_gaussian_tv,
    mmd_rbf,
    orbit_counts,
    orbit_counts_batch,
)
