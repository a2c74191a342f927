"""Port parity of ``eval/graph_stats.py``: orbit counts (native and numpy)
and the MMD statistics equal to the JAX package's."""

from unittest import mock

import numpy as np
import pytest

from glearning_benchmark_tpu.eval import graph_stats as jax_stats
from glearning_benchmark_tpu_torch import native
from glearning_benchmark_tpu_torch.data import generator as G
from glearning_benchmark_tpu_torch.eval import graph_stats as stats


def _graphs(k=10, seed=1, max_nodes=16):
    """Generator graphs of at most ``max_nodes`` nodes (the numpy counter
    enumerates every quad) and one edgeless graph."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        g = G.generate_graph(["er", "ba", "sbm", "star", "path"][int(rng.integers(5))],
                             int(rng.integers(1 << 20)))
        if g.num_nodes <= max_nodes:
            out.append((np.asarray(g.edges).reshape(-1, 2), g.num_nodes))
    return out + [(np.zeros((0, 2), dtype=np.int64), 3)]


def test_orbit_tables_by_hand():
    def counts(edges, n):
        return stats._orbit_counts_numpy(np.asarray(edges), n)

    c = counts([[0, 1], [1, 2], [2, 3]], 4)              # P4
    assert c[:, 4].tolist() == [1, 0, 0, 1] and c[:, 5].tolist() == [0, 1, 1, 0]
    c = counts([[0, 1], [1, 2], [0, 2], [2, 3]], 4)      # paw
    assert c[:, 9].tolist() == [0, 0, 0, 1] and c[:, 11].tolist() == [0, 0, 1, 0]
    c = counts([[0, 1], [0, 2], [1, 2], [1, 3], [2, 3]], 4)   # diamond
    assert c[:, 12].tolist() == [1, 0, 0, 1] and c[:, 13].tolist() == [0, 1, 1, 0]
    c = counts([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], 4)  # K4
    assert c[:, 14].tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_orbit_counts_match_the_jax_package(path):
    graphs = _graphs()
    edges, nn = [e for e, _ in graphs], [n for _, n in graphs]
    with mock.patch.object(native, "get_gstats", (lambda: None) if path == "numpy"
                           else native.get_gstats):
        assert native.gstats_available() == (path == "native")
        got = stats.orbit_counts_batch(edges, nn)
    ref = jax_stats.orbit_counts_batch(edges, nn)
    for e, n, a, b in zip(edges, nn, got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(a, jax_stats._orbit_counts_numpy(e, n))
    assert stats.orbit_counts(edges[0], nn[0]).tobytes() == got[0].tobytes()


def test_native_refusal_falls_back_to_numpy():
    """The library refuses a graph with a self-loop; the batch then takes
    the numpy path, as the JAX package's does."""
    edges = [np.array([[0, 1], [1, 1], [1, 2]]), np.array([[0, 1]])]
    with pytest.raises(ValueError):
        native.orbit_counts_batch_native(edges, [3, 2])
    got = stats.orbit_counts_batch(edges, [3, 2])
    for a, b in zip(got, jax_stats.orbit_counts_batch(edges, [3, 2])):
        assert a.tobytes() == b.tobytes()


def test_mmd_and_scalar_statistics_match_the_jax_package():
    rng = np.random.default_rng(2)
    a = [rng.dirichlet(np.ones(8)) for _ in range(20)]
    b = [np.roll(x, 3) for x in a]
    assert stats.mmd_gaussian_tv(a, b) == jax_stats.mmd_gaussian_tv(a, b) > 1e-4
    assert stats.mmd_gaussian_tv(a, list(a)) == pytest.approx(0.0, abs=1e-12)
    xs = rng.normal(size=(15, 15))
    assert stats.mmd_rbf(xs, xs + 25.0) == jax_stats.mmd_rbf(xs, xs + 25.0) > 1e-3
    for e, n in _graphs(4, seed=3):
        assert stats.degree_histogram(e, n).tobytes() == jax_stats.degree_histogram(e, n).tobytes()
        assert (stats.clustering_coefficients(e, n).tobytes()
                == jax_stats.clustering_coefficients(e, n).tobytes())


def test_compare_corpora_matches_the_jax_package():
    """Same-generator corpora are closer than cross-generator ones on every
    statistic, and every value equals the JAX package's."""
    def gen(algo, seed0, k=12):
        return [G.generate_graph(algo, seed0 + i) for i in range(k)]

    er_a, er_b, star = gen("er", 0), gen("er", 1000), gen("star", 2000)
    same, diff = stats.compare_corpora(er_a, er_b), stats.compare_corpora(er_a, star)
    assert same == jax_stats.compare_corpora(er_a, er_b)
    assert diff == jax_stats.compare_corpora(er_a, star)
    for key in ("degree_mmd", "clustering_mmd", "orbit_mmd"):
        assert diff[key] > same[key], key
