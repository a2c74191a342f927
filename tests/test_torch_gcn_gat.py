"""The port's GCN-vs-GAT example against the root ``examples/gcn_vs_gat.py``
(CPU): the seeded citation-network stand-in is byte-equal, and a GCN and a
GAT forward from the reference's flax weights agree within 1e-5 (f32).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

from glearning_benchmark_tpu_torch.examples import gcn_vs_gat as port

# one intra-op thread: the tier-1 run puts six pytest workers on one host,
# where torch's own pool in each of them would oversubscribe the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location("root_gcn_vs_gat",
                                                  REPO / "examples" / "gcn_vs_gat.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # flax's dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def test_stand_in_is_byte_equal():
    ref = _reference().make_citation_sbm()
    got = port.make_citation_sbm()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_forwards_from_flax_weights_match():
    import jax
    import jax.numpy as jnp

    ref = _reference()
    x, edges, y, *_ = port.make_citation_sbm(num_nodes=120)      # small: a quick forward
    a_norm, adj_mask = port.graph_operators(edges, x.shape[0])
    classes = int(y.max()) + 1
    flax_gcn, flax_gat = ref.build_models(x.shape[1], classes)
    gcn, gat = port.build_models(x.shape[1], classes)
    key = jax.random.PRNGKey(0)
    t = lambda a: torch.from_numpy(np.array(a))          # noqa: E731

    p = flax_gcn.init({"params": key, "dropout": key}, x, a_norm, train=False)
    gcn.dense_0.data = t(p["params"]["Dense_0"]["kernel"])
    gcn.dense_1.data = t(p["params"]["Dense_1"]["kernel"])
    want = np.asarray(flax_gcn.apply(p, x, jnp.asarray(a_norm), train=False))
    got = gcn(torch.from_numpy(x), torch.from_numpy(a_norm), train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)

    p = flax_gat.init({"params": key, "dropout": key}, x, adj_mask, train=False)
    for layer, name in ((gat.layer_0, "GATLayer_0"), (gat.layer_1, "GATLayer_1")):
        layer.kernel.data = t(p["params"][name]["DenseGeneral_0"]["kernel"])
        layer.a_l.data = t(p["params"][name]["a_l"])
        layer.a_r.data = t(p["params"][name]["a_r"])
    want = np.asarray(flax_gat.apply(p, x, jnp.asarray(adj_mask), train=False))
    got = gat(torch.from_numpy(x), torch.from_numpy(adj_mask), train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
