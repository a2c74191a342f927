"""The reference's frozen copies against the port, and the port against the
reference on tiny cells on the CPU."""

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import model as ref
from portbench.reference import pack as ref_pack
from portbench.reference import sent as ref_sent
from portbench.reference import zinc as ref_zinc
from portbench.tests import tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mols():
    return {s: ref_zinc.split_molecules(s, 40) for s in ref_zinc.SPLIT_SIZES}


def test_stand_in_copy_equals_the_port(tmp_path, mols):
    from glearning_benchmark_tpu_torch.data.zinc import load_zinc_split

    ref_zinc.ensure_corpus(str(tmp_path), {"train": 40, "val": 40, "test": 40})
    for s in ref_zinc.SPLIT_SIZES:
        port = load_zinc_split(str(tmp_path / "none"), s, limit=40)
        back = ref_zinc.load_split(str(tmp_path), s)
        for g, m, b in zip(port, mols[s], back):
            for got in (m, b):
                assert np.array_equal(g.edges, got.edges)
                assert np.array_equal(g.node_labels, got.atoms)
                assert np.array_equal(g.edge_labels, got.bonds)
                assert g.y == got.y


def test_sent_and_pack_copies_equal_the_port(mols):
    from glearning_benchmark_tpu_torch.data.graphs import Graph
    from glearning_benchmark_tpu_torch.tokenization.pack import pack_examples
    from glearning_benchmark_tpu_torch.tokenization.sent import TrailTokenizer
    from glearning_benchmark_tpu_torch.tokenization.vocab import build_fixed_zinc_vocab

    tok = TrailTokenizer(max_length=48, truncation_length=48, labeled_graph=True)
    tok.set_num_nodes(37)
    tok.set_num_node_and_edge_types(9, 4)
    fixed = build_fixed_zinc_vocab()[0]
    seqs = []
    for m in mols["train"]:
        g = Graph(edges=m.edges, num_nodes=m.num_nodes, y=m.y, node_labels=m.atoms,
                  edge_labels=m.bonds)
        want = tok.remap_zinc_tokens(tok(g), fixed)
        got = ref_sent.trail(m.edges, m.atoms, m.bonds, 48)
        assert np.array_equal(want, got)
        seqs.append(got)
    want = pack_examples(seqs, bucket=64, pad_id=2)
    got = ref_pack.pack(seqs, 64, 2)
    for k in ("ids", "seg", "pos", "pos_bos", "ex_valid", "ex_index"):
        assert np.array_equal(want[k], got[k]), k


def test_dropout_hashes_equal_the_port():
    from glearning_benchmark_tpu_torch.ops.attention import hash_keep_mask
    from glearning_benchmark_tpu_torch.ops.flash_attention import dropout_keep_reference

    want = dropout_keep_reference(1234567, 6, 5, 5, 26 / 256, bh_offset=4)
    assert torch.equal(ref.attn_keep(1234567, 4, 6, 5, 26 / 256, "cpu"), want)
    keep, _ = hash_keep_mask(99, (5, 3, 10), 0.1, batch_offset=2, batch_total=9)
    assert torch.equal(ref.byte_keep(99, (5, 3, 10), 2, 0.1, "cpu"), keep)


def test_parameter_shapes_and_order_equal_the_port():
    from glearning_benchmark_tpu_torch.models.transformer import SimpleTransformer

    arch = check._arch({"model": tiny.MODEL})
    with torch.device("meta"):
        m = SimpleTransformer(vocab_size=70, d_model=32, nhead=2, nlayers=2, d_ff=64,
                              max_pos=1024, num_classes=1, use_query_nodes=False, task="zinc")
    port = [(k, tuple(p.shape)) for k, p in m.named_parameters()]
    assert list(ref.param_shapes(arch, 70, 1024).items()) == port


@pytest.mark.parametrize("mix", ["dense", "packed"])
def test_port_holds_to_the_reference_on_tiny_cells(tmp_path, mix):
    line = tiny.run(tiny.make_root(str(tmp_path)), mix)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("mix, host, device", [
    ("packed", {"host_ms_per_step.train", "bundle_s"},
     {"mfu.train", "attn_roofline.train", "device_idle_share.train"}),
    ("dense", {"host_ms_per_step.train"}, {"mfu.train", "attn_roofline.train"})])
def test_traced_run_reads_its_per_layer_metrics(tmp_path, mix, host, device):
    line = tiny.run(tiny.make_root(str(tmp_path)), mix, trace=True)
    assert line["correct"] is True
    assert host <= set(line["metrics"])
    # no card: no device time, roofline or peak share is read
    assert not device & set(line["metrics"])
