"""The output check against the faults a cell can have, planted in the
port underneath a tiny CPU run, and the control against the reference."""

import pytest
import torch

from portbench import check
from portbench.tests import tiny

torch.set_num_threads(1)


def test_a_step_that_leaves_its_state_unchanged_fails(tmp_path, monkeypatch):
    from glearning_benchmark_tpu_torch.train import optim

    monkeypatch.setattr(optim.ClippedAdamW, "step",
                        lambda self, grads: self.global_norm([g.float() for g in grads]))
    line = tiny.run(tiny.make_root(str(tmp_path)), "dense")
    assert line["correct"] is False
    assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("mix", ["dense", "packed"])
def test_half_the_batch_left_out_fails(tmp_path, monkeypatch, mix):
    from glearning_benchmark_tpu_torch.train import trainer

    inputs = trainer._loss_inputs

    def half(logits, batch, bvalid):
        bvalid = bvalid.clone()
        bvalid[bvalid.shape[0] // 2:] = False
        return inputs(logits, batch, bvalid)

    monkeypatch.setattr(trainer, "_loss_inputs", half)
    line = tiny.run(tiny.make_root(str(tmp_path)), mix)
    assert line["correct"] is False
    assert line["checks"]["loss1_mean_gap"]["value"] > line["checks"]["loss1_mean_gap"]["limit"]


def test_a_token_altered_in_the_packed_rows_fails(tmp_path, monkeypatch):
    from glearning_benchmark_tpu_torch.train import datasets

    pack = datasets.pack_examples

    def altered(*args, **kw):
        out = pack(*args, **kw)
        out["ids"][0, 2] = 8 + (int(out["ids"][0, 2]) - 8 + 1) % 9
        return out

    monkeypatch.setattr(datasets, "pack_examples", altered)
    line = tiny.run(tiny.make_root(str(tmp_path)), "packed")
    assert line["correct"] is False
    assert line["checks"]["rows_differ"]["value"] == 1.0


def test_dv_left_out_of_the_attention_backward_fails(tmp_path):
    from portbench.control import dv_zeroed

    with dv_zeroed():
        line = tiny.run(tiny.make_root(str(tmp_path)), "dense")
    assert line["correct"] is False
    assert (line["checks"]["grad_median_gap"]["value"]
            > 10 * tiny.LIMITS["dense"]["grad_median_gap"])


def test_the_control_separates_from_the_program_on_a_tiny_cell(tmp_path):
    """The control (the reference one precision below bf16) reads at least
    three times what the program does, on each seed."""
    from portbench import harness
    from portbench.drivers.train import Setup

    root = tiny.make_root(str(tmp_path))
    cell = harness.find_cell(root, "tiny.dense", root + "/pb")
    dev = torch.device("cpu")
    for seed in (1, 2, 3):
        st = Setup(cell, seed, dev)
        program, first = st.first_steps()
        rows, vocab, max_pos, _ = check.reference_inputs(cell, st.host)
        args = (cell.config, seed, dev, rows, first, vocab, max_pos)
        ref = check.train_reference(*args)
        sound = check.train_gaps(program, ref)
        control = check.train_gaps(check.train_reference(*args, precision="fp8"), ref)
        assert control["loss1_gap"] > 3 * sound["loss1_gap"]
        assert control["grad_median_gap"] > 3 * sound["grad_median_gap"]
        assert control["pred1_gap"] > 3 * sound["pred1_gap"]
        assert any(control[k] > lim for k, lim in cell.limits.items())
