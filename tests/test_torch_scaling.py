"""The port's multi-process scaling bench (``tools.scaling_bench``) on the
CPU: at N = 2 gloo processes every host's vocab and ids equal one
process's build (the tool checks both and raises otherwise), and the
point has the root tool's keys.
"""

import io
import json
from contextlib import redirect_stdout

from glearning_benchmark_tpu_torch.tools import scaling_bench


def test_two_processes_equal_one(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        scaling_bench.main(["--mols", "60", "--hosts", "2", "--reps", "1",
                            "--out", str(tmp_path / "s.json")])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    (point,) = json.loads((tmp_path / "s.json").read_text())["points"]
    assert point["n_hosts"] == 2 and point["mols"] == 120 and point["equal_to_one_process"]
    for key in ("tokenize_graphs_per_sec", "vocab_bytes_per_sec", "tokenize_efficiency",
                "vocab_efficiency", "t_tok_per_host", "vocab_size"):
        assert key in point
    assert rows[-1]["summary"] == "scaling_bench"
