"""portbench: the benchmark of the PyTorch and CUDA port.

One command runs one cell once (``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``); ``BENCHMARK.json`` at the
root of the repo names the cells, and every part of a cell is found by name
under this folder: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<workload>.json`` and one reader a per-layer metric in
``metrics/<metric>.py``. The plain reference that decides ``correct`` lives
in ``reference/`` and imports nothing of the port.
"""
