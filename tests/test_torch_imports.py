"""The port stands alone: no module of ``glearning_benchmark_tpu_torch``,
and not ``chip_smoke.py``, imports jax, flax, optax or the JAX package."""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "glearning_benchmark_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
BANNED = ("jax", "flax", "optax", "glearning_benchmark_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_imports(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in BANNED, f"{path.name} imports {name}"


def test_package_is_covered():
    assert len(FILES) > 20
    names = {str(p.relative_to(REPO / "glearning_benchmark_tpu_torch")) for p in FILES[:-1]}
    for module in ("data/generator.py", "data/loader.py", "data/graphs.py",
                   "ops/segment.py", "models/mpnn.py", "models/gps.py",
                   "train/viz.py", "train/datasets.py", "native/__init__.py",
                   "tokenization/ibtt_fast.py", "eval/graph_stats.py",
                   "models/moe.py", "parallel/data.py", "parallel/dist.py",
                   "parallel/mesh.py", "parallel/multiproc.py", "parallel/pipeline.py",
                   "ops/ring_attention.py", "bench.py", "utils/card.py",
                   "tools/__init__.py", "tools/serve_bench.py", "tools/mfu_bench.py",
                   "tools/flash_ab.py", "tools/export_zinc.py",
                   "tools/graph_stats_report.py", "tools/roofline.py", "utils/trace.py"):
        assert module in names, module


MODULES = [".".join(p.relative_to(REPO).with_suffix("").parts)
           for p in FILES[:-1] if p.name != "__main__.py"]


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_a_gpu_toolchain(module):
    """Every module imports where there is no nvcc, no triton and no GPU:
    kernels are built inside the call that launches them."""
    importlib.import_module(module)
