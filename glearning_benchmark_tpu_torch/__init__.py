"""PyTorch/CUDA port of ``glearning_benchmark_tpu`` for NVIDIA Hopper GPUs.

Built one slice at a time (ROADMAP.md). It imports nothing of JAX or of the
JAX package; its tests (``tests/test_torch_*.py``) hold it against the JAX
package on the CPU, and ``chip_smoke.py`` runs it on the GPU.
"""
