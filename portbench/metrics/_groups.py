"""Device kernels grouped by name.

The attention, hash-dropout and GEMM groups are copied from
``glearning_benchmark_tpu_torch/tools/mfu_bench.py`` (``KERNEL_GROUPS``);
the optimizer group is the foreach kernels ``ClippedAdamW`` runs
(``multi_tensor_apply``, with the norm's ``lpnorm_cleanup``). Everything
else is ``other``.
"""

from __future__ import annotations

GROUPS = (("attention", ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")),
          ("dropout", ("hash_dropout",)),
          ("gemm", ("gemm", "xmma", "nvjet", "cutlass")),
          ("optim", ("multi_tensor_apply", "lpnorm_cleanup")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"
