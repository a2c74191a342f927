"""The frozen arithmetic against hand-worked small shapes."""

import numpy as np
import pytest

from portbench.metrics import _counts, _groups, _peaks

ARCH = {"d_model": 8, "heads": 2, "layers": 3, "d_ff": 16}
PEAKS = {"bf16_flops": 1000.0, "hbm_bytes_s": 100.0}


def test_allowed_pairs_packed_and_dense():
    # packed: segments of 2 and 3 tokens, one pad -> 4 + 9
    assert _counts.allowed_pairs(np.array([[1, 1, 2, 2, 2, 0]])) == 13
    # dense rows: a padding mask as segment ids -> valid^2 a row
    assert _counts.allowed_pairs(np.array([[1, 1, 1, 0], [1, 1, 1, 1]])) == 9 + 16
    assert _counts.allowed_pairs(np.zeros((0, 4), dtype=int)) == 0


def test_attention_work_by_hand():
    w = _counts.attention_work(pairs=13, valid=5, arch=ARCH, backward=True)
    dh = 4
    assert w["calls"][0] == {"flops": 4 * dh * 13 * 2 * 3, "bytes": 4 * 5 * 2 * dh * 2 * 3}
    assert w["calls"][1] == {"flops": 8 * dh * 13 * 2 * 3, "bytes": 8 * 5 * 2 * dh * 2 * 3}
    assert len(_counts.attention_work(13, 5, ARCH, False)["calls"]) == 1


def test_attention_bound_takes_the_larger_side_of_each_call():
    w = {"calls": [{"flops": 1000.0, "bytes": 50.0}, {"flops": 100.0, "bytes": 300.0}]}
    b = _counts.attention_bound_s(w, PEAKS)
    assert b["seconds"] == pytest.approx(1.0 + 3.0)
    assert b["by"] == "bytes"          # 1.1 s of FLOPs against 3.5 s of bytes


def test_model_flops_by_hand():
    p_mm = 3 * (4 * 64 + 2 * 8 * 16)
    assert _counts.matmul_params(ARCH) == p_mm
    att_fwd = 4 * 4 * 13 * 2 * 3
    fwd = 2 * p_mm * 5 + 2 * 8 * 2 + att_fwd
    assert _counts.model_flops(13, 5, 2, ARCH, backward=False) == fwd
    assert _counts.model_flops(13, 5, 2, ARCH, backward=True) == 3 * fwd


def test_groups_and_peaks():
    assert _groups.group_of("void attn_fwd_kernel_wgmma<128>(...)") == "attention"
    assert _groups.group_of("attn_bwd_dkv_kernel_mma") == "attention"
    assert _groups.group_of("hash_dropout_kernel") == "dropout"
    assert _groups.group_of("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == "gemm"
    assert _groups.group_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert _groups.group_of("void at::native::multi_tensor_apply_kernel<...>") == "optim"
    assert _groups.group_of("void at::native::vectorized_elementwise_kernel<4>") == "other"
    assert _peaks.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989.4e12
    assert _peaks.peaks("some other card") is None
