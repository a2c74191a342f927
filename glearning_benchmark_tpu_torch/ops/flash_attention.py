"""Flash-attention forward: the hand-written Hopper kernel and its plain version.

Port of ``glearning_benchmark_tpu/ops/pallas_attention.py`` (forward only:
``flash_attention`` / ``_flash_fwd`` / ``_attn_kernel`` and the dropout
stream ``_hash_u32`` / ``dropout_keep_reference``). The kernel source is
``csrc/flash_attn_fwd.cu``; its header note gives the design and what
bounds it on an H100.

- :func:`flash_attention_fwd` is the wrapper. A CUDA tensor goes to the
  kernel (or the call raises); a CPU tensor goes to
  :func:`flash_attention_reference`, the plain version. Nothing falls back.
- :data:`LAUNCHES` counts kernel launches, so a run can show that its path
  went through the kernel.
- The kernel is compiled with ``nvcc`` for ``sm_90a`` from the package's own
  source at first use, into ``_build/`` beside the package, and bound with
  ``ctypes``.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) are not
ported yet; this module serves inference only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (4, 8, 16, 32, 64)
_U32 = 0xFFFFFFFF

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flash_attn_fwd.cu"
BUILD_DIR = _PKG / "_build"

# kernel launches since import (or since the caller last set it to 0)
LAUNCHES = 0

_lib = None


# ---------------------------------------------------------------------------
# the counter-hash dropout stream (pallas_attention._hash_u32), u32
# arithmetic carried in int64 tensors
# ---------------------------------------------------------------------------

def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_u32(seed_u32: int, bh: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor) -> torch.Tensor:
    """triple32 finaliser over absolute (batch*head, row, col) indices."""
    x = _mul_u32(bh, 0x9E3779B1)
    x = x ^ _mul_u32(row, 0x85EBCA77)
    x = x ^ _mul_u32(col, 0xC2B2AE3D)
    x = (x + seed_u32) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_u32(seed: int) -> int:
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    return seed & _U32


def _keep_threshold(p_drop: float) -> int:
    return min(int(p_drop * 4294967296.0), 4294967295)


def dropout_keep_reference(seed: int, bh: int, n_rows: int, n_cols: int,
                           p_drop: float,
                           device: torch.device | str = "cpu") -> torch.Tensor:
    """[bh, n_rows, n_cols] bool keep mask, bit-identical to the kernel's
    stream and to the JAX package's ``dropout_keep_reference``."""
    idx = dict(dtype=torch.int64, device=device)
    x = _hash_u32(_seed_u32(seed),
                  torch.arange(bh, **idx)[:, None, None],
                  torch.arange(n_rows, **idx)[None, :, None],
                  torch.arange(n_cols, **idx)[None, None, :])
    return x >= _keep_threshold(p_drop)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seg: torch.Tensor,
                              p_drop: float = 0.0, seed: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention in f32 with the kernel's semantics.

    q, k, v [B, L, H, D]; seg [B, L] int (0 = pad). Returns O [B, L, H, D]
    in q's dtype (exact zeros on pad queries) and LSE [B, H, L] f32
    (-1e30 on rows that attend nothing)."""
    b, l, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("blhd,bshd->bhls", qf, kf) * (1.0 / d ** 0.5)
    allow = ((seg[:, None, :, None] == seg[:, None, None, :])
             & (seg[:, None, None, :] != 0))
    logits = torch.where(allow, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * allow
    denom = p.sum(dim=-1, keepdim=True)
    if p_drop > 0.0:
        keep = dropout_keep_reference(seed, b * h, l, l, p_drop,
                                      device=q.device).view(b, h, l, l)
        p = torch.where(keep, p * (1.0 / (1.0 - p_drop)), 0.0)
    safe = torch.where(denom > 0, denom, 1.0)
    out = torch.einsum("bhls,bshd->bhld", p, vf) / safe
    lse = (m + torch.log(safe)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "flash-attention kernel cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/flash_attn_fwd.cu`` for sm_90a into a shared library
    named by the source's hash (a rebuilt source gets a new library), and
    return its path. A library already built from the same source is
    reused."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_attn_fwd_{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (BUILD_DIR / f"{lib.stem}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attn_fwd
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = ([ptr] * 6 + [i64] * 9 + [i32] * 5
                       + [ctypes.c_float, i32, ctypes.c_uint32,
                          ctypes.c_uint32, ctypes.c_float, ptr])
        fn.restype = i32
        _lib = lib
    return _lib


def build_seconds() -> float:
    """Build (or find) the kernel library and bind it; seconds taken."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, seg):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one [B, L, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, _, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if seg.shape != (b, l) or seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32 [{b}, {l}], got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    devices = {t.device for t in (q, k, v, seg)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, seg lie on different devices: {devices}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg: torch.Tensor, p_drop: float = 0.0,
                        seed: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over [B, L, H, D] inputs with segment masking and
    optional in-kernel dropout. Returns (O [B, L, H, D] in q's dtype,
    LSE [B, H, L] f32). CUDA tensors run the kernel; CPU tensors run
    :func:`flash_attention_reference`."""
    global LAUNCHES
    _check(q, k, v, seg)
    p_drop = float(p_drop)
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must lie in [0, 1), got {p_drop}")
    seed = 0 if seed is None else int(seed)
    seed_u32 = _seed_u32(seed)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seg, p_drop, seed)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    if not seg.is_contiguous():
        raise ValueError("seg must be contiguous")
    b, l, h, d = q.shape
    if b * h >= 2**31 or -(-l // 128) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _library().flash_attn_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 o.data_ptr(), lse.data_ptr(),
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 b, l, h, d, int(q.dtype == torch.bfloat16),
                 1.0 / d ** 0.5, int(p_drop > 0.0), seed_u32,
                 _keep_threshold(p_drop), 1.0 / (1.0 - p_drop), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None, *,
                    seg: Optional[torch.Tensor] = None, p_drop: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``flash_attention`` signature, forward only: pass
    ``key_mask`` [B, L] bool (True = attend) or ``seg`` [B, L] segment ids
    (0 = pad). Returns O [B, L, H, D]."""
    if seg is None:
        if key_mask is None:
            raise ValueError("flash_attention needs key_mask or seg")
        seg = key_mask
    return flash_attention_fwd(q, k, v, seg.to(torch.int32).contiguous(),
                               p_drop=p_drop, seed=seed)[0]
