"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain versions.

Port of ``glearning_benchmark_tpu/ops/pallas_attention.py``:
``flash_attention`` with its custom gradient (``_flash_fwd`` / ``_flash_bwd``),
the three kernels ``_attn_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``, and the dropout stream ``_hash_u32`` /
``dropout_keep_reference``. The kernel sources are ``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd_dq.cu`` and ``csrc/flash_attn_bwd_dkv.cu`` (shared
pieces in ``csrc/flash_attn_common.cuh``); each source's header note gives
its design and what bounds it on an H100.

- :func:`flash_attention` is differentiable: :class:`FlashAttentionFunction`
  runs the forward kernel and, in its backward, the dQ and the dK/dV kernel.
- :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq` and
  :func:`flash_attention_bwd_dkv` are the wrappers, one per kernel. A CUDA
  tensor goes to the kernel (or the call raises); a CPU tensor goes to the
  plain version, :func:`flash_attention_reference` or
  :func:`flash_attention_bwd_reference`. Nothing falls back.
- :data:`LAUNCHES` counts launches per kernel, so a run can show that its
  path went through each of them.
- The kernels are compiled with ``nvcc`` for ``sm_90a`` from the package's
  own sources at first use (one ``nvcc`` per source, all started together),
  into ``_build/`` beside the package, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.build import compile_library, library_path

NEG_INF = -1e30
HEAD_DIMS = (4, 8, 16, 32, 64)
_U32 = 0xFFFFFFFF

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
# one shared library per source, named like its source and its C entry point
SOURCES = {name: _CSRC / f"{name}.cu"
           for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                        "flash_attn_bwd_dkv")}
HEADERS = (_CSRC / "flash_attn_common.cuh",)
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches since import (or since :func:`reset_launches`), by kernel
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _check_bh_offset(bh_offset, bh: int) -> int:
    """The offset of this call's first batch*head row in the global index
    space: a data-parallel rank's rows are rows of the global batch, so its
    keep masks are the matching rows of the global mask."""
    bh_offset = int(bh_offset)
    if bh_offset < 0 or bh_offset + bh > 2**32:
        raise ValueError(f"bh_offset {bh_offset} with {bh} batch*head rows leaves "
                         "the u32 index space")
    return bh_offset


def dropout_keep_reference(seed: int, bh: int, n_rows: int, n_cols: int,
                           p_drop: float,
                           device: torch.device | str = "cpu",
                           bh_offset: int = 0) -> torch.Tensor:
    """[bh, n_rows, n_cols] bool keep mask, bit-identical to the kernel's
    stream and to the JAX package's ``dropout_keep_reference``; with
    ``bh_offset``, rows ``bh_offset ..`` of the mask of a larger batch."""
    idx = dict(dtype=torch.int64, device=device)
    x = _hash_u32(_seed_u32(seed),
                  torch.arange(bh, **idx)[:, None, None]
                  + _check_bh_offset(bh_offset, bh),
                  torch.arange(n_rows, **idx)[None, :, None],
                  torch.arange(n_cols, **idx)[None, None, :])
    return x >= _keep_threshold(p_drop)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seg: torch.Tensor,
                              p_drop: float = 0.0, seed: int = 0,
                              bh_offset: int = 0
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
        keep = dropout_keep_reference(seed, b * h, l, l, p_drop, device=q.device,
                                      bh_offset=bh_offset).view(b, h, l, l)
        p = torch.where(keep, p * (1.0 / (1.0 - p_drop)), 0.0)
    safe = torch.where(denom > 0, denom, 1.0)
    out = torch.einsum("bhls,bshd->bhld", p, vf) / safe
    lse = (m + torch.log(safe)).squeeze(-1)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def _allow_mask(seg: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] bool: query i may attend key j."""
    return ((seg[:, None, :, None] == seg[:, None, None, :])
            & (seg[:, None, None, :] != 0))


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) over the stored O, summed in f32: [B, H, L]."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, seg: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor,
                                  do: torch.Tensor, p_drop: float = 0.0,
                                  seed: int = 0, bh_offset: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The two backward kernels' formulae (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel``), dense in f32: P recomputed from LSE, dP = dO.v
    (times keep/(1-p)), dS = P (dP - delta) with delta from the stored O;
    dQ = scale dS k, dK = scale dS^T q, dV = (P keep/(1-p))^T dO.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, l, h, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    allow = _allow_mask(seg)
    logits = torch.einsum("blhd,bshd->bhls", qf, kf) * scale
    logits = torch.where(allow, logits, NEG_INF)
    p = torch.exp(logits - lse[..., None]) * allow
    dp = torch.einsum("blhd,bshd->bhls", dof, vf)
    delta = flash_attention_delta(o, do)[..., None]
    if p_drop > 0.0:
        keep = dropout_keep_reference(seed, b * h, l, l, p_drop, device=q.device,
                                      bh_offset=bh_offset).view(b, h, l, l)
        keepf = keep * (1.0 / (1.0 - p_drop))
        pd = p * keepf
        dp = dp * keepf
    else:
        pd = p
    ds = p * (dp - delta)
    dq = torch.einsum("bhls,bshd->blhd", ds, kf) * scale
    dk = torch.einsum("bhls,blhd->bshd", ds, qf) * scale
    dv = torch.einsum("bhls,blhd->bshd", pd, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

class _BwdParams(ctypes.Structure):
    """``flash::BwdParams`` of csrc/flash_attn_common.cuh, field by field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("q", "k", "v", "o", "dout", "seg", "lse", "delta",
                  "dq", "dk", "dv")]
                + [(f"{t}_s{a}", ctypes.c_int64)
                   for t in ("q", "k", "v", "do") for a in "blh"]
                + [("B", ctypes.c_int), ("L", ctypes.c_int), ("H", ctypes.c_int),
                   ("scale", ctypes.c_float), ("scale_log2", ctypes.c_float),
                   ("dropout", ctypes.c_int), ("seed", ctypes.c_uint32),
                   ("keep_thresh", ctypes.c_uint32),
                   ("keep_scale", ctypes.c_float),
                   ("bh_offset", ctypes.c_uint32)])


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_BWD_ARGTYPES = [ctypes.POINTER(_BwdParams), _I32, _I32, _PTR]
_ARGTYPES = {
    "flash_attn_fwd": ([_PTR] * 6 + [_I64] * 9 + [_I32] * 5
                       + [ctypes.c_float, _I32, ctypes.c_uint32,
                          ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32, _PTR]),
    "flash_attn_bwd_dq": _BWD_ARGTYPES,
    "flash_attn_bwd_dkv": _BWD_ARGTYPES,
}

_fns: Dict[str, object] = {}
_build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "flash-attention kernels cannot be built")
    return path


def _compile(name: str, lib: Path) -> float:
    secs, ptxas = compile_library([_nvcc()] + _NVCC_FLAGS + [str(SOURCES[name])], lib)
    (lib.parent / f"{lib.stem}.ptxas.txt").write_text(ptxas)
    return secs


def build() -> Dict[str, Path]:
    """Compile every kernel source for sm_90a into a shared library of its
    own, named by the hash of the source, the shared header and the flags
    (a changed source gets a new library), and return {name: path}. The
    compilers run side by side; a library already built from the same text
    is reused."""
    inputs = [h.read_bytes() for h in HEADERS] + [" ".join(_NVCC_FLAGS).encode()]
    libs = {name: library_path(name, [src.read_bytes()] + inputs)
            for name, src in SOURCES.items()}
    todo = [name for name, lib in libs.items() if not lib.is_file()]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            for name, secs in zip(todo, pool.map(
                    lambda n: _compile(n, libs[n]), todo)):
                _build_seconds[name] = secs
    return libs


def _kernel(name: str):
    """The C entry point ``name``, building every library at first use."""
    if name not in _fns:
        fn = getattr(ctypes.CDLL(str(build()[name])), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I32
        _fns[name] = fn
    return _fns[name]


def build_seconds() -> Dict[str, float]:
    """Build (or find) and bind every kernel library; nvcc seconds per
    source, 0.0 for one that was already built."""
    for name in SOURCES:
        _kernel(name)
    return {name: _build_seconds.get(name, 0.0) for name in SOURCES}


# ---------------------------------------------------------------------------
# the wrappers
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


def _check_p_drop(p_drop) -> float:
    p_drop = float(p_drop)
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must lie in [0, 1), got {p_drop}")
    return p_drop


def _check_cuda(q, k, v, seg):
    """What the kernels need beyond :func:`_check` of a CUDA tensor."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    if not seg.is_contiguous():
        raise ValueError("seg must be contiguous")
    b, l, h, _ = q.shape
    if b * h >= 2**31 or -(-l // 64) > 65535:   # grid (B*H, row tiles of 64 or 128)
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg: torch.Tensor, p_drop: float = 0.0,
                        seed: Optional[int] = None, bh_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over [B, L, H, D] inputs with segment masking and
    optional in-kernel dropout; ``bh_offset`` places the rows in the dropout
    index space of a larger batch (:func:`dropout_keep_reference`). Returns
    (O [B, L, H, D] in q's dtype, LSE [B, H, L] f32). CUDA tensors run the
    kernel; CPU tensors run :func:`flash_attention_reference`."""
    _check(q, k, v, seg)
    p_drop = _check_p_drop(p_drop)
    seed = 0 if seed is None else int(seed)
    seed_u32 = _seed_u32(seed)
    bh_offset = _check_bh_offset(bh_offset, q.shape[0] * q.shape[2])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seg, p_drop, seed, bh_offset)
    _check_cuda(q, k, v, seg)
    b, l, h, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _kernel("flash_attn_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 o.data_ptr(), lse.data_ptr(),
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 b, l, h, d, int(q.dtype == torch.bfloat16),
                 1.0 / d ** 0.5, int(p_drop > 0.0), seed_u32,
                 _keep_threshold(p_drop), 1.0 / (1.0 - p_drop), bh_offset, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def _launch_bwd(name: str, q, k, v, seg, o, lse, do, delta, outs,
                p_drop: float, seed: int, bh_offset: int) -> None:
    """Fill ``flash::BwdParams`` and launch backward kernel ``name``."""
    _check_cuda(q, k, v, seg)
    b, l, h, d = q.shape
    for what, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, h, l), torch.float32),
                                  ("delta", delta, (b, h, l), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{what} must be {dtype} {tuple(shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for what, t in (("o", o), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if do.stride(-1) != 1:
        raise ValueError("do must have a contiguous last dim")
    ptr = {"q": q, "k": k, "v": v, "o": o, "dout": do, "seg": seg,
           "lse": lse, "delta": delta, **outs}
    params = _BwdParams(
        **{name_: (t.data_ptr() if t is not None else None)
           for name_, t in ptr.items()},
        **{f"{n}_s{a}": t.stride(i) for n, t in
           (("q", q), ("k", k), ("v", v), ("do", do))
           for i, a in enumerate("blh")},
        B=b, L=l, H=h, scale=1.0 / d ** 0.5, scale_log2=0.0,
        dropout=int(p_drop > 0.0), seed=_seed_u32(seed),
        keep_thresh=_keep_threshold(p_drop), keep_scale=1.0 / (1.0 - p_drop),
        bh_offset=bh_offset)
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.byref(params), d, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           p_drop: float = 0.0, seed: Optional[int] = None,
                           bh_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ of attention, and delta = rowsum(dO * O) [B, H, L] f32 for
    :func:`flash_attention_bwd_dkv`. ``o`` and ``lse`` are the forward's
    outputs for the same inputs, ``p_drop``, ``seed`` and ``bh_offset``.
    CUDA tensors run the dQ kernel; CPU tensors the plain version."""
    _check(q, k, v, seg)
    p_drop = _check_p_drop(p_drop)
    seed = 0 if seed is None else int(seed)
    bh_offset = _check_bh_offset(bh_offset, q.shape[0] * q.shape[2])
    if q.device.type == "cpu":
        dq = flash_attention_bwd_reference(q, k, v, seg, o, lse, do,
                                           p_drop, seed, bh_offset)[0]
        return dq, flash_attention_delta(o, do)
    b, l, h, d = q.shape
    dq = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    if dq.numel():
        _launch_bwd("flash_attn_bwd_dq", q, k, v, seg, o, lse, do, delta,
                    {"dq": dq, "dk": None, "dv": None}, p_drop, seed, bh_offset)
    return dq, delta


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            seg: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            delta: torch.Tensor, p_drop: float = 0.0,
                            seed: Optional[int] = None, bh_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of attention, from the forward's ``o``/``lse`` and the
    ``delta`` that :func:`flash_attention_bwd_dq` returned. CUDA tensors run
    the dK/dV kernel; CPU tensors the plain version."""
    _check(q, k, v, seg)
    p_drop = _check_p_drop(p_drop)
    seed = 0 if seed is None else int(seed)
    bh_offset = _check_bh_offset(bh_offset, q.shape[0] * q.shape[2])
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, seg, o, lse, do,
                                             p_drop, seed, bh_offset)[1:]
    b, l, h, d = q.shape
    dk = torch.empty((b, l, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, l, h, d), dtype=v.dtype, device=q.device)
    if dk.numel():
        _launch_bwd("flash_attn_bwd_dkv", q, k, v, seg, o, lse, do, delta,
                    {"dq": None, "dk": dk, "dv": dv}, p_drop, seed, bh_offset)
    return dk, dv


def flash_attention_bwd(q, k, v, seg, o, lse, do, p_drop: float = 0.0,
                        seed: Optional[int] = None, bh_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV): the dQ kernel, then the dK/dV kernel on the same stream
    (CPU tensors: one pass of :func:`flash_attention_bwd_reference`)."""
    if q.device.type == "cpu":
        _check(q, k, v, seg)
        return flash_attention_bwd_reference(
            q, k, v, seg, o, lse, do, _check_p_drop(p_drop),
            0 if seed is None else int(seed),
            _check_bh_offset(bh_offset, q.shape[0] * q.shape[2]))
    dq, delta = flash_attention_bwd_dq(q, k, v, seg, o, lse, do, p_drop, seed,
                                       bh_offset)
    dk, dv = flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta,
                                     p_drop, seed, bh_offset)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``_flash_core`` with its custom gradient: forward kernel, and in the
    backward the dQ and dK/dV kernels on the saved q, k, v, O, LSE, seg and
    seed and ``bh_offset`` (the dropout masks are regenerated, never
    stored)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, p_drop, seed, bh_offset=0):
        o, lse = flash_attention_fwd(q, k, v, seg, p_drop, seed, bh_offset)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.p_drop, ctx.seed, ctx.bh_offset = p_drop, seed, bh_offset
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, seg, o, lse, do,
                                         ctx.p_drop, ctx.seed, ctx.bh_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None, *,
                    seg: Optional[torch.Tensor] = None, p_drop: float = 0.0,
                    seed: Optional[int] = None, bh_offset: int = 0) -> torch.Tensor:
    """The JAX package's ``flash_attention`` signature, differentiable in
    q, k, v: pass ``key_mask`` [B, L] bool (True = attend) or ``seg``
    [B, L] segment ids (0 = pad). ``p_drop`` > 0 drops attention
    probabilities inside the kernels by the counter hash of ``seed`` (an
    int32), at batch*head rows ``bh_offset ..`` of the global index space
    (a data-parallel rank's rows; 0 on one process). Returns O [B, L, H, D]."""
    if seg is None:
        if key_mask is None:
            raise ValueError("flash_attention needs key_mask or seg")
        seg = key_mask
    return FlashAttentionFunction.apply(
        q, k, v, seg.to(torch.int32).contiguous(), float(p_drop),
        0 if seed is None else int(seed), int(bh_offset))
