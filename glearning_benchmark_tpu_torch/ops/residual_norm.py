"""The encoder layer's residual site in one kernel pair: the residual hash
dropout, the f32 residual add and LayerNorm, and the result's copy in the
compute dtype for the next GEMM.

No Pallas kernel stands behind it. It is the port's counterpart of what XLA
fuses at the JAX package's two residual sites
(``glearning_benchmark_tpu/models/transformer.py:122`` and ``:135``): the
branch's ``cheap_dropout``, ``(x + y).astype(float32)``, ``nn.LayerNorm``
and the next ``Dense``'s cast. The kernels are ``csrc/residual_norm.cu``
(its header note gives their design and what bounds them on an H100).

- :func:`residual_norm` returns ``norm(x + cheap_dropout(seed, y, rate,
  ...).float())`` and that result's copy in ``copy_dtype``. It chooses its
  path by device alone: on CPU tensors :func:`plain`, the composition as
  separate torch ops; on CUDA tensors :class:`ResidualNormFunction`, the
  kernel forward and backward, on contiguous copies of strided inputs.
  What the kernels cannot take (another dtype than an f32 stream, a bf16
  or f32 branch and an f32 LayerNorm, or d_model not a multiple of 8 up
  to :data:`MAX_D`) raises.
- :data:`CALLS` counts fused forwards, fused backwards and plain calls, so
  a run can show which path its sites took.
- :func:`bound` gives the least time the card could take for a site.
- The kernels are compiled with ``nvcc`` for ``sm_90a`` from the package's
  own source at first use, into ``_build/`` beside the package, and bound
  with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..utils.build import compile_library, library_path
from ..utils.card import HBM_BYTES_S
from .attention import _quantised_threshold, cheap_dropout
from .flash_attention import _NVCC_FLAGS, _nvcc
from .hash_dropout import HEADER, Site, _SiteStruct, blocked_site, site_struct

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "residual_norm.cu"
MAX_D = 4096                   # csrc: kMaxD
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# calls since import (or since :func:`reset_calls`): fused forwards, fused
# backwards, plain calls
CALLS: Dict[str, int] = {"fused": 0, "fused_backward": 0, "plain": 0}


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def plain(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm, seed: Optional[int],
          rate: float, batch_offset: int = 0,
          place: Optional[Dict[int, Tuple[int, int]]] = None) -> torch.Tensor:
    """The site as separate torch ops: the branch's residual dropout (none
    with ``seed`` None), the f32 add, ``norm``."""
    if seed is not None:
        y = cheap_dropout(seed, y, rate, batch_offset=batch_offset, place=place)
    return norm(x + y.float())


def check_kernel_inputs(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm,
                        copy_dtype: torch.dtype) -> None:
    """Raise ValueError where the kernels cannot take the site (module
    docstring)."""
    d = x.shape[-1] if x.dim() else 0
    w, b = norm.weight, norm.bias
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"residual_norm: branch {tuple(y.shape)} on {y.device} for a "
                         f"stream {tuple(x.shape)} on {x.device}")
    if x.dtype != torch.float32 or y.dtype not in _DTYPES or copy_dtype not in _DTYPES:
        raise ValueError(f"residual_norm's kernels take an f32 stream and a branch and copy "
                         f"of {list(_DTYPES)}, not {x.dtype}, {y.dtype}, {copy_dtype}")
    if d % 8 != 0 or not 0 < d <= MAX_D:
        raise ValueError(f"residual_norm's kernels take d_model a multiple of 8 up to "
                         f"{MAX_D}, not {d}")
    if (w is None or b is None or w.dtype != torch.float32 or b.dtype != torch.float32
            or w.device != x.device):
        raise ValueError("residual_norm's kernels take an affine f32 LayerNorm on the "
                         "stream's device")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy of it on 16-byte-aligned storage (the
    kernels' vector accesses)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def residual_norm(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm,
                  seed: Optional[int], rate: float, *, batch_offset: int = 0,
                  place: Optional[Dict[int, Tuple[int, int]]] = None,
                  copy_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, copy): out = ``norm(x + cheap_dropout(seed, y, rate,
    batch_offset=..., place=...).float())`` in f32 (no dropout with ``seed``
    None), copy = ``out.to(copy_dtype)``, or None where ``copy_dtype`` is
    f32 (out serves the next GEMM itself). Differentiable in x, y and the
    norm's parameters."""
    if x.device.type == "cpu":
        CALLS["plain"] += 1
        out = plain(x, y, norm, seed, rate, batch_offset, place)
        return out, None if copy_dtype == torch.float32 else out.to(copy_dtype)
    check_kernel_inputs(x, y, norm, copy_dtype)
    site = None
    thresh = 0 if seed is None else _quantised_threshold(rate)
    if thresh > 0:
        site = blocked_site(y.shape, seed, thresh, 1.0 - thresh / 256.0,
                            batch_offset=batch_offset, place=place)
    copy = copy_dtype != torch.float32
    got = ResidualNormFunction.apply(*(_dense(t) for t in (x, y, norm.weight, norm.bias)),
                                     site, norm.eps, copy)
    return got if copy else (got, None)


# ---------------------------------------------------------------------------
# build, bind, launch
# ---------------------------------------------------------------------------

class _ArgsStruct(ctypes.Structure):
    """``Args`` of csrc/residual_norm.cu, field by field."""
    _fields_ = [("site", _SiteStruct), ("dropping", ctypes.c_int32), ("d", ctypes.c_int32),
                ("g", ctypes.c_int32), ("rows", ctypes.c_int64), ("x", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("eps", ctypes.c_float), ("out", ctypes.c_void_p), ("copy", ctypes.c_void_p),
                ("mean", ctypes.c_void_p), ("rstd", ctypes.c_void_p), ("gout", ctypes.c_void_p),
                ("gcopy", ctypes.c_void_p), ("dx", ctypes.c_void_p), ("dy", ctypes.c_void_p),
                ("partial", ctypes.c_void_p)]


_fns = None
_build_seconds = 0.0
_capacity: Dict[Tuple[int, int, int], int] = {}


def build() -> Path:
    """Compile ``csrc/residual_norm.cu`` for sm_90a into a shared library
    named by the hash of the source, its header and the flags (the
    attention kernels' flags: no fast math), unless one built from the same
    text is there."""
    global _build_seconds
    lib = library_path("residual_norm", [SOURCE.read_bytes(), HEADER.read_bytes(),
                                         " ".join(_NVCC_FLAGS).encode()])
    if not lib.is_file():
        _build_seconds, ptxas = compile_library([_nvcc()] + _NVCC_FLAGS + [str(SOURCE)], lib)
        (lib.parent / f"{lib.stem}.ptxas.txt").write_text(ptxas)
    return lib


def build_seconds() -> float:
    """Build (or find) and bind the kernels; nvcc seconds, 0.0 if they were
    already built."""
    _kernels()
    return _build_seconds


def _kernels():
    global _fns
    if _fns is None:
        lib = ctypes.CDLL(str(build()))
        lib.residual_norm_capacity.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.residual_norm_forward.argtypes = [ctypes.POINTER(_ArgsStruct), ctypes.c_int,
                                              ctypes.c_void_p]
        lib.residual_norm_backward.argtypes = [ctypes.POINTER(_ArgsStruct), ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_void_p]
        for fn in (lib.residual_norm_capacity, lib.residual_norm_forward,
                   lib.residual_norm_backward):
            fn.restype = ctypes.c_int
        _fns = lib
    return _fns


def _args(x, y, weight, site: Optional[Site]) -> _ArgsStruct:
    a = _ArgsStruct(dropping=int(site is not None), d=x.shape[-1],
                    rows=x.numel() // x.shape[-1], x=x.data_ptr(), y=y.data_ptr(),
                    w=weight.data_ptr())
    if site is not None:
        a.site = site_struct(site)
    return a


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"residual_norm {what} launch failed: CUDA error {err}")


def launch_forward(x, y, weight, bias, site: Optional[Site], eps: float, copy: bool):
    """The forward kernel on tensors :func:`check_kernel_inputs` takes,
    contiguous and aligned: (out, its bf16 copy or None, mean, rstd)."""
    rows = x.numel() // x.shape[-1]
    out = torch.empty_like(x)
    cp = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) if copy else None
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    a = _args(x, y, weight, site)
    a.b, a.eps = bias.data_ptr(), eps
    a.out, a.mean, a.rstd = out.data_ptr(), mean.data_ptr(), rstd.data_ptr()
    a.copy = None if cp is None else cp.data_ptr()
    with torch.cuda.device(x.device):
        _check(_kernels().residual_norm_forward(
            ctypes.byref(a), _DTYPES[y.dtype],
            torch.cuda.current_stream(x.device).cuda_stream), "forward")
    return out, cp, mean, rstd


def launch_backward(x, y, weight, mean, rstd, g_out, g_copy, site: Optional[Site]):
    """The backward kernels: (dx, dy, dweight, dbias)."""
    d, code = x.shape[-1], _DTYPES[y.dtype]
    key = (x.device.index or 0, d, code)
    with torch.cuda.device(x.device):
        if key not in _capacity:
            _capacity[key] = _kernels().residual_norm_capacity(d, code)
        cap = _capacity[key]
        if cap <= 0:
            raise RuntimeError(f"residual_norm takes no width {d} of {y.dtype}")
        dx = torch.empty_like(x)
        dy = torch.empty_like(y)
        dw = torch.empty(d, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw)
        partial = torch.empty((cap, 2, d), dtype=torch.float32, device=x.device)
        a = _args(x, y, weight, site)
        a.mean, a.rstd, a.dx, a.dy, a.partial = (mean.data_ptr(), rstd.data_ptr(),
                                                 dx.data_ptr(), dy.data_ptr(),
                                                 partial.data_ptr())
        a.gout = None if g_out is None else g_out.data_ptr()
        a.gcopy = None if g_copy is None else g_copy.data_ptr()
        _check(_kernels().residual_norm_backward(
            ctypes.byref(a), code, cap, dw.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream), "backward")
    return dx, dy, dw, db


class ResidualNormFunction(torch.autograd.Function):
    """The fused site: forward (out, and its bf16 copy where ``copy``) and
    backward by the kernels. Saves x, y, the weight and the rows' mean and
    rstd; the backward recomputes the sum and the keep bits."""

    @staticmethod
    def forward(ctx, x, y, weight, bias, site, eps, copy):
        out, cp, mean, rstd = launch_forward(x, y, weight, bias, site, eps, copy)
        ctx.save_for_backward(x, y, weight, mean, rstd)
        ctx.site = site
        ctx.set_materialize_grads(False)
        CALLS["fused"] += 1
        return (out, cp) if copy else out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_copy=None):
        x, y, weight, mean, rstd = ctx.saved_tensors
        # an output nothing used gets None (no zeros are made for it)
        grads = [None if g is None else g.contiguous() for g in (g_out, g_copy)]
        dx, dy, dw, db = launch_backward(x, y, weight, mean, rstd, *grads, ctx.site)
        CALLS["fused_backward"] += 1
        return dx, dy, dw, db, None, None, None


def bound(rows: int, d: int, branch: torch.dtype, copy: bool) -> dict:
    """Least time the card could take for one site of [rows, d]: each
    input read once and each output written once over the HBM rate. The
    forward reads x (f32) and y and writes out and its bf16 copy, the
    backward reads x, y and both incoming gradients and writes dx and dy;
    the rows' statistics and the weight's sums are counted too."""
    yb = torch.empty((), dtype=branch).element_size()
    cb = 2 if copy else 0
    n = rows * d
    fwd = n * (4 + yb + 4 + cb) + rows * 8 + d * 8
    bwd = n * (4 + yb + 4 + cb + 4 + yb) + rows * 8 + d * 12
    ms = {"forward": fwd / HBM_BYTES_S * 1e3, "backward": bwd / HBM_BYTES_S * 1e3}
    return {"bound_ms": ms["forward"] + ms["backward"], "parts_ms": ms, "bytes": fwd + bwd}
