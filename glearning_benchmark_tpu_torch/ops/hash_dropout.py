"""The hash-dropout kernel: inverted dropout by the counter hash in one pass.

No Pallas kernel stands behind it. It is the port's counterpart of the
fused XLA pass that the JAX package's ``hash_keep_mask`` and
``cheap_dropout`` (``glearning_benchmark_tpu/ops/attention.py:62-153``)
compile to: the iota, the triple32 hash, the byte compare, the scale and
the select in one pass, the backward regenerating the mask. The kernel is
``csrc/hash_dropout.cu`` (its header note gives its design and what bounds
it on an H100).

- :class:`Site` says where one dropout site's keep bits come from: the
  seed, the threshold, the scale and the tensor's place in the global one
  (:func:`blocked_site` for ``cheap_dropout``'s blocked-byte layout,
  :func:`element_site` for ``hash_dropout``'s one hash an element). It holds
  no tensor.
- :func:`dropout` applies a site to x through :class:`HashDropoutFunction`,
  whose backward applies the same site to the gradient: the forward saves
  no mask. A CUDA tensor goes to the kernel (or the call raises); a CPU
  tensor to the plain version the caller hands in (``ops/attention.py``'s
  ``*_reference`` functions). Nothing falls back.
- :data:`LAUNCHES` counts the kernel's launches, forward and backward, so a
  run can show that its path went through it.
- :func:`bound` gives the least time the card could take for one launch.
- The kernel is compiled with ``nvcc`` for ``sm_90a`` from the package's
  own source at first use, into ``_build/`` beside the package, and bound
  with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils.build import compile_library, library_path
from ..utils.card import HBM_BYTES_S, nvidia_smi
from .flash_attention import _NVCC_FLAGS, _nvcc

_U32 = 0xFFFFFFFF
MAX_AXES = 8                   # csrc: kMaxAxes
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hash_dropout.cu"
# Site and the hash, shared with csrc/residual_norm.cu
HEADER = SOURCE.parent / "hash_site.cuh"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# integer operations a word of hash and an element of compare, scale and
# select (bound); the INT32 lanes of one Hopper SM
HASH_OPS, ELEMENT_OPS, INT32_PER_SM_CLK = 10, 3, 64

# kernel launches since import (or since :func:`reset_launches`)
LAUNCHES: Dict[str, int] = {"hash_dropout": 0}


def reset_launches() -> None:
    LAUNCHES["hash_dropout"] = 0


@dataclass(frozen=True)
class Site:
    """One dropout site's keep bits and scale, for a tensor of ``shape``.
    ``blocked``: the blocked-byte layout (``thresh`` a byte threshold) or
    one hash an element (``thresh`` a u32 threshold). The word (element)
    index is ``base`` plus, for each leading axis of ``axes`` ((local size,
    global stride) after merging), its index times its stride, plus the
    word's place in its row; with no ``axes`` it is ``base`` plus the linear
    word index. Kept elements are divided by ``keep_scale`` (1 - p)."""
    shape: Tuple[int, ...]
    seed: int
    thresh: int
    keep_scale: float
    blocked: bool
    base: int = 0
    axes: Tuple[Tuple[int, int], ...] = ()


def placement(shape, batch_axis: int, batch_offset: int, batch_total: Optional[int],
              place: Optional[Dict[int, Tuple[int, int]]]) -> Dict[int, Tuple[int, int]]:
    """{axis: (offset, global size)} of a tensor of ``shape`` placed in a
    global one (``ops/attention.py``'s module docstring): the batch axis
    and the axes of ``place``. Raises for a placement that does not fit."""
    shape = tuple(shape)
    if batch_axis < 0 or batch_axis >= max(len(shape), 1):
        raise ValueError(f"batch_axis {batch_axis} out of range for {shape}")
    if batch_total is None:
        if batch_axis > 0 and batch_offset > 0:
            raise ValueError("a batch axis that is not the leading one needs "
                             "batch_total")
        batch_total = batch_offset + shape[batch_axis]
    at = {batch_axis: (int(batch_offset), int(batch_total))}
    for ax, (offset, total) in (place or {}).items():
        if ax == batch_axis or not 0 <= ax < len(shape) - 1:
            raise ValueError(f"place axis {ax} is the batch axis or out of range "
                             f"for {shape} (the last axis holds the words)")
        at[ax] = (int(offset), int(total))
    for ax, (offset, total) in at.items():
        if offset < 0 or offset + shape[ax] > total:
            raise ValueError(f"block {offset}..{offset + shape[ax]} of axis {ax} "
                             f"lies outside its global size {total}")
    return at


def blocked_site(shape, seed_u32: int, thresh: int, keep_scale: float, *,
                 batch_axis: int = 0, batch_offset: int = 0,
                 batch_total: Optional[int] = None,
                 place: Optional[Dict[int, Tuple[int, int]]] = None) -> Site:
    """The :class:`Site` of ``hash_keep_mask``'s blocked-byte layout over a
    tensor of ``shape`` placed as the arguments say. The global strides are
    taken over the global word tensor (the last axis ``ceil(s / 4)`` words,
    never placed); adjacent leading axes whose strides nest are merged and
    axes of size 1 dropped."""
    shape = tuple(shape)
    at = placement(shape, batch_axis, int(batch_offset), batch_total, place)
    wshape = shape[:-1] + ((shape[-1] + 3) // 4,)
    strides, stride = [0] * len(wshape), 1
    for ax in range(len(wshape) - 1, -1, -1):
        strides[ax] = stride
        stride *= at.get(ax, (0, wshape[ax]))[1]
    base = sum(offset * strides[ax] for ax, (offset, _) in at.items())
    axes = []     # (local size, global stride) of the leading axes, merged
    for ax in range(len(wshape) - 1):
        if wshape[ax] == 1:
            continue
        if axes and axes[-1][1] == wshape[ax] * strides[ax]:
            axes[-1] = (axes[-1][0] * wshape[ax], strides[ax])
        else:
            axes.append((wshape[ax], strides[ax]))
    if len(axes) == 1 and axes[0][1] == wshape[-1]:
        axes = []     # the words of x are one run of the global tensor's
    if len(axes) > MAX_AXES:
        raise ValueError(f"{shape} placed as {at} has {len(axes)} leading axes after "
                         f"merging; the kernel takes {MAX_AXES}")
    return Site(shape, int(seed_u32) & _U32, int(thresh), float(keep_scale), True,
                base & _U32, tuple((size, gs & _U32) for size, gs in axes))


def element_site(shape, seed_u32: int, thresh: int, keep_scale: float,
                 batch_offset: int = 0) -> Site:
    """The :class:`Site` of ``hash_dropout``: one hash an element over the
    linear index of a tensor of ``shape`` whose rows are rows
    ``batch_offset ..`` of the leading axis of a global tensor."""
    shape = tuple(shape)
    placement(shape, 0, int(batch_offset), None, None)
    row = 1
    for size in shape[1:]:
        row *= size
    return Site(shape, int(seed_u32) & _U32, int(thresh), float(keep_scale), False,
                (int(batch_offset) * row) & _U32)


def words(site: Site) -> Tuple[int, int]:
    """(rows of the last axis, hashes a row) of a site: the kernel's work."""
    rows = 1
    for size in site.shape[:-1]:
        rows *= size
    s = site.shape[-1] if site.shape else 1
    return rows, ((s + 3) // 4 if site.blocked else s)


# ---------------------------------------------------------------------------
# build, bind, launch
# ---------------------------------------------------------------------------

class _SiteStruct(ctypes.Structure):
    """``Site`` of csrc/hash_site.cuh, field by field."""
    _fields_ = [("rows", ctypes.c_int64), ("s", ctypes.c_int64), ("sq", ctypes.c_int64),
                ("size", ctypes.c_int64 * MAX_AXES), ("gstride", ctypes.c_uint32 * MAX_AXES),
                ("naxes", ctypes.c_int32), ("blocked", ctypes.c_int32),
                ("base", ctypes.c_uint32), ("seed", ctypes.c_uint32),
                ("thresh", ctypes.c_uint32), ("inv", ctypes.c_float)]


_fn = None
_build_seconds = 0.0


def build() -> Path:
    """Compile ``csrc/hash_dropout.cu`` for sm_90a into a shared library
    named by the hash of the source, its header and the flags (the
    attention kernels' flags: no fast math), unless one built from the same
    text is there."""
    global _build_seconds
    lib = library_path("hash_dropout", [SOURCE.read_bytes(), HEADER.read_bytes(),
                                        " ".join(_NVCC_FLAGS).encode()])
    if not lib.is_file():
        _build_seconds, ptxas = compile_library([_nvcc()] + _NVCC_FLAGS + [str(SOURCE)], lib)
        (lib.parent / f"{lib.stem}.ptxas.txt").write_text(ptxas)
    return lib


def build_seconds() -> float:
    """Build (or find) and bind the kernel; nvcc seconds, 0.0 if it was
    already built."""
    _kernel()
    return _build_seconds


def _kernel():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(str(build())).hash_dropout
        fn.argtypes = [ctypes.POINTER(_SiteStruct), ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def inverse_scale(keep_scale: float) -> float:
    """1 / c in f32, c the f32 of ``keep_scale``: the factor PyTorch's CUDA
    true division by a host scalar multiplies by (``x / c`` on a CUDA
    tensor runs as x * (1 / c), the reciprocal taken once in f32)."""
    return float(np.float32(1.0) / np.float32(keep_scale))


def site_struct(site: Site) -> _SiteStruct:
    """The kernels' ``Site`` of a site (csrc/hash_site.cuh)."""
    rows, per_row = words(site)
    st = _SiteStruct(rows=rows, s=site.shape[-1], sq=per_row if site.blocked else 0,
                     naxes=len(site.axes), blocked=int(site.blocked), base=site.base,
                     seed=site.seed, thresh=site.thresh, inv=inverse_scale(site.keep_scale))
    for i, (size, gstride) in enumerate(site.axes):
        st.size[i], st.gstride[i] = size, gstride
    return st


def launch(x: torch.Tensor, site: Site) -> torch.Tensor:
    """The kernel on a contiguous CUDA tensor of the site's shape: a new
    tensor, x with the site's dropout applied."""
    if x.device.type != "cuda":
        raise ValueError(f"the hash-dropout kernel takes CUDA tensors, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the hash-dropout kernel takes {list(_DTYPES)}, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the hash-dropout kernel reads a contiguous row-major tensor")
    if tuple(x.shape) != site.shape:
        raise ValueError(f"tensor of shape {tuple(x.shape)} for a site of {site.shape}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    st = site_struct(site)
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(ctypes.byref(st), x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_dropout launch failed: CUDA error {err}")
    LAUNCHES["hash_dropout"] += 1
    return out


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

def _apply(t: torch.Tensor, site: Site, plain: Callable[[torch.Tensor], torch.Tensor]
           ) -> torch.Tensor:
    return plain(t) if t.device.type == "cpu" else launch(t, site)


class HashDropoutFunction(torch.autograd.Function):
    """dropout(x) by a :class:`Site`; the gradient is the same dropout of
    the incoming gradient (the same keep bits, regenerated, and scale). The
    forward saves the site and the plain version, no tensor."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, site: Site, plain) -> torch.Tensor:
        ctx.site, ctx.plain = site, plain
        return _apply(x, site, plain)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        return _apply(grad.contiguous(), ctx.site, ctx.plain), None, None


def dropout(x: torch.Tensor, site: Site,
            plain: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """x with the site's dropout, differentiable. A CUDA tensor runs the
    kernel (a contiguous one, or the call raises); a CPU tensor runs
    ``plain``, the same function as plain torch ops, forward and backward."""
    return HashDropoutFunction.apply(x, site, plain)


def bound(x: torch.Tensor, site: Site) -> dict:
    """Least time the card could take for one launch on x: its bytes read
    once and the output written once over the HBM rate, and the integer
    operations (``HASH_OPS`` a hash, ``ELEMENT_OPS`` an element) over the
    INT32 lanes of every SM at the card's top clock."""
    rows, per_row = words(site)
    nbytes = 2 * x.numel() * x.element_size()
    ops = HASH_OPS * rows * per_row + ELEMENT_OPS * x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    t = {"bytes": nbytes / HBM_BYTES_S * 1e3,
         "operations": ops / (sms * INT32_PER_SM_CLK * clock_hz) * 1e3}
    by = max(t, key=t.get)
    return {"bound_ms": t[by], "bound_by": by, "parts_ms": t, "bytes": nbytes}
