"""Named spans at the layer boundaries of the training step.

While a ``torch.profiler`` profile runs (``train.profile_epochs``, or any
profile around the call), ``span(name)`` records a range of that name in
the profile's host timeline, the one its device kernels share; with no
profiler running it is one shared context that does nothing. The ranges are
plain recorded functions, not user annotations, so the profiler makes no
copy of them on the device's timeline: the device's operations read the same
with spans as without.

``region(name, fn, *args)`` runs ``fn(*args)`` inside ``span(name)`` and,
when its tensor inputs need gradients, also names the region's backward: an
identity autograd node on its inputs and one on its outputs open a span of
the same name where the backward reaches the outputs and close it where it
leaves through the inputs, on the autograd engine's thread. The engine runs
the ready node of the highest sequence number first, so a region's backward
nodes run between the two. With no profiler running ``region`` only calls
``fn``.

The names the port uses:

- ``train.step``, and inside it ``train.forward`` (the batch gather, the
  model's forward, the loss and its statistics), ``train.backward``
  (``torch.autograd.grad`` and the gradients' sums on a mesh) and
  ``train.update`` (the optimizer step and the step's statistics);
- the token transformer's regions ``model.embed`` and ``model.readout``,
  and in each encoder layer ``layer.attn`` (qkv, attention, out
  projection), ``layer.attn_norm`` (the residual site: the branch's
  dropout, the f32 residual add, ``norm1`` and the copy for the next GEMM),
  ``layer.ffn`` (the FFN or the MoE FFN, with its inner dropout) and
  ``layer.ffn_norm`` (the same residual site with ``norm2``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the code it holds in a running profiler's trace."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


class _Edge(torch.autograd.Function):
    """Identity on its tensors. Its backward opens the span of ``box`` (at
    a region's outputs) or closes it (at the region's inputs)."""

    @staticmethod
    def forward(ctx, box, opens, *xs):
        ctx.box, ctx.opens = box, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        box = ctx.box
        if ctx.opens:
            box["open"] = span(box["name"])
            box["open"].__enter__()
        elif "open" in box:
            box.pop("open").__exit__(None, None, None)
        return (None, None) + grads


def _marked(box, opens, values):
    """``values`` with the tensors that need gradients passed through one
    ``_Edge``; None when none does."""
    at = [i for i, v in enumerate(values)
          if isinstance(v, torch.Tensor) and v.requires_grad]
    if not at:
        return None
    out = list(values)
    for i, v in zip(at, _Edge.apply(box, opens, *(values[i] for i in at))):
        out[i] = v
    return out


def region(name: str, fn, *args):
    """``fn(*args)`` as the region ``name`` (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    box = {"name": name}
    inputs = _marked(box, False, args) if torch.is_grad_enabled() else None
    with span(name):
        out = fn(*(args if inputs is None else inputs))
    if inputs is None:
        return out
    if isinstance(out, tuple):
        return tuple(_marked(box, True, out) or out)
    marked = _marked(box, True, (out,))
    return out if marked is None else marked[0]
