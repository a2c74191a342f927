"""Where the port's entry points run."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev
