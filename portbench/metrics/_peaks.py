"""Datasheet peaks by the name the card gives (``torch.cuda.get_device_name``).

Copied from ``glearning_benchmark_tpu_torch/utils/card.py`` (``DATASHEET``):
the NVIDIA H100 SXM5 data sheet, dense rates at the full 700 W.
"""

from __future__ import annotations

from typing import Dict, Optional

DATASHEET: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def peaks(name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold."""
    return DATASHEET.get(name)
