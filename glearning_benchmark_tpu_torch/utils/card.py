"""The card a measurement ran on, its datasheet peaks, and device timing.

Every measurement tool of the port prints the card's ``name`` and
``power.limit`` beside its numbers (:func:`card`), because a card set below
its full power limit runs slower under load. :func:`cuda_ms` is the kernel
timer of ``chip_smoke.py`` and the tools: CUDA events around many
back-to-back calls, queued behind a device spin so that the time is the
device's and not the host's enqueue rate.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List

import torch

# NVIDIA H100 SXM5 data sheet, dense rates at the full 700 W: HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores; the SFU
# computes 16 exp2 per SM per clock
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989.4e12, torch.float32: 67e12}
SFU_PER_SM_CLK = 16

# what a result line run on the host gives in place of a card
HOST = {"name": "cpu", "power_limit": "none"}

# bf16 dense tensor-core peak (FLOP/s) and HBM bytes/s by the name
# ``nvidia-smi`` gives a card (data sheets)
DATASHEET = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """The first card's answer to ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card() -> Dict[str, str]:
    """{"name", "power_limit"} of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    name, limit = (s.strip() for s in nvidia_smi("name,power.limit").split(","))
    return {"name": name, "power_limit": limit}


def device_info(device: torch.device) -> Dict[str, str]:
    """What a result line says of where it ran: the card (:func:`card`) on
    a CUDA device, ``{"name": "cpu"}`` on the CPU, where no number is a
    device metric."""
    return card() if device.type == "cuda" else dict(HOST)


def datasheet(name: str) -> Dict[str, float]:
    """The datasheet peaks of the card named ``name``; raises for a card
    the table does not hold, rather than compare it to another card's."""
    if name not in DATASHEET:
        raise KeyError(f"no datasheet peaks for {name!r} (known: {sorted(DATASHEET)})")
    return DATASHEET[name]


def cuda_ms(fn: Callable[[], object], iters: int, readings: int = 2) -> List[float]:
    """Device ms per call of ``fn`` over ``iters`` back-to-back calls, read
    ``readings`` times one after the other. The device first spins for at
    least 20 ms and for three times the host's own time to enqueue the
    calls (timed on one call), so the host has queued them before the first
    one starts: the time is the device's, not the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(max(40e6, 3 * host_s * iters * 2e9))   # 2e9: above the SM clock
    out = []
    for _ in range(readings):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / iters)
    return out
