"""Device timing helpers.

PyTorch returns from a CUDA call before the device has finished, so a host
clock must end in ``sync``; kernel times come from CUDA events
(``cuda_time_ms``), which measure on the device's own clock.
"""
from __future__ import annotations

import torch


def sync(device=None) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_time_ms(fn, *, iters: int = 100, warmup: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, timed with CUDA events on the current stream after ``warmup``
    untimed calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters
