"""Device-time profile of a solve, read from one ``torch.profiler`` trace.

:func:`device_profile` runs a callable once under the profiler and reads
the trace it wrote: the wall time of a named span (``SOLVE_SPAN``, which
``driver.solve`` opens around the Krylov iteration and its final
synchronize; ``MIXED_SPAN``, which ``mixed.solve_mixed`` opens around the
whole mixed solve; ``MIXED_LOOP_SPAN`` around the device-resident outer loop
alone, without the per-call packing), the device's busy time inside that span (the union of its
kernel, memcpy and memset intervals), and the host's kernel launches.  Busy
time and wall time come from the same trace, so the idle share they give is
that of the profiled run: the profiler's own host overhead counts as idle,
which makes it an upper bound of the unprofiled idle share.

Port of the ``trace`` part of ``cpkrylov_tpu/utils/profiling.py``; its
work model waits for the benchmark.

:func:`launch_counts` reads the ``LAUNCHES`` counters of the hand-written
kernels B1-B6 (each wrapper adds one where it launches its kernel, and
nowhere else), and :func:`reset_launches` sets them to 0, so a run can show
which kernels carried it.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import tempfile

import torch

SOLVE_SPAN = "cpkrylov.solve"   # record_function span around the iteration
MIXED_SPAN = "cpkrylov.solve_mixed"   # ... around a whole mixed solve
MIXED_LOOP_SPAN = "cpkrylov.mixed_loop"   # ... around its device loop

# kernel name -> (wrapper module, its counter): B1, B2, B3, B4, B5, B6
KERNEL_COUNTERS = {
    "dia_spmv": ("cpkrylov_tpu_torch.ops.cuda_dia", "LAUNCHES"),
    "bidiag_scan": ("cpkrylov_tpu_torch.precond.cuda_bidiag", "LAUNCHES"),
    "df_dia_spmv": ("cpkrylov_tpu_torch.ops.cuda_df_dia", "LAUNCHES"),
    "band_tri": ("cpkrylov_tpu_torch.precond.cuda_tri", "LAUNCHES"),
    "csr_spmv": ("cpkrylov_tpu_torch.ops.cuda_spmv", "LAUNCHES"),
    "affine_scan": ("cpkrylov_tpu_torch.precond.cuda_tri", "SCAN_LAUNCHES"),
}

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """What one profiled span shows (times in ms on the trace's clock)."""

    wall_ms: float      # the span's host duration
    busy_ms: float      # union of device activity inside the span
    device_ops: int     # kernels, copies and memsets inside the span
    launches: int       # host kernel-launch calls inside the span
    table: str          # key_averages table of the whole profiled call

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.wall_ms if self.wall_ms > 0 else 0.0


def launch_counts() -> dict:
    """Each kernel's launches since its counter was last reset."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(importlib.import_module(mod), attr, 0)


def union_ms(intervals, lo: float, hi: float) -> float:
    """Total length (µs in, ms out) of the union of ``(start, end)``
    intervals clipped to ``[lo, hi]``."""
    total, cursor = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, cursor), min(e, hi)
        if e > s:
            total += e - s
            cursor = e
    return total / 1e3


def summarize_trace(events, table: str = "",
                    span: str = SOLVE_SPAN) -> DeviceProfile:
    """Read a Chrome-trace event list: the last ``span`` annotation and the
    device activity and launches inside it."""
    spans = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not spans:
        raise ValueError(f"the trace holds no {span!r} span")
    lo = float(spans[-1]["ts"])
    hi = lo + float(spans[-1]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") in _DEVICE_CATS
           and e.get("ph") == "X"]
    inside = [(s, e) for s, e in dev if e > lo and s < hi]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") in _LAUNCH_NAMES
                   and lo <= float(e["ts"]) <= hi)
    return DeviceProfile(wall_ms=(hi - lo) / 1e3,
                         busy_ms=union_ms(inside, lo, hi),
                         device_ops=len(inside), launches=launches,
                         table=table)


def device_profile(fn, *, trace_path: str | None = None,
                   span: str = SOLVE_SPAN) -> DeviceProfile:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and, when present,
    CUDA activity) and summarize its last ``span``.  The Chrome trace is
    kept at ``trace_path`` when one is given."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return summarize_trace(events, table, span)
