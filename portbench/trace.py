"""Reading a torch.profiler Chrome trace: device busy time, launches,
spans and the breakdown of a traced run.

``union_s`` is a frozen copy of ``cpkrylov_tpu_torch/utils/profiling.py::
union_ms`` (seconds out); the launch API names are that module's
``_LAUNCH_NAMES``.  Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
HOST_CATS = ("cpu_op", "user_annotation")


def union_s(intervals, lo: float, hi: float) -> float:
    """Total length (µs in, s out) of the union of ``(start, end)``
    intervals clipped to ``[lo, hi]``."""
    total, cursor = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, cursor), min(e, hi)
        if e > s:
            total += e - s
            cursor = e
    return total / 1e6


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class Trace:
    """The events of one traced stretch of whole requests."""

    def __init__(self, events):
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e["cat"]) for e in _complete(events, DEVICE_CATS))
        self.launches = sorted(
            float(e["ts"]) for e in _complete(events, ("cuda_runtime",))
            if e.get("name") in LAUNCH_NAMES)
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e["cat"]) for e in _complete(events, HOST_CATS))

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def spans(self, name: str):
        """(start, end) of every user annotation called ``name``."""
        return [(s, e) for s, e, n, c in self.host
                if n == name and c == "user_annotation"]

    def busy_s(self, lo: float, hi: float) -> float:
        return union_s([(s, e) for s, e, _, _ in self.device], lo, hi)

    def launches_in(self, lo: float, hi: float) -> int:
        return (bisect.bisect_right(self.launches, hi)
                - bisect.bisect_left(self.launches, lo))

    def kernels(self, names, lo: float, hi: float):
        """(start, end) of the kernels inside [lo, hi] whose name contains
        one of ``names``."""
        return [(s, e) for s, e, n, c in self.device
                if c == "kernel" and lo <= s and e <= hi
                and any(k in n for k in names)]

    def device_ops(self, lo: float, hi: float, top: int = 10):
        """The device operations that took most time: [name, seconds]."""
        tot: dict = {}
        for s, e, n, _ in self.device:
            if s >= lo and e <= hi:
                tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda t: -t[1])[:top]

    def idle_gaps(self, lo: float, hi: float, top: int = 10):
        """The device's idle time inside [lo, hi], summed by what the host
        was doing at the middle of each gap: the innermost annotation (a
        span of the harness or the program) and the outermost host op
        under it, or "python" where the host ran no op.  [label, seconds],
        largest first."""
        gaps, cursor = [], lo
        for s, e, _, _ in self.device:
            if e <= lo or s >= hi:
                continue
            s, e = max(s, lo), min(e, hi)
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            gaps.append((cursor, hi))
        tot: dict = {}
        active, i = [], 0
        for g0, g1 in gaps:                  # in time order: one sweep
            mid = 0.5 * (g0 + g1)
            while i < len(self.host) and self.host[i][0] <= mid:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            anns = [h for h in active if h[3] == "user_annotation"]
            ann = min(anns, key=lambda h: h[1] - h[0]) if anns else None
            ops = [h for h in active if h[3] != "user_annotation"
                   and (ann is None or h[0] >= ann[0])]
            op = max(ops, key=lambda h: h[1] - h[0]) if ops else None
            label = ((ann[2] if ann else "no span") + " / "
                     + (op[2] if op else "python"))
            tot[label] = tot.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda t: -t[1])[:top]
