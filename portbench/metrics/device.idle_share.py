"""device.idle_share: 1 - (union of kernel, memcpy and memset intervals) /
wall time, over the traced stretch of whole requests, in %."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    lo, hi = run.traced_window()
    busy = run.trace.busy_s(lo, hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e6))
