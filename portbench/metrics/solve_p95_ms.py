"""solve_p95_ms: the 95th percentile of all requests' latencies in the
window."""
from portbench.stats import percentile


def read(run):
    if not run.requests:
        return None
    return 1e3 * percentile([r.wall_s for r in run.requests], 95.0)
