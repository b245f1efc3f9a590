"""precond.build_ms: the preconditioner build that the program reports
(SolveOutput.ptime: host LDL, packing and upload), mean a request of the
window, ms."""


def read(run):
    if not run.requests:
        return None
    return 1e3 * sum(r.ptime_s for r in run.requests) / len(run.requests)
