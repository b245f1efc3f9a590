"""krylov.iters: the program's iteration count (SolveOutput.niters; in the
mixed form every inner iteration), mean a request of the window."""


def read(run):
    if not run.requests:
        return None
    return sum(r.niters for r in run.requests) / len(run.requests)
