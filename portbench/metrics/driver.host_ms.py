"""driver.host_ms: a traced request's wall time, less the preconditioner
build the program reports (SolveOutput.ptime), less the duration of the
program's loop span (``cpkrylov.solve``, or ``cpkrylov.mixed_loop`` in the
mixed form): the host packing and upload outside the loop.  Mean a
request, ms."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    vals = []
    for r in run.traced:
        loop = sum(e - s for s, e in run.loop_spans(r)) / 1e3
        vals.append((r.span[1] - r.span[0]) / 1e3 - 1e3 * r.ptime_s - loop)
    return sum(vals) / len(vals)
