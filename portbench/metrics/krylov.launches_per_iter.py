"""krylov.launches_per_iter: CUDA launch API calls inside the program's
loop spans of the traced requests, over their iterations."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    its = sum(r.niters for r in run.traced)
    launches = sum(run.trace.launches_in(s, e)
                   for r in run.traced for s, e in run.loop_spans(r))
    return launches / its if its and launches else None
