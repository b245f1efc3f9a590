"""krylov.apply_ms_per_iter: host time in the preconditioner's apply
(``cpkrylov.apply`` spans inside the program's loop spans) over the traced
requests' iterations, ms: the dispatch and the waits of the direct
solves, the GHN update and the refinement."""
from portbench import spans


def read(run):
    found = spans.in_loops(run, spans.APPLY)
    its = spans.traced_iters(run)
    if found is None or not its:
        return None
    return sum(e - s for s, e in found) / 1e3 / its
