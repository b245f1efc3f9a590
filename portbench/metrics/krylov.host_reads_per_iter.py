"""krylov.host_reads_per_iter: the device-to-host reads the loop makes
(``cpkrylov.host_read`` spans inside the program's loop spans: the
stopping tests, the refinement trigger, the mixed loop's scalars) over
the traced requests' iterations."""
from portbench import spans


def read(run):
    found = spans.in_loops(run, spans.HOST_READ)
    its = spans.traced_iters(run)
    if found is None or not its:
        return None
    return len(found) / its
