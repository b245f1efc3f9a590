"""krylov.read_wait_ms_per_iter: host time in the loop's device-to-host
reads (``cpkrylov.host_read`` spans inside the program's loop spans): how
long the host waits on the device, over the traced requests' iterations,
ms."""
from portbench import spans


def read(run):
    found = spans.in_loops(run, spans.HOST_READ)
    its = spans.traced_iters(run)
    if found is None or not its:
        return None
    return sum(e - s for s, e in found) / 1e3 / its
