"""precond.probe_ms: the preconditioner build's probe solve, with the
df64 re-probe and its rebuild where the build takes them
(``cpkrylov.build.probe``).  Mean a traced request, ms."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, spans.BUILD_PROBE)
