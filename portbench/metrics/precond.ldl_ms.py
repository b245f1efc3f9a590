"""precond.ldl_ms: the preconditioner build's host factorization of K_P
(``cpkrylov.build.ldl``).  Mean a traced request, ms."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, spans.BUILD_LDL)
