"""precond.pack_ms: the preconditioner build's device packs of the factor
and of K_P, uploads included (``cpkrylov.build.pack``).  Mean a traced
request, ms."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, spans.BUILD_PACK)
