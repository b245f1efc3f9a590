"""driver.upload_ms: the program's host-to-device copies on the request
path (``cpkrylov.upload`` spans outside any ``cpkrylov.build``, whose
uploads ``precond.pack_ms`` holds).  Mean a traced request, ms."""
from portbench import spans


def read(run):
    reqs = spans.per_request(run, spans.UPLOAD)
    if reqs is None:
        return None
    builds = run.trace.spans(spans.BUILD)
    return sum(sum(e - s for s, e in spans.outside(sp, builds))
               for sp in reqs) / 1e3 / len(reqs)
