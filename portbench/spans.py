"""Reading the program's own spans from a traced run.

The port opens ``torch.profiler.record_function`` spans named in
``cpkrylov_tpu_torch/utils/profiling.py``; the names are copied here as
text, so that a reader run against a program without a span finds nothing
and returns None instead of failing on an import.  Every reader counts
only the spans inside a traced request's ``portbench.request`` span, as
``Run.loop_spans`` does.  Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

OPERANDS = "cpkrylov.operands"
UPLOAD = "cpkrylov.upload"
BUILD = "cpkrylov.build"
BUILD_ORDER = "cpkrylov.build.order"
BUILD_LDL = "cpkrylov.build.ldl"
BUILD_PROBE = "cpkrylov.build.probe"
BUILD_PACK = "cpkrylov.build.pack"
MIXED_PACK = "cpkrylov.mixed.pack"
APPLY = "cpkrylov.apply"
HOST_READ = "cpkrylov.host_read"


def inside(spans, outer) -> list:
    """The spans of ``spans`` that lie inside one of ``outer``."""
    return [(s, e) for s, e in spans
            if any(lo <= s and e <= hi for lo, hi in outer)]


def outside(spans, outer) -> list:
    """The spans of ``spans`` that lie inside none of ``outer``."""
    return [(s, e) for s, e in spans
            if not any(lo <= s and e <= hi for lo, hi in outer)]


def per_request(run, *names) -> list | None:
    """For each traced request, the spans called one of ``names`` inside
    it; None where the trace holds no such span at all."""
    if run.trace is None or not run.traced:
        return None
    found = [s for n in names for s in run.trace.spans(n)]
    if not found:
        return None
    return [inside(found, [r.span]) for r in run.traced]


def mean_ms(run, *names) -> float | None:
    """The summed length of the spans called one of ``names``, mean a
    traced request, ms."""
    reqs = per_request(run, *names)
    if reqs is None:
        return None
    return sum(sum(e - s for s, e in sp) for sp in reqs) / 1e3 / len(reqs)


def in_loops(run, name: str) -> list | None:
    """The spans called ``name`` inside the program's loop spans of the
    traced requests; None where the trace holds none."""
    if run.trace is None or not run.traced:
        return None
    loops = [sp for r in run.traced for sp in run.loop_spans(r)]
    found = inside(run.trace.spans(name), loops)
    return found or None


def traced_iters(run) -> int:
    return sum(r.niters for r in run.traced)
