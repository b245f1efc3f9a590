"""kernel.trisolve_roofline: the least time of the traced requests'
triangular solves over the device time of their launches, in %.  The
launches are the kernels that ``kernels/trisolve.json`` names; the least
time of each counts the host factor's triangle L (``roofline.py``), not its
device layout."""
from portbench.roofline import least_s, peaks, triangle_work
from portbench.harness import HERE, load_json


def read(run):
    if run.trace is None or not run.traced:
        return None
    kmap = load_json(HERE, "kernels", "trisolve.json")
    pk = peaks()
    least = device = 0.0
    for r in run.traced:
        tri = run.triangles.get(r.pool_index)
        launches = run.trace.kernels(kmap["kernels"], *r.span)
        if tri is None or not launches:
            continue
        nbytes, flops = triangle_work(tri[0], tri[1], run.value_bytes)
        least += len(launches) * least_s(nbytes, flops, run.dtype_name, pk)
        device += sum(e - s for s, e in launches) / 1e6
    return 100.0 * least / device if device > 0 else None
