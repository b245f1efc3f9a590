"""kernel.band_tri_roofline: the least time of the traced requests'
reduced-scan triangular solves over the device time of their launches, in
%.  The launches are the kernels that ``kernels/band_tri.json`` names: B4's
c kernel, launched once a solve, and its scan B6, so the solves are counted
by the first name alone and the device time sums both.  The least time of a
solve counts the host factor's triangle L (``roofline.py``), as
``kernel.trisolve_roofline`` does for B9, not the panels' device layout."""
from portbench.roofline import least_s, peaks, triangle_work
from portbench.harness import HERE, load_json


def read(run):
    if run.trace is None or not run.traced:
        return None
    kmap = load_json(HERE, "kernels", "band_tri.json")
    solve_kernel = kmap["kernels"][0]
    pk = peaks()
    least = device = 0.0
    for r in run.traced:
        tri = run.triangles.get(r.pool_index)
        solves = run.trace.kernels([solve_kernel], *r.span)
        if tri is None or not solves:
            continue
        nbytes, flops = triangle_work(tri[0], tri[1], run.value_bytes)
        least += len(solves) * least_s(nbytes, flops, run.dtype_name, pk)
        device += sum(e - s for s, e in
                      run.trace.kernels(kmap["kernels"], *r.span)) / 1e6
    return 100.0 * least / device if device > 0 else None
