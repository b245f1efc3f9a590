"""precond.scan_pack_s: the host seconds the process spent packing
reduced-scan triangles (the panels' trtri and the batched matmul of
``precond/trisolve.py::pack_reduced_scan_np``), from the program's
``path_counts()["scan_pack_us"]``; in a cell whose preconditioner is built
once in set-up, that build's two packs.  None where the program has no such
counter or packed none."""


def read(run):
    from cpkrylov_tpu_torch.utils import profiling

    counts = getattr(profiling, "path_counts", None)
    if counts is None:
        return None
    us = counts().get("scan_pack_us")
    if not us:
        return None
    return us / 1e6
