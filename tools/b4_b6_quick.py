"""A short check of kernels B4 and B6 on the card, for a change to either.

Runs ``chip_smoke.py``'s holds of B6's two layouts without its other
phases: B6 on each layout at the tests' shapes and at panels of many head
rows, each y within chip_smoke's ``BAND_TOL`` of the plain sequential scan
(``scan_plain``, in float64), the grid's y bit for bit against the single
cluster's and a second grid call, the grid's read floor equal to c, none
of these named-layout calls counted (``utils/profiling.launch_counts``); B4 on
a synthetic reduced-scan factor at AUG2D-L's shape (p 632, r 631, nb 473),
f64 and f32, with its scan on each layout (``chip_smoke.hold_scan_paths``:
x bit for bit, the scans' and read floors' device ms); then the crossover
table of the two layouts (``chip_smoke.scan_crossover``).  With ``--aug``
it also builds AUG2D-L's own factor (host LDL and packing, about a
minute) and holds both of its triangles.  About a minute on the card
without it:

    python3 tools/b4_b6_quick.py [--aug]
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# B6 at the shapes of tests/test_torch_kernels_cuda.py (q, r, nb), and
# AUG2D-L's
SCAN_SHAPES = ((1, 1, 5), (8, 8, 1000), (100, 100, 77), (1024, 1024, 9),
               (37, 37, 50), (631, 631, 40), (17, 17, 300), (632, 631, 60),
               (8, 3, 700), (104, 100, 97), (512, 7, 300), (256, 64, 300),
               (512, 1, 40))


def scan_plain(m, c, r):
    """B6's plain version for q >= r rows, in float64: y_i = m_i s_{i-1} +
    c_i from s_{-1} = 0, s_i the last r entries of y_i, step by step."""
    import torch

    q, nb = c.shape
    m, c = m.double(), c.double()
    y = torch.empty((q, nb), dtype=torch.float64, device=c.device)
    s = torch.zeros(r, dtype=torch.float64, device=c.device)
    for i in range(nb):
        y[:, i] = m[:, :, i] @ s + c[:, i]
        s = y[q - r:, i]
    return y


def synthetic_factor(p, r, nb, dtype, device, seed):
    """A reduced-scan factor of nb panels with random inverse panels and
    maps scaled so that the scan stays bounded."""
    import torch

    from cpkrylov_tpu_torch.precond.trisolve import ReducedScanTriFactor

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inv = torch.randn((nb, p, p), generator=gen, device=device,
                      dtype=dtype) / p ** 0.5
    w = torch.randn((nb, p, r), generator=gen, device=device,
                    dtype=dtype) * (0.5 / r ** 0.5)
    return ReducedScanTriFactor(inv_diag=inv, w_blocks=w, n=nb * p - 3,
                                panel=p, r=r)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aug", action="store_true",
                    help="also hold AUG2D-L's own factor")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b4_b6_quick: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from cpkrylov_tpu_torch import _build
    from cpkrylov_tpu_torch.precond import cuda_tri
    from cpkrylov_tpu_torch.utils.profiling import launch_counts

    device = torch.device("cuda", 0)
    print("card " + chip_smoke.nvidia_smi_card(), flush=True)
    print(f"build seconds={_build.build_kernels():.2f}", flush=True)
    blocks = cuda_tri.resident_blocks(device)
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        for q, r, nb in SCAN_SHAPES:
            m = (torch.randn((nb, q, r), generator=gen, device=device,
                             dtype=dtype) * (0.5 / r ** 0.5)).permute(1, 2, 0)
            c = torch.randn((q, nb), generator=gen, device=device,
                            dtype=dtype)
            counts = launch_counts()
            yg = cuda_tri.scan_on("grid", m, c, r)
            yg2 = cuda_tri.scan_on("grid", m, c, r)
            yc = cuda_tri.scan_on("cluster", m, c, r)
            fl = cuda_tri.scan_read_floor(m, c, r, "grid")
            uncounted = launch_counts() == counts
            ref = scan_plain(m, c, r)
            tol = chip_smoke.BAND_TOL[str(dtype).split(".")[1]]
            err = {w: float(torch.linalg.vector_norm(y.double() - ref)
                            / torch.linalg.vector_norm(ref))
                   for w, y in (("grid", yg), ("cluster", yc))}
            ok = (torch.equal(yg, yc) and torch.equal(yg, yg2)
                  and torch.equal(fl, c) and max(err.values()) <= tol
                  and uncounted)
            print(f"b6 {str(dtype).split('.')[1]} q={q} r={r} nb={nb} "
                  f"grid_rel_err_vs_plain={err['grid']:.3e} "
                  f"cluster_rel_err_vs_plain={err['cluster']:.3e} "
                  f"tol={tol:.0e} "
                  f"grid_equals_cluster={torch.equal(yg, yc)} "
                  f"grid_repeats={torch.equal(yg, yg2)} "
                  f"grid_floor_is_c={torch.equal(fl, c)} "
                  f"uncounted={uncounted} "
                  f"layout={cuda_tri.scan_grid_layout(q, r, dtype, blocks)}",
                  flush=True)
            if not ok:
                return 1
        for label in ("L", "U"):
            tf = synthetic_factor(632, 631, 473, dtype, device,
                                  seed=1 if label == "L" else 2)
            chip_smoke.hold_scan_paths(
                f"synthetic {str(dtype).split('.')[1]} {label}", tf, device)
            del tf
            torch.cuda.empty_cache()
    chip_smoke.scan_crossover(device)
    if args.aug:
        import cpkrylov_tpu_torch as cpt
        from cpkrylov_tpu_torch.precond.trisolve import ReducedScanTriFactor
        from cpkrylov_tpu_torch.utils.mm import aug_kkt

        s = aug_kkt("2d", "l")
        M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float64,
                                    device=device)
        for label, tf in (("L", M.factor.tf1), ("U", M.factor.tf2)):
            for dtype in (torch.float64, torch.float32):
                t = tf if dtype == torch.float64 else ReducedScanTriFactor(
                    inv_diag=tf.inv_diag.float(),
                    w_blocks=tf.w_blocks.float(), n=tf.n, panel=tf.panel,
                    r=tf.r)
                chip_smoke.hold_scan_paths(
                    f"AUG2D-L {str(dtype).split('.')[1]} {label}", t, device)
                del t
                torch.cuda.empty_cache()
    print("card " + chip_smoke.nvidia_smi_card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
