"""CPGMRES on CVXQP1's unreduced Newton system, against the plain PyTorch
reference ``portbench/reference/unreduced.py``.

For each seed, builds ``utils/mm.py::cvxqp_kkt_unreduced("cvxqp1", n)``
at the iterate numbers of ``portbench/configs/cvxqp1_l.json`` (mu, delta)
and ``SIGMA``, solves it once with the reference on the device (the
multipliers eliminated, the reduced system by dense LU), then through
``cpkrylov_tpu_torch.solve("cpgmres", ...)`` at ``RESTART`` and the
configuration's tolerances and precond block with M from ``make_preconditioner`` on the
device: the program in float64, and the control, the same path in float32
without refinement.  Prints one JSON line a seed and side (the relative
error ``||x - x_ref|| / ||x_ref||``, that of the dx block alone, the
residual ratio of ``portbench/reference/residual.py``, the iterations,
``solved``, the triangle forms the program's build chose), then one
summary line, also appended to ``--out``.  Exits 0 when every program
answer is solved, within ``TOL`` of the reference, and built from
blocked-substitution triangles only.

    python3 tools/unreduced_reference.py --seeds 1 2 3 [--n 10000] \
        [--device cuda] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "portbench", "configs", "cvxqp1_l.json")
RESTART = 100      # CPGMRES's restart length in the reference's cpk_exprog2.m:69
SIGMA = 0.1        # the centring parameter of the complementarity rows
# The contract atol = rtol = 1e-6 leaves the program's answer 1.2e-3-1.6e-3
# from the reference at CVXQP1-L (9.9e-4 at CVXQP1-M), whatever the
# precision: 1e-2 checks it against an independent solution.
TOL = 1e-2


def _solve(u, cfg, device, dtype, refine):
    """(SolveOutput, the path counters of the build) of one side."""
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils import profiling as prof

    s = cfg["solver"]
    popts = cpt.PrecondOptions(**cfg["precond"])
    prof.reset_launches()
    M = cpt.make_preconditioner(u.G, u.B, u.C, options=popts,
                                panel=cfg["panel"], dtype=dtype,
                                device=device)
    built = prof.path_counts()
    opts = cpt.SolverOptions(atol=s["atol"], rtol=s["rtol"],
                             itmax=s["itmax"], restart=RESTART)
    out = cpt.solve("cpgmres", u.b, u.A, u.B, u.C, u.G, opts=opts,
                    precond_opts=popts, panel=cfg["panel"], dtype=dtype,
                    device=device, M=M, refine=refine)
    return out, built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt_unreduced
    from portbench.reference.kkt_schur import rel_err
    from portbench.reference.residual import residual_ratio
    from portbench.reference.unreduced import UnreducedReference

    with open(CONFIG) as f:
        cfg = json.load(f)
    gen, s = cfg["generator"], cfg["solver"]
    on_card = args.device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rows = []
    for seed in args.seeds:
        u = cvxqp_kkt_unreduced(gen["member"], args.n, mu=gen["mu"],
                                delta=gen["delta"], sigma=SIGMA,
                                seed=seed)
        n = u.A.shape[0] // 3
        t0 = time.perf_counter()
        ref = UnreducedReference(u.A, u.B, u.C,
                                 device=args.device).solve(u.b)
        sync()
        ref_s = time.perf_counter() - t0
        x_ref = ref.x.cpu()
        for side, dtype, refine in (("program", torch.float64, False),
                                    ("control", torch.float32, False)):
            t0 = time.perf_counter()
            out, built = _solve(u, cfg, args.device, dtype, refine)
            sync()
            wall = time.perf_counter() - t0
            x = out.x.detach().cpu().double().numpy()
            rows.append({
                "side": side, "seed": seed, "n": n,
                "rel_err": rel_err(x, x_ref),
                "rel_err_dx": rel_err(x[:n], x_ref[:n]),
                "resid_ratio": residual_ratio(u.A, u.B, u.C, u.b, x,
                                              s["atol"], s["rtol"]),
                "niters": int(out.niters), "solved": bool(out.solved),
                "tri_block_builds": built["tri_block_builds"],
                "tri_reduced_scan_builds": built["tri_reduced_scan_builds"],
                "build_and_solve_s": wall, "reference_s": ref_s,
                "reference_kkt_rel": ref.kkt_rel})
            print(json.dumps(rows[-1]), flush=True)
            del out
        del ref
        if on_card:
            torch.cuda.empty_cache()

    summary = {"seeds": args.seeds, "n": args.n, "restart": RESTART,
               "sigma": SIGMA, "tol": TOL, "device": args.device,
               "reference_kkt_rel_max": max(r["reference_kkt_rel"]
                                            for r in rows)}
    if on_card:
        summary["kind"] = torch.cuda.get_device_name(0)
    for side in ("program", "control"):
        mine = [r for r in rows if r["side"] == side]
        summary[side] = {
            **{f"{k}_{f.__name__}": f(r[k] for r in mine)
               for k in ("rel_err", "rel_err_dx", "resid_ratio", "niters")
               for f in (min, max)},
            "unsolved": sum(not r["solved"] for r in mine),
            "blocked_only": all(r["tri_reduced_scan_builds"] == 0
                                and r["tri_block_builds"] == 2
                                for r in mine),
            "passes_tol": all(r["rel_err"] <= TOL for r in mine)}
    line = json.dumps(summary)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    prog = summary["program"]
    return 0 if (prog["passes_tol"] and prog["unsolved"] == 0
                 and prog["blocked_only"]) else 1


if __name__ == "__main__":
    sys.exit(main())
