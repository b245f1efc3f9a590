"""The program's and the control's answers in ``aug2d_l.rhs_stream``,
against the plain PyTorch reference ``portbench/reference/kkt_schur.py``.

Builds the cell as the benchmark does (``portbench.harness.Cell`` at the
given seed, the cell's own configuration), solves the pool's first
``--requests`` right-hand sides with the program's call
(``harness._program``) and then with the control's (``harness.CONTROL``:
the same path in float32, unrefined), and solves each right-hand side once
with the reference on the same device.  Prints one JSON line a request and
side (the relative error ``||x - x_ref|| / ||x_ref||``, the harness's
residual ratio, the iterations), then one summary line: each side's
largest and smallest error, and whether each side passes ``--tol``.  The
summary is also written to ``--out``.

    python3 tools/aug_reference.py --seed <n> [--requests 16] \
        [--tol 1e-8] [--device cuda] [--grid 316] [--out FILE]

``--grid`` replaces the configuration's grid (a small one runs on the CPU).

The default ``--tol`` 1e-8 lies between the two sides' readings on the
H100 (``PERF.md`` section 2, AUG2D-L): the program's answers stop at the
contract atol = rtol = 1e-6 and read 3.6e-9 to 3.7e-9, while the control's
float32 answers cannot come nearer than float32's own rounding of x
(2^-24 over a component, about 3e-8 over the vector) and read 2.6e-8 to
1.3e-4.  The two are only about 7x apart, so the tolerance sits about
2.6x from each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "aug2d_l.rhs_stream"


def _side(cell, device, program, refs, nreq):
    """(errors, rows) of one side's answers to the first ``nreq``
    requests."""
    import torch

    from portbench import harness
    from portbench.reference.kkt_schur import rel_err
    from portbench.reference.residual import residual_ratio

    label = "program" if program is None else "control"
    t0 = time.perf_counter()
    call, M = harness._program(cell, device, **(program or {}))
    build_s = time.perf_counter() - t0
    rows, errs = [], []
    for i in range(nreq):
        sysm, b = cell.system(i)
        t1 = time.perf_counter()
        out = call(sysm, b)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        x = out.x.detach().cpu().double().numpy()
        err = rel_err(x, refs[i].x)
        errs.append(err)
        rows.append({"side": label, "request": i, "rel_err": err,
                     "resid_ratio": residual_ratio(
                         sysm.A, sysm.B, sysm.C, b, x, cell.atol, cell.rtol),
                     "niters": int(out.niters), "solved": bool(out.solved),
                     "wall_s": wall, "build_s": build_s})
        print(json.dumps(rows[-1]), flush=True)
    del call, M
    if device != "cpu":
        torch.cuda.empty_cache()
    return errs, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench.reference.kkt_schur import KKTSchur

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    config = None
    if args.grid is not None:
        config = harness.load_json(ROOT, "portbench/configs/aug2d_l.json")
        config["generator"]["grid"] = args.grid
    cell = harness.Cell(bench, CELL, args.seed, config=config)
    base = cell.base
    t0 = time.perf_counter()
    ref = KKTSchur(base.A, base.B, base.C, device=args.device)
    refs = [ref.solve(cell.system(i)[1]) for i in range(args.requests)]
    ref_s = time.perf_counter() - t0
    for i, r in enumerate(refs):
        print(json.dumps({"side": "reference", "request": i,
                          "cg_iters": r.cg_iters, "cg_rel": r.cg_rel,
                          "schur_rel": r.schur_rel, "kkt_rel": r.kkt_rel}),
              flush=True)
    summary = {"cell": CELL, "seed": args.seed, "requests": args.requests,
               "device": args.device, "grid": args.grid, "tol": args.tol,
               "reference_s": ref_s,
               "reference_kkt_rel_max": max(r.kkt_rel for r in refs)}
    if args.device != "cpu":
        import torch

        summary["card"] = harness.power_limit()
        summary["kind"] = torch.cuda.get_device_name(0)
    for program in (None, harness.CONTROL):
        errs, _ = _side(cell, args.device, program, refs, args.requests)
        key = "program" if program is None else "control"
        summary[key] = {"rel_err_max": max(errs), "rel_err_min": min(errs),
                        "passes_tol": all(e <= args.tol for e in errs),
                        "fails_tol": all(not e <= args.tol for e in errs)}
    line = json.dumps(summary)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if (summary["program"]["passes_tol"]
                 and summary["control"]["fails_tol"]) else 1


if __name__ == "__main__":
    sys.exit(main())
