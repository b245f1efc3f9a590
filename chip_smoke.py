#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``cpkrylov_tpu_torch``) on one
CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
before its last line:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from ``cpkrylov_tpu_torch/csrc`` (nvcc,
   sm_90a) and report the seconds taken;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (DIA SpMV on A, K_P and B of the 1M x 250k banded
   system in f32 and f64; the bidiagonal scan forward and reverse at
   n = 1.25M and at an n that is not a multiple of the scan tile, also held
   against scipy in f64; the df64 DIA SpMV on A, B and B' of the same
   system, bit for bit against its plain version and to 1e-12 against
   scipy's f64 product), with times from CUDA events;
4. golden: CPMINRES on the shipped ``cvxqp1_m`` fixture in f64 on the card,
   53 +- 2 iterations and rel-err < 5e-6 against scipy ``spsolve``;
5. golden_mixed: ``solve_mixed`` on ``cvxqp1_m`` with f32 inner solves to
   1e-8, through the df64-applied factor, rel-err < 1e-7, <= 5 passes;
6. main path: ``make_preconditioner`` + ``solve("cpminres", ...)`` in f64 on
   the card for ``banded_saddle_system(1_000_000, 250_000, bandwidth=3)``
   at rtol 1e-6, checked by a host f64 true residual and by the kernels'
   launch counters (reset just before the main path starts);
7. main_mixed: the f32-inner / df64-outer mixed solve of the same system,
   device-resident, at the JAX bench's settings (``bench.py:148-154,
   183-184``); run twice, the second (warm) run checked by a host f64 true
   residual and by the launch counters (reset just before it).

With ``--profile DIR`` it then profiles one more warm solve of each main
path under ``torch.profiler``, prints the device's busy time and idle share
inside the solve span of each trace (``cpkrylov.solve``, and
``cpkrylov.solve_mixed`` with its device loop ``cpkrylov.mixed_loop``),
and writes the traces (``profile_main.json``,
``profile_mixed.json``) and per-op tables (``.txt``) into DIR.

Then a JSON line of per-kernel results, the card line from ``nvidia-smi``,
and as the last line ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances (relative).  DIA SpMV: the kernel rounds each multiply and add
# in the plain version's order, so it is expected to agree bit for bit; the
# bound leaves room for one rounding per term.  Bidiagonal scan: held both
# against scipy's sequential f64 substitution and against its plain version
# (a Hillis-Steele scan, which associates the products differently).
DIA_TOL = {"float32": 1e-6, "float64": 1e-14}
SCAN_TOL = {"float32": 1e-5, "float64": 1e-12}
# df64 DIA SpMV: every step of the error-free chain is rounded explicitly in
# the plain version's order, so hi and lo must match exactly; hi + lo
# carries ~2^-48 relative accuracy, held against scipy's f64 product.
DF_SCIPY_TOL = 1e-12

# The JAX bench's mixed configuration (bench.py:148-154, 183-184).
MIXED_SOLVER = dict(atol=0.0, rtol=1e-6, itmax=200, stagwin=25)
MIXED_INNER_STAGWIN = 25


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_max(got, ref) -> float:
    import torch

    scale = float(torch.max(torch.abs(ref)))
    return float(torch.max(torch.abs(got - ref))) / max(scale, 1e-300)


def phase_kernels(sysm, device, results):
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from cpkrylov_tpu_torch.ops.cuda_df_dia import df_dia_spmv
    from cpkrylov_tpu_torch.ops.cuda_dia import dia_spmv
    from cpkrylov_tpu_torch.ops.df64 import (df_dia_matvec, df_from_f64,
                                             pack_df_dia)
    from cpkrylov_tpu_torch.ops.dia import dia_matvec, pack_dia
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.precond.cuda_bidiag import (bidiag_scan,
                                                         bidiag_scan_plain)
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    rng = np.random.default_rng(7)
    kp = assemble_kp(sysm.G, sysm.B, sysm.C)
    dia = results["dia_spmv"]
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[1]
        for label, mat in (("A", sysm.A), ("K_P", kp), ("B", sysm.B)):
            d = pack_dia(mat, dtype=dtype, device=device)
            if d is None:
                raise RuntimeError(f"{label} did not pack as DIA")
            x = torch.as_tensor(rng.standard_normal(mat.shape[1])).to(
                device=device, dtype=dtype)
            yk = dia_spmv(d, x)
            yp = dia_matvec(d, x)
            torch.cuda.synchronize()
            err = rel_max(yk, yp)
            dia["max_abs_err"] = max(dia["max_abs_err"],
                                     float(torch.max(torch.abs(yk - yp))))
            ms = cuda_time_ms(lambda: dia_spmv(d, x))
            pms = cuda_time_ms(lambda: dia_matvec(d, x))
            print(f"kernel dia_spmv {tname} {label} {mat.shape[0]}x"
                  f"{mat.shape[1]} offsets={list(d.offsets)} "
                  f"max_rel_err={err:.3e} ms={ms:.4f} plain_ms={pms:.4f}",
                  flush=True)
            if not err <= DIA_TOL[tname]:
                raise RuntimeError(f"dia_spmv {tname} {label}: relative "
                                   f"error {err:.3e} > {DIA_TOL[tname]}")
            if label == "A" and dtype == torch.float64:
                dia["ms"], dia["plain_ms"] = ms, pms

    scan = results["bidiag_scan"]
    for n in (1_250_000, 1_000_003):
        dd = 1.0 + rng.random(n)
        off = 0.4 * rng.standard_normal(n - 1)
        b = rng.standard_normal(n)
        for reverse in (False, True):
            if reverse:
                T = sp.diags([dd, off], [0, 1], format="csr")
                a = np.append(-off / dd[:-1], 0.0)
            else:
                T = sp.diags([dd, off], [0, -1], format="csr")
                a = np.concatenate([[0.0], -off / dd[1:]])
            x64 = spla.spsolve_triangular(T, b, lower=not reverse)
            for dtype in (torch.float32, torch.float64):
                tname = str(dtype).split(".")[1]

                def dev(v):
                    return torch.as_tensor(v).to(device=device, dtype=dtype)

                ta, ti, tb = dev(a), dev(1.0 / dd), dev(b)
                xk = bidiag_scan(ta, ti, tb, reverse)
                xp = bidiag_scan_plain(ta, ti, tb, reverse)
                torch.cuda.synchronize()
                xk64 = xk.double().cpu().numpy()
                err = float(np.linalg.norm(xk64 - x64) / np.linalg.norm(x64))
                err_plain = rel_max(xk, xp)
                scan["max_abs_err"] = max(
                    scan["max_abs_err"], float(torch.max(torch.abs(xk - xp))))
                ms = cuda_time_ms(lambda: bidiag_scan(ta, ti, tb, reverse))
                pms = cuda_time_ms(
                    lambda: bidiag_scan_plain(ta, ti, tb, reverse), iters=10,
                    warmup=2)
                print(f"kernel bidiag_scan {tname} n={n} "
                      f"{'reverse' if reverse else 'forward'} "
                      f"rel_err_vs_scipy={err:.3e} "
                      f"max_rel_diff_vs_plain={err_plain:.3e} "
                      f"ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
                for what, e in (("scipy", err), ("plain", err_plain)):
                    if not e <= SCAN_TOL[tname]:
                        raise RuntimeError(
                            f"bidiag_scan {tname} n={n} reverse={reverse}: "
                            f"error vs {what} {e:.3e} > {SCAN_TOL[tname]}")
                if (n == 1_250_000 and not reverse
                        and dtype == torch.float64):
                    scan["ms"], scan["plain_ms"] = ms, pms

    dfd = results["df_dia_spmv"]
    for label, mat in (("A", sysm.A), ("B", sysm.B), ("Bt", sysm.B.T.tocsr())):
        d = pack_df_dia(mat, device=device)
        if d is None:
            raise RuntimeError(f"{label} did not pack as df64 DIA")
        x = rng.standard_normal(mat.shape[1])
        xh, xl = (torch.as_tensor(v).to(device) for v in df_from_f64(x))
        yh, yl = df_dia_spmv(d, xh, xl)
        ph, pl = df_dia_matvec(d, (xh, xl))
        torch.cuda.synchronize()
        err_h = float(torch.max(torch.abs(yh - ph)))
        err_l = float(torch.max(torch.abs(yl - pl)))
        exact = mat @ x
        y = yh.double().cpu().numpy() + yl.double().cpu().numpy()
        err_ref = float(np.linalg.norm(y - exact) / np.linalg.norm(exact))
        dfd["max_abs_err"] = max(dfd["max_abs_err"], err_h, err_l)
        ms = cuda_time_ms(lambda: df_dia_spmv(d, xh, xl))
        pms = cuda_time_ms(lambda: df_dia_matvec(d, (xh, xl)), iters=20,
                           warmup=2)
        print(f"kernel df_dia_spmv f32x2 {label} {mat.shape[0]}x"
              f"{mat.shape[1]} offsets={list(d.offsets)} "
              f"max_abs_err_hi={err_h:.3e} max_abs_err_lo={err_l:.3e} "
              f"rel_err_vs_scipy_f64={err_ref:.3e} ms={ms:.4f} "
              f"plain_ms={pms:.4f}", flush=True)
        if err_h != 0.0 or err_l != 0.0:
            raise RuntimeError(f"df_dia_spmv {label}: differs from its "
                               f"plain version (hi {err_h}, lo {err_l})")
        if not err_ref <= DF_SCIPY_TOL:
            raise RuntimeError(f"df_dia_spmv {label}: relative error "
                               f"{err_ref:.3e} vs scipy > {DF_SCIPY_TOL}")
        if label == "A":
            dfd["ms"], dfd["plain_ms"] = ms, pms


def phase_main_path(sysm, device):
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import cuda_dia
    from cpkrylov_tpu_torch.ops.dia import DIA
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    cuda_dia.LAUNCHES = 0
    cuda_bidiag.LAUNCHES = 0
    t0 = time.perf_counter()
    M = cpt.make_preconditioner(sysm.G, sysm.B, sysm.C, options=popts,
                                dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    ptime = time.perf_counter() - t0
    f = M.factor
    if not (isinstance(f.tf1, cuda_bidiag.BidiagTriFactor)
            and isinstance(f.tf2, cuda_bidiag.BidiagTriFactor)
            and f.tf2.reverse and f.dinv_folded):
        raise RuntimeError(f"unexpected factor layout: {type(f.tf1)}, "
                           f"{type(f.tf2)}, folded={f.dinv_folded}")
    if not isinstance(M.kp, DIA):
        raise RuntimeError(f"K_P is {type(M.kp).__name__}, not DIA")

    out = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                    device=device, dtype=torch.float64, opts=opts,
                    precond_opts=popts, M=M)
    launches = {"dia_spmv": cuda_dia.LAUNCHES,
                "bidiag_scan": cuda_bidiag.LAUNCHES}
    if not isinstance(getattr(out.A_op, "mat", None), DIA):
        raise RuntimeError(
            f"the solve applied A as {type(out.A_op).__name__}("
            f"{type(getattr(out.A_op, 'mat', None)).__name__}), not DIA")

    x = out.x.cpu().numpy()
    true_rel = float(np.linalg.norm(sysm.b - sysm.K @ x)
                     / np.linalg.norm(sysm.b))
    print(f"main_path cpminres f64 n={sysm.n} m={sysm.m} "
          f"solved={out.solved} iters={out.niters} ptime_s={ptime:.3f} "
          f"stime_s={out.stime:.4f} "
          f"ms_per_iter={1e3 * out.stime / max(out.niters, 1):.4f} "
          f"true_rel_resid={true_rel:.3e} launches={launches} "
          f"nitref={M.factor_nitref}", flush=True)
    if not out.solved:
        raise RuntimeError(f"main path not solved: status {out.istatus}")
    if not (np.all(np.isfinite(x)) and x.shape == (sysm.n + sysm.m,)):
        raise RuntimeError("main path solution not finite or wrong shape")
    if not true_rel <= 1e-6:
        raise RuntimeError(f"true residual {true_rel:.3e} > 1e-6")
    for name, count in launches.items():
        if count < 4 * out.niters:
            raise RuntimeError(f"{name} launched {count} times in "
                               f"{out.niters} iterations (< 4 per iter)")
    return launches, M


def phase_profile(sysm, device, M, M32, outdir):
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.profiling import (MIXED_LOOP_SPAN,
                                                    MIXED_SPAN, SOLVE_SPAN,
                                                    device_profile,
                                                    summarize_trace)

    os.makedirs(outdir, exist_ok=True)
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    runs = {
        "main_path": ("profile_main", SOLVE_SPAN, lambda: cpt.solve(
            "cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
            device=device, dtype=torch.float64, opts=opts,
            precond_opts=popts, M=M)),
        "main_mixed": ("profile_mixed", MIXED_SPAN, lambda: cpt.solve_mixed(
            "cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G, M=M32,
            device=device, device_resident=True,
            opts=cpt.SolverOptions(**MIXED_SOLVER),
            inner_stagwin=MIXED_INNER_STAGWIN)),
    }
    for name, (stem, span, fn) in runs.items():
        outs = []
        prof = device_profile(lambda: outs.append(fn()),
                              trace_path=os.path.join(outdir, stem + ".json"),
                              span=span)
        with open(os.path.join(outdir, stem + ".txt"), "w") as fh:
            fh.write(prof.table)
        iters = max(outs[0].niters, 1)
        print(f"profile {name} span={span} iters={outs[0].niters} "
              f"span_wall_ms={prof.wall_ms:.4f} "
              f"device_busy_ms={prof.busy_ms:.4f} "
              f"idle_share={prof.idle_share:.4f} "
              f"device_ops={prof.device_ops} launches={prof.launches} "
              f"launches_per_iter={prof.launches / iters:.1f} "
              f"dir={outdir}", flush=True)
        if prof.device_ops == 0:
            raise RuntimeError(f"the profiled {name} solve shows no device "
                               "activity")
        if span == MIXED_SPAN:
            # the device loop inside the same trace, without the packing
            with open(os.path.join(outdir, stem + ".json")) as fh:
                loop = summarize_trace(json.load(fh)["traceEvents"],
                                       span=MIXED_LOOP_SPAN)
            print(f"profile {name} span={MIXED_LOOP_SPAN} "
                  f"span_wall_ms={loop.wall_ms:.4f} "
                  f"device_busy_ms={loop.busy_ms:.4f} "
                  f"idle_share={loop.idle_share:.4f} "
                  f"device_ops={loop.device_ops} launches={loop.launches} "
                  f"launches_per_iter={loop.launches / iters:.1f}",
                  flush=True)


def phase_golden(device):
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture

    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True, itref_tol=1e-8)
    out = cpt.solve("cpminres", fix.b, fix.A, fix.B, fix.C, fix.G,
                    device=device, dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500),
                    precond_opts=popts)
    x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
    rel = float(np.linalg.norm(out.x.cpu().numpy() - x_ref)
                / np.linalg.norm(x_ref))
    print(f"golden cvxqp1_m cpminres f64 solved={out.solved} "
          f"iters={out.niters} rel_err={rel:.3e} "
          f"stime_s={out.stime:.4f}", flush=True)
    if not (out.solved and abs(out.niters - 53) <= 2 and rel < 5e-6):
        raise RuntimeError("golden cvxqp1_m check failed")


def phase_golden_mixed(device):
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture

    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    M32 = cpt.make_preconditioner(fix.G, fix.B, fix.C, options=popts,
                                  dtype=torch.float32, device=device)
    if not isinstance(M32.factor, DFFactorApply):
        raise RuntimeError("cvxqp1_m f32: the df64-applied factor is not "
                           f"engaged (probe {M32.probe_rel:.3e})")
    out = cpt.solve_mixed(
        "cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, M=M32, device=device,
        opts=cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
        precond_opts=popts)
    x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
    rel = float(np.linalg.norm(out.x - x_ref) / np.linalg.norm(x_ref))
    loop = "host" if out.inner_outputs else "device"
    print(f"golden_mixed cvxqp1_m cpminres f32-inner solved={out.solved} "
          f"factor=DFFactorApply probe_rel={M32.probe_rel:.3e} "
          f"loop={loop} nouter={out.nouter} inner={list(out.inner_niters)} "
          f"niters={out.niters} rel_err={rel:.3e} "
          f"stime_s={out.stime:.4f}", flush=True)
    if not (out.solved and rel < 1e-7 and out.nouter <= 5):
        raise RuntimeError("golden_mixed cvxqp1_m check failed")


def phase_main_mixed(sysm, device):
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.mixed import _lean_inner_options
    from cpkrylov_tpu_torch.ops import cuda_df_dia, cuda_dia
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(**MIXED_SOLVER)
    t0 = time.perf_counter()
    M32 = cpt.make_preconditioner(sysm.G, sysm.B, sysm.C, options=popts,
                                  dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    ptime = time.perf_counter() - t0

    def run():
        return cpt.solve_mixed(
            "cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G, M=M32,
            device=device, device_resident=True, opts=opts,
            inner_stagwin=MIXED_INNER_STAGWIN)

    run()                                   # cold: packing, first launches
    cuda_dia.LAUNCHES = 0
    cuda_bidiag.LAUNCHES = 0
    cuda_df_dia.LAUNCHES = 0
    out = run()
    launches = {"dia_spmv": cuda_dia.LAUNCHES,
                "bidiag_scan": cuda_bidiag.LAUNCHES,
                "df_dia_spmv": cuda_df_dia.LAUNCHES}

    # The device loop alone, apart from the per-call packing, with the
    # inner preconditioner solve_mixed runs (lean: factor exact at f32).
    solver = cpt.prepare_mixed_device(
        "cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
        _lean_inner_options(M32), opts,
        inner_stagwin=MIXED_INNER_STAGWIN, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop = solver.dispatch()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1

    x = out.x
    true_rel = float(np.linalg.norm(sysm.b - sysm.K @ x)
                     / np.linalg.norm(sysm.b))
    print(f"main_mixed cpminres f32-inner df64-outer n={sysm.n} m={sysm.m} "
          f"solved={out.solved} nouter={out.nouter} "
          f"inner={list(out.inner_niters)} niters={out.niters} "
          f"factor_nitref={M32.factor_nitref} "
          f"factor_exact={M32.factor_exact} ptime_s={ptime:.3f} "
          f"stime_s={out.stime:.4f} loop_s={loop_s:.4f} "
          f"loop_inner={[int(v) for v in loop[3][:loop[4]]]} "
          f"ms_per_inner_iter={1e3 * loop_s / max(out.niters, 1):.4f} "
          f"true_rel_resid={true_rel:.3e} "
          f"resid_history={[float(f'{v:.4e}') for v in out.resid_history]} "
          f"launches={launches}", flush=True)
    if not out.solved:
        raise RuntimeError("main_mixed not solved")
    if out.inner_outputs != ():
        raise RuntimeError("main_mixed did not run the device-resident loop")
    if not (np.all(np.isfinite(x)) and x.shape == (sysm.n + sysm.m,)):
        raise RuntimeError("main_mixed solution not finite or wrong shape")
    if not true_rel <= 1e-6:
        raise RuntimeError(f"main_mixed true residual {true_rel:.3e} > 1e-6")
    bounds = {"df_dia_spmv": 3 * out.nouter, "dia_spmv": out.niters,
              "bidiag_scan": 2 * out.niters}
    for name, bound in bounds.items():
        if launches[name] < max(bound, 1):
            raise RuntimeError(f"main_mixed: {name} launched "
                               f"{launches[name]} times (< {bound})")
    return launches, M32


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one more main-path solve into DIR")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "cpkrylov_tpu_torch")):
        print("chip_smoke: cpkrylov_tpu_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from cpkrylov_tpu_torch import _build
    from cpkrylov_tpu_torch.utils import fixtures

    card = nvidia_smi_card()
    print(f"device torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} card=\"{card}\"",
          flush=True)
    print(f"build seconds={_build.build_kernels():.2f} "
          f"dir={os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)

    results = {
        "dia_spmv": {"name": "dia_spmv", "route": "cuda",
                     "source": "cpkrylov_tpu_torch/csrc/dia_spmv.cu",
                     "replaces": "cpkrylov_tpu/ops/pallas_dia.py:93",
                     "max_abs_err": 0.0},
        "bidiag_scan": {"name": "bidiag_scan", "route": "cuda",
                        "source": "cpkrylov_tpu_torch/csrc/bidiag_scan.cu",
                        "replaces":
                            "cpkrylov_tpu/precond/pallas_bidiag.py:100",
                        "max_abs_err": 0.0},
        "df_dia_spmv": {"name": "df_dia_spmv", "route": "cuda",
                        "source": "cpkrylov_tpu_torch/csrc/df_dia_spmv.cu",
                        "replaces": "cpkrylov_tpu/ops/pallas_dia.py:152",
                        "max_abs_err": 0.0},
    }
    t0 = time.perf_counter()
    sysm = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3)
    print(f"fixture banded 1000000x250000 seconds="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    phase_kernels(sysm, device, results)
    # the golden solve first: it also brings up the libraries (cuBLAS for
    # the dot products) that the first solve of a process initializes
    phase_golden(device)
    phase_golden_mixed(device)
    by_path = {}
    by_path["main_path"], M = phase_main_path(sysm, device)
    by_path["main_mixed"], M32 = phase_main_mixed(sysm, device)
    if args.profile:
        phase_profile(sysm, device, M, M32, args.profile)

    kernels = []
    for name in ("dia_spmv", "bidiag_scan", "df_dia_spmv"):
        entry = dict(results[name])
        counts = {p: c[name] for p, c in by_path.items() if name in c}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        kernels.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms")})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
