#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``cpkrylov_tpu_torch``) on one
CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
before its last line:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from ``cpkrylov_tpu_torch/csrc`` (one
   nvcc per source, all started together, sm_90a) and report the seconds;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (DIA SpMV on A, K_P and B of the 1M x 250k banded
   system in f32 and f64; the bidiagonal scan forward and reverse at
   n = 1.25M and at an n that is not a multiple of the scan tile, bit for
   bit against its plain version and a repeated call, and against scipy,
   with its launches a call and its read floor (the same loads and stores
   without the look-back), and bit for bit at the tests' ragged sizes; the
   df64 DIA SpMV on A, B and B' of the same
   system, bit for bit against its plain version and to 1e-12 against
   scipy's f64 product; the interleave riffle B7 and its inverse B8 at
   n = 1M, m = 250k with c = 1 and c = 4, f32 and f64, bit for bit against
   their plain versions and the explicit permutation, ``torch.index_select``
   timed beside them), with times from CUDA events (``ms``) and device
   times per call from a profiler trace with the inputs rotated past the
   L2 (``device_ms``, for every kernel and for the library calls beside
   B1, B5, B7 and B8);
4. mm setup: the Maros-Meszaros systems AUG2D-L and CVXQP3-L
   (``utils/mm.py``), their host LDL^T and device packing, timed;
5. mm kernels: the banded triangular solve (B4) with its affine scan (B6)
   on both triangles of AUG2D-L's factor (p = 632, r = 631, nb = 473), f32
   and f64, against their plain versions and scipy's
   ``spsolve_triangular``, with B4's split into its c and scan kernels,
   the bytes it moves, the scan's launch layout, and the scan's read floor
   (the same cluster and per-step slices with no chain between the
   steps); the CSR SpMV (B5) on AUG2D-L's K_P and CVXQP3-L's A, f32 and
   f64, bit for bit against its plain version and against scipy, with its
   bound at both shapes; ``torch.sparse.mm`` timed beside B5 and B1;
6. golden: CPMINRES on the shipped ``cvxqp1_m`` fixture in f64 on the card,
   53 +- 2 iterations and rel-err < 5e-6 against scipy ``spsolve``;
7. golden_mixed: ``solve_mixed`` on ``cvxqp1_m`` with f32 inner solves to
   1e-8, through the df64-applied factor, rel-err < 1e-7, <= 5 passes; run
   twice, and the two runs' inner counts must agree (no atomics);
8. main path: ``make_preconditioner`` + ``solve("cpminres", ...)`` in f64 on
   the card for ``banded_saddle_system(1_000_000, 250_000, bandwidth=3)``
   at rtol 1e-6, checked by a host f64 true residual and by the kernels'
   launch counters (reset just before the main path starts);
9. main_mixed: the f32-inner / df64-outer mixed solve of the same system,
   device-resident, at the JAX bench's settings (``bench.py:148-154,
   183-184``); run twice, the second (warm) run checked by a host f64 true
   residual and by the launch counters (reset just before it);
10. mm_aug2d_l / mm_cvxqp3_l: ``solve("cpminres", ...)`` in f64 at the JAX
   Maros-Meszaros sweep's settings (``benchmarks/bench_mm_sweep.py``:
   atol = rtol = 1e-6, itmax 1000, default ``PrecondOptions()``), the
   counters reset just before each solve; checked against the sweep's
   records (``benchmarks/MM_SWEEP_L.json``: 5 and 86 iterations, and the
   error of the JAX package's solution against scipy's ``spsolve``), by
   the factor forms, the solver's stopping test on its own history, a host
   f64 true residual (at its measured multiple of atol + rtol |b|) and the
   counters;
11. solvers_banded: CPCG, CP-CG-Lanczos, CPSYMMLQ, CPGMRES(50) and
   CPDQGMRES(50) (and CPMINRES, warm) through ``solve`` on the main path's
   system, options and preconditioner, each run cold and then warm with
   the counters reset just before it: 12 +- 1 iterations and a host f64
   true residual <= 1e-6 |b| within 10 % of the JAX package's CPU figure
   (``BANDED_JAX``), and B1, B2, B7 and B8 launched at least once per
   iteration;
12. golden_solvers: ``tests/test_golden.py`` on the card in f64 (cvxqp1_m
   with the Lanczos family and CPDQGMRES at mem 2 and 50, cvxqp2_s with
   CPGMRES(100), CPGMRES(20) and CPDQGMRES(100)): its golden counts and
   error bounds against scipy ``spsolve``;
13. dist_banded: the main path's system and options as two gloo ranks
   (``cpkrylov_tpu_torch.parallel``, spawned processes) that share the
   card: ``dist_solve`` CPMINRES with its default (Schur) factor and with
   the replicated one, and ``dist_cpminres`` (replicated factor, halo A and
   C products) on the b2 = 0 system; each held to the serial card count
   12 +- 1, a host f64 true residual <= 1e-6 |b| and x within 1e-6 of the
   serial card solution, and each rank to B2 and B1 or B5 launched (B7/B8
   under the replicated factor), with setup and solve seconds and each
   rank's peak device memory.  At two ranks the main system's Schur plan
   has no interface (its x-y chain lies in rank 0's chunk), so the same
   ranks also solve the system at the same sizes with a banded G and a
   slope-matched B (``schur_sharded``): a Schur plan with s > 0 and a
   sharded exchange, applied on the slices with no global K_P; held to
   that system's serial card count +- 1 and the same residual and x
   bounds, and each rank to B4, B6 and B5 (the A_dS products) launched;
14. dist_mixed: ``dist_solve_mixed`` on the same ranks and system (f32
   inner solves on the slices, the f64 true residual on the host) to
   1e-6 |b|;
15. dist_nccl1: one NCCL rank on the card, ``dist_solve`` CPMINRES, device
   tensors straight to the collectives, held as in 13.

With ``--profile DIR`` it then profiles one more warm solve of each main
path, of both Maros-Meszaros systems and of the five further solvers on
the banded system under ``torch.profiler``, prints
the device's busy time and idle share inside the solve span of each trace
(``cpkrylov.solve``, and ``cpkrylov.solve_mixed`` with its device loop
``cpkrylov.mixed_loop``), and writes the main paths' traces (``profile_main.json``,
``profile_mixed.json``) and every run's per-op table (``.txt``) into DIR.

Then a JSON line of per-kernel results (time and device time, plain
version's time, the bound from this run's shapes, the library call's time
and device time where one exists, launches per path), the card line from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
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
# bound leaves room for one rounding per term.  Bidiagonal scan: equal bit
# for bit to its plain version (which performs the kernel's multiplies and
# adds in the kernel's order) and to a repeated call; held to these bounds
# against scipy's sequential f64 substitution.
DIA_TOL = {"float32": 1e-6, "float64": 1e-14}
SCAN_TOL = {"float32": 1e-5, "float64": 1e-12}
# df64 DIA SpMV: every step of the error-free chain is rounded explicitly in
# the plain version's order, so hi and lo must match exactly; hi + lo
# carries ~2^-48 relative accuracy, held against scipy's f64 product.
DF_SCIPY_TOL = 1e-12

# Banded triangular solve (B4) and its scan (B6) on AUG2D-L's factor:
# relative 2-norm against the plain version and against scipy's sequential
# f64 substitution.  The factor carries element growth (solutions up to
# ~1e8 for a unit right-hand side), so rounding is amplified: on the H100
# B4 measured 1.7e-12 / 3.2e-13 (f64, L / reversed U) and 4.8e-5 / 1.2e-4
# (f32) against scipy, 3.1e-13 and 7.0e-5 at most against its plain
# version, and B6 0 against its plain version; each bound is about 10x the
# largest reading of its dtype.
BAND_TOL = {"float32": 1e-3, "float64": 2e-11}
# CSR SpMV (B5): the kernel sums each row in stored order, every step
# rounded, as its plain version does: exact.  Against scipy's f64 product:
# f32 rounding of rows of at most 10 products (f64 is exact in principle;
# the bound leaves room for one rounding per term).
CSR_SCIPY_TOL = {"float32": 1e-6, "float64": 1e-14}

# Bounds: the larger of bytes over the card's memory rate and operations
# over its peak rate for their type.  3.35 TB/s and 67 TFLOP/s f32 outside
# the tensor cores are the H100 SXM figures of NVIDIA's data sheet; for f64
# the data sheet's 67 TFLOP/s (FP64 tensor core) is the highest rate the
# card offers, so the bound stays a lower bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}

# The JAX Maros-Meszaros sweep's settings (benchmarks/bench_mm_sweep.py)
# and its f64 CPMINRES records (benchmarks/MM_SWEEP_L.json): iterations,
# +-, and the solution's relative error against scipy's spsolve.
MM_SOLVER = dict(atol=1e-6, rtol=1e-6, itmax=1000)
MM_RECORD = {"aug2d_l": (5, 2, 3.6866635621552876e-09),
             "cvxqp3_l": (86, 5, 8.325103533499263e-04)}
# The error against spsolve may exceed the record by 10 %: the port and the
# JAX package reach the same error to 1e-6 relative on the CPU at AUG2D
# grids 40 and 100 and CVXQP3 n = 2000, and the JAX package there
# reproduces its AUG2D-M record (tests/test_torch_mm.py).
MM_ORACLE_SLACK = 1.1
# |b - K x| over atol + rtol |b|.  CPMINRES stops on its preconditioned
# residual, so the true one is not bounded by the contract: both packages
# end at 0.1115, 0.2262 and 1.2872 times it at AUG2D grids 40 and 100 and
# CVXQP3 n = 2000 (tests/test_torch_mm.py).  The card measured 1.0427
# (AUG2D-L; the CPU's plain versions from the same factor too) and 0.9298
# (CVXQP3-L); each limit leaves 0.7-7.5 % above its reading.
MM_TRUE_RESID = {"aug2d_l": 1.05, "cvxqp3_l": 1.0}
# AUG2D-L's factor in the JAX package's rule: reach 631, p0 = 632
MM_AUG_PANEL = (632, 631)

# The JAX bench's mixed configuration (bench.py:148-154, 183-184).
MIXED_SOLVER = dict(atol=0.0, rtol=1e-6, itmax=200, stagwin=25)
MIXED_INNER_STAGWIN = 25

# The JAX package's f64 solves of the 1M x 250k banded system on a CPU at
# the main path's settings (GHN update, nitref 1 forced, atol 0, rtol 1e-6,
# itmax 200, restart and mem 50): 12 iterations each, and these host f64
# |b - K x| / |b|.  The card is held to 12 +- 1 iterations and to 10 % of
# each residual (another summation order moves the last digits).
BANDED_JAX = {"cpcg": 8.211e-7, "cpcglanczos": 8.281e-7,
              "cpsymmlq": 3.006e-7, "cpgmres": 7.355e-7,
              "cpdqgmres": 7.355e-7, "cpminres": 7.355e-7}
BANDED_ITERS = (12, 1)
BANDED_SLACK = 0.10

# tests/test_golden.py: (solver, options, golden iterations, +-, rel-err
# bound against scipy's spsolve) per shipped fixture.
GOLDEN_SOLVERS = {
    "cvxqp1_m": [("cpcg", {}, 55, 2, 5e-6),
                 ("cpcglanczos", {}, 54, 2, 5e-6),
                 ("cpsymmlq", {}, 54, 2, 5e-6),
                 ("cpdqgmres", {"mem": 2}, 54, 2, 5e-6),
                 ("cpdqgmres", {"mem": 50}, 54, 2, 5e-6)],
    "cvxqp2_s": [("cpgmres", {"restart": 100}, 127, 3, 5e-4),
                 ("cpgmres", {"restart": 20}, 380, 15, 5e-4),
                 ("cpdqgmres", {"mem": 100}, 120, 3, 5e-4)],
}


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


def rel_2norm(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-300))


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def torch_sparse_csr(mat, dtype, device):
    """A scipy matrix as a torch sparse CSR tensor: the operand of the
    library call timed beside the port's SpMV kernels (never used by the
    port itself)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    c = sp.csr_matrix(mat)
    return torch.sparse_csr_tensor(
        torch.as_tensor(c.indptr.astype(np.int64)),
        torch.as_tensor(c.indices.astype(np.int64)),
        torch.as_tensor(c.data), size=c.shape).to(device=device, dtype=dtype)


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
    from cpkrylov_tpu_torch.precond import cuda_bidiag
    from cpkrylov_tpu_torch.precond.cuda_bidiag import (TILE,
                                                         bidiag_read_floor,
                                                         bidiag_scan,
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
                sa = torch_sparse_csr(mat, dtype, device)
                xs = x[:, None]
                dia["library_ms"] = cuda_time_ms(
                    lambda: torch.sparse.mm(sa, xs))
                dia["ms"], dia["plain_ms"] = ms, pms
                dia["bound_ms"], dia["bound_by"] = bound_ms(
                    8 * (d.ndiag * mat.shape[0] + mat.shape[1]
                         + mat.shape[0]), 2 * mat.nnz, tname)
                # the diagonals (56 MB) and two x exceed the L2 together
                xs2 = [(x,), (torch.randn_like(x),)]
                dia["device_ms"] = device_ms(lambda v: dia_spmv(d, v), xs2)
                dia["library_device_ms"] = device_ms(
                    lambda v: torch.sparse.mm(sa, v[:, None]), xs2)
                print(f"kernel dia_spmv bound_ms={dia['bound_ms']:.4f} "
                      f"({dia['bound_by']}) library_ms(torch.sparse.mm)="
                      f"{dia['library_ms']:.4f} device_ms="
                      f"{dia['device_ms']:.4f} library_device_ms="
                      f"{dia['library_device_ms']:.4f}", flush=True)

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
                before = cuda_bidiag.LAUNCHES
                xk = bidiag_scan(ta, ti, tb, reverse)
                per_call = cuda_bidiag.LAUNCHES - before
                xk2 = bidiag_scan(ta, ti, tb, reverse)
                xp = bidiag_scan_plain(ta, ti, tb, reverse)
                torch.cuda.synchronize()
                xk64 = xk.double().cpu().numpy()
                err = float(np.linalg.norm(xk64 - x64) / np.linalg.norm(x64))
                exact = torch.equal(xk, xp) and torch.equal(xk, xk2)
                scan["max_abs_err"] = max(
                    scan["max_abs_err"], float(torch.max(torch.abs(xk - xp))))
                ms = cuda_time_ms(lambda: bidiag_scan(ta, ti, tb, reverse))
                pms = cuda_time_ms(
                    lambda: bidiag_scan_plain(ta, ti, tb, reverse), iters=10,
                    warmup=2)
                print(f"kernel bidiag_scan {tname} n={n} "
                      f"{'reverse' if reverse else 'forward'} "
                      f"rel_err_vs_scipy={err:.3e} "
                      f"equal_to_plain_and_repeat={exact} "
                      f"launches_per_call={per_call} "
                      f"ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
                if not exact:
                    raise RuntimeError(
                        f"bidiag_scan {tname} n={n} reverse={reverse}: "
                        "differs from its plain version or between calls")
                if not err <= SCAN_TOL[tname]:
                    raise RuntimeError(
                        f"bidiag_scan {tname} n={n} reverse={reverse}: "
                        f"error vs scipy {err:.3e} > {SCAN_TOL[tname]}")
                if per_call != 1:
                    raise RuntimeError(f"bidiag_scan: {per_call} counted "
                                       "launches a call")
                if n != 1_250_000 or dtype != torch.float64:
                    continue
                # two operand sets (80 MB) exceed the L2 together
                sets = [(ta, ti, tb), (ta.flip(0), ti.flip(0), tb.flip(0))]

                def call(a_, i_, b_, reverse=reverse):
                    return bidiag_scan(a_, i_, b_, reverse)

                def floor(a_, i_, b_, reverse=reverse):
                    return bidiag_read_floor(a_, i_, b_, reverse)

                traced = traced_kernels(call, sets, 48)
                kernels_per_call = sum(c for _, c in traced.values()) / 48
                dms = device_ms(call, sets)
                fl = floor(ta, ti, tb)
                torch.cuda.synchronize()
                if not torch.equal(fl[:TILE] if not reverse else
                                   fl[-TILE:], xk[:TILE] if not reverse
                                   else xk[-TILE:]):
                    raise RuntimeError("bidiag_read_floor: its first tile "
                                       "differs from the scan's")
                fms = cuda_time_ms(lambda: floor(ta, ti, tb))
                fdms = device_ms(floor, sets)
                print(f"kernel bidiag_scan {tname} n={n} "
                      f"{'reverse' if reverse else 'forward'} "
                      f"device_ms={dms:.4f} read_floor_ms={fms:.4f} "
                      f"read_floor_device_ms={fdms:.4f} "
                      f"device_ops_per_call={kernels_per_call:.2f} "
                      f"traced={[(k[:48], c) for k, (_, c) in traced.items()]}",
                      flush=True)
                # one kernel a call, nothing else: a trace may keep fewer
                # records than launches (device_ms), never more
                if not (len(traced) == 1 and kernels_per_call <= 1
                        and "bidiag_scan_kernel" in next(iter(traced))):
                    raise RuntimeError(f"bidiag_scan: a call ran {traced}")
                if not reverse:
                    scan["ms"], scan["plain_ms"] = ms, pms
                    # a, invd and b read, x written; 3 operations a row
                    scan["bound_ms"], scan["bound_by"] = bound_ms(
                        4 * 8 * n, 3 * n, tname)
                    scan.update(device_ms=dms, read_floor_ms=fms,
                                read_floor_device_ms=fdms,
                                launches_per_call=per_call)
    # the ragged sizes of the tests: one partial tile, exact tiles, above
    # 32 and above 256 tiles (two aggregates a look-back thread)
    for n in (1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 33 * TILE + 1,
              257 * TILE + 3):
        for dtype in (torch.float32, torch.float64):
            ops = [torch.as_tensor(v).to(device=device, dtype=dtype) for v in
                   (0.4 * rng.standard_normal(n), 1.0 + rng.random(n),
                    rng.standard_normal(n))]
            for reverse in (False, True):
                if not torch.equal(bidiag_scan(*ops, reverse),
                                   bidiag_scan_plain(*ops, reverse)):
                    raise RuntimeError(f"bidiag_scan n={n} {dtype} "
                                       f"reverse={reverse}: differs from "
                                       "its plain version")
    print("kernel bidiag_scan ragged sizes: equal to the plain version "
          "(f32, f64, both directions)", flush=True)

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
            # (hi, lo) diagonals and x and y pairs; about 30 f32 operations
            # per stored entry for the error-free product and sum
            dfd["bound_ms"], dfd["bound_by"] = bound_ms(
                2 * 4 * (d.ndiag * mat.shape[0] + mat.shape[1]
                         + mat.shape[0]), 30 * mat.nnz, "float32")
            # the (hi, lo) diagonals (56 MB) and two x pairs exceed the L2
            dfd["device_ms"] = device_ms(
                lambda h, lo: df_dia_spmv(d, h, lo),
                [(xh, xl), (xl, xh)])
            print(f"kernel df_dia_spmv device_ms={dfd['device_ms']:.4f}",
                  flush=True)

    phase_riffle(sysm.n, sysm.m, device, results)


def traced_kernels(fn, operands, iters: int) -> dict:
    """{device operation's name: (mean ms of its traced launches, launches
    in the trace)} over ``iters`` calls of ``fn(*operands[i % len])`` in one
    ``torch.profiler`` trace, after one untimed call per operand set."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for ops in operands:
        fn(*ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*operands[i % len(operands)])
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA") or evt.count == 0:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (us / 1e3 / evt.count, evt.count)
    return out


def device_ms(fn, operands, iters: int = 48) -> float:
    """Device milliseconds per call of ``fn(*operands[i % len])``: for each
    kernel, copy or memset it launches, the mean duration of its launches in
    a profiler trace times its launches per call, summed.  Back-to-back
    CUDA-event timing of a kernel of a few microseconds measures the host's
    launch rate instead (the Python wrapper and ``ctypes``).  The operand
    sets rotate so that together they exceed the 50 MB L2, as for a caller
    whose input was not just written.  A trace may hold fewer launches than
    were made (on the H100, traces taken late in this script kept 4 to 9 of
    12 launches of the ms-long B4/B6 kernels, whose recorded durations match
    their event times): the mean over the launches it holds stands for
    all, and a line says what was missing."""
    total = 0.0
    for name, (mean, count) in traced_kernels(fn, operands, iters).items():
        per_call = max(1, round(count / iters))
        if count != per_call * iters:
            print(f"device_ms: the trace kept {count} of {per_call * iters} "
                  f"launches of {name[:60]}", flush=True)
        total += mean * per_call
    return total


def device_ms_by_kernel(fn, operands, iters: int = 12) -> dict:
    """Device milliseconds per launch of each kernel that ``fn`` launches,
    by the kernel's name (``traced_kernels``)."""
    return {name: mean for name, (mean, _) in
            traced_kernels(fn, operands, iters).items()}


def phase_riffle(n, m, device, results):
    """B7 and B8 at the main path's shape: the ordering's c = 1 and, with an
    empty x-tail, c = n // m; exact against their plain versions and against
    the explicit permutation.  ``torch.index_select`` with the permutation
    is the one library call computing the same function.  ``ms``,
    ``plain_ms`` and ``library_ms`` are CUDA-event times, as for every
    kernel (host overhead included: what a solve pays per call);
    ``device_ms`` and ``library_device_ms`` are device times per call from
    a profiler trace (``device_ms``)."""
    import numpy as np
    import torch

    from cpkrylov_tpu_torch.precond import cuda_interleave as ci
    from cpkrylov_tpu_torch.precond.permute import InterleavePermute
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    rng = np.random.default_rng(5)
    fwd, inv = results["interleave"], results["uninterleave"]
    for c in (1, n // m):
        perm = torch.as_tensor(InterleavePermute(n, m, c).perm, device=device)
        iperm = torch.argsort(perm)
        for dtype in (torch.float64, torch.float32):
            tname = str(dtype).split(".")[1]
            # six inputs of 5-10 MB: more than the L2 together
            zs = [torch.as_tensor(rng.standard_normal(n + m)).to(
                device=device, dtype=dtype) for _ in range(6)]
            ws = [ci.interleave(z, n, m, c) for z in zs]
            z, w = zs[0], ws[0]
            back = ci.uninterleave(w, n, m, c)
            torch.cuda.synchronize()
            exact = {
                "interleave": (torch.equal(w, ci.interleave_plain(z, n, m, c))
                               and torch.equal(w, z[perm])),
                "uninterleave": (torch.equal(
                    back, ci.uninterleave_plain(w, n, m, c))
                    and torch.equal(back, z)),
            }
            nbytes = 2 * (n + m) * z.element_size()
            calls = {
                "interleave": (zs, perm, lambda v: ci.interleave(v, n, m, c),
                               lambda v: ci.interleave_plain(v, n, m, c)),
                "uninterleave": (ws, iperm,
                                 lambda v: ci.uninterleave(v, n, m, c),
                                 lambda v: ci.uninterleave_plain(v, n, m, c)),
            }
            for name, res in (("interleave", fwd), ("uninterleave", inv)):
                vs, idx, kern, plain = calls[name]
                ops = [(v,) for v in vs]

                def lib(v, idx=idx):
                    return torch.index_select(v, 0, idx)

                ms = cuda_time_ms(lambda: kern(vs[0]))
                pms = cuda_time_ms(lambda: plain(vs[0]))
                lms = cuda_time_ms(lambda: lib(vs[0]))
                dms = device_ms(kern, ops)
                ldms = device_ms(lib, ops)
                bms, by = bound_ms(nbytes, 0, tname)
                print(f"kernel {name} {tname} n={n} m={m} c={c} "
                      f"tail={n - c * m} exact={exact[name]} ms={ms:.4f} "
                      f"plain_ms={pms:.4f} library_ms(torch.index_select)="
                      f"{lms:.4f} bound_ms={bms:.4f} ({by}) "
                      f"device_ms={dms:.4f} library_device_ms={ldms:.4f}",
                      flush=True)
                if not exact[name]:
                    raise RuntimeError(f"{name} {tname} c={c}: differs from "
                                       "its plain version")
                if c == 1 and dtype == torch.float64:   # the main path's
                    res.update(ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, device_ms=dms,
                               library_device_ms=ldms)
            del zs, ws, z, w, back


def phase_mm_setup(device):
    """AUG2D-L and CVXQP3-L: generation, host LDL^T and device packing, each
    timed.  ``factorize_kp`` + ``build_precond`` are the two halves of
    ``make_preconditioner`` (with its defaults); the host factor is kept for
    the scipy references of the mm kernels phase."""
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.cp import build_precond, factorize_kp
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt

    out = {}
    for name, make in (("aug2d_l", lambda: aug_kkt("2d", "l")),
                       ("cvxqp3_l", lambda: cvxqp_kkt("cvxqp3", "l"))):
        t0 = time.perf_counter()
        sysm = make()
        t1 = time.perf_counter()
        hf = factorize_kp(sysm.G, sysm.B, sysm.C)
        t2 = time.perf_counter()
        M = build_precond(hf.fac, hf.ksp, hf.n, hf.m,
                          options=cpt.PrecondOptions(), panel=256,
                          dtype=torch.float64, device=device,
                          base_order=hf.base_order)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        f = M.factor
        setup = {"generate_s": t1 - t0, "ldl_s": t2 - t1, "pack_s": t3 - t2}
        low = hf.fac.L.tocoo()
        reach = int((low.row - low.col).max()) if low.nnz else 0
        print(f"mm_setup {name} n={sysm.n} m={sysm.m} nnz_K={sysm.K.nnz} "
              f"nnz_L={hf.fac.L.nnz} reach={reach} ordering="
              f"{'rcm' if hf.base_order is None else 'interleave'} "
              f"tf1={type(f.tf1).__name__}(panel={f.tf1.panel}, "
              f"r={getattr(f.tf1, 'r', None)}) tf2={type(f.tf2).__name__}"
              f"(panel={f.tf2.panel}, r={getattr(f.tf2, 'r', None)}) "
              f"kp={type(M.kp).__name__} factor_nitref={M.factor_nitref} "
              f"generate_s={setup['generate_s']:.2f} "
              f"ldl_s={setup['ldl_s']:.2f} pack_s={setup['pack_s']:.2f} "
              f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}",
              flush=True)
        out[name] = (sysm, hf, M, setup)
    return out


def phase_mm_kernels(mm, device, results):
    """B4 and B6 on both triangles of AUG2D-L's factor, B5 on AUG2D-L's K_P
    and CVXQP3-L's A, f32 and f64."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from cpkrylov_tpu_torch.ops.cuda_spmv import csr_matvec_plain, csr_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.precond.cuda_tri import (affine_scan,
                                                     affine_scan_plain,
                                                     band_tri_solve,
                                                     band_tri_solve_plain,
                                                     scan_layout,
                                                     scan_read_floor)
    from cpkrylov_tpu_torch.precond.trisolve import ReducedScanTriFactor
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    _, hf, M, _ = mm["aug2d_l"]
    N = hf.n + hf.m
    L1 = (hf.fac.L + sp.identity(N, format="csc")).tocsr()
    U = L1.T.tocsr()
    rng = np.random.default_rng(11)
    b = rng.standard_normal(N).astype(np.float32).astype(np.float64)
    t0 = time.perf_counter()
    ref = {"L": spla.spsolve_triangular(L1, b, lower=True),
           "U": spla.spsolve_triangular(U, b, lower=False)}
    print(f"kernel band_tri scipy_reference_s={time.perf_counter() - t0:.2f}"
          f" nnz_L1={L1.nnz}", flush=True)
    del L1, U
    tri, scan = results["band_tri"], results["affine_scan"]
    for label, tf64 in (("L", M.factor.tf1), ("U", M.factor.tf2)):
        if not isinstance(tf64, ReducedScanTriFactor):
            raise RuntimeError(f"AUG2D-L {label}: factor is "
                               f"{type(tf64).__name__}, not the B4 form")
        for dtype in (torch.float64, torch.float32):
            tname = str(dtype).split(".")[1]
            tf = tf64 if dtype == torch.float64 else ReducedScanTriFactor(
                inv_diag=tf64.inv_diag.float(), w_blocks=tf64.w_blocks.float(),
                n=tf64.n, panel=tf64.panel, r=tf64.r)
            # the upper triangle's B4 form solves J U J: flip around it
            bd = torch.as_tensor(b if label == "L" else b[::-1].copy()).to(
                device=device, dtype=dtype)
            xk = band_tri_solve(tf, bd)
            xp = band_tri_solve_plain(tf, bd)
            torch.cuda.synchronize()
            err_abs = float(torch.max(torch.abs(xk - xp)))
            xk = xk.double().cpu().numpy()
            xp = xp.double().cpu().numpy()
            if label == "U":
                xk, xp = xk[::-1], xp[::-1]
            err_plain = rel_2norm(xk, xp)
            err_ref = rel_2norm(xk, ref[label])
            ms = cuda_time_ms(lambda: band_tri_solve(tf, bd), iters=20,
                              warmup=3)
            pms = cuda_time_ms(lambda: band_tri_solve_plain(tf, bd),
                               iters=3, warmup=1)
            # inv and W (GB) exceed the L2 by far: one operand set
            dms = device_ms(lambda v: band_tri_solve(tf, v), [(bd,)],
                            iters=12)
            split = device_ms_by_kernel(lambda v: band_tri_solve(tf, v),
                                        [(bd,)])
            c_ms = sum(t for k, t in split.items() if "band_c_kernel" in k)
            s_ms = sum(t for k, t in split.items()
                       if "affine_scan_kernel" in k)
            p, r, nb = tf.panel, tf.r, tf.nblocks
            lay = scan_layout(p, r, dtype)
            item = tf.inv_diag.element_size()
            # what this design moves: inv and W once, b read, c written
            # into x and read back by the scan, x written
            moved = item * (nb * p * p + nb * p * r + tf.n + 3 * nb * p)
            mats = item * (nb * p * p + nb * p * r)
            print(f"kernel band_tri {tname} {label} n={tf.n} panel={p} r={r}"
                  f" nb={nb} rel_err_vs_plain={err_plain:.3e} "
                  f"rel_err_vs_scipy_f64={err_ref:.3e} "
                  f"max_abs_err_vs_plain={err_abs:.3e} "
                  f"max_abs_x={np.max(np.abs(ref[label])):.3e} ms={ms:.4f} "
                  f"plain_ms={pms:.4f} device_ms={dms:.4f} "
                  f"c_kernel_device_ms={c_ms:.4f} "
                  f"scan_kernel_device_ms={s_ms:.4f} scan_layout={lay} "
                  f"bytes_moved={moved} bytes_inv_and_W={mats} "
                  f"bound_bytes={item * (nb * p * p + nb * p * r + 2 * tf.n)}"
                  f" W_reads_per_solve=1", flush=True)
            for what, e in (("plain", err_plain), ("scipy", err_ref)):
                if not e <= BAND_TOL[tname]:
                    raise RuntimeError(f"band_tri {tname} {label}: error vs "
                                       f"{what} {e:.3e} > {BAND_TOL[tname]}")
            if dtype == torch.float64:      # the dtype of the path's solves
                tri["max_abs_err"] = max(tri["max_abs_err"], err_abs)

            # B6 alone on this triangle's scan operands (W's negated tail
            # rows, c's tail entries), lane-major views as its contract has
            c = torch.zeros(nb * p, dtype=dtype, device=device)
            c[:tf.n] = bd
            c = torch.bmm(tf.inv_diag, c.view(nb, p, 1)).view(nb, p)
            mr = (-tf.w_blocks[:, p - r:, :]).permute(1, 2, 0)
            cr = c[:, p - r:].T
            sk = affine_scan(mr, cr)
            sp_ = affine_scan_plain(mr, cr)
            torch.cuda.synchronize()
            serr_abs = float(torch.max(torch.abs(sk - sp_)))
            serr = rel_2norm(sk.double().cpu().numpy(),
                             sp_.double().cpu().numpy())
            sms = cuda_time_ms(lambda: affine_scan(mr, cr), iters=20,
                               warmup=3)
            spms = cuda_time_ms(lambda: affine_scan_plain(mr, cr), iters=3,
                                warmup=1)
            sdms = device_ms(affine_scan, [(mr, cr)], iters=12)
            # the read floor: the same cluster, blocks and per-step slices
            # of W's tail rows, no chain between the steps; and the same
            # at B4's scan (all p rows of W, c in x)
            fl = scan_read_floor(mr, cr, r)
            torch.cuda.synchronize()
            if not torch.equal(fl, cr):
                raise RuntimeError(f"scan_read_floor {tname} {label}: "
                                   "differs from c")
            fms = cuda_time_ms(lambda: scan_read_floor(mr, cr, r), iters=20,
                               warmup=3)
            fdms = device_ms(lambda m_, c_: scan_read_floor(m_, c_, r),
                             [(mr, cr)], iters=12)
            wfull = tf.w_blocks.permute(1, 2, 0)
            fbdms = device_ms(lambda m_, c_: scan_read_floor(m_, c_, r),
                              [(wfull, c.T)], iters=12)
            print(f"kernel affine_scan {tname} {label} r={r} nb={nb} "
                  f"rel_err_vs_plain={serr:.3e} max_abs_err={serr_abs:.3e} "
                  f"ms={sms:.4f} plain_ms={spms:.4f} device_ms={sdms:.4f} "
                  f"read_floor_ms={fms:.4f} read_floor_device_ms={fdms:.4f} "
                  f"read_floor_b4_scan_device_ms={fbdms:.4f} "
                  f"read_floor_GBps={nb * r * r * item / fdms / 1e6:.1f} "
                  f"scan_layout={scan_layout(r, r, dtype)} "
                  f"W_tail_GB={nb * r * r * item / 1e9:.4f}", flush=True)
            if not serr <= BAND_TOL[tname]:
                raise RuntimeError(f"affine_scan {tname} {label}: error vs "
                                   f"plain {serr:.3e} > {BAND_TOL[tname]}")
            if dtype == torch.float64:
                scan["max_abs_err"] = max(scan["max_abs_err"], serr_abs)
            if label == "L" and dtype == torch.float64:
                tri["ms"], tri["plain_ms"], tri["device_ms"] = ms, pms, dms
                scan["device_ms"] = sdms
                tri["bound_ms"], tri["bound_by"] = bound_ms(
                    8 * (nb * p * p + nb * p * r + 2 * tf.n),
                    2 * nb * (p * p + p * r + r * r), tname)
                scan["ms"], scan["plain_ms"] = sms, spms
                scan["bound_ms"], scan["bound_by"] = bound_ms(
                    8 * (nb * r * r + 2 * nb * r), 2 * nb * r * r, tname)
                print(f"kernel band_tri bound_ms={tri['bound_ms']:.4f} "
                      f"({tri['bound_by']}) affine_scan bound_ms="
                      f"{scan['bound_ms']:.4f} ({scan['bound_by']})",
                      flush=True)
            del c, mr, cr, sk, sp_, bd, fl, wfull
            if dtype == torch.float32:
                del tf
            torch.cuda.empty_cache()

    csr = results["csr_spmv"]
    cvx = mm["cvxqp3_l"][0]
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).split(".")[1]
        for label, mat in (("K_P aug2d_l", hf.ksp), ("A cvxqp3_l", cvx.A)):
            c = csr_from_scipy(mat, dtype, device)
            x64 = rng.standard_normal(mat.shape[1])
            x = torch.as_tensor(x64).to(device=device, dtype=dtype)
            yk = csr_spmv(c, x)
            yk2 = csr_spmv(c, x)
            yp = csr_matvec_plain(c, x)
            torch.cuda.synchronize()
            err_abs = float(torch.max(torch.abs(yk - yp)))
            err_ref = rel_2norm(yk.double().cpu().numpy(),
                                mat @ x.double().cpu().numpy())
            ms = cuda_time_ms(lambda: csr_spmv(c, x))
            pms = cuda_time_ms(lambda: csr_matvec_plain(c, x), iters=20,
                               warmup=2)
            sa = torch_sparse_csr(mat, dtype, device)
            xs = x[:, None]
            lms = cuda_time_ms(lambda: torch.sparse.mm(sa, xs))
            print(f"kernel csr_spmv {tname} {label} {mat.shape[0]}x"
                  f"{mat.shape[1]} nnz={c.nnz} max_abs_err_vs_plain="
                  f"{err_abs:.3e} repeat_equal={torch.equal(yk, yk2)} "
                  f"rel_err_vs_scipy_f64={err_ref:.3e} ms={ms:.4f} "
                  f"plain_ms={pms:.4f} library_ms(torch.sparse.mm)={lms:.4f}",
                  flush=True)
            if err_abs != 0.0 or not torch.equal(yk, yk2):
                raise RuntimeError(f"csr_spmv {tname} {label}: differs from "
                                   "its plain version or between runs")
            if not err_ref <= CSR_SCIPY_TOL[tname]:
                raise RuntimeError(f"csr_spmv {tname} {label}: error vs "
                                   f"scipy {err_ref:.3e}")
            if dtype == torch.float64:
                nrows, ncols = mat.shape
                bms, by = bound_ms(
                    12 * c.nnz + 8 * (nrows + 1) + 8 * (ncols + nrows),
                    2 * c.nnz, tname)
                # copies of the matrix, so that the operand sets exceed the
                # L2 together (AUG2D-L's K_P is 20 MB, CVXQP3-L's A 1 MB)
                copies = max(2, -(-60_000_000 // (12 * c.nnz + 8 * nrows)))
                sets = [(csr_from_scipy(mat, dtype, device),
                         torch_sparse_csr(mat, dtype, device),
                         torch.randn_like(x)) for _ in range(copies)]
                dms = device_ms(lambda c_, s_, v: csr_spmv(c_, v), sets)
                ldms = device_ms(lambda c_, s_, v: torch.sparse.mm(
                    s_, v[:, None]), sets)
                print(f"kernel csr_spmv {tname} {label} bound_ms={bms:.4f} "
                      f"({by}) device_ms={dms:.4f} library_device_ms="
                      f"{ldms:.4f} operand_sets={copies}", flush=True)
                if label.startswith("K_P"):
                    csr.update(ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, device_ms=dms,
                               library_device_ms=ldms)
                del sets
            del c, sa


def phase_mm_solve(name, sysm, M, setup, device):
    """CPMINRES in f64 on one Maros-Meszaros system at the sweep's
    settings, the kernels' counters reset just before the solve."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops.formats import CSR
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor)
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    opts = cpt.SolverOptions(**MM_SOLVER)
    reset_launches()
    out = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                    opts=opts, M=M, dtype=torch.float64, device=device)
    launches = launch_counts()
    x = out.x.cpu().numpy()
    bnorm = float(np.linalg.norm(sysm.b))
    rnorm = float(np.linalg.norm(sysm.b - sysm.K @ x))
    contract = MM_SOLVER["atol"] + MM_SOLVER["rtol"] * bnorm
    t0 = time.perf_counter()
    x_direct = spla.spsolve(sysm.K.tocsc(), sysm.b)
    direct_s = time.perf_counter() - t0
    oracle = rel_2norm(x, x_direct)
    hist = out.resid_history
    f = M.factor
    print(f"{name} cpminres f64 n={sysm.n} m={sysm.m} solved={out.solved} "
          f"iters={out.niters} true_resid={rnorm:.4e} "
          f"true_rel_resid={rnorm / bnorm:.3e} "
          f"contract(atol+rtol*|b|)={contract:.4e} "
          f"contract_met={rnorm <= contract} "
          f"true_resid_over_contract={rnorm / contract:.4f} "
          f"err_vs_spsolve={oracle:.4e} (JAX record "
          f"{MM_RECORD[name][2]:.4e}, spsolve_s={direct_s:.2f}) "
          f"precond_resid={hist[-1]:.4e}/{hist[0]:.4e} "
          f"tf={type(f.tf1).__name__}(panel={f.tf1.panel}) "
          f"A={type(getattr(out.A_op, 'mat', None)).__name__} "
          f"kp={type(M.kp).__name__} "
          f"generate_s={setup['generate_s']:.2f} ldl_s={setup['ldl_s']:.2f} "
          f"pack_s={setup['pack_s']:.2f} stime_s={out.stime:.4f} "
          f"ms_per_iter={1e3 * out.stime / max(out.niters, 1):.3f} "
          f"launches={launches}", flush=True)
    target, slack, oracle_record = MM_RECORD[name]
    if not out.solved:
        raise RuntimeError(f"{name} not solved: status {out.istatus}")
    if abs(out.niters - target) > slack:
        raise RuntimeError(f"{name}: {out.niters} iterations, the JAX record "
                           f"is {target} +- {slack}")
    if not (np.all(np.isfinite(x)) and x.shape == (sysm.n + sysm.m,)):
        raise RuntimeError(f"{name}: solution not finite or wrong shape")
    if not hist[-1] <= MM_SOLVER["atol"] + MM_SOLVER["rtol"] * hist[0]:
        raise RuntimeError(f"{name}: the solver's stopping test does not "
                           "hold on its own history")
    if not isinstance(M.kp, CSR) or launches["csr_spmv"] < out.niters:
        raise RuntimeError(f"{name}: K_P is {type(M.kp).__name__}, "
                           f"{launches['csr_spmv']} B5 launches")
    if name == "aug2d_l":
        ok = all(isinstance(t, ReducedScanTriFactor)
                 and (t.panel, t.r) == MM_AUG_PANEL for t in (f.tf1, f.tf2))
        if not ok:
            raise RuntimeError("aug2d_l: the factor is not the B4 form with "
                               "p = 632, r = 631")
        for kname in ("band_tri", "affine_scan"):
            if launches[kname] < 2 * out.niters:
                raise RuntimeError(f"aug2d_l: {kname} launched "
                                   f"{launches[kname]} times")
    elif not all(isinstance(t, BlockTriFactor) for t in (f.tf1, f.tf2)):
        raise RuntimeError("cvxqp3_l: the factor is not blocked "
                           "substitution, as in the JAX package")
    if not oracle <= MM_ORACLE_SLACK * oracle_record:
        raise RuntimeError(f"{name}: error against spsolve {oracle:.4e}, the "
                           f"JAX record is {oracle_record:.4e}")
    if not rnorm <= MM_TRUE_RESID[name] * contract:
        raise RuntimeError(f"{name}: true residual {rnorm:.4e} > "
                           f"{MM_TRUE_RESID[name]} x {contract:.4e}")
    return launches


def phase_main_path(sysm, device):
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops.dia import DIA
    from cpkrylov_tpu_torch.precond import cuda_bidiag
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    reset_launches()
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
    launches = launch_counts()
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
    for name in ("dia_spmv", "bidiag_scan"):
        count = launches[name]
        if count < 4 * out.niters:
            raise RuntimeError(f"{name} launched {count} times in "
                               f"{out.niters} iterations (< 4 per iter)")
    check_riffle(f.pin, launches, out.niters, "main path")
    return launches, M


def check_riffle(pin, launches, niters, what):
    """The path's ordering is the interleave at c = 1, and B7 and B8 ran at
    least once per iteration (around every direct solve)."""
    from cpkrylov_tpu_torch.precond.permute import InterleavePermute

    if not (isinstance(pin, InterleavePermute) and pin.c == 1):
        raise RuntimeError(f"{what}: the ordering is {pin!r}, not the "
                           "interleave at c = 1")
    for name in ("interleave", "uninterleave"):
        if launches[name] < max(niters, 1):
            raise RuntimeError(f"{what}: {name} launched {launches[name]} "
                               f"times in {niters} iterations")


def phase_profile(sysm, device, M, M32, mm, outdir):
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
    for name in ("aug2d_l", "cvxqp3_l"):
        msys, _, mM, _ = mm[name]
        runs["mm_" + name] = (
            "profile_mm_" + name, SOLVE_SPAN,
            lambda msys=msys, mM=mM: cpt.solve(
                "cpminres", msys.b, msys.A, msys.B, msys.C, msys.G,
                opts=cpt.SolverOptions(**MM_SOLVER), M=mM,
                dtype=torch.float64, device=device))
    for solver in BANDED_JAX:
        if solver != "cpminres":
            runs["solvers_banded_" + solver] = (
                "profile_banded_" + solver, SOLVE_SPAN,
                lambda solver=solver: cpt.solve(
                    solver, sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                    device=device, dtype=torch.float64, opts=opts,
                    precond_opts=popts, M=M))
    for name, (stem, span, fn) in runs.items():
        outs = []
        # the Maros-Meszaros traces run to tens of MB, and the solvers'
        # repeat the main path's: their tables only
        trace = (None if name.startswith(("mm_", "solvers_"))
                 else os.path.join(outdir, stem + ".json"))
        prof = device_profile(lambda: outs.append(fn()), trace_path=trace,
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
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    M32 = cpt.make_preconditioner(fix.G, fix.B, fix.C, options=popts,
                                  dtype=torch.float32, device=device)
    if not isinstance(M32.factor, DFFactorApply):
        raise RuntimeError("cvxqp1_m f32: the df64-applied factor is not "
                           f"engaged (probe {M32.probe_rel:.3e})")
    x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
    inner = []
    for run in (1, 2):
        reset_launches()
        out = cpt.solve_mixed(
            "cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, M=M32,
            device=device,
            opts=cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
            precond_opts=popts)
        launches = launch_counts()
        rel = float(np.linalg.norm(out.x - x_ref) / np.linalg.norm(x_ref))
        loop = "host" if out.inner_outputs else "device"
        print(f"golden_mixed cvxqp1_m cpminres f32-inner run={run} "
              f"solved={out.solved} factor=DFFactorApply "
              f"probe_rel={M32.probe_rel:.3e} loop={loop} "
              f"nouter={out.nouter} inner={list(out.inner_niters)} "
              f"niters={out.niters} rel_err={rel:.3e} "
              f"stime_s={out.stime:.4f} launches={launches}", flush=True)
        if not (out.solved and rel < 1e-7 and out.nouter <= 5):
            raise RuntimeError("golden_mixed cvxqp1_m check failed")
        if launches["csr_spmv"] < out.niters:
            raise RuntimeError("golden_mixed: the CSR products did not go "
                               "through B5")
        inner.append(tuple(out.inner_niters))
    if inner[0] != inner[1]:
        raise RuntimeError(f"golden_mixed inner counts differ between two "
                           f"runs: {inner}")
    return launches


def phase_main_mixed(sysm, device):
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.mixed import _lean_inner_options
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

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
    reset_launches()
    out = run()
    launches = launch_counts()

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
    check_riffle(M32.factor.pin, launches, out.niters, "main_mixed")
    return launches, M32


def phase_solvers_banded(sysm, M, device):
    """The other five solvers on the main path's system, options and
    preconditioner (and CPMINRES again, warm, beside them), each run cold
    once and then warm with the counters reset just before it; held to the
    JAX package's CPU iterations and true residuals (``BANDED_JAX``).
    Returns the launches summed over the warm runs."""
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    bnorm = float(np.linalg.norm(sysm.b))
    total = {}
    for name, jax_resid in BANDED_JAX.items():
        def run():
            return cpt.solve(name, sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                             device=device, dtype=torch.float64, opts=opts,
                             precond_opts=popts, M=M)

        cold = run()
        reset_launches()
        out = run()
        launches = launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        x = out.x.cpu().numpy()
        true_rel = float(np.linalg.norm(sysm.b - sysm.K @ x) / bnorm)
        per_iter = sum(launches.values()) / max(out.niters, 1)
        print(f"solvers_banded {name} f64 n={sysm.n} m={sysm.m} "
              f"solved={out.solved} iters={out.niters} "
              f"true_rel_resid={true_rel:.4e} (JAX CPU {jax_resid:.4e}) "
              f"stime_s={out.stime:.4f} cold_stime_s={cold.stime:.4f} "
              f"ms_per_iter={1e3 * out.stime / max(out.niters, 1):.4f} "
              f"kernel_launches_per_iter={per_iter:.1f} "
              f"interleave={launches['interleave']} "
              f"uninterleave={launches['uninterleave']} "
              f"launches={launches}", flush=True)
        if not out.solved:
            raise RuntimeError(f"solvers_banded {name}: not solved, status "
                               f"{out.istatus}")
        if abs(out.niters - BANDED_ITERS[0]) > BANDED_ITERS[1]:
            raise RuntimeError(f"solvers_banded {name}: {out.niters} "
                               f"iterations, the JAX package takes "
                               f"{BANDED_ITERS[0]}")
        if not (np.all(np.isfinite(x)) and x.shape == (sysm.n + sysm.m,)):
            raise RuntimeError(f"solvers_banded {name}: solution not finite "
                               "or wrong shape")
        if not (true_rel <= 1e-6
                and abs(true_rel - jax_resid) <= BANDED_SLACK * jax_resid):
            raise RuntimeError(f"solvers_banded {name}: true residual "
                               f"{true_rel:.4e}, the JAX package's "
                               f"{jax_resid:.4e}")
        for kname in ("dia_spmv", "bidiag_scan"):
            if launches[kname] < out.niters:
                raise RuntimeError(f"solvers_banded {name}: {kname} launched "
                                   f"{launches[kname]} times")
        check_riffle(M.factor.pin, launches, out.niters,
                     f"solvers_banded {name}")
    return total


def phase_golden_solvers(device):
    """``tests/test_golden.py`` on the card in f64: the shipped fixtures'
    golden counts and error bounds for the five solvers besides CPMINRES
    (RCM gather ordering, CSR products of B5).  Returns the launches summed
    over the solves."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True, itref_tol=1e-8)
    total = {}
    for fixture, cases in GOLDEN_SOLVERS.items():
        fix = load_fixture(fixture)
        M = cpt.make_preconditioner(fix.G, fix.B, fix.C, options=popts,
                                    dtype=torch.float64, device=device)
        x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
        for name, extra, iters, slack, relmax in cases:
            reset_launches()
            out = cpt.solve(name, fix.b, fix.A, fix.B, fix.C, fix.G, M=M,
                            device=device, dtype=torch.float64,
                            precond_opts=popts,
                            opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6,
                                                   itmax=500, **extra))
            launches = launch_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            rel = float(np.linalg.norm(out.x.cpu().numpy() - x_ref)
                        / np.linalg.norm(x_ref))
            print(f"golden_solvers {fixture} {name} {extra} f64 "
                  f"solved={out.solved} iters={out.niters} (golden {iters} "
                  f"+- {slack}) rel_err={rel:.3e} (< {relmax}) "
                  f"resid0={out.resid_history[0]:.4e} "
                  f"stime_s={out.stime:.4f} "
                  f"csr_spmv={launches['csr_spmv']}", flush=True)
            if not (out.solved and abs(out.niters - iters) <= slack
                    and rel < relmax):
                raise RuntimeError(f"golden_solvers {fixture} {name} {extra}"
                                   " check failed")
            if (fixture == "cvxqp2_s" and extra == {"restart": 100}
                    and not abs(out.resid_history[0] - 1.19e2) / 1.19e2
                    < 0.05):
                raise RuntimeError("golden_solvers cvxqp2_s cpgmres: first "
                                   "residual off the golden 1.19e2")
            if launches["csr_spmv"] < out.niters:
                raise RuntimeError(f"golden_solvers {fixture} {name}: the "
                                   "CSR products did not go through B5")
    return total


# The distributed phases: the main path's system as DIST_RANKS gloo ranks
# that share the card (NCCL refuses two ranks on one GPU), then one NCCL
# rank.  Each rank holds the serial card count, 12 +- 1 (BANDED_ITERS), a
# host f64 true residual <= 1e-6 |b|, and x within DIST_X_TOL of the serial
# x (relative 2-norm; the factors are exact, so only rounding differs).
DIST_RANKS = 2
DIST_X_TOL = 1e-6
# The kernels every rank must launch, by factor: one of each group.
_SPMV = ("dia_spmv", "csr_spmv")
NEED_SCHUR = (("bidiag_scan",), _SPMV)
NEED_REPLICATED = NEED_SCHUR + (("interleave",), ("uninterleave",))
NEED_SHARDED = (("band_tri",), ("affine_scan",), ("csr_spmv",))
# The system of ``schur_sharded``: the main path's sizes with a banded G
# and a slope-matched B, whose Schur plan has an interface at two ranks.
SHARDED_SYS = dict(bandwidth=3, g_mode="banded", b_mode="slope")


def _peak_gib(device) -> float:
    import torch

    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _dist_solves_rank(comm, n, m):
    """One gloo rank of ``dist_banded`` and ``dist_mixed``: dist_solve
    CPMINRES with the Schur and with the replicated factor,
    dist_cpminres (replicated factor) on the b2 = 0 system, dist_solve
    CPMINRES with the sharded Schur factor on the ``SHARDED_SYS`` system,
    and dist_solve_mixed, at the main path's settings.  Per solve: setup
    and solve seconds, the count, the launches of this rank (counters
    reset just before the solve, read just after), the peak device memory
    from its setup on and the collectives; rank 0 adds the solutions."""
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.parallel import (dist_cpminres, dist_solve,
                                             dist_solve_mixed,
                                             partition_blocks, plan_dist,
                                             plan_halo_block, shard_vector,
                                             unshard_vector)
    from cpkrylov_tpu_torch.parallel.mixed import build_dist_precond
    from cpkrylov_tpu_torch.parallel.schur import SchurFactor
    from cpkrylov_tpu_torch.utils.fixtures import banded_saddle_system
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    dev = comm.device
    sysm = banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    f64 = torch.float64
    out = {}

    def clock():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def solve_run(key, setup_s, fn, extra, cold=True):
        """A cold run first (unless ``cold`` is False), then the one
        that is counted and timed."""
        cold_s = None
        if cold:
            t0 = clock()
            fn()
            cold_s = clock() - t0
        calls0 = dict(comm.calls)
        reset_launches()
        t0 = clock()
        iters, x = fn()
        solve_s = clock() - t0
        out[key] = dict(setup_s=setup_s, solve_s=solve_s, cold_s=cold_s,
                        iters=iters,
                        launches=launch_counts(),
                        peak_gib=_peak_gib(dev),
                        calls={k: v - calls0[k]
                               for k, v in comm.calls.items()},
                        x=x if comm.rank == 0 else None, **extra)

    def both(x1, x2):
        return torch.cat([x1, x2]).cpu().numpy()

    def fresh_peak():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    fresh_peak()
    # the Schur factor (dist_solve's default) and its partition plan
    t0 = clock()
    Ms = build_dist_precond(sysm.G, sysm.B, sysm.C, comm,
                            precond_opts=popts, dtype=f64)
    f = Ms.factor
    plan = plan_dist(sysm.A, sysm.B, sysm.C, comm, dtype=f64,
                     G=sysm.G if getattr(f, "has_shard_plan", False)
                     else None)
    setup_s = clock() - t0
    if not isinstance(f, SchurFactor):
        raise RuntimeError(f"dist_banded: the default factor is "
                           f"{type(f).__name__}, not the Schur factor")

    def run_schur():
        res, x1, x2 = dist_solve(comm, "cpminres", sysm.b, sysm.A, sysm.B,
                                 sysm.C, sysm.G, opts=opts, M=Ms, plan=plan)
        return res.niters, both(x1, x2)

    solve_run("schur", setup_s, run_schur, dict(
        s=f.s, sharded=f.has_shard_plan,
        form=type(f.local_factor.tf1).__name__,
        blocks={k: f"{type(v).__name__}:{type(v.mat).__name__}"
                for k, v in plan.blocks.items()}))
    del Ms, plan, f

    # the replicated factor
    fresh_peak()
    t0 = clock()
    Mr = cpt.make_preconditioner(sysm.G, sysm.B, sysm.C, options=popts,
                                 dtype=f64, device=dev)
    plan_r = plan_dist(sysm.A, sysm.B, sysm.C, comm, dtype=f64)
    setup_s = clock() - t0

    def run_rep():
        res, x1, x2 = dist_solve(comm, "cpminres", sysm.b, sysm.A, sysm.B,
                                 sysm.C, sysm.G, opts=opts, M=Mr,
                                 plan=plan_r)
        return res.niters, both(x1, x2)

    solve_run("rep", setup_s, run_rep,
              dict(form=type(Mr.factor.tf1).__name__))
    del plan_r

    # the hand-fused CPMINRES on the b2 = 0 system, halo A and C products
    t0 = clock()
    blocks = partition_blocks(sysm.A, sysm.B, sysm.C, comm, dtype=f64)
    ha = plan_halo_block(sysm.A, comm, blocks.n_loc, blocks.n_loc)
    hc = plan_halo_block(sysm.C, comm, blocks.m_loc, blocks.m_loc)
    setup_s = clock() - t0

    def run_cpminres():
        b_loc = shard_vector(sysm.b[:n], comm, blocks.n_loc, f64)
        xl, yl, k, _, _ = dist_cpminres(comm, blocks, Mr, b_loc, opts,
                                        halo_a=ha, halo_c=hc)
        return k, both(unshard_vector(xl, n, comm),
                       unshard_vector(yl, m, comm))

    solve_run("dist_cpminres", setup_s, run_cpminres, {})
    del Mr, blocks, ha, hc

    # the Schur factor with an interface and a sharded exchange, on the
    # SHARDED_SYS system: applied on the slices, no global K_P
    sysb = banded_saddle_system(n, m, with_oracle=False, **SHARDED_SYS)
    fresh_peak()
    t0 = clock()
    Mb = build_dist_precond(sysb.G, sysb.B, sysb.C, comm,
                            precond_opts=popts, dtype=f64)
    fb = Mb.factor
    plan_b = plan_dist(sysb.A, sysb.B, sysb.C, comm, dtype=f64, G=sysb.G)
    setup_s = clock() - t0
    if not (isinstance(fb, SchurFactor) and fb.s > 0 and fb.has_shard_plan
            and Mb.kp is None):
        raise RuntimeError(
            f"dist_banded schur_sharded: factor {type(fb).__name__}, s = "
            f"{getattr(fb, 's', None)}, exchange "
            f"{getattr(fb, 'has_shard_plan', None)}, K_P kept "
            f"{Mb.kp is not None}")

    def run_sharded():
        res, x1, x2 = dist_solve(comm, "cpminres", sysb.b, sysb.A, sysb.B,
                                 sysb.C, sysb.G, opts=opts, M=Mb,
                                 plan=plan_b)
        return res.niters, both(x1, x2)

    # one run: its scans take ~0.1 s a trisolve (nb = 78,125 panels)
    solve_run("schur_sharded", setup_s, run_sharded, dict(
        s=fb.s, sharded=fb.has_shard_plan,
        form=type(fb.local_factor.tf1).__name__,
        panel=getattr(fb.local_factor.tf1, "panel", None),
        r=getattr(fb.local_factor.tf1, "r", None),
        blocks={k: f"{type(v).__name__}:{type(v.mat).__name__}"
                for k, v in plan_b.blocks.items()}), cold=False)
    del Mb, plan_b, fb, sysb

    # dist_mixed: f32 inner solves on the same ranks, f64 host outer loop
    fresh_peak()
    mixed = {}

    def run_mixed():
        mo = dist_solve_mixed(comm, "cpminres", sysm.b, sysm.A, sysm.B,
                              sysm.C, sysm.G,
                              opts=cpt.SolverOptions(**MIXED_SOLVER),
                              precond_opts=popts,
                              inner_stagwin=MIXED_INNER_STAGWIN)
        mixed.update(solved=mo.solved, nouter=mo.nouter,
                     inner=list(mo.inner_niters), ptime_s=mo.ptime)
        return mo.niters, np.asarray(mo.x)

    # one run: every call of dist_solve_mixed builds its f32 factor anew
    solve_run("mixed", 0.0, run_mixed, mixed, cold=False)
    return out


def _dist_nccl_rank(comm, n, m):
    """The one NCCL rank of ``dist_nccl1``: dist_solve CPMINRES with its
    default preconditioner (the replicated factor on one rank), device
    tensors straight to the collectives."""
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.parallel import dist_solve, plan_dist
    from cpkrylov_tpu_torch.utils.fixtures import banded_saddle_system
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    dev = comm.device
    sysm = banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    M = cpt.make_preconditioner(sysm.G, sysm.B, sysm.C, options=popts,
                                dtype=torch.float64, device=dev)
    plan = plan_dist(sysm.A, sysm.B, sysm.C, comm, dtype=torch.float64)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        out = dist_solve(comm, "cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                         sysm.G, opts=opts, M=M, plan=plan)
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    _, cold_s = run()     # the first collectives set up NCCL's communicator
    reset_launches()
    calls0 = dict(comm.calls)
    (res, x1, x2), solve_s = run()
    return {"nccl": dict(
        setup_s=setup_s, solve_s=solve_s, cold_s=cold_s,
        iters=res.niters, launches=launch_counts(), peak_gib=_peak_gib(dev),
        calls={k: v - calls0[k] for k, v in comm.calls.items()},
        backend=comm.backend,
        x=torch.cat([x1, x2]).cpu().numpy())}


def _check_dist(phase, key, ranks, ref_x, ref_iters, b, K, card, need):
    """Print one distributed solve's line and hold it to the serial card
    run; returns the launches summed over the ranks."""
    import numpy as np

    r0 = ranks[0][key]
    x = r0["x"]
    true_rel = float(np.linalg.norm(b - K @ x) / np.linalg.norm(b))
    rel_x = rel_2norm(x, ref_x)
    per_rank = [r[key] for r in ranks]
    extra = {k: v for k, v in r0.items()
             if k not in ("x", "launches", "calls", "setup_s", "solve_s",
                          "cold_s", "iters", "peak_gib")}
    print(f"{phase} {key} ranks={len(ranks)} n={K.shape[0]} "
          f"iters={r0['iters']} (serial {ref_iters}) "
          f"setup_s={[round(p['setup_s'], 3) for p in per_rank]} "
          f"solve_s={[round(p['solve_s'], 4) for p in per_rank]} "
          f"cold_solve_s={[_round(p['cold_s'], 4) for p in per_rank]} "
          f"true_rel_resid={true_rel:.4e} rel_x_vs_serial={rel_x:.3e} "
          f"peak_gib={[round(p['peak_gib'], 3) for p in per_rank]} "
          f"collectives={[p['calls'] for p in per_rank]} "
          f"launches={[p['launches'] for p in per_rank]} {extra} "
          f"card=\"{card}\"", flush=True)
    if any(p["iters"] != r0["iters"] for p in per_rank):
        raise RuntimeError(f"{phase} {key}: the ranks' counts differ")
    if abs(r0["iters"] - ref_iters) > BANDED_ITERS[1]:
        raise RuntimeError(f"{phase} {key}: {r0['iters']} iterations, the "
                           f"serial card run takes {ref_iters}")
    if not (np.all(np.isfinite(x)) and x.shape == ref_x.shape):
        raise RuntimeError(f"{phase} {key}: solution not finite or wrong "
                           "shape")
    if not true_rel <= 1e-6:
        raise RuntimeError(f"{phase} {key}: true residual {true_rel:.3e}")
    if not rel_x <= DIST_X_TOL:
        raise RuntimeError(f"{phase} {key}: x off the serial x by "
                           f"{rel_x:.3e}")
    return _rank_launches(f"{phase} {key}", per_rank, need)


def _round(x, digits):
    return None if x is None else round(x, digits)


def _rank_launches(what, per_rank, need):
    """Every rank launched, for each group of kernels in ``need``, at least
    one of them; returns the launches summed over the ranks."""
    total = {}
    for p in per_rank:
        la = p["launches"]
        missing = [g for g in need if not any(la[k] for k in g)]
        if missing:
            raise RuntimeError(f"{what}: a rank launched none of "
                               f"{missing}: {la}")
        for k, v in la.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_dist(sysm, M, device):
    """``dist_banded`` and ``dist_mixed`` on DIST_RANKS gloo ranks sharing
    the card, then ``dist_nccl1`` on one NCCL rank; held to serial card
    solves with the main path's factor ``M``.  Returns the launches of
    each phase summed over its ranks."""
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.parallel.dryrun import run_ranks
    from cpkrylov_tpu_torch.utils import fixtures

    card = nvidia_smi_card()
    n, m = sysm.n, sysm.m
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200)
    b0 = np.concatenate([sysm.b[:n], np.zeros(m)])
    ref = {}
    for key, rhs in (("b", sysm.b), ("b0", b0)):
        out = cpt.solve("cpminres", rhs, sysm.A, sysm.B, sysm.C, sysm.G,
                        device=device, dtype=torch.float64, opts=opts,
                        precond_opts=popts, M=M)
        ref[key] = (out.x.cpu().numpy(), out.niters)
    # the serial card solve of schur_sharded's system
    sysb = fixtures.banded_saddle_system(n, m, **SHARDED_SYS)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    Mb = cpt.make_preconditioner(sysb.G, sysb.B, sysb.C, options=popts,
                                 dtype=torch.float64, device=device)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    out = cpt.solve("cpminres", sysb.b, sysb.A, sysb.B, sysb.C, sysb.G,
                    device=device, dtype=torch.float64, opts=opts,
                    precond_opts=popts, M=Mb)
    torch.cuda.synchronize(device)
    ref["bs"] = (out.x.cpu().numpy(), out.niters)
    print(f"dist_banded serial schur_sharded system g_mode=banded "
          f"b_mode=slope iters={out.niters} setup_s={t1 - t0:.3f} "
          f"solve_s={time.perf_counter() - t1:.4f} "
          f"form={type(Mb.factor.tf1).__name__} "
          f"panel={getattr(Mb.factor.tf1, 'panel', None)} "
          f"r={getattr(Mb.factor.tf1, 'r', None)} card=\"{card}\"",
          flush=True)
    del Mb, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_dist_solves_rank, DIST_RANKS, n, m, backend="gloo",
                      device=device)
    print(f"dist_banded ranks={DIST_RANKS} backend=gloo device={device} "
          f"wall_s={time.perf_counter() - t0:.2f} (spawn, system, setups, "
          "solves)", flush=True)
    launches = {"dist_banded": {}}
    for key, s_, rhs, rk, need in (
            ("schur", sysm, sysm.b, "b", NEED_SCHUR),
            ("rep", sysm, sysm.b, "b", NEED_REPLICATED),
            ("dist_cpminres", sysm, b0, "b0", NEED_REPLICATED),
            ("schur_sharded", sysb, sysb.b, "bs", NEED_SHARDED)):
        la = _check_dist("dist_banded", key, ranks, *ref[rk], rhs, s_.K,
                         card, need)
        for k, v in la.items():
            launches["dist_banded"][k] = launches["dist_banded"].get(k, 0) \
                + v
    mixed = ranks[0]["mixed"]
    if not mixed["solved"]:
        raise RuntimeError(f"dist_mixed not solved: {mixed}")
    launches["dist_mixed"] = _check_dist_mixed(ranks, sysm, card)

    t0 = time.perf_counter()
    nccl = run_ranks(_dist_nccl_rank, 1, n, m, backend="nccl",
                     device=device)
    print(f"dist_nccl1 ranks=1 backend=nccl device={device} "
          f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
    r = nccl[0]["nccl"]
    if r["backend"] != "nccl" or r["calls"]["allreduce"] == 0:
        raise RuntimeError(f"dist_nccl1: no NCCL collective ran: {r}")
    launches["dist_nccl1"] = _check_dist("dist_nccl1", "nccl", nccl,
                                         *ref["b"], sysm.b, sysm.K, card,
                                         NEED_REPLICATED)
    return launches


def _check_dist_mixed(ranks, sysm, card):
    """dist_mixed to the f64 contract (true residual <= 1e-6 |b|); returns
    its launches summed over the ranks."""
    import numpy as np

    per_rank = [r["mixed"] for r in ranks]
    r0 = per_rank[0]
    x = r0["x"]
    true_rel = float(np.linalg.norm(sysm.b - sysm.K @ x)
                     / np.linalg.norm(sysm.b))
    print(f"dist_mixed cpminres f32-inner f64-outer ranks={len(ranks)} "
          f"n={sysm.n} m={sysm.m} solved={r0['solved']} "
          f"nouter={r0['nouter']} inner={r0['inner']} "
          f"niters={r0['iters']} "
          f"ptime_s={[round(p['ptime_s'], 3) for p in per_rank]} "
          f"stime_s={[round(p['solve_s'], 4) for p in per_rank]} "
          f"true_rel_resid={true_rel:.4e} "
          f"peak_gib={[round(p['peak_gib'], 3) for p in per_rank]} "
          f"collectives={[p['calls'] for p in per_rank]} "
          f"launches={[p['launches'] for p in per_rank]} "
          f"card=\"{card}\"", flush=True)
    if not (np.all(np.isfinite(x)) and true_rel <= 1e-6):
        raise RuntimeError(f"dist_mixed: true residual {true_rel:.3e}")
    return _rank_launches("dist_mixed", per_rank, NEED_SCHUR)


def kernel_entry(name: str, source: str, replaces: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"cpkrylov_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": 0.0, "library_ms": None}


def run_phases(device, profile_dir=None) -> list:
    """Phases 3-15 (and the profile when asked); returns the kernels' JSON
    entries."""
    import torch

    from cpkrylov_tpu_torch.utils import fixtures

    results = {
        "dia_spmv": kernel_entry("dia_spmv", "dia_spmv.cu",
                                 "cpkrylov_tpu/ops/pallas_dia.py:93"),
        "bidiag_scan": kernel_entry(
            "bidiag_scan", "bidiag_scan.cu",
            "cpkrylov_tpu/precond/pallas_bidiag.py:100"),
        "df_dia_spmv": kernel_entry("df_dia_spmv", "df_dia_spmv.cu",
                                    "cpkrylov_tpu/ops/pallas_dia.py:152"),
        "band_tri": kernel_entry("band_tri", "band_tri.cu",
                                 "cpkrylov_tpu/precond/pallas_tri.py:173"),
        "csr_spmv": kernel_entry("csr_spmv", "csr_spmv.cu",
                                 "cpkrylov_tpu/ops/pallas_spmv.py:25"),
        "affine_scan": kernel_entry("affine_scan", "band_tri.cu",
                                    "cpkrylov_tpu/precond/pallas_tri.py:36"),
        "interleave": kernel_entry(
            "interleave", "interleave.cu",
            "cpkrylov_tpu/precond/pallas_interleave.py:26"),
        "uninterleave": kernel_entry(
            "uninterleave", "interleave.cu",
            "cpkrylov_tpu/precond/pallas_interleave.py:32"),
    }
    t0 = time.perf_counter()
    sysm = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3)
    print(f"fixture banded 1000000x250000 seconds="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    phase_kernels(sysm, device, results)
    mm = phase_mm_setup(device)
    phase_mm_kernels(mm, device, results)
    torch.cuda.empty_cache()
    # the golden solve first among the solves: it also brings up the
    # libraries (cuBLAS for the dot products) that a process's first solve
    # initializes
    phase_golden(device)
    by_path = {"golden_mixed": phase_golden_mixed(device)}
    by_path["main_path"], M = phase_main_path(sysm, device)
    by_path["main_mixed"], M32 = phase_main_mixed(sysm, device)
    by_path["solvers_banded"] = phase_solvers_banded(sysm, M, device)
    for name in ("aug2d_l", "cvxqp3_l"):
        msys, _, mM, setup = mm[name]
        by_path[name] = phase_mm_solve(name, msys, mM, setup, device)
    by_path["golden_solvers"] = phase_golden_solvers(device)
    by_path.update(phase_dist(sysm, M, device))
    if profile_dir:
        phase_profile(sysm, device, M, M32, mm, profile_dir)

    kernels = []
    for name, res in results.items():
        entry = dict(res)
        counts = {p: c[name] for p, c in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if entry["launches"] == 0:
            raise RuntimeError(f"{name} was launched no time on the paths")
        if name in ("interleave", "uninterleave") and not all(
                counts[p] > 0 for p in ("main_path", "main_mixed",
                                        "solvers_banded")):
            raise RuntimeError(f"{name} missing on a banded path: {counts}")
        kernels.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "launches_per_call", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "read_floor_ms", "read_floor_device_ms")
            if k in entry})
    return kernels


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

    card = nvidia_smi_card()
    print(f"device torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} card=\"{card}\"",
          flush=True)
    print(f"build seconds={_build.build_kernels():.2f} "
          f"dir={os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)

    kernels = run_phases(device, args.profile)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
