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
   steps); the CSR SpMV (B5) on AUG2D-L's K_P and CVXQP3-L's A, K_P and
   B', f32 and f64, bit for bit against its plain version, a second call
   and the thread-a-row kernel it replaced (``tools/csr_spmv_rowthread.cu``,
   built beside the package's kernels), and against scipy, with its bound
   at each shape, and its device time with the operands rotated past the
   L2 (read in turns with the thread-a-row kernel) and warm, beside an
   empty kernel on its grid (the launch floor); ``torch.sparse.mm`` timed
   beside B5 and B1; ``torch.triangular_solve`` on a sparse CSR triangle
   (cuSPARSE's solve) timed beside B2 (the n = 1.25M bidiagonal), B4
   (AUG2D-L's L) and B9 (CVXQP3-L's L), f64 and f32, and held against each
   kernel's solution;
   blocked substitution (B9) on both triangles of CVXQP3-L's factor (69
   panels, timed) and of cvxqp1_m's (22 panels), f64 and f32, against its
   plain version and scipy's ``spsolve_triangular``, row by row, and bit
   for bit against a second call, with its byte bound and its sequential
   stages; the df64 triangle product (B10) on both df64 triangles of
   each, bit for bit against its plain version and a second call, timed
   on CVXQP3-L's, with its bound from the stored entries (AUG2D-L's are
   held in 17, where its f32 factor is built);
6. golden: CPMINRES on the shipped ``cvxqp1_m`` fixture in f64 on the card,
   53 +- 2 iterations and rel-err < 5e-6 against scipy ``spsolve``, its
   triangular solves in B9;
7. golden_mixed: ``solve_mixed`` on ``cvxqp1_m`` with f32 inner solves to
   1e-8, through the df64-applied factor (B9 in f32 and B10), rel-err <
   1e-7, <= 5 passes; run twice, and the two runs' inner counts must
   agree (no atomics);
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
   error bounds against scipy ``spsolve``; B9 held on each fixture's
   blocked triangles before its solves;
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

Between 10 and 11 run the phases of the Maros-Meszaros sweep and the
auxiliaries (the counters reset before each, their launches listed per
path):

16. mm_sweep: ``BASELINE.json`` configs[2], the six solvers at the JAX
   sweep's settings (``benchmarks/bench_mm_sweep.py:73-74, 141-155``) on
   AUG2D-L (``mm_setup``'s preconditioner), CVXQP1-L and CVXQP3-L, and
   CPMINRES on CVXQP2-L (all six with ``--full-sweep``); the first call,
   then the best of two warm calls; each row held to its record in
   ``benchmarks/MM_SWEEP_L.json`` (``solved``, iterations within
   max(2, 3 %), the error against scipy's ``spsolve`` within 1.1 x of the
   record's, exactly itmax iterations where unsolved), with its work-model
   nnz/s and its B4/B6/B9/B5 launches a solve; before its rows, each
   system's B4/B6 or B9 triangles and B5 operands are held against their
   plain versions at its own shapes, and a kernel a row launches must have
   been held;
17. mm_mixed: ``solve(..., dtype=torch.float32)`` on AUG2D-L and CVXQP3-L
   (the host outer loop, f32 preconditioners built from ``mm_setup``'s
   host LDL^T through the build probe and the df64 swap), solved to the
   f64 contract, within 10 x the f64 record's error, repeated bit for bit
   by a second run, B4/B6 launched in f32 on AUG2D-L; before the solves,
   B10 held bit for bit on both df64 triangles of each f32 factor (timed
   on AUG2D-L's); one direct solve of each f32 preconditioner profiled
   (its launches and idle share);
18. operator_a: ``BASELINE.json`` configs[3], CVXQP3-L with A given only as
   a callable (B5 on the card) and two forced refinement steps, within
   +-1 iteration and 1.1 x the error of the explicit-A solve;
19. checkpoint: CVXQP3-L's f64 and mixed f32 preconditioners saved,
   loaded into templates on the card and from the file alone (timed
   against the f64 build's LDL^T and packing), held bit for bit (direct
   solve, full solve);
20. subsystems: ``solve(debug=True)``, ``validate_system``,
   ``check_finite``, ``matmat`` of AUG2D-L's K_P against B5 column by
   column, and ``examples/exprog1_torch.py`` run to its end.

With ``--profile DIR`` it then profiles one more warm solve of each main
path, of both Maros-Meszaros systems, of the five further solvers on
the banded system and of the new paths of 16-18 under
``torch.profiler``, prints
the device's busy time and idle share inside the solve span of each trace
(``cpkrylov.solve``, and ``cpkrylov.solve_mixed`` with its device loop
``cpkrylov.mixed_loop``), and writes the main paths' traces (``profile_main.json``,
``profile_mixed.json``) and every run's per-op table (``.txt``) into DIR.

On the card every blocked triangular solve is one B9 launch and every
df64 triangle product one B10 launch: golden_mixed, mm_cvxqp3_l and
mm_mixed count the calls of ``cuda_block_tri.block_tri`` and
``cuda_df_tri.df_tri_matvec`` beside the launches and require them
equal, and the kernels line requires B9 launches on golden, mm_cvxqp3_l,
mm_sweep, operator_a and golden_solvers, and B10 on golden_mixed,
mm_mixed and checkpoint.  Every phase records the shapes of those calls
and fails if one of them was not held against the plain version earlier
in the run (B9: CVXQP3-L and cvxqp1_m in ``mm_kernels``, CVXQP1-L in
``mm_sweep``, cvxqp2_s in ``golden_solvers``; B10: CVXQP3-L and cvxqp1_m
in ``mm_kernels``, AUG2D-L in ``mm_mixed``).

Then a JSON line of per-kernel results (time and device time, plain
version's time, the bound from this run's shapes, the library call's time
and device time where one exists, launches per path), the card line from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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

# Blocked substitution (B9), on every blocked factor a path solves with.
# (1) Relative 2-norm against its plain version (which sums in torch's
# order) and against scipy's f64 ``spsolve_triangular``.  The factors
# carry element growth (solutions up to ~1.5e9 for a unit right-hand side
# at CVXQP3-L), which amplifies rounding.  On the H100 (700 W) B9 measured
# at most 6.5e-16 (f64) and 4.9e-7 (f32) from its plain version at
# CVXQP3-L, and 1.1e-13 (f64) and 5.5e-5 (f32) at cvxqp1_m's upper
# triangle; each bound is about 10x the larger card reading of its dtype.
# (2) A 2-norm over such an x is ruled by its few largest entries, so each
# solve is also held row by row (``block_tri_stage_error``): with rhs = b
# - off x and y = inv rhs evaluated in f64 from the solve's own x, every
# row's |x - y| over (|inv| (|b| + |off| |x|)).  Whatever its summation
# order, a solve keeps that below gamma_{p+K+1} = (p+K+1) u / (1 - (p+K+1)
# u) in its unit roundoff u (a dot product of at most K + 1 terms for the
# rhs, one of p for the panel); the limit is twice that, the second share
# for the check's own f64 rounding.  B9 also repeats its bits from call to
# call.
BLOCK_TOL = {"float32": 4e-4, "float64": 1e-12}
UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "float64": 2.0 ** -53}
# the panel above the old 1024 bound at which B9 is also held (cvxqp1_m)
WIDE_PANEL = 2048

# The shapes at which B9 (("block_tri", dtype, n, panel, nblocks, K)) and
# B10 (("df_tri_matvec", n, K)) were held against their plain versions in
# this run (``hold_block_tri``, ``hold_df_tri``).  Every phase runs inside
# ``counted_calls``, which records the shapes of its calls, and fails if it
# called either kernel at shapes not held (``_timed``).
HELD = set()

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
                      f"{_fmt(dia['device_ms'])} library_device_ms="
                      f"{_fmt(dia['library_device_ms'])}", flush=True)

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
                if n == 1_250_000 and not reverse:
                    lib = library_trisolve("B2 bidiagonal", T, tb, xk,
                                           SCAN_TOL[tname], device)
                    if dtype == torch.float64:
                        scan.update(lib)
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
                      f"device_ms={_fmt(dms)} read_floor_ms={fms:.4f} "
                      f"read_floor_device_ms={_fmt(fdms)} "
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
            print(f"kernel df_dia_spmv device_ms={_fmt(dfd['device_ms'])}",
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
    all, and a line says what was missing.  None when the trace kept no
    device record at all (seen on the H100 for a trace of 12 calls of a
    1 ms kernel late in this script): not measured."""
    traced = traced_kernels(fn, operands, iters)
    if not traced:
        print("device_ms: the trace kept no device record: not measured",
              flush=True)
        return None
    total = 0.0
    for name, (mean, count) in traced.items():
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
                      f"device_ms={_fmt(dms)} library_device_ms={_fmt(ldms)}",
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
    """B4 and B6 on both triangles of AUG2D-L's factor, f32 and f64, with
    the library call on L; B5 on AUG2D-L's K_P and CVXQP3-L's A, K_P and
    B' (``hold_csr_spmv``)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

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
    del U
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
            if label == "L":
                lib = library_trisolve("B4 AUG2D-L L", L1, bd, xk,
                                       BAND_TOL[tname], device)
                if dtype == torch.float64:
                    tri.update(lib)
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
                  f"plain_ms={pms:.4f} device_ms={_fmt(dms)} "
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
                  f"ms={sms:.4f} plain_ms={spms:.4f} device_ms={_fmt(sdms)} "
                  f"read_floor_ms={fms:.4f} read_floor_device_ms={_fmt(fdms)} "
                  f"read_floor_b4_scan_device_ms={_fmt(fbdms)} "
                  f"read_floor_GBps="
                  f"{nb * r * r * item / (fdms or fms) / 1e6:.1f} "
                  f"scan_layout={scan_layout(r, r, dtype)} "
                  f"W_tail_GB={nb * r * r * item / 1e9:.4f}", flush=True)
            if not serr <= BAND_TOL[tname]:
                raise RuntimeError(f"affine_scan {tname} {label}: error vs "
                                   f"plain {serr:.3e} > {BAND_TOL[tname]}")
            if dtype == torch.float64:
                scan["max_abs_err"] = max(scan["max_abs_err"], serr_abs)
            if label == "L":
                b4 = bound_ms(item * (nb * p * p + nb * p * r + 2 * tf.n),
                              2 * nb * (p * p + p * r + r * r), tname)
                b6 = bound_ms(item * (nb * r * r + 2 * nb * r),
                              2 * nb * r * r, tname)
                print(f"kernel band_tri {tname} bound_ms={b4[0]:.4f} "
                      f"({b4[1]}) affine_scan {tname} bound_ms="
                      f"{b6[0]:.4f} ({b6[1]})", flush=True)
            if label == "L" and dtype == torch.float64:
                tri["ms"], tri["plain_ms"], tri["device_ms"] = ms, pms, dms
                scan["device_ms"] = sdms
                tri["bound_ms"], tri["bound_by"] = b4
                scan["ms"], scan["plain_ms"] = sms, spms
                scan["bound_ms"], scan["bound_by"] = b6
            del c, mr, cr, sk, sp_, bd, fl, wfull
            if dtype == torch.float32:
                del tf
            torch.cuda.empty_cache()
        if label == "L":
            del L1
    csr = results["csr_spmv"]
    cvx, hq, _, _ = mm["cvxqp3_l"]
    for label, mat in (("K_P aug2d_l", hf.ksp), ("A cvxqp3_l", cvx.A),
                       ("K_P cvxqp3_l", hq.ksp),
                       ("Bt cvxqp3_l", cvx.B.T.tocsr())):
        got = hold_csr_spmv(label, mat, device)
        csr["max_abs_err"] = max(csr["max_abs_err"], got["max_abs_err"])
        if label == "K_P aug2d_l":
            csr.update({k: got[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "device_ms", "library_device_ms")})
    torch.cuda.empty_cache()
    phase_block_kernels(mm, device, results)


def phase_block_kernels(mm, device, results):
    """B9 on both triangles of CVXQP3-L's factor (69 panels, timed) and of
    cvxqp1_m's (22 panels, the golden paths'; and at panels of WIDE_PANEL),
    f64 and f32, against its plain version and scipy; B10 on both df64
    triangles of each (packed from the same host factor as an f32
    preconditioner packs them), bit for bit, timed on CVXQP3-L's, whose t1
    is also held with the special x[0] of DF_SPECIAL_X0.  AUG2D-L's df64
    triangles are held in ``mm_mixed``, where its f32 factor is built."""
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.cp import build_precond, factorize_kp
    from cpkrylov_tpu_torch.precond.df_factor import _pack_df_tri
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     build_block_tri)
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture

    blk = results["block_tri"]
    _, hf, M, _ = mm["cvxqp3_l"]
    fix = load_fixture("cvxqp1_m")
    hf1 = factorize_kp(fix.G, fix.B, fix.C)
    M1 = build_precond(hf1.fac, hf1.ksp, hf1.n, hf1.m,
                       options=cpt.PrecondOptions(), panel=256,
                       dtype=torch.float64, device=device,
                       base_order=hf1.base_order)
    for name, h, f in (("cvxqp3_l", hf, M.factor), ("cvxqp1_m", hf1,
                                                     M1.factor)):
        L1, U = triangles(h.fac, h.n + h.m)
        for label, tf, T in (("L", f.tf1, L1), ("U", f.tf2, U)):
            if not isinstance(tf, BlockTriFactor):
                raise RuntimeError(f"{name} {label}: factor is "
                                   f"{type(tf).__name__}, not blocked "
                                   "substitution")
            got = hold_block_tri(f"{name} {label}", tf, device, T=T,
                                 timing=name == "cvxqp3_l",
                                 library=name == "cvxqp3_l" and label == "L")
            blk["max_abs_err"] = max(blk["max_abs_err"],
                                     got["float64"]["max_abs_err"])
            if name == "cvxqp3_l" and label == "L":
                blk.update(got["float64"], launches_per_call=1)
        for tag, T in (("t1", L1), ("t2", U)):
            t = _pack_df_tri(T, device)
            hold_df_tri(f"{name} {tag}", t, device,
                        timing=name == "cvxqp3_l",
                        special=name == "cvxqp3_l" and tag == "t1")
            del t
        if name == "cvxqp1_m":
            # any panel (ROADMAP C.1): 3 panels of 2048 rows, rhs in
            # dynamic shared memory (16 KB in f64)
            for label, T in (("L", L1), ("U", U)):
                tf = build_block_tri(T, torch.float64, device,
                                     panel=WIDE_PANEL)
                hold_block_tri(f"{name} {label} panel={WIDE_PANEL}", tf,
                               device, T=T)
                del tf
        del L1, U
        torch.cuda.empty_cache()


def triangles(fac, N):
    """(L + I, J U J): the lower matrices that a factor's tf1 and, on the
    index reversal, its tf2 solve (and the df64 factor's t1 and t2 hold),
    as scipy CSR."""
    import numpy as np
    import scipy.sparse as sp

    L1 = (fac.L + sp.identity(N, format="csc")).tocsr()
    rev = np.arange(N - 1, -1, -1)
    return L1, L1.T.tocsr()[rev][:, rev].tocsr()


def _fmt(v) -> str:
    """A measured number, or "not measured" for None."""
    return "not measured" if v is None else f"{v:.4f}"


def block_tri_bound(tf):
    """(ms, "bytes" or "operations", bytes, off entries): the least time of
    one B9 solve.  Bytes: the lower triangles of the panel inverses, each
    off-panel entry once (value and int32 column), the row counts, b read
    and x written.  Operations: a multiply and an add for each of those
    matrix entries."""
    import torch

    item = tf.inv_diag.element_size()
    p, nb = tf.panel, tf.nblocks
    nnz = int(tf.off_counts.sum())
    tri = nb * p * (p + 1) // 2
    nbytes = item * tri + (item + 4) * nnz + 4 * nb * p + 2 * item * tf.n
    tname = "float64" if tf.inv_diag.dtype == torch.float64 else "float32"
    ms, by = bound_ms(nbytes, 2 * (tri + nnz), tname)
    return ms, by, nbytes, nnz


def df_tri_bound(t):
    """(ms, "bytes" or "operations", bytes, entries, slot ms): the least
    time of one B10 product, from the triangle's stored entries (the slots
    whose hi or lo is not zero; the product needs no padding).  Bytes: 12
    an entry (hi, lo, an int32 column), the x pair read and the y pair
    written; operations: the chain's 28 roundings an entry (two_prod 16,
    its error terms 4, two_sum 6, the lo sum 2).  The slot time is the
    (K, n) layout's read floor, 12 bytes a slot, padding included: what a
    kernel that walks every slot, as B10 does, cannot go below."""
    K, n = (int(v) for v in t.hi.shape)
    nnz = int(((t.hi != 0) | (t.lo != 0)).sum())
    nbytes = 12 * nnz + 16 * n
    ms, by = bound_ms(nbytes, 28 * nnz, "float32")
    return ms, by, nbytes, nnz, (12 * K * n + 16 * n) / HBM_BYTES_PER_S * 1e3


def block_tri_shape(tf, dtype) -> tuple:
    return ("block_tri", str(dtype).split(".")[1], tf.n, tf.panel,
            tf.nblocks, int(tf.off_data.shape[1]))


def df_tri_shape(t) -> tuple:
    return ("df_tri_matvec", t.n, int(t.hi.shape[0]))


def block_tri_stage_error(tf, b, x) -> float:
    """The largest row error of one blocked solve, stage by stage: with
    rhs = b - off x and y = inv rhs, both evaluated in f64 from the solve's
    own x, max over rows of |x - y| / (|inv| (|b| + |off| |x|)), the
    factor's values as the solve read them (BLOCK_TOL's note)."""
    import torch

    f64 = torch.float64
    p, nb = tf.panel, tf.nblocks
    xp = torch.zeros(nb * p, dtype=f64, device=x.device)
    bp = torch.zeros_like(xp)
    xp[:tf.n], bp[:tf.n] = x, b
    od, oc = tf.off_data.to(f64), tf.off_cols.long()
    rhs = bp - (od * xp[oc]).sum(dim=1)
    scale = bp.abs() + (od.abs() * xp.abs()[oc]).sum(dim=1)
    inv = tf.inv_diag.to(f64)
    y = torch.bmm(inv, rhs.view(nb, p, 1)).view(-1)
    den = torch.bmm(inv.abs(), scale.view(nb, p, 1)).view(-1)
    num = (xp - y).abs()
    ratio = torch.where(den > 0, num / den.clamp_min(1e-300),
                        torch.where(num > 0, float("inf"), 0.0))
    return float(ratio[:tf.n].max())


def block_tri_stage_limit(tf, tname: str) -> float:
    """Twice gamma_{p+K+1} in the solve's unit roundoff (BLOCK_TOL's
    note)."""
    m = (tf.panel + int(tf.off_data.shape[1]) + 1) * UNIT_ROUNDOFF[tname]
    return 2 * m / (1 - m)


def _operand_sets(nbytes, copy, base):
    """``base`` and copies of it (made by ``copy``), enough that the sets
    exceed the 50 MB L2 together."""
    return [base] + [copy() for _ in range(max(0, -(-60_000_000 // nbytes)
                                               - 1))]


# The first port of B5 (a thread a row) and an empty kernel, carried in
# tools/ to time B5 against in the same run and to read the launch floor;
# built beside the package's kernels (``start_rowthread_build``).
ROWTHREAD_SOURCE = os.path.join(ROOT, "tools", "csr_spmv_rowthread.cu")
ROWTHREAD_LIB = os.path.join(ROOT, "build", "csr_rowthread",
                             "libcsr_rowthread.so")
_ROWTHREAD = {}


def start_rowthread_build():
    """Start nvcc on ROWTHREAD_SOURCE (the package's flags), so that it
    runs beside the package's build; ``rowthread_library`` waits for it."""
    from cpkrylov_tpu_torch import _build

    os.makedirs(os.path.dirname(ROWTHREAD_LIB), exist_ok=True)
    _ROWTHREAD["proc"] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         ROWTHREAD_LIB, ROWTHREAD_SOURCE], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def rowthread_library():
    """The loaded library of ROWTHREAD_SOURCE (built now if not started)."""
    import ctypes

    if "lib" not in _ROWTHREAD:
        if "proc" not in _ROWTHREAD:
            start_rowthread_build()
        proc = _ROWTHREAD["proc"]
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {ROWTHREAD_SOURCE} failed:\n{out}")
        lib = ctypes.CDLL(ROWTHREAD_LIB)
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("csr_rowthread_f32", "csr_rowthread_f64"):
            getattr(lib, name).argtypes = [P, P, P, I64, P, P, P]
        lib.empty_launch.argtypes = [I32, I32, P]
        _ROWTHREAD["lib"] = lib
    return _ROWTHREAD["lib"]


def csr_rowthread(mat, x):
    """y = mat @ x by the thread-a-row kernel (no launch is counted)."""
    import torch

    lib = rowthread_library()
    y = torch.empty(mat.shape[0], dtype=x.dtype, device=x.device)
    fn = (lib.csr_rowthread_f64 if x.dtype == torch.float64
          else lib.csr_rowthread_f32)
    st = fn(mat.indptr.data_ptr(), mat.indices.data_ptr(),
            mat.data.data_ptr(), mat.shape[0], x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if st != 0:
        raise RuntimeError(f"csr_rowthread: CUDA error {st}")
    return y


def empty_launch(blocks: int, threads: int):
    import torch

    st = rowthread_library().empty_launch(
        blocks, threads, torch.cuda.current_stream().cuda_stream)
    if st != 0:
        raise RuntimeError(f"empty kernel: CUDA error {st}")


def hold_csr_spmv(what, mat, device) -> dict:
    """B5 on one scipy matrix, in f64 and f32: bit for bit against its
    plain version, the thread-a-row kernel and a second call, and to
    CSR_SCIPY_TOL against scipy's f64 product.  Timed in f64: ``ms``, ``plain_ms`` and ``library_ms`` (``torch.sparse.mm``) by
    CUDA events, and device ms a call from profiler traces (``device_ms``)
    of B5 and the thread-a-row kernel read in turns (B5, row, row, B5), with
    the matrix and x rotated past the L2 (copies of them) and warm (one
    operand set, as inside a solve), of the library call, and of an empty
    kernel on B5's grid (the launch floor); and the bound.  Returns the f64
    readings and the largest |kernel - plain|."""
    import numpy as np
    import torch

    from cpkrylov_tpu_torch.ops import cuda_spmv, formats
    from cpkrylov_tpu_torch.ops.cuda_spmv import csr_matvec_plain, csr_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    rng = np.random.default_rng(13)
    nrows, ncols = mat.shape
    got = cuda_spmv.layout()
    want = (formats.TILE_THREADS, formats.MAX_TILE, formats.TILE_HALO)
    if got != want:
        raise RuntimeError(f"csr_spmv: the kernel's tiles {got} are not the "
                           f"packing's {want}")
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).split(".")[1]
        c = csr_from_scipy(mat, dtype, device, transpose=False)
        x = torch.as_tensor(rng.standard_normal(ncols)).to(device=device,
                                                          dtype=dtype)
        yk, yk2 = csr_spmv(c, x), csr_spmv(c, x)
        yp, yr = csr_matvec_plain(c, x), csr_rowthread(c, x)
        torch.cuda.synchronize()
        err_abs = float(torch.max(torch.abs(yk - yp))) if nrows else 0.0
        exact = {"plain": torch.equal(yk, yp),
                 "repeat": torch.equal(yk, yk2),
                 "rowthread": torch.equal(yk, yr)}
        err_ref = rel_2norm(yk.double().cpu().numpy(),
                            mat @ x.double().cpu().numpy())
        line = (f"kernel csr_spmv {tname} {what} {nrows}x{ncols} "
                f"nnz={c.nnz} max_abs_err_vs_plain={err_abs:.3e} "
                f"equal={exact} rel_err_vs_scipy_f64={err_ref:.3e}")
        out["max_abs_err"] = max(out["max_abs_err"], err_abs)
        if dtype == torch.float64:
            # indptr, values and columns, x read, y written; 2 flops an entry
            bms, by = bound_ms(12 * c.nnz + 8 * (nrows + 1)
                               + 8 * (ncols + nrows), 2 * c.nnz, tname)
            ms = cuda_time_ms(lambda: csr_spmv(c, x))
            pms = cuda_time_ms(lambda: csr_matvec_plain(c, x), iters=20,
                               warmup=2)
            sa = torch_sparse_csr(mat, dtype, device)
            lms = cuda_time_ms(lambda: torch.sparse.mm(sa, x[:, None]))
            # copies of the matrix, so that the operand sets exceed the L2
            # together (AUG2D-L's K_P is 20 MB, CVXQP3-L's A 1 MB)
            sets = _operand_sets(
                12 * c.nnz + 8 * nrows + 8 * ncols,
                lambda: (csr_from_scipy(mat, dtype, device, transpose=False),
                         torch_sparse_csr(mat, dtype, device),
                         torch.randn_like(x)), (c, sa, x))
            warm = [sets[0]]
            blocks = c.tiles.shape[0] - 1

            def b5(c_, s_, v):
                return csr_spmv(c_, v)

            def row(c_, s_, v):
                return csr_rowthread(c_, v)

            turns = [device_ms(fn, sets) for fn in (b5, row, row, b5)]
            dms = _mean(turns[::3])
            rdms = _mean(turns[1:3])
            wdms = device_ms(b5, warm)
            wrdms = device_ms(row, warm)
            ldms = device_ms(lambda c_, s_, v: torch.sparse.mm(s_, v[:, None]),
                             sets)
            lwdms = device_ms(lambda c_, s_, v: torch.sparse.mm(s_, v[:, None]),
                              warm)
            fdms = device_ms(lambda c_, s_, v: empty_launch(
                blocks, formats.TILE_THREADS), warm)
            line += (f" bound_ms={bms:.4f} ({by}) ms={ms:.4f} "
                     f"plain_ms={pms:.4f} library_ms(torch.sparse.mm)="
                     f"{lms:.4f} device_ms={_fmt(dms)} "
                     f"turns(b5,row,row,b5)={[_fmt(v) for v in turns]} "
                     f"rowthread_device_ms={_fmt(rdms)} "
                     f"warm_device_ms={_fmt(wdms)} "
                     f"rowthread_warm_device_ms={_fmt(wrdms)} "
                     f"library_device_ms={_fmt(ldms)} "
                     f"library_warm_device_ms={_fmt(lwdms)} "
                     f"launch_floor_device_ms={_fmt(fdms)} "
                     f"(empty kernel, {blocks}x{formats.TILE_THREADS}) "
                     f"tile={c.tile} "
                     f"operand_sets={len(sets)}")
            out.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                       bound_by=by, device_ms=dms, library_device_ms=ldms,
                       warm_device_ms=wdms, rowthread_device_ms=rdms,
                       launch_floor_device_ms=fdms)
            del sets, warm, sa
        print(line, flush=True)
        if not all(exact.values()):
            raise RuntimeError(f"csr_spmv {tname} {what}: differs from "
                               f"{[k for k, v in exact.items() if not v]}")
        if not err_ref <= CSR_SCIPY_TOL[tname]:
            raise RuntimeError(f"csr_spmv {tname} {what}: error vs scipy "
                               f"{err_ref:.3e} > {CSR_SCIPY_TOL[tname]}")
        del c, x, yk, yk2, yp, yr
    return out


# The library call beside the triangle kernels B2, B4/B6 and B9:
# ``torch.triangular_solve`` on the triangle as a sparse CSR tensor, which on
# the card runs cuSPARSE's SpSV, its analysis on every call.  The bidiagonal
# and band triangles have ~1.25M and ~300k dependent levels, so a reading
# takes at most LIBRARY_TRI_CALLS calls after the first, and none where the
# first took longer than LIBRARY_TRI_CAP_S (it then stands alone, capped).
LIBRARY_TRI_CALLS = 3
LIBRARY_TRI_CAP_S = 5.0


def _events_and_device_ms(fn, calls: int):
    """(CUDA-event ms, device ms from a profiler trace) a call, over
    ``calls`` calls of ``fn`` in one trace, and the last call's result; the
    device ms is None where the trace kept no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            out = fn()
        stop.record()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total", None) or
          e.self_cuda_time_total for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA") and e.count]
    return (start.elapsed_time(stop) / calls,
            sum(us) / 1e3 / calls if us else None, out)


def library_trisolve(what, T, b, x_kernel, tol: float, device) -> dict:
    """``torch.triangular_solve(b[:, None], T, upper=False)`` with the lower
    scipy triangle ``T`` as a sparse CSR tensor on the card (b's dtype),
    held to ``tol`` (relative 2-norm) against the kernel's solution
    ``x_kernel``, so that a wrong call cannot pass for a time.  Returns
    ``library_ms`` (CUDA events) and ``library_device_ms`` (profiler; the
    analysis kernels included), each a call: over up to LIBRARY_TRI_CALLS
    calls after a first, or of the first alone where it took longer than
    LIBRARY_TRI_CAP_S."""
    import torch

    dtype = b.dtype
    tname = str(dtype).split(".")[1]
    A = torch_sparse_csr(T, dtype, device)
    warm = torch_sparse_csr(T[:2, :2], dtype, device)    # cuSPARSE's handle
    torch.triangular_solve(b[:2, None], warm, upper=False)
    torch.cuda.synchronize()

    def call():
        return torch.triangular_solve(b[:, None], A, upper=False)[0]

    t0 = time.perf_counter()
    ms, dms, x = _events_and_device_ms(call, 1)
    first_s = time.perf_counter() - t0
    err = rel_2norm(x[:, 0].double().cpu().numpy(),
                    x_kernel.double().cpu().numpy())
    calls = 1
    if first_s <= LIBRARY_TRI_CAP_S:
        calls = LIBRARY_TRI_CALLS
        ms, dms, _ = _events_and_device_ms(call, calls)
    print(f"library triangular_solve {tname} {what} n={T.shape[0]} "
          f"nnz={T.nnz} rel_err_vs_kernel={err:.3e} first_call_s="
          f"{first_s:.3f} library_ms={ms:.4f} library_device_ms={_fmt(dms)} "
          f"calls={calls}{' (capped)' if calls == 1 else ''}", flush=True)
    if not err <= tol:
        raise RuntimeError(f"torch.triangular_solve {tname} {what}: differs "
                           f"from the kernel by {err:.3e} > {tol}")
    del A
    torch.cuda.empty_cache()
    return {"library_ms": ms, "library_device_ms": dms}


def _mean(values):
    """The mean of the readings that were measured (None if none was)."""
    got = [v for v in values if v is not None]
    return sum(got) / len(got) if got else None


def hold_block_tri(what, tf64, device, T=None, dtypes=None,
                   timing=False, library=False) -> dict:
    """B9 on one triangle (a ``BlockTriFactor`` in f64), in each of
    ``dtypes`` (f64 and f32 unless given; the f32 factor holds the same
    numbers rounded once, as an f32 build packs them): against its plain
    version and, given the scipy matrix ``T``, scipy's f64
    ``spsolve_triangular``, both to BLOCK_TOL, row by row to
    ``block_tri_stage_limit``, and bit for bit against a second call; each
    held shape goes into HELD.  With ``timing``: ``ms`` and ``plain_ms`` (CUDA events),
    ``device_ms`` (profiler, the factor and copies of it rotated past the
    L2), the bound.  With ``library``, the library call on ``T``
    (``library_trisolve``), held to BLOCK_TOL against B9's solution.
    Returns those readings by dtype name."""
    import dataclasses

    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from cpkrylov_tpu_torch.precond.cuda_block_tri import (
        block_tri, block_tri_solve_plain, on_chip_fits)
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    rng = np.random.default_rng(17)
    # f32-representable, so that both dtypes solve the same system
    b64 = rng.standard_normal(tf64.n).astype(np.float32).astype(np.float64)
    ref = None
    if T is not None:
        t0 = time.perf_counter()
        ref = spla.spsolve_triangular(T, b64, lower=True)
        ref_s = time.perf_counter() - t0
    out = {}
    for dtype in dtypes or (torch.float64, torch.float32):
        tname = str(dtype).split(".")[1]
        tf = tf64 if dtype == tf64.inv_diag.dtype else dataclasses.replace(
            tf64, inv_diag=tf64.inv_diag.to(dtype),
            off_data=tf64.off_data.to(dtype))
        b = torch.as_tensor(b64).to(device=device, dtype=dtype)
        x, x2 = block_tri(tf, b), block_tri(tf, b)
        xp = block_tri_solve_plain(tf, b)
        torch.cuda.synchronize()
        repeat = torch.equal(x, x2)
        err_abs = float(torch.max(torch.abs(x - xp)))
        xk, xpn = x.double().cpu().numpy(), xp.double().cpu().numpy()
        err_plain = rel_2norm(xk, xpn)
        stage, stage_plain = (block_tri_stage_error(tf, b, v)
                              for v in (x, xp))
        stage_lim = block_tri_stage_limit(tf, tname)
        bms, by, nbytes, nnz = block_tri_bound(tf)
        line = (f"kernel block_tri {tname} {what} n={tf.n} "
                f"panel={tf.panel} nb={tf.nblocks} "
                f"K={tf.off_data.shape[1]} off_entries={nnz} "
                f"rel_err_vs_plain={err_plain:.3e} "
                f"max_abs_err_vs_plain={err_abs:.3e} "
                f"row_stage_err={stage:.3e} (plain {stage_plain:.3e}, "
                f"limit {stage_lim:.3e}) repeat_equal={repeat} "
                f"bound_ms={bms:.4f} ({by}) bytes={nbytes} "
                f"shape_sequential_stages={2 * tf.nblocks} "
                f"on_chip={on_chip_fits(tf, dtype, device)}")
        errs = [("plain", err_plain)]
        if ref is not None:
            err_ref = rel_2norm(xk, ref)
            line += (f" rel_err_vs_scipy_f64={err_ref:.3e} "
                     f"plain_rel_err_vs_scipy_f64={rel_2norm(xpn, ref):.3e} "
                     f"max_abs_x={np.max(np.abs(ref)):.3e} "
                     f"scipy_s={ref_s:.2f}")
            errs.append(("scipy", err_ref))
        got = dict(bound_ms=bms, bound_by=by, max_abs_err=err_abs)
        if timing:
            ms = cuda_time_ms(lambda: block_tri(tf, b), iters=50, warmup=3)
            pms = cuda_time_ms(lambda: block_tri_solve_plain(tf, b),
                               iters=5, warmup=1)
            sets = _operand_sets(nbytes, lambda: (dataclasses.replace(
                tf, inv_diag=tf.inv_diag.clone(),
                off_data=tf.off_data.clone(), off_cols=tf.off_cols.clone(),
                off_counts=tf.off_counts.clone()), torch.randn_like(b)),
                (tf, b))
            dms = device_ms(block_tri, sets, iters=48)
            per_panel = None if dms is None else 1e3 * dms / tf.nblocks
            line += (f" ms={ms:.4f} plain_ms={pms:.4f} "
                     f"device_ms={_fmt(dms)} "
                     f"per_panel_us={_fmt(per_panel)} launches_per_call=1 "
                     f"operand_sets={len(sets)}")
            got.update(ms=ms, plain_ms=pms, device_ms=dms,
                       per_panel_us=per_panel)
            del sets
        print(line, flush=True)
        if library:
            got.update(library_trisolve(what, T, b, x, BLOCK_TOL[tname],
                                        device))
        out[tname] = got
        if not repeat:
            raise RuntimeError(f"block_tri {tname} {what}: a second call "
                               "gave other bits")
        for against, e in errs:
            if not e <= BLOCK_TOL[tname]:
                raise RuntimeError(f"block_tri {tname} {what}: error vs "
                                   f"{against} {e:.3e} > {BLOCK_TOL[tname]}")
        if not stage <= stage_lim:
            raise RuntimeError(f"block_tri {tname} {what}: row error "
                               f"{stage:.3e} > {stage_lim:.3e}")
        HELD.add(block_tri_shape(tf, dtype))
    return out


def df_tri_walk(t) -> tuple:
    """Shape facts of a df64 triangle, counted from its inputs, not
    measured: (slots a walk of each row's stored slots and one padding slot
    takes, min(count + 1, K) a row; slot steps of warps of 32 consecutive
    rows, each as many as its longest row)."""
    import torch

    K = int(t.hi.shape[0])
    steps = torch.clamp(t.counts.long() + 1, max=K)
    pad = (-t.n) % 32
    warp = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32).amax(1)
    return int(steps.sum()), 32 * int(warp.sum())


# the values of x[0] (the column of every padding slot) at which B10 is held
# bit for bit beside a random x (``hold_df_tri(special=True)``)
DF_SPECIAL_X0 = (-0.0, 1e35, float("inf"))


def hold_df_tri(what, t, device, timing=False, special=False) -> dict:
    """B10 on one df64 triangle (``DFTriMat``): hi and lo bit for bit
    against its plain version and a second call; with ``special`` also with
    x[0] at each of DF_SPECIAL_X0 (NaNs compared by their bits); the held
    shape goes into HELD.  With ``timing``: ``ms`` and ``plain_ms`` (CUDA
    events), ``device_ms`` (profiler; the matrix and copies of it rotated
    past the L2 where it is smaller), the bound.  Returns those readings."""
    import dataclasses

    import numpy as np
    import torch

    from cpkrylov_tpu_torch.precond.cuda_df_tri import (df_tri_matvec,
                                                        df_tri_matvec_plain)
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    v = np.random.default_rng(19).standard_normal(t.n) * 10.0
    xh = torch.as_tensor(v.astype(np.float32), device=device)
    xl = torch.as_tensor((v - v.astype(np.float32)).astype(np.float32),
                         device=device)
    y, y2 = df_tri_matvec(t, (xh, xl)), df_tri_matvec(t, (xh, xl))
    yp = df_tri_matvec_plain(t, (xh, xl))
    torch.cuda.synchronize()
    exact = torch.equal(y[0], yp[0]) and torch.equal(y[1], yp[1])
    repeat = torch.equal(y[0], y2[0]) and torch.equal(y[1], y2[1])
    err_abs = max(float(torch.max(torch.abs(y[0] - yp[0]))),
                  float(torch.max(torch.abs(y[1] - yp[1]))))
    bms, by, nbytes, nnz, slot_ms = df_tri_bound(t)
    walked, warp_steps = df_tri_walk(t)
    K, n = (int(d) for d in t.hi.shape)
    line = (f"kernel df_tri_matvec float32 {what} K={K} n={n} "
            f"shape_slots={K * n} shape_entries={nnz} "
            f"shape_slots_to_walk={walked} "
            f"shape_warp_slot_steps={warp_steps} bitwise_vs_plain={exact} "
            f"repeat_equal={repeat} max_abs_err_vs_plain={err_abs:.3e} "
            f"bound_ms={bms:.4f} ({by}) bytes={nbytes} "
            f"slot_bound_ms={slot_ms:.4f}")
    special_ok = True
    if special:
        for x0 in DF_SPECIAL_X0:
            sh, sl = xh.clone(), xl.clone()
            sh[0] = x0
            sl[0] = x0 if x0 == 0 else 0.0
            a, c = df_tri_matvec(t, (sh, sl)), df_tri_matvec_plain(t,
                                                                   (sh, sl))
            torch.cuda.synchronize()
            ok = all(torch.equal(u.view(torch.int32), w.view(torch.int32))
                     for u, w in zip(a, c))
            special_ok &= ok
            line += f" bitwise_x0={x0}:{ok}"
    got = dict(bound_ms=bms, bound_by=by, max_abs_err=err_abs,
               slot_bound_ms=slot_ms)
    if timing:
        ms = cuda_time_ms(lambda: df_tri_matvec(t, (xh, xl)), iters=20,
                          warmup=2)
        pms = cuda_time_ms(lambda: df_tri_matvec_plain(t, (xh, xl)),
                           iters=2, warmup=1)
        sets = _operand_sets(nbytes, lambda: (dataclasses.replace(
            t, hi=t.hi.clone(), lo=t.lo.clone(), cols=t.cols.clone(),
            counts=t.counts.clone()), torch.randn_like(xh),
            torch.zeros_like(xl)), (t, xh, xl))
        dms = device_ms(lambda m, h, lo: df_tri_matvec(m, (h, lo)), sets,
                        iters=48)
        line += (f" ms={ms:.4f} plain_ms={pms:.4f} device_ms={_fmt(dms)} "
                 f"launches_per_call=1 operand_sets={len(sets)}")
        got.update(ms=ms, plain_ms=pms, device_ms=dms)
        del sets
    print(line, flush=True)
    if not (exact and repeat and special_ok):
        raise RuntimeError(f"df_tri_matvec {what}: differs from its plain "
                           "version or between calls")
    HELD.add(df_tri_shape(t))
    return got


@contextlib.contextmanager
def counted_calls(shapes=None, csr_operands=None):
    """Counts, while open, the blocked-substitution solves
    (``cuda_block_tri.block_tri``, which ``tri_solve`` calls) and the df64
    triangle products (``cuda_df_tri.df_tri_matvec``, which
    ``DFTriMat.matvec_df`` calls), whatever runs them: on the card each
    must be one launch of B9 or B10 (``check_calls``).  Adds the shape of
    each call to the set ``shapes`` when one is given, and counts the CSR
    products (B5) by operand, (rows, columns, entries), into the dict
    ``csr_operands`` when one is given."""
    from cpkrylov_tpu_torch.ops import cuda_spmv, spmv
    from cpkrylov_tpu_torch.precond import cuda_block_tri, cuda_df_tri

    calls = {"block_tri": 0, "df_tri_matvec": 0}
    solve, product = cuda_block_tri.block_tri, cuda_df_tri.df_tri_matvec
    csr = cuda_spmv.csr_spmv

    def count_csr(mat, x):
        key = (*mat.shape, mat.nnz)
        csr_operands[key] = csr_operands.get(key, 0) + 1
        return csr(mat, x)

    if csr_operands is not None:
        cuda_spmv.csr_spmv = spmv.csr_spmv = count_csr

    def count_solve(tf, b):
        calls["block_tri"] += 1
        if shapes is not None:
            shapes.add(block_tri_shape(tf, b.dtype))
        return solve(tf, b)

    def count_product(t, x):
        calls["df_tri_matvec"] += 1
        if shapes is not None:
            shapes.add(df_tri_shape(t))
        return product(t, x)

    cuda_block_tri.block_tri = count_solve
    cuda_df_tri.df_tri_matvec = count_product
    try:
        yield calls
    finally:
        cuda_block_tri.block_tri = solve
        cuda_df_tri.df_tri_matvec = product
        cuda_spmv.csr_spmv = spmv.csr_spmv = csr


def check_calls(what, calls, launches):
    """Each blocked solve and df64 product of a run was one launch."""
    for k, v in calls.items():
        if launches[k] != v:
            raise RuntimeError(f"{what}: {v} calls of {k} but "
                               f"{launches[k]} launches")


# scipy spsolve solutions of the Maros-Meszaros systems (the error
# oracle), by system name: each is computed once a run, in worker
# processes started with the phases (``start_oracles``), while the card
# runs the earlier phases
_ORACLES = {}
ORACLE_SYSTEMS = ("cvxqp3_l", "cvxqp1_l", "cvxqp2_l", "aug2d_l")


def _oracle_job(name):
    """(x, seconds) of scipy's ``spsolve`` of one Maros-Meszaros system,
    generated here from its definition (a worker process)."""
    import scipy.sparse.linalg as spla

    sysm = _mm_system(name)
    t0 = time.perf_counter()
    x = spla.spsolve(sysm.K.tocsc(), sysm.b)
    return x, time.perf_counter() - t0


def start_oracles():
    """Start the spsolve oracles in two spawned worker processes; returns
    the pool (shut down by the caller)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    for name in ORACLE_SYSTEMS:
        _ORACLES[name] = pool.submit(_oracle_job, name)
    return pool


def oracle(name):
    """(x, seconds) of scipy's ``spsolve`` of the system ``name``, from the
    worker ``start_oracles`` gave it."""
    got = _ORACLES[name]
    if not isinstance(got, tuple):
        got = _ORACLES[name] = got.result()
    return got


def phase_mm_solve(name, sysm, M, setup, device):
    """CPMINRES in f64 on one Maros-Meszaros system at the sweep's
    settings, the kernels' counters reset just before the solve."""
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops.formats import CSR
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor)
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    opts = cpt.SolverOptions(**MM_SOLVER)
    operands = {}
    reset_launches()
    with counted_calls(csr_operands=operands) as calls:
        out = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                        opts=opts, M=M, dtype=torch.float64, device=device)
    launches = launch_counts()
    check_calls(name, calls, launches)
    x = out.x.cpu().numpy()
    bnorm = float(np.linalg.norm(sysm.b))
    rnorm = float(np.linalg.norm(sysm.b - sysm.K @ x))
    contract = MM_SOLVER["atol"] + MM_SOLVER["rtol"] * bnorm
    x_direct, direct_s = oracle(name)
    err = rel_2norm(x, x_direct)
    hist = out.resid_history
    f = M.factor
    print(f"{name} cpminres f64 n={sysm.n} m={sysm.m} solved={out.solved} "
          f"iters={out.niters} true_resid={rnorm:.4e} "
          f"true_rel_resid={rnorm / bnorm:.3e} "
          f"contract(atol+rtol*|b|)={contract:.4e} "
          f"contract_met={rnorm <= contract} "
          f"true_resid_over_contract={rnorm / contract:.4f} "
          f"err_vs_spsolve={err:.4e} (JAX record "
          f"{MM_RECORD[name][2]:.4e}, spsolve_s={direct_s:.2f}) "
          f"precond_resid={hist[-1]:.4e}/{hist[0]:.4e} "
          f"tf={type(f.tf1).__name__}(panel={f.tf1.panel}) "
          f"A={type(getattr(out.A_op, 'mat', None)).__name__} "
          f"kp={type(M.kp).__name__} "
          f"generate_s={setup['generate_s']:.2f} ldl_s={setup['ldl_s']:.2f} "
          f"pack_s={setup['pack_s']:.2f} stime_s={out.stime:.4f} "
          f"ms_per_iter={1e3 * out.stime / max(out.niters, 1):.3f} "
          f"launches={launches} "
          f"csr_spmv_by_operand(rows,cols,nnz)={operands}", flush=True)
    if sum(operands.values()) != launches["csr_spmv"]:
        raise RuntimeError(f"{name}: {sum(operands.values())} CSR products "
                           f"but {launches['csr_spmv']} B5 launches")
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
    elif launches["block_tri"] < 2 * out.niters:
        raise RuntimeError(f"cvxqp3_l: block_tri launched "
                           f"{launches['block_tri']} times")
    if not err <= MM_ORACLE_SLACK * oracle_record:
        raise RuntimeError(f"{name}: error against spsolve {err:.4e}, the "
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
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True, itref_tol=1e-8)
    reset_launches()
    out = cpt.solve("cpminres", fix.b, fix.A, fix.B, fix.C, fix.G,
                    device=device, dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500),
                    precond_opts=popts)
    launches = launch_counts()
    x_ref = spla.spsolve(fix.K.tocsc(), fix.b)
    rel = float(np.linalg.norm(out.x.cpu().numpy() - x_ref)
                / np.linalg.norm(x_ref))
    print(f"golden cvxqp1_m cpminres f64 solved={out.solved} "
          f"iters={out.niters} rel_err={rel:.3e} "
          f"stime_s={out.stime:.4f} launches={launches}", flush=True)
    if not (out.solved and abs(out.niters - 53) <= 2 and rel < 5e-6):
        raise RuntimeError("golden cvxqp1_m check failed")
    if launches["block_tri"] < 2 * out.niters:
        raise RuntimeError("golden: the triangular solves did not go "
                           "through B9")
    return launches


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
        with counted_calls() as calls:
            out = cpt.solve_mixed(
                "cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, M=M32,
                device=device,
                opts=cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
                precond_opts=popts)
        launches = launch_counts()
        check_calls("golden_mixed", calls, launches)
        if launches["df_tri_matvec"] < 2 * out.niters:
            raise RuntimeError("golden_mixed: the df64 triangle products "
                               "did not go through B10")
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
    (RCM gather ordering, CSR products of B5); before a fixture's solves,
    B9 is held on its factor's blocked triangles.  Returns the launches
    summed over the solves."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.trisolve import BlockTriFactor
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
        for label, tf in (("L", M.factor.tf1), ("U", M.factor.tf2)):
            if isinstance(tf, BlockTriFactor):
                hold_block_tri(f"golden_solvers {fixture} {label}", tf,
                               device, dtypes=(torch.float64,))
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


# ---------------------------------------------------------------------------
# Maros-Meszaros sweep, mixed f32, operator-only A, checkpoint, subsystems
# ---------------------------------------------------------------------------

# The JAX sweep's settings (benchmarks/bench_mm_sweep.py:73-74, 141-155):
# all six solvers, atol = rtol = 1e-6, itmax 1000, restart = mem = 50,
# ``make_preconditioner`` defaults, f64; the first call, then the best of
# two warm calls.  Each row is held to its record in MM_SWEEP_L.json (the
# JAX package on a CPU): the same ``solved`` flag, iterations within
# max(2, 3 % of the record), the error against spsolve within 1.1 x the
# record where solved, and exactly itmax iterations with a non-solved
# status where not.
SWEEP_RECORDS = os.path.join("benchmarks", "MM_SWEEP_L.json")
SWEEP_SOLVER = dict(atol=1e-6, rtol=1e-6, itmax=1000, restart=50, mem=50)
SWEEP_SOLVERS = ("cpcg", "cpcglanczos", "cpminres", "cpsymmlq", "cpgmres",
                 "cpdqgmres")
SWEEP_ITERS = (2, 0.03)
# (record name, system name, solvers of the default run); --full-sweep
# runs all six on every system
SWEEP_PROBLEMS = (("aug2d_316", "aug2d_l", SWEEP_SOLVERS),
                  ("cvxqp1_10000", "cvxqp1_l", SWEEP_SOLVERS),
                  ("cvxqp2_10000", "cvxqp2_l", ("cpminres",)),
                  ("cvxqp3_10000", "cvxqp3_l", SWEEP_SOLVERS))
# mm_mixed: the f32 solve is held to 10 x the f64 JAX record's error
# against spsolve (MM_RECORD): f32 counts follow the rounding, and
# MM_SWEEP_M_F32.json is a TPU record at cvxqp*_1000, not these sizes.
MIXED_MM_SLACK = 10.0
# operator_a: CVXQP3-L with A as a callable, GHN and two forced
# refinement steps (BASELINE.json configs[3]), against the explicit A
OPERATOR_A_POPTS = dict(residual_update=True, nitref=2, force_itref=True)


def _mm_system(name):
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt

    if name == "aug2d_l":
        return aug_kkt("2d", "l")
    return cvxqp_kkt(name[:-2], "l")


def _sweep_check(rec, solver, out, err):
    import numpy as np

    want, slack = rec["iters"], max(SWEEP_ITERS[0],
                                    SWEEP_ITERS[1] * rec["iters"])
    what = f"mm_sweep {rec['problem']} {solver}"
    x = out.x.cpu().numpy()
    if not np.all(np.isfinite(x)):
        raise RuntimeError(f"{what}: the solution is not finite")
    if bool(out.solved) != bool(rec["solved"]):
        raise RuntimeError(f"{what}: solved={out.solved}, the record "
                           f"{rec['solved']}")
    if abs(out.niters - want) > slack:
        raise RuntimeError(f"{what}: {out.niters} iterations, the record "
                           f"{want} +- {slack:.1f}")
    # unsolved rows too: a wrong preconditioner also runs to itmax
    if not err <= MM_ORACLE_SLACK * rec["oracle_rel_err"]:
        raise RuntimeError(f"{what}: error against spsolve {err:.4e}, the "
                           f"record {rec['oracle_rel_err']:.4e}")
    if not rec["solved"] and (out.niters != SWEEP_SOLVER["itmax"]
                              or out.istatus == 0):
        raise RuntimeError(f"{what}: unsolved after {out.niters} "
                           f"iterations, status {out.istatus}")


def _hold_sweep_kernels(prob, sysm, M, device):
    """The kernels of a sweep system's solves at its own shapes, each held
    against its plain version on the same inputs in f64 (the sweep's
    dtype): B4 and B6 on each triangle of ``M`` in the reduced-scan form
    (to BAND_TOL; B6 alone on the triangle's scan operands), B9 on each
    triangle in blocked substitution (to BLOCK_TOL, and bit for bit
    against a second call), and B5 on A,
    B (both directions) and a CSR K_P, bit for bit and repeatable.  Returns
    the names of the kernels held."""
    import numpy as np
    import torch

    from cpkrylov_tpu_torch.ops.cuda_spmv import (csr_matvec_plain,
                                                  csr_rmatvec, csr_spmv)
    from cpkrylov_tpu_torch.ops.formats import CSR, csr_from_scipy
    from cpkrylov_tpu_torch.precond.cuda_tri import (affine_scan,
                                                     affine_scan_plain,
                                                     band_tri_solve,
                                                     band_tri_solve_plain,
                                                     scan_layout)
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor)

    f64 = torch.float64
    rng = np.random.default_rng(13)

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n), dtype=f64,
                               device=device)

    held = set()
    for label, tf in (("L", M.factor.tf1), ("U", M.factor.tf2)):
        if not isinstance(tf, ReducedScanTriFactor):
            continue
        p, r, nb = tf.panel, tf.r, tf.nblocks
        b = vec(tf.n)
        xk, xk2 = band_tri_solve(tf, b), band_tri_solve(tf, b)
        xp = band_tri_solve_plain(tf, b)
        c = torch.zeros(nb * p, dtype=f64, device=device)
        c[:tf.n] = b
        c = torch.bmm(tf.inv_diag, c.view(nb, p, 1)).view(nb, p)
        mr = (-tf.w_blocks[:, p - r:, :]).permute(1, 2, 0)
        cr = c[:, p - r:].T
        sk, sp_ = affine_scan(mr, cr), affine_scan_plain(mr, cr)
        torch.cuda.synchronize()
        err = rel_2norm(xk.cpu().numpy(), xp.cpu().numpy())
        serr = rel_2norm(sk.cpu().numpy(), sp_.cpu().numpy())
        print(f"mm_sweep {prob} kernel band_tri float64 {label} n={tf.n} "
              f"panel={p} r={r} nb={nb} rel_err_vs_plain={err:.3e} "
              f"repeat_equal={torch.equal(xk, xk2)} "
              f"scan_layout={scan_layout(p, r, f64)} affine_scan "
              f"rel_err_vs_plain={serr:.3e} "
              f"scan_layout={scan_layout(r, r, f64)}", flush=True)
        if not (err <= BAND_TOL["float64"] and serr <= BAND_TOL["float64"]
                and torch.equal(xk, xk2)):
            raise RuntimeError(f"mm_sweep {prob} {label}: B4 or B6 differs "
                               "from its plain version")
        held |= {"band_tri", "affine_scan"}
    for label, tf in (("L", M.factor.tf1), ("U", M.factor.tf2)):
        if isinstance(tf, BlockTriFactor):
            hold_block_tri(f"mm_sweep {prob} {label}", tf, device,
                           dtypes=(f64,))
            held.add("block_tri")
    mats = [("A", csr_from_scipy(sysm.A, f64, device)),
            ("B", csr_from_scipy(sysm.B, f64, device))]
    if isinstance(M.kp, CSR):
        mats.append(("K_P", M.kp))
    for label, mat in mats:
        x, y = vec(mat.shape[1]), vec(mat.shape[0])
        checks = [("matvec", lambda: csr_spmv(mat, x),
                   csr_matvec_plain(mat, x))]
        if mat.t is not None:
            checks.append(("rmatvec", lambda: csr_rmatvec(mat, y),
                           csr_matvec_plain(mat.t, y)))
        for how, kernel, plain in checks:
            yk, yk2 = kernel(), kernel()
            torch.cuda.synchronize()
            err_abs = float(torch.max(torch.abs(yk - plain)))
            print(f"mm_sweep {prob} kernel csr_spmv float64 {label} {how} "
                  f"{mat.shape[0]}x{mat.shape[1]} nnz={mat.nnz} "
                  f"max_abs_err_vs_plain={err_abs:.3e} "
                  f"repeat_equal={torch.equal(yk, yk2)}", flush=True)
            if err_abs != 0.0 or not torch.equal(yk, yk2):
                raise RuntimeError(f"mm_sweep {prob} {label} {how}: B5 "
                                   "differs from its plain version")
        held.add("csr_spmv")
    return held


def phase_mm_sweep(mm, device, full: bool, card: str):
    """BASELINE.json configs[2] on the card: the six solvers at the JAX
    sweep's settings on AUG2D-L (the preconditioner of ``mm_setup``, timed
    by ``solve`` and priced by ``work_model``) and on CVXQP1-L, CVXQP2-L
    (CPMINRES alone unless ``full``) and CVXQP3-L (``profile_solve``, which
    builds its own preconditioner).  Returns the launches summed over the
    rows."""
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    profile_solve,
                                                    reset_launches,
                                                    work_model)

    with open(os.path.join(ROOT, SWEEP_RECORDS)) as fh:
        records = {(r["problem"], r["kernel"]): r
                   for r in json.load(fh)["rows"]}
    opts = cpt.SolverOptions(**SWEEP_SOLVER)
    total = {}
    for prob, name, default in SWEEP_PROBLEMS:
        if name in mm:
            sysm, _, M, setup = mm[name]
        else:
            t0 = time.perf_counter()
            sysm, M = _mm_system(name), None
            print(f"mm_sweep {prob} generate_s="
                  f"{time.perf_counter() - t0:.2f}", flush=True)
        x_direct, direct_s = oracle(name)
        held = _hold_sweep_kernels(prob, sysm, M if M is not None else
                                   cpt.make_preconditioner(
                                       sysm.G, sysm.B, sysm.C,
                                       dtype=torch.float64, device=device),
                                   device)
        for solver in (SWEEP_SOLVERS if full else default):
            rec = records[(prob, solver)]
            reset_launches()
            if name == "aug2d_l":
                # profile_solve would build a second 5.7 GiB factor: the
                # rows share mm_setup's, timed here as profile_solve does
                def call():
                    return cpt.solve(solver, sysm.b, sysm.A, sysm.B, sysm.C,
                                     sysm.G, opts=opts, M=M,
                                     dtype=torch.float64, device=device)
                t0 = time.perf_counter()
                call()
                first_s = time.perf_counter() - t0
                stime = float("inf")
                for _ in range(2):
                    t0 = time.perf_counter()
                    out = call()
                    stime = min(stime, time.perf_counter() - t0)
                work = work_model(M, sysm.A.nnz, sysm.C.nnz)
                ptime = setup["ldl_s"] + setup["pack_s"]    # in mm_setup
            else:
                prof = profile_solve(solver, sysm.b, sysm.A, sysm.B, sysm.C,
                                     sysm.G, opts=opts, repeats=2,
                                     device=device, dtype=torch.float64)
                out, work = prof.output, prof.work
                first_s, stime, ptime = (prof.compile_time, prof.stime,
                                         prof.ptime)
            launches = launch_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            per_solve = {k: v / 3 for k, v in launches.items()}
            err = rel_2norm(out.x.cpu().numpy(), x_direct)
            print(f"mm_sweep {prob} {solver} f64 N={sysm.n + sysm.m} "
                  f"solved={out.solved} iters={out.niters} "
                  f"istatus={out.istatus} (record {rec['iters']}, "
                  f"solved={rec['solved']}) err_vs_spsolve={err:.4e} "
                  f"(record {rec['oracle_rel_err']:.4e}, spsolve_s="
                  f"{direct_s:.2f}) ptime_s={ptime:.3f} "
                  f"first_s={first_s:.4f} stime_s={stime:.4f} "
                  f"iters_per_s={out.niters / stime:.1f} "
                  f"nnz_per_s={out.niters * work.nnz_per_iter / stime:.4g} "
                  f"nnz_per_iter={work.nnz_per_iter:.6g} "
                  f"band_tri={per_solve['band_tri']:.1f} "
                  f"affine_scan={per_solve['affine_scan']:.1f} "
                  f"block_tri={per_solve['block_tri']:.1f} "
                  f"csr_spmv={per_solve['csr_spmv']:.1f} (a solve) "
                  f"card=\"{card}\"", flush=True)
            _sweep_check(rec, solver, out, err)
            unheld = [k for k in ("band_tri", "affine_scan", "block_tri",
                                  "csr_spmv")
                      if launches[k] and k not in held]
            if unheld:
                raise RuntimeError(f"mm_sweep {prob} {solver}: {unheld} "
                                   "launched but not held against the plain "
                                   "version at this system's shapes")
            if launches["csr_spmv"] == 0:
                raise RuntimeError(f"mm_sweep {prob} {solver}: no B5 launch")
            if name == "aug2d_l":
                for kname in ("band_tri", "affine_scan"):
                    if per_solve[kname] < 2 * out.niters:
                        raise RuntimeError(
                            f"mm_sweep {prob} {solver}: {kname} launched "
                            f"{per_solve[kname]:.1f} times a solve")
        torch.cuda.empty_cache()
    return total


def _profile_once(fn, span: str):
    """``device_profile`` of one call of ``fn`` inside a span of its own
    (synchronized at its end): (profile, fn's result)."""
    import torch

    from cpkrylov_tpu_torch.utils.profiling import device_profile

    res = []

    def run():
        with torch.profiler.record_function(span):
            res.append(fn())
            torch.cuda.synchronize()

    return device_profile(run, span=span), res[0]


def phase_mm_mixed(mm, device, card: str, results):
    """ROADMAP A.2 on the card: ``solve(..., dtype=torch.float32)`` of
    AUG2D-L and CVXQP3-L with CPMINRES, to atol = rtol = 1e-6 on the f64
    true residual.  The f32 preconditioner comes from ``mm_setup``'s host
    LDL^T by the route ``make_preconditioner`` takes at f32 (the build
    probe and the df64 swap).  The blocks are not DIA, so ``refine="auto"``
    takes ``solve_mixed``'s host loop.  A second run through
    ``solve_mixed`` itself must repeat the first bit for bit: here for
    AUG2D-L, and in ``phase_checkpoint`` for CVXQP3-L, whose second run
    (about 45 s of df64 triangle products) goes through its reloaded
    preconditioner.  One direct solve of each f32 preconditioner is
    profiled: the df64 triangle product's launches and the device's idle
    share.  Before the solves, B10 is held bit for bit on each f32
    factor's two df64 triangles (timed on AUG2D-L's, the kernels line's
    entry).  Returns (launches of the first runs, {name: (M32, first
    run's output)})."""
    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond import ldl_host
    from cpkrylov_tpu_torch.precond.cp import build_precond
    from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
    from cpkrylov_tpu_torch.precond.trisolve import ReducedScanTriFactor
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    opts = cpt.SolverOptions(**MM_SOLVER)
    total, kept = {}, {}
    dft = results["df_tri_matvec"]
    for name in ("aug2d_l", "cvxqp3_l"):
        sysm, hf, _, _ = mm[name]
        t0 = time.perf_counter()
        M32 = build_precond(hf.fac, hf.ksp, hf.n, hf.m,
                            options=cpt.PrecondOptions(), panel=256,
                            dtype=torch.float32, device=device,
                            base_order=hf.base_order)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        f = M32.factor
        t1 = getattr(f, "t1", None)
        # the build probe's first reading, of the plain f32 factor: above
        # 1e-2 it swaps in the df64-applied factor and probes that
        z = np.random.default_rng(0).standard_normal(hf.n + hf.m)
        y = ldl_host.solve_host(hf.fac, z, dtype=np.float32)
        plain_probe = float(np.linalg.norm(
            hf.ksp @ np.asarray(y, np.float64) - z) / np.linalg.norm(z))
        print(f"mm_mixed {name} f32 factor={type(f).__name__} "
              f"plain_f32_probe={plain_probe:.4e} "
              f"probe_rel={M32.probe_rel:.4e} "
              f"tf1={type(f.tf1).__name__}(panel={f.tf1.panel}, "
              f"r={getattr(f.tf1, 'r', None)}, "
              f"dtype={str(f.tf1.inv_diag.dtype)[6:]}) "
              f"df64_ell_slots={None if t1 is None else t1.hi.shape[0]} "
              f"build_s={build_s:.2f} device_gib="
              f"{torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)
        if not isinstance(f, DFFactorApply):
            raise RuntimeError(f"mm_mixed {name}: the df64-applied factor "
                               "is not engaged")
        for tag, t in (("t1", f.t1), ("t2", f.t2)):
            got = hold_df_tri(f"mm_mixed {name} {tag}", t, device,
                              timing=name == "aug2d_l")
            dft["max_abs_err"] = max(dft["max_abs_err"], got["max_abs_err"])
            if name == "aug2d_l" and tag == "t1":
                dft.update(got, launches_per_call=1)
        torch.cuda.empty_cache()
        x_direct, _ = oracle(name)
        bnorm = float(np.linalg.norm(sysm.b))
        contract = MM_SOLVER["atol"] + MM_SOLVER["rtol"] * bnorm

        reset_launches()
        with counted_calls() as calls:
            out = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                            sysm.G, opts=opts, M=M32, dtype=torch.float32,
                            device=device)
        launches = launch_counts()
        check_calls(f"mm_mixed {name}", calls, launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        x = out.x.cpu().numpy()
        rnorm = float(np.linalg.norm(sysm.b - sysm.K @ x))
        err = rel_2norm(x, x_direct)
        print(f"mm_mixed {name} cpminres f32-inner f64-outer "
              f"solved={out.solved} nouter={len(out.resid_history) - 1} "
              f"niters={out.niters} true_resid={rnorm:.4e} "
              f"contract={contract:.4e} err_vs_spsolve={err:.4e} (f64 JAX "
              f"record {MM_RECORD[name][2]:.4e}) stime_s={out.stime:.3f} "
              f"launches={launches} card=\"{card}\"", flush=True)
        if not (out.solved and np.all(np.isfinite(x))):
            raise RuntimeError(f"mm_mixed {name}: not solved "
                               f"(status {out.istatus})")
        if not rnorm <= contract:
            raise RuntimeError(f"mm_mixed {name}: true residual "
                               f"{rnorm:.4e} > {contract:.4e}")
        if not err <= MIXED_MM_SLACK * MM_RECORD[name][2]:
            raise RuntimeError(f"mm_mixed {name}: error against spsolve "
                               f"{err:.4e} > {MIXED_MM_SLACK} x the record")
        if name == "aug2d_l":
            reset_launches()
            again = cpt.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B,
                                    sysm.C, sysm.G, opts=opts, M=M32,
                                    device=device)
            check_repeat(f"mm_mixed {name}", out, launches, again,
                         launch_counts())
        if launches["csr_spmv"] == 0:
            raise RuntimeError(f"mm_mixed {name}: no B5 launch")
        if launches["df_tri_matvec"] < 2 * out.niters:
            raise RuntimeError(f"mm_mixed {name}: the df64 triangle "
                               f"products did not go through B10 "
                               f"({launches})")
        if name == "aug2d_l":
            f32_band = all(isinstance(t, ReducedScanTriFactor)
                           and t.inv_diag.dtype == torch.float32
                           for t in (f.tf1, f.tf2))
            if not (f32_band and launches["band_tri"] >= 2 * out.niters
                    and launches["affine_scan"] >= 2 * out.niters):
                raise RuntimeError(f"mm_mixed aug2d_l: B4/B6 not launched "
                                   f"in f32 ({launches})")
        # direct solves of the f32 preconditioner, profiled: ten in one
        # span (a trace may lose its first few device records, which would
        # be all of one ~5 ms solve), reported a solve
        z = torch.as_tensor(np.random.default_rng(0).standard_normal(
            sysm.n + sysm.m), dtype=torch.float32, device=device)
        M32._direct_solve(z)
        reset_launches()
        reps = 10
        prof, _ = _profile_once(
            lambda: [M32._direct_solve(z) for _ in range(reps)],
            "cpkrylov.direct_solve")
        counts = {k: v / reps for k, v in launch_counts().items()}
        print(f"mm_mixed {name} a direct solve (f32, df64-applied; mean of "
              f"{reps} in one span) span_wall_ms={prof.wall_ms / reps:.3f} "
              f"device_busy_ms={prof.busy_ms / reps:.3f} "
              f"idle_share={prof.idle_share:.4f} "
              f"launches={prof.launches / reps:.1f} "
              f"device_ops={prof.device_ops / reps:.1f} "
              f"band_tri={counts['band_tri']:.0f} "
              f"affine_scan={counts['affine_scan']:.0f} "
              f"block_tri={counts['block_tri']:.0f} "
              f"df_tri_matvec={counts['df_tri_matvec']:.0f} "
              f"csr_spmv={counts['csr_spmv']:.0f} card=\"{card}\"",
              flush=True)
        kept[name] = (M32, out, launches)
        torch.cuda.empty_cache()
    return total, kept


def check_repeat(what, out, launches, again, again_launches):
    """A second mixed run (``MixedSolveOutput``) against the first
    (``SolveOutput``): the same passes, iterations, x bit for bit and
    launches; prints the second run's inner counts."""
    import numpy as np

    x = out.x.cpu().numpy()
    same = (again.nouter == len(out.resid_history) - 1
            and again.niters == out.niters and np.array_equal(again.x, x)
            and again_launches == launches)
    print(f"{what} second run: nouter={again.nouter} "
          f"inner={list(again.inner_niters)} niters={again.niters} "
          f"stime_s={again.stime:.3f} x_bitwise="
          f"{np.array_equal(again.x, x)} launches_equal="
          f"{again_launches == launches}", flush=True)
    if not same:
        raise RuntimeError(f"{what}: the second run differs from the first")


def phase_operator_a(mm, device, card: str):
    """BASELINE.json configs[3] on the card: CVXQP3-L with A given only as
    a callable (the port's CSR product of A, kernel B5, on the card), GHN
    and two forced refinement steps, held to the explicit-A solve with the
    same options: iterations within +-1 and the error against spsolve
    within 1.1 x.  Returns the operator solve's launches."""
    import dataclasses

    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import cuda_spmv, spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    sysm, _, M, _ = mm["cvxqp3_l"]
    Mo = dataclasses.replace(M, options=cpt.PrecondOptions(
        **OPERATOR_A_POPTS))
    opts = cpt.SolverOptions(**MM_SOLVER)
    A_dev = csr_from_scipy(sysm.A, dtype=torch.float64, device=device,
                           transpose=False)
    seen = {"calls": 0, "b5": 0}

    def amv(v):
        before = cuda_spmv.LAUNCHES
        y = spmv.matvec(A_dev, v)
        seen["calls"] += 1
        seen["b5"] += cuda_spmv.LAUNCHES - before
        return y

    A_op = cpt.aslinearoperator(amv, shape=sysm.A.shape)
    reset_launches()
    out = cpt.solve("cpminres", sysm.b, A_op, sysm.B, sysm.C, sysm.G,
                    opts=opts, M=Mo, dtype=torch.float64, device=device)
    launches = launch_counts()
    ref = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                    opts=opts, M=Mo, dtype=torch.float64, device=device)
    x_direct, _ = oracle("cvxqp3_l")
    x = out.x.cpu().numpy()
    err = rel_2norm(x, x_direct)
    err_ref = rel_2norm(ref.x.cpu().numpy(), x_direct)
    print(f"operator_a cvxqp3_l cpminres f64 A=callable "
          f"popts={OPERATOR_A_POPTS} solved={out.solved} "
          f"iters={out.niters} (explicit A {ref.niters}) "
          f"err_vs_spsolve={err:.4e} (explicit A {err_ref:.4e}) "
          f"stime_s={out.stime:.4f} (explicit A {ref.stime:.4f}) "
          f"callable_calls={seen['calls']} callable_b5={seen['b5']} "
          f"launches={launches} card=\"{card}\"", flush=True)
    if not (out.solved and ref.solved and np.all(np.isfinite(x))):
        raise RuntimeError("operator_a: not solved")
    if abs(out.niters - ref.niters) > 1:
        raise RuntimeError(f"operator_a: {out.niters} iterations against "
                           f"{ref.niters} with the explicit A")
    if not err <= MM_ORACLE_SLACK * err_ref:
        raise RuntimeError(f"operator_a: error {err:.4e} against "
                           f"{err_ref:.4e} with the explicit A")
    if seen["calls"] < out.niters or seen["b5"] != seen["calls"]:
        raise RuntimeError(f"operator_a: the callable ran {seen['calls']} "
                           f"times with {seen['b5']} B5 launches")
    return launches


def phase_checkpoint(mm, kept, device, card: str):
    """``save_pytree`` / ``load_pytree`` on the card: CVXQP3-L's f64
    preconditioner (``mm_setup``) and its mixed f32 one (``mm_mixed``),
    each loaded into a template on the card and from the file alone (the
    load a new process makes, timed beside the f64 build's LDL^T and
    packing), and held to the original: the direct solve of both loads
    bit for bit on a fixed vector, and, through the load without a
    template, the same iterations and a bit-identical x in a full solve
    (for the f32 one, the mixed
    solve's second run through ``solve_mixed``, held to ``mm_mixed``'s
    first run with the same launches).  AUG2D-L's 5.7 GiB factor is left
    out.  Returns the launches of the reloaded solves."""
    import tempfile

    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils.checkpoint import load_pytree, save_pytree
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    sysm, _, M64, setup = mm["cvxqp3_l"]
    M32, out32, launches32 = kept["cvxqp3_l"]
    opts = cpt.SolverOptions(**MM_SOLVER)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, M, dtype in (("f64", M64, torch.float64),
                              ("f32", M32, torch.float32)):
            path = os.path.join(tmp, f"cvxqp3_l_{tag}.npz")
            build_s = setup["ldl_s"] + setup["pack_s"]
            build = f"build_s(ldl+pack)={build_s:.3f}" if tag == "f64" else ""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_pytree(M, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Mt = load_pytree(M, path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            # the file alone, as a new process would load it: this one
            # runs the solve below
            t0 = time.perf_counter()
            M2 = load_pytree(None, path, device=device)
            torch.cuda.synchronize()
            alone_s = time.perf_counter() - t0
            z = torch.as_tensor(np.random.default_rng(7).standard_normal(
                M.n + M.m), dtype=dtype, device=device)
            want = M._direct_solve(z)
            same_direct = (torch.equal(want, M2._direct_solve(z))
                           and torch.equal(want, Mt._direct_solve(z)))
            on_card = all(t.device.type == "cuda" for t in (
                M2.kp.data, M2.factor.dinv, Mt.kp.data, Mt.factor.dinv))
            reset_launches()
            if tag == "f64":
                got = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                                sysm.G, opts=opts, M=M2, dtype=dtype,
                                device=device)
                launches = launch_counts()
                ref = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                                sysm.G, opts=opts, M=M, dtype=dtype,
                                device=device)
                same = (torch.equal(got.x, ref.x) and got.solved
                        and got.niters == ref.niters)
                iters = (got.niters, ref.niters)
            else:
                got = cpt.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B,
                                      sysm.C, sysm.G, opts=opts, M=M2,
                                      device=device)
                launches = launch_counts()
                check_repeat("mm_mixed cvxqp3_l (reloaded preconditioner)",
                             out32, launches32, got, launches)
                same, iters = True, (got.niters, out32.niters)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            print(f"checkpoint cvxqp3_l {tag} "
                  f"factor={type(M.factor).__name__} "
                  f"file_mib={os.path.getsize(path) / 2**20:.1f} "
                  f"save_s={save_s:.3f} load_s={load_s:.3f} "
                  f"load_without_template_s={alone_s:.3f} "
                  f"{build} "
                  f"on_card={on_card} direct_solve_bitwise={same_direct} "
                  f"iters={iters[0]} (original {iters[1]}) "
                  f"x_bitwise={same} card=\"{card}\"", flush=True)
            if not (on_card and same_direct and same):
                raise RuntimeError(f"checkpoint {tag}: the reloaded "
                                   "preconditioner differs")
            del M2, Mt
    return total


def phase_subsystems(mm, device, card: str):
    """The auxiliaries on the card: ``solve(debug=True)`` on cvxqp1_m with
    the count of the plain solve, ``validate_system`` rejecting a bad B,
    ``check_finite`` on the output, ``matmat`` of AUG2D-L's K_P on a block
    of 4 columns against 4 B5 products, and ``examples/exprog1_torch.py``
    run to its end.  Returns the launches of the debug solve and the
    block product."""
    import tempfile

    import numpy as np
    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import spmv
    from cpkrylov_tpu_torch.ops.formats import CSR
    from cpkrylov_tpu_torch.utils.debug import (ValidationError,
                                                check_finite)
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    fix = load_fixture("cvxqp1_m")
    kw = dict(device=device, dtype=torch.float64,
              opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500),
              precond_opts=cpt.PrecondOptions(residual_update=True, nitref=1,
                                              force_itref=True))
    reset_launches()
    out = cpt.solve("cpminres", fix.b, fix.A, fix.B, fix.C, fix.G,
                    debug=True, **kw)
    plain = cpt.solve("cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, **kw)
    check_finite(out)
    try:
        cpt.solve("cpminres", fix.b, fix.A, fix.B[:, :-1], fix.C, fix.G,
                  debug=True, **kw)
        rejected = False
    except ValidationError:
        rejected = True
    kp = mm["aug2d_l"][2].kp
    if not isinstance(kp, CSR):
        raise RuntimeError(f"AUG2D-L's K_P is {type(kp).__name__}")
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (kp.shape[1], 4)), device=device)
    Y = spmv.matmat(kp, X)
    cols = torch.stack([spmv.matvec(kp, X[:, j].contiguous())
                        for j in range(4)], dim=1)
    mm_err = rel_max(Y, cols)
    launches = launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [sys.executable,
             os.path.join(ROOT, "examples", "exprog1_torch.py")],
            capture_output=True, text=True, timeout=600, cwd=tmp)
    ex_s = time.perf_counter() - t0
    ex_lines = [ln for ln in res.stdout.splitlines()
                if ln.startswith(("solved", "iterations", "rel. error"))]
    print(f"subsystems debug_solve iters={out.niters} (plain "
          f"{plain.niters}) check_finite=ok bad_B_rejected={rejected} "
          f"matmat_kp_4cols_rel_err={mm_err:.3e} exprog1_torch rc="
          f"{res.returncode} s={ex_s:.1f} {ex_lines} card=\"{card}\"",
          flush=True)
    if not (out.solved and out.niters == plain.niters):
        raise RuntimeError("subsystems: solve(debug=True) differs")
    if not rejected:
        raise RuntimeError("subsystems: validate_system let a bad B pass")
    if not mm_err <= CSR_SCIPY_TOL["float64"]:
        raise RuntimeError(f"subsystems: matmat differs by {mm_err:.3e}")
    if res.returncode != 0 or not any(
            ln.split(":")[1].split()[0] == "True" for ln in ex_lines
            if ln.startswith("solved")):
        raise RuntimeError(f"subsystems: exprog1_torch.py failed: "
                           f"{res.stderr[-2000:]}")
    return launches


def kernel_entry(name: str, source: str, replaces: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"cpkrylov_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": 0.0, "library_ms": None}


def phase_profile_mm(mm, kept, device, outdir):
    """With ``--profile``: one profiled run of the sweep's CPMINRES rows on
    CVXQP1-L and CVXQP2-L, of the operator-only A, of the whole mixed f32
    solves of AUG2D-L and CVXQP3-L (``mm_mixed``'s preconditioners) and of
    ``golden_mixed``'s solve: span wall, device busy time, idle share and
    launches an iteration, and the per-op tables (``.txt``) in DIR.  (Before
    B9 and B10 a mixed AUG2D-L solve held about 1.2M launches, too many
    to trace; ``mm_mixed`` still profiles one direct solve of each.)"""
    import dataclasses

    import torch

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture
    from cpkrylov_tpu_torch.utils.profiling import (MIXED_SPAN, SOLVE_SPAN,
                                                    device_profile)

    os.makedirs(outdir, exist_ok=True)
    runs = {}
    for name in ("cvxqp1_l", "cvxqp2_l"):
        sysm = _mm_system(name)
        M = cpt.make_preconditioner(sysm.G, sysm.B, sysm.C, device=device)
        runs["mm_sweep_" + name] = (SOLVE_SPAN, lambda s=sysm, M=M: cpt.solve(
            "cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device=device,
            dtype=torch.float64, opts=cpt.SolverOptions(**SWEEP_SOLVER)))
    sysm, _, M, _ = mm["cvxqp3_l"]
    A_dev = csr_from_scipy(sysm.A, dtype=torch.float64, device=device,
                           transpose=False)
    A_op = cpt.aslinearoperator(lambda v: spmv.matvec(A_dev, v),
                                shape=sysm.A.shape)
    Mo = dataclasses.replace(M, options=cpt.PrecondOptions(
        **OPERATOR_A_POPTS))
    runs["operator_a"] = (SOLVE_SPAN, lambda: cpt.solve(
        "cpminres", sysm.b, A_op, sysm.B, sysm.C, sysm.G, M=Mo,
        device=device, dtype=torch.float64,
        opts=cpt.SolverOptions(**MM_SOLVER)))
    for name in ("aug2d_l", "cvxqp3_l"):
        msys, M32 = mm[name][0], kept[name][0]
        runs["mm_mixed_" + name] = (
            MIXED_SPAN, lambda s=msys, M32=M32: cpt.solve_mixed(
                "cpminres", s.b, s.A, s.B, s.C, s.G, M=M32, device=device,
                opts=cpt.SolverOptions(**MM_SOLVER)))
    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    Mg = cpt.make_preconditioner(fix.G, fix.B, fix.C, options=popts,
                                 dtype=torch.float32, device=device)
    runs["golden_mixed"] = (MIXED_SPAN, lambda: cpt.solve_mixed(
        "cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, M=Mg, device=device,
        opts=cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
        precond_opts=popts))
    for name, (span, fn) in runs.items():
        warm = fn()                 # warm; its stime is unprofiled
        outs = []
        prof = device_profile(lambda: outs.append(fn()), span=span)
        with open(os.path.join(outdir, f"profile_{name}.txt"), "w") as fh:
            fh.write(prof.table)
        iters = max(outs[0].niters, 1)
        print(f"profile {name} span={span} iters={outs[0].niters} "
              f"span_wall_ms={prof.wall_ms:.4f} "
              f"device_busy_ms={prof.busy_ms:.4f} "
              f"idle_share={prof.idle_share:.4f} "
              f"device_ops={prof.device_ops} launches={prof.launches} "
              f"launches_per_iter={prof.launches / iters:.1f} "
              f"stime_s={outs[0].stime:.4f} "
              f"warm_stime_s={warm.stime:.4f}", flush=True)
        if prof.device_ops == 0:
            raise RuntimeError(f"the profiled {name} run shows no device "
                               "activity")


def _timed(name, fn, *args):
    """``fn(*args)``, with a line of its wall seconds; fails if the phase
    called B9 or B10 at shapes where it was not held against its plain
    version in this run (HELD)."""
    seen = set()
    t0 = time.perf_counter()
    with counted_calls(seen):
        out = fn(*args)
    print(f"phase {name} seconds={time.perf_counter() - t0:.1f} "
          f"b9_b10_shapes={sorted(seen)}", flush=True)
    if seen - HELD:
        raise RuntimeError(f"phase {name}: B9 or B10 called at shapes never "
                           f"held against its plain version: "
                           f"{sorted(seen - HELD)}")
    return out


def run_phases(device, profile_dir=None, full_sweep=False) -> list:
    """Phases 3-20 (and the profile when asked); returns the kernels' JSON
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
        "block_tri": kernel_entry(
            "block_tri", "block_tri.cu",
            "cpkrylov_tpu/precond/trisolve.py:156 (XLA loop)"),
        "df_tri_matvec": kernel_entry(
            "df_tri_matvec", "df_tri_matvec.cu",
            "cpkrylov_tpu/precond/df_factor.py:67 (XLA loop)"),
    }
    t0 = time.perf_counter()
    sysm = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3)
    print(f"fixture banded 1000000x250000 seconds="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    _timed("kernels", phase_kernels, sysm, device, results)
    mm = _timed("mm_setup", phase_mm_setup, device)
    _timed("mm_kernels", phase_mm_kernels, mm, device, results)
    torch.cuda.empty_cache()
    # the golden solve first among the solves: it also brings up the
    # libraries (cuBLAS for the dot products) that a process's first solve
    # initializes
    by_path = {"golden": _timed("golden", phase_golden, device)}
    by_path["golden_mixed"] = _timed("golden_mixed", phase_golden_mixed,
                                     device)
    by_path["main_path"], M = _timed("main_path", phase_main_path, sysm,
                                     device)
    by_path["main_mixed"], M32 = _timed("main_mixed", phase_main_mixed,
                                        sysm, device)
    by_path["solvers_banded"] = _timed("solvers_banded",
                                       phase_solvers_banded, sysm, M, device)
    for name in ("aug2d_l", "cvxqp3_l"):
        msys, _, mM, setup = mm[name]
        by_path[name] = _timed("mm_" + name, phase_mm_solve, name, msys, mM,
                               setup, device)
    card = nvidia_smi_card()
    by_path["mm_sweep"] = _timed("mm_sweep", phase_mm_sweep, mm, device,
                                 full_sweep, card)
    by_path["mm_mixed"], kept = _timed("mm_mixed", phase_mm_mixed, mm,
                                       device, card, results)
    by_path["operator_a"] = _timed("operator_a", phase_operator_a, mm,
                                   device, card)
    by_path["checkpoint"] = _timed("checkpoint", phase_checkpoint, mm, kept,
                                   device, card)
    by_path["subsystems"] = _timed("subsystems", phase_subsystems, mm,
                                   device, card)
    if profile_dir:
        phase_profile_mm(mm, kept, device, profile_dir)
    del kept
    torch.cuda.empty_cache()
    by_path["golden_solvers"] = _timed("golden_solvers",
                                       phase_golden_solvers, device)
    by_path.update(_timed("dist", phase_dist, sysm, M, device))
    if profile_dir:
        _timed("profile", phase_profile, sysm, device, M, M32, mm,
               profile_dir)

    # the paths each of B9 and B10 must carry (by_path's keys)
    need = {"block_tri": ("golden", "cvxqp3_l", "mm_sweep", "operator_a",
                          "golden_solvers"),
            "df_tri_matvec": ("golden_mixed", "mm_mixed", "checkpoint")}
    kernels = []
    for name, res in results.items():
        entry = dict(res)
        counts = {p: c.get(name, 0) for p, c in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if entry["launches"] == 0:
            raise RuntimeError(f"{name} was launched no time on the paths")
        if name in ("interleave", "uninterleave") and not all(
                counts[p] > 0 for p in ("main_path", "main_mixed",
                                        "solvers_banded")):
            raise RuntimeError(f"{name} missing on a banded path: {counts}")
        if not all(counts[p] > 0 for p in need.get(name, ())):
            raise RuntimeError(f"{name} missing on one of {need[name]}: "
                               f"{counts}")
        kernels.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_by_path", "launches_per_call", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "read_floor_ms", "read_floor_device_ms",
            "slot_bound_ms", "per_panel_us")
            if k in entry})
    return kernels


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one more main-path solve into DIR")
    ap.add_argument("--full-sweep", action="store_true",
                    help="run all six solvers on CVXQP2-L in mm_sweep "
                         "(1000 iterations each)")
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
    start_rowthread_build()
    print(f"build seconds={_build.build_kernels():.2f} "
          f"dir={os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)

    t0 = time.perf_counter()
    pool = start_oracles()
    try:
        kernels = run_phases(device, args.profile, args.full_sweep)
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"phases seconds={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
