"""Top-level driver: build the constraint preconditioner, shift the RHS,
run the kernel, un-shift — the reg_cpkrylov equivalent.

Port of ``cpkrylov_tpu/driver.py`` for the six kernels of ``solvers/``
in the solve's own dtype:
  * build and time the preconditioner (reg_cpkrylov.m:128-132),
  * shift the system so the RHS becomes [b1'; 0] when b2 != 0 (l.152-160),
  * run the kernel (l.163), un-shift (l.166-173), attach ptime/stime.

Explicit host blocks are moved to ``device`` once per call: by default A
and B as DIA when their natural-order diagonals pass the fill gate
(``ops/dia.py``, kernel B1), else CSR (kernel B5, with B's transpose for
``B'y``); C = delta*I as ``Diagonal``.  ``spmv_format`` forces a layout.
``refine=`` routes the solve through the mixed-precision outer refinement
(``mixed.solve_mixed``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from .config import PrecondOptions, SolverOptions
from .operators.linop import aslinearoperator
from .ops.dia import MAX_FILL_RATIO, pack_dia
from .precond.cp import (CPPrecond, check_spmv_format,
                        make_preconditioner)
from .solvers import SOLVERS
from .solvers.common import KrylovResult
from .utils.device import resolve_device, torch_dtype
from .utils.profiling import SOLVE_SPAN
from .utils.timing import sync


@dataclasses.dataclass(frozen=True)
class SolveOutput:
    """Driver output: combined solution + stats (reg_cpkrylov.m:107-117)."""

    x: torch.Tensor            # (n+m,) combined solution, on the device
    x1: torch.Tensor           # (n,)
    x2: torch.Tensor           # (m,)
    niters: int
    resid_history: np.ndarray  # NaN-trimmed
    solved: bool
    istatus: int
    ptime: float               # preconditioner build seconds
    stime: float               # solve seconds
    result: KrylovResult       # full kernel result
    A_op: object               # the device operator A was applied through


def _device_operand(X, dtype, device, spmv_format: str = "auto"):
    """Explicit host block -> device operator, by ``spmv_format`` (as
    ``precond.cp.pack_device_format`` lays out K_P): "auto" packs
    natural-order DIA when it passes the fill gate, "dia" without the
    gate, and a diagonal block under "auto" and every block under "csr"
    or "pgell" take Diagonal/CSR (aslinearoperator).  Anything else (a
    container, a tensor, a callable) is wrapped as it is."""
    if sp.issparse(X) or isinstance(X, np.ndarray):
        is_diag = (X.shape[0] == X.shape[1]
                   and sp.issparse(X) and X.nnz <= X.shape[0])
        if spmv_format == "dia" or (spmv_format == "auto" and not is_diag):
            packed = pack_dia(X, dtype=dtype, device=device,
                              max_fill_ratio=(0.0 if spmv_format == "dia"
                                              else MAX_FILL_RATIO))
            if packed is not None:
                return aslinearoperator(packed)
    return aslinearoperator(X, dtype=dtype, device=device)


def _solve_core(method: str, b, A_op, C_op, B_op, M: CPPrecond,
                opts: SolverOptions, shift: bool):
    """Shift -> kernel -> un-shift (reg_cpkrylov.m:152-173)."""
    n, m = M.n, M.m
    mstate = M.init_state(b.dtype)
    if shift:
        # xy0 = M * [0; b2]; b1' = b1 - A*xy0_1 - B'*xy0_2
        mstate, xy0, _ = M.apply(
            mstate, torch.cat([torch.zeros(n, dtype=b.dtype,
                                           device=b.device), b[n:]]))
        b1 = b[:n] - A_op.matvec(xy0[:n]) - B_op.rmatvec(xy0[n:])
    else:
        xy0 = torch.zeros(n + m, dtype=b.dtype, device=b.device)
        b1 = b[:n]
    res = SOLVERS[method](b1, A_op, C_op, M, opts, mstate, B=B_op)
    x1 = xy0[:n] + res.x if shift else res.x
    x2 = xy0[n:] + res.y if shift else res.y
    return res, x1, x2


def solve(method, b, A, B, C, G, *,
          opts: SolverOptions | None = None,
          precond_opts: PrecondOptions | None = None,
          backend: str = "auto", ordering="auto", panel: int = 256,
          spmv_format: str = "auto", tile_rows: int = 2048,
          dtype=None, device=None, M: CPPrecond | None = None,
          refine: bool | str = "auto", debug: bool = False) -> SolveOutput:
    """Solve the regularized saddle-point system [A B'; B -C] [x1;x2] = b.

    ``method`` is a kernel name ("cpminres", "cpcg", "cpcglanczos",
    "cpsymmlq", "cpgmres", "cpdqgmres") or the kernel function.  ``A`` may
    be a matrix or an operator; B, C, G must be explicit host matrices
    since they form the preconditioner.  Every vector, operator and factor
    lives on ``device``: the CUDA card by default, "cpu" on request; the
    card without CUDA raises.  ``dtype`` defaults to the rhs dtype.  Pass
    ``M`` to reuse a built preconditioner.

    ``spmv_format`` sets the device layout of A, B and K_P: "auto" (DIA
    where the natural-order diagonals pass the fill gate, else CSR), "dia"
    (DIA without the gate), "csr" or "pgell" (CSR: kernel B5, the port of
    the PGELL kernel).  ``tile_rows``, the height of PGELL pages, exists
    only on a TPU and has no effect here.

    ``refine`` controls the mixed-precision outer refinement: f32 solves
    become the inner loop of a true-residual refinement (``solve_mixed``)
    that reaches the f64 contract.  "auto" enables it exactly for f32
    solves on a CUDA device with explicit host blocks; True/False force it.

    ``debug=True`` validates the blocks' structure
    (``utils.debug.validate_system``) before any factorization, and checks
    that the solution is finite (``utils.debug.check_finite``, which raises
    FloatingPointError) after the solve.
    """
    opts = opts or SolverOptions()
    if callable(method):
        method = method.__name__
    if method not in SOLVERS:
        raise ValueError(f"unknown solver {method!r}")
    check_spmv_format(spmv_format)
    device = resolve_device(device)
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
    b = np.asarray(b).reshape(-1)
    if debug:
        from .utils.debug import validate_system
        validate_system(A, B, C, G, b)
    dtype = torch_dtype(dtype if dtype is not None else b.dtype)
    n = A.shape[0]
    m = C.shape[0]
    if b.shape[0] != n + m:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")

    if refine == "auto":
        refine = (dtype == torch.float32 and device.type == "cuda"
                  and all(sp.issparse(X) or isinstance(X, np.ndarray)
                          for X in (A, B, C, G)))
    if refine:
        from .mixed import solve_mixed
        from .solvers.common import STATUS_SOLVED, STATUS_STAGNATED

        mout = solve_mixed(method, b, A, B, C, G, opts=opts,
                           precond_opts=precond_opts, backend=backend,
                           ordering=ordering, panel=panel, M=M,
                           spmv_format=spmv_format, tile_rows=tile_rows,
                           device=device)
        last = mout.inner_outputs[-1] if mout.inner_outputs else None
        x = torch.as_tensor(mout.x).to(device)
        if debug:
            from .utils.debug import check_finite
            check_finite(x, "solution")
        return SolveOutput(
            x=x, x1=x[:n], x2=x[n:], niters=mout.niters,
            resid_history=np.asarray(mout.resid_history),
            solved=bool(mout.solved),
            istatus=(STATUS_SOLVED if mout.solved else
                     (last.istatus if last is not None
                      else STATUS_STAGNATED)),
            ptime=mout.ptime, stime=mout.stime,
            result=last.result if last is not None else None,
            A_op=last.A_op if last is not None else None)

    t0 = time.perf_counter()
    if M is None:
        M = make_preconditioner(G, B, C, options=precond_opts,
                                backend=backend, ordering=ordering,
                                panel=panel, spmv_format=spmv_format,
                                dtype=dtype, device=device)
    ptime = time.perf_counter() - t0

    A_op = _device_operand(A, dtype, device, spmv_format)
    C_op = aslinearoperator(C, dtype=dtype, device=device)
    B_op = _device_operand(B, dtype, device, spmv_format)
    shift = bool(np.any(b[n:]))                     # reg_cpkrylov.m:154
    b_dev = torch.as_tensor(b).to(device=device, dtype=dtype)
    sync(device)

    t1 = time.perf_counter()
    with torch.profiler.record_function(SOLVE_SPAN):
        res, x1, x2 = _solve_core(method, b_dev, A_op, C_op, B_op, M, opts,
                                  shift)
        sync(device)
    stime = time.perf_counter() - t1

    if debug:
        from .utils.debug import check_finite
        check_finite((x1, x2), "solution")
    return SolveOutput(
        x=torch.cat([x1, x2]), x1=x1, x2=x2, niters=res.niters,
        resid_history=res.trimmed_history(), solved=res.solved,
        istatus=res.istatus, ptime=ptime, stime=stime, result=res,
        A_op=A_op)
