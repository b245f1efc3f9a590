"""Distributed mixed precision: f32 inner solves on row shards, f64 outer
refinement on the host.

Counterpart of ``cpkrylov_tpu/parallel/mixed.py``.  The serial host loop
(``mixed.solve_mixed``) recovers f64 accuracy from f32 solves by Krylov-
accelerated iterative refinement; here each inner solve is a full
:func:`~.solve.dist_solve` in f32 (halo-exchange SpMVs, all-reduced dots,
the distributed Schur preconditioner), and every rank accumulates the f64
solution and computes the f64 TRUE residual on the host from the gathered
correction, so all ranks take the same decisions.  The f32 preconditioner
and the partition plan are built once per call and reused by its passes;
nothing is cached across calls, and a caller that solves several
right-hand sides with one matrix (an interior-point code's predictor and
corrector) builds the preconditioner once and passes it as ``M``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import PrecondOptions, SolverOptions
from ..mixed import (INNER_RTOL, MixedSolveOutput, _as_host_matrix,
                     _lean_inner_options)
from ..utils.device import torch_dtype


def build_dist_precond(G, B, C, comm, *,
                       precond_opts: PrecondOptions | None = None,
                       panel: int = 256, dtype=torch.float32):
    """The preconditioner the distributed paths prefer: this rank's Schur
    factor when the system's profile permits chunked partitioning, else
    the replicated serial factor.  Every rank takes the same branch (the
    Schur plan's checks are global)."""
    from ..precond.cp import make_preconditioner
    from .schur import plan_schur_precond

    dtype = torch_dtype(dtype)
    if comm.size > 1:
        try:
            return plan_schur_precond(G, B, C, comm, options=precond_opts,
                                      panel=min(panel, 128), dtype=dtype)
        except ValueError:
            pass
    return make_preconditioner(G, B, C, options=precond_opts, panel=panel,
                               dtype=dtype, device=comm.device)


def dist_solve_mixed(comm, method, b, A, B, C, G, *,
                     opts: SolverOptions | None = None,
                     precond_opts: PrecondOptions | None = None,
                     inner_rtol: float = INNER_RTOL,
                     inner_stagwin: int = 30,
                     max_outer: int = 40,
                     lean_inner: bool = True,
                     panel: int = 256, halo: bool = True,
                     M=None) -> MixedSolveOutput:
    """Sharded solve of [A B'; B -C][x1; x2] = b to f64 accuracy with f32
    work on ``comm``'s ranks (every rank calls it with the same system).

    Outer contract: ``||b - K x||_2 <= atol + rtol * ||b||_2`` with the f64
    TRUE residual (stronger than the kernels' preconditioned recurrence
    criterion, cpminres.m:234-236); at most ``max_outer`` passes.
    ``inner_rtol``, ``inner_stagwin`` and ``lean_inner`` act as in
    ``mixed.solve_mixed``; ``halo`` as in ``plan_dist``.  ``M``: an f32
    preconditioner built before (``build_dist_precond(..., dtype=
    torch.float32)``, the same on every rank); the call then builds none,
    no host factorization and no packing, and ``ptime`` covers the
    partition plan alone."""
    from .solve import dist_solve, plan_dist

    opts = opts or SolverOptions()
    t_all = time.perf_counter()
    A_h = _as_host_matrix(A, "A")
    B_h = _as_host_matrix(B, "B")
    C_h = _as_host_matrix(C, "C")
    n, m = A_h.shape[0], C_h.shape[0]
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if b.shape[0] != n + m:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")

    def kmatvec(x):
        x1, x2 = x[:n], x[n:]
        return np.concatenate([A_h @ x1 + B_h.T @ x2, B_h @ x1 - C_h @ x2])

    t0 = time.perf_counter()
    M32 = M if M is not None else build_dist_precond(
        G, B, C, comm, precond_opts=precond_opts, panel=panel,
        dtype=torch.float32)
    if hasattr(M32, "factor_nitref"):
        M32 = _lean_inner_options(M32, lean_inner)
    plan = plan_dist(A, B, C, comm, dtype=torch.float32, halo=halo,
                     G=G if getattr(M32.factor, "has_shard_plan", False)
                     else None)
    ptime = time.perf_counter() - t0

    inner_opts = dataclasses.replace(opts, atol=0.0, rtol=inner_rtol,
                                     stagwin=inner_stagwin, reorth=True)
    bnorm = float(np.linalg.norm(b))
    stop = opts.atol + opts.rtol * bnorm

    x = np.zeros(n + m)
    r = b.copy()
    rnorm = bnorm
    history = [rnorm]
    inner_iters = []
    solved = rnorm <= stop
    stagnant = 0
    stagwin_cur = inner_stagwin
    for _ in range(max_outer):
        if solved:
            break
        # Adaptive per-pass target for a factor exact at f32, capped by
        # inner_rtol and rounded down to a power of ten, as in
        # mixed.solve_mixed.
        if getattr(M32, "factor_exact", False) and stop > 0:
            t_pass = min(inner_rtol, max(0.3 * stop / rnorm, 1e-7))
            t_pass = 10.0 ** np.floor(np.log10(max(t_pass, 1e-7)))
            inner_opts = dataclasses.replace(inner_opts, rtol=float(t_pass))
        res, x1c, x2c = dist_solve(
            comm, method, (r / rnorm).astype(np.float32), A, B, C, G,
            opts=inner_opts, M=M32, plan=plan, dtype=torch.float32)
        inner_iters.append(int(res.niters))
        d = torch.cat([x1c, x2c]).cpu().numpy().astype(np.float64)
        x = x + rnorm * d
        r = b - kmatvec(x)
        new_norm = float(np.linalg.norm(r))
        history.append(new_norm)
        solved = new_norm <= stop
        stagnant = stagnant + 1 if new_norm > 0.5 * rnorm else 0
        rnorm = max(new_norm, np.finfo(np.float64).tiny)
        if stagnant >= 2:
            # widen the inner stagnation window (x4, up to 512) before
            # giving up, as in mixed.solve_mixed
            if stagwin_cur and stagwin_cur < 512:
                stagwin_cur *= 4
                inner_opts = dataclasses.replace(inner_opts,
                                                 stagwin=stagwin_cur)
                stagnant = 0
                continue
            break

    return MixedSolveOutput(
        x=x, x1=x[:n], x2=x[n:],
        niters=int(sum(inner_iters)), nouter=len(inner_iters),
        resid_history=np.asarray(history), inner_niters=tuple(inner_iters),
        solved=bool(solved), ptime=ptime,
        stime=time.perf_counter() - t_all, inner_outputs=())
