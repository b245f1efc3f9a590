"""Constraint-preconditioned CG.

Port of ``cpkrylov_tpu/solvers/cpcg.py`` (the reference's kernels/cpcg.m,
Dollar-Gould-Schilders-Wathen, SIMAX 2006): the coupled direction pair
(p, q), the curvature ``p'Ap + q'Cq``, and the M-inner-product residual norm
``sqrt(g'r + t'w)`` with ``t = a + u`` (cpcg.m:146-176).  The loop reads
``(resid, curvature, g'r + t'w)`` to the host once per iteration.  A
nonpositive curvature rolls the step back; a negative M-norm keeps it and
ends the loop, and the exit then verifies the iterate on a freshly computed
residual, as the JAX package does.
"""
from __future__ import annotations

import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from .common import (KrylovResult, STATUS_BREAKDOWN, STATUS_ITMAX,
                     STATUS_SOLVED, STATUS_STAGNATED, apply_manifold_veto,
                     history_init, resolve_itmax, resolve_operators,
                     stag_init, stag_stop, stag_update, true_resid, vdot)


def cpcg(b: torch.Tensor, A, C, M: CPPrecond,
         opts: SolverOptions | None = None,
         mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-CG.

    Requires A, C symmetric and the system second-order sufficient
    (cpcg.m:19-32).
    """
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    itmax = resolve_itmax(opts, n)                     # cpcg.m:99
    mstate = mstate if mstate is not None else M.init_state(dtype)

    zeron = torch.zeros(n, dtype=dtype, device=dev)
    zerom = torch.zeros(m, dtype=dtype, device=dev)

    # Initialization (cpcg.m:117-133).
    g = -b
    w = zerom
    mstate, r, u, _ = M.apply_nm(mstate, g, w)
    p = -r
    q = -u
    resid2 = vdot(g, r)
    # sqrt clamped at 0: a (roundoff-)negative M-inner product would go
    # complex in MATLAB, whose comparisons then use the (zero) real part.
    resid_t = torch.sqrt(torch.clamp(resid2, min=0.0))
    stop_t = opts.atol + opts.rtol * resid_t
    resid, stop_tol = torch.stack([resid_t, stop_t]).tolist()
    hist = history_init(itmax, resid, dtype)
    stag_best, stag_since = stag_init(resid)

    k = 0
    breakdown = False
    x, a = zeron, zerom
    best_x, best_a, best_resid = zeron, zerom, resid

    while (resid > stop_tol and k < itmax and not breakdown
           and not stag_stop(stag_since, opts.stagwin)):
        # Curvatures and step (cpcg.m:151-154).
        Ap = A.matvec(p)
        Cq = C.matvec(q)
        curv = vdot(p, Ap) + vdot(q, Cq)
        alpha = resid2 / curv

        # Updates (cpcg.m:161-171).
        x_n = x + alpha * p
        a_n = a + alpha * q
        g_n = g + alpha * Ap
        w_n = w + alpha * Cq
        mstate, r, u, _ = M.apply_nm(mstate, g_n, w_n)
        t = a_n + u
        resid2_n = vdot(g_n, r) + vdot(t, w_n)
        beta = resid2_n / resid2
        p_n = -r + beta * p
        q_n = -t + beta * q
        resid_n = torch.sqrt(torch.clamp(resid2_n, min=0.0))

        resid_h, curv_h, resid2_h = torch.stack(
            [resid_n, curv, resid2_n]).tolist()
        if curv_h <= 0:
            # Nonpositive curvature makes the step itself undefined
            # (second-order sufficiency broken): roll it back and stop.
            breakdown = True
            break
        k += 1
        x, a, g, w, p, q, resid2 = x_n, a_n, g_n, w_n, p_n, q_n, resid2_n
        resid = resid_h
        if resid < best_resid:
            best_x, best_a, best_resid = x, a, resid
        hist[k] = resid
        if opts.verbose:
            print(f"{k:5d}  {resid:9.2e}")
        stag_best, stag_since = stag_update(stag_best, stag_since, resid)
        # A negative M-norm residual means the estimate lost meaning (the
        # reference would go complex): the update is kept, the loop exits,
        # and the verification below decides `solved`.
        breakdown = resid2_h < 0

    # Return the minimum-estimate iterate (the final one in healthy runs).
    if best_resid < resid:
        x_out, a_out, resid_out = best_x, best_a, best_resid
    else:
        x_out, a_out, resid_out = x, a, resid
    if breakdown:
        # The estimate is untrustworthy: verify against the true
        # preconditioned residual before claiming convergence.
        resid_out = float(true_resid(b, A, C, M, mstate, x_out, a_out)[3])
    solved = resid_out <= stop_tol
    if breakdown and not solved:
        istatus = STATUS_BREAKDOWN
    elif solved:
        istatus = STATUS_SOLVED
    elif stag_stop(stag_since, opts.stagwin):
        istatus = STATUS_STAGNATED
    else:
        istatus = STATUS_ITMAX
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x_out, a_out,
                                          stop_tol)
    return KrylovResult(x=x_out, y=a_out, niters=k, resid_history=hist,
                        solved=bool(solved), istatus=int(istatus))
