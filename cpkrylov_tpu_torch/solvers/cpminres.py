"""Constraint-preconditioned MINRES.

Port of ``cpkrylov_tpu/solvers/cpminres.py`` (the reference's
kernels/cpminres.m): the coupled (v, q) Lanczos recurrence, the MINRES Givens
QR recurrences and the two-back direction windows, with the residual norm
available as ``taubar`` (cpminres.m:234-236).  The ``lax.while_loop`` becomes
a Python loop that reads ``(resid, indefinite)`` to the host once per
iteration; on indefiniteness the last good iterate is kept (the JAX
package's rollback of cpminres.m:195-199).
"""
from __future__ import annotations

import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from .common import (KrylovResult, STATUS_INDEFINITE, STATUS_ITMAX,
                     STATUS_SOLVED, STATUS_STAGNATED, apply_manifold_veto,
                     breakdown_resid_recheck, eps100, history_init,
                     initial_lanczos_pair, lanczos_step, resolve_itmax,
                     resolve_operators, stag_init, stag_stop, stag_update)


def cpminres(b: torch.Tensor, A, C, M: CPPrecond,
             opts: SolverOptions | None = None,
             mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-MINRES (A, C symmetric).

    ``mstate`` carries the preconditioner's GHN caches in from the driver's
    RHS-shift application (reg_cpkrylov.m:156).
    """
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    itmax = resolve_itmax(opts, n)                     # cpminres.m:95
    e100 = eps100(dtype)
    mstate = mstate if mstate is not None else M.init_state(dtype)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    zeron = torch.zeros(n, dtype=dtype, device=dev)
    zerom = torch.zeros(m, dtype=dtype, device=dev)

    # Initial Lanczos pair and residual norm (cpminres.m:119-153).
    mstate, vkp1, qkp1, beta, indefinite0 = initial_lanczos_pair(
        b, m, M, mstate, e100)

    stop_t = opts.atol + opts.rtol * beta              # cpminres.m:164
    resid, stop_tol, indefinite = torch.stack(
        [beta, stop_t, indefinite0.to(dtype)]).tolist()
    indefinite = bool(indefinite)
    hist = history_init(itmax, resid, dtype)
    stag_best, stag_since = stag_init(resid)

    k = 0
    x, y = zeron, zerom
    vk, qk = zeron, zerom
    deltabar = scalar(0.0)
    epsln = scalar(0.0)
    taubar = beta
    cs = scalar(-1.0)
    sn = scalar(0.0)
    wv, wq, wv2, wq2 = vkp1, qkp1, zeron, zerom

    while (resid > stop_tol and k < itmax and not indefinite
           and not stag_stop(stag_since, opts.stagwin)):
        vkm1, qkm1 = vk, qk
        vk_n, qk_n = vkp1, qkp1

        # Coupled Lanczos step (cpminres.m:187-206).
        (mstate, _, _, alpha, vkp1_n, qkp1_n, beta_n,
         indef) = lanczos_step(A, C, M, mstate, vk_n, qk_n, vkm1, qkm1,
                               beta, e100)

        # Previous rotation (cpminres.m:208-215).
        oldeps = epsln
        delta = cs * deltabar + sn * alpha
        gammabar = sn * deltabar - cs * alpha
        epsln_n = sn * beta_n
        deltabar_n = -cs * beta_n

        # Current rotation and tau (cpminres.m:217-222).
        gamma = torch.hypot(gammabar, beta_n)
        cs_n = gammabar / gamma
        sn_n = beta_n / gamma
        tau = cs_n * taubar
        taubar_n = sn_n * taubar

        resid_n, indef_h = torch.stack([taubar_n, indef.to(dtype)]).tolist()
        if indef_h:
            # Keep the last good iterate; the status reports the guard.
            indefinite = True
            break

        # Direction windows and solution update (cpminres.m:224-232).
        wv1, wq1 = wv2, wq2
        wv2, wq2 = wv, wq
        wv = (vk_n - oldeps * wv1 - delta * wv2) / gamma
        wq = (qk_n - oldeps * wq1 - delta * wq2) / gamma
        x = x + tau * wv
        y = y - tau * wq

        k += 1
        vk, qk, vkp1, qkp1 = vk_n, qk_n, vkp1_n, qkp1_n
        beta, deltabar, epsln = beta_n, deltabar_n, epsln_n
        taubar, cs, sn = taubar_n, cs_n, sn_n
        resid = resid_n                                # cpminres.m:235
        hist[k] = resid
        if opts.verbose:
            print(f"{k:5d}  {resid:9.2e}")
        stag_best, stag_since = stag_update(stag_best, stag_since, resid)

    solved = resid <= stop_tol
    if indefinite:
        istatus = STATUS_INDEFINITE
    elif solved:
        istatus = STATUS_SOLVED
    elif stag_stop(stag_since, opts.stagwin):
        istatus = STATUS_STAGNATED
    else:
        istatus = STATUS_ITMAX
    # Krylov exhaustion fires the indefiniteness guard one step short of
    # the tolerance; judge `solved` on a freshly computed residual there.
    solved, _ = breakdown_resid_recheck(solved, istatus, resid, stop_tol, b,
                                        A, C, M, mstate, x, y)
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x, y,
                                          stop_tol)
    return KrylovResult(x=x, y=y, niters=k, resid_history=hist,
                        solved=bool(solved), istatus=int(istatus))
