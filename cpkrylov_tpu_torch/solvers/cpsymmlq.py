"""Constraint-preconditioned SYMMLQ.

Port of ``cpkrylov_tpu/solvers/cpsymmlq.py`` (the reference's
kernels/cpsymmlq.m): tracks the LQ, QR (MINRES) and CG residual-norm
histories (cpsymmlq.m:86-90) and stops on the CG residual norm only ("one
iteration ahead", cpsymmlq.m:38-41); the end-game moves to the CG point when
it is better and adds a final step along the first Lanczos vector
(cpsymmlq.m:333-347).  The loop reads ``(lq, qr, cg, indefinite)`` to the
host once per iteration; on indefiniteness the last good iterate is kept.

It keeps the reference's defect at k = 1: when the solve ends after one
iteration the end-game degenerates, and the manifold veto then reports a
breakdown instead of a false convergence.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from ..utils.device import numpy_dtype
from .common import (KrylovResult, STATUS_INDEFINITE, STATUS_ITMAX,
                     STATUS_SOLVED, STATUS_STAGNATED, apply_manifold_veto,
                     breakdown_resid_recheck, eps100, initial_lanczos_pair,
                     lanczos_step, resolve_itmax, resolve_operators,
                     stag_init, stag_stop, stag_update)


def cpsymmlq(b: torch.Tensor, A, C, M: CPPrecond,
             opts: SolverOptions | None = None,
             mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-SYMMLQ."""
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    itmax = resolve_itmax(opts, n)                     # cpsymmlq.m:102
    e100 = eps100(dtype)
    feps = float(torch.finfo(dtype).eps)
    mstate = mstate if mstate is not None else M.init_state(dtype)

    zeron = torch.zeros(n, dtype=dtype, device=dev)
    zerom = torch.zeros(m, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # Initial Lanczos pair (cpsymmlq.m:137-154).
    mstate, v1, q1, beta1, indefinite0 = initial_lanczos_pair(
        b, m, M, mstate, e100)
    stop_t = opts.atol + opts.rtol * beta1             # cpsymmlq.m:158

    # Second Lanczos step (cpsymmlq.m:193-216; no beta*v_{k-1} term).
    mstate, _, _, alpha, v2, q2, beta, indef1 = lanczos_step(
        A, C, M, mstate, v1, q1, zeron, zerom, zero, e100)

    cgresid, stop_tol, indefinite = torch.stack(
        [beta1, stop_t, (indefinite0 | indef1).to(dtype)]).tolist()
    indefinite = bool(indefinite)
    beta1_h = cgresid
    done0 = cgresid <= stop_tol                        # cpsymmlq.m:189
    stag_best, stag_since = stag_init(cgresid)

    # History buffers: the loop writes lq/qr at slot k and cg at slot k+1;
    # slot 0 of cg is beta1, set at wrap-up (cpsymmlq.m:331).
    hsize = itmax + 2
    npd = numpy_dtype(dtype)
    lq_hist = np.full(hsize, np.nan, dtype=npd)
    qr_hist = np.full(hsize, np.nan, dtype=npd)
    cg_hist = np.full(hsize, np.nan, dtype=npd)

    k = 0
    x, y = zeron, zerom
    best_x, best_y, best_bstep, best_resid = zeron, zerom, zero, cgresid
    vk, qk, vkp1, qkp1 = v1, q1, v2, q2
    gammabar, deltabar = alpha, beta                   # cpsymmlq.m:219-220
    epsdelzeta, epsilonzeta = beta1, zero
    bstep = zero
    snprod = torch.ones((), dtype=dtype, device=dev)
    matnorm2 = alpha * alpha + beta * beta             # cpsymmlq.m:225
    wv, wq = zeron, zerom

    def norms(matnorm2, gammabar, epsdelzeta, epsilonzeta, snprod, beta):
        """LQ/QR/CG residual norms from the carried scalars
        (cpsymmlq.m:231-241 and 317-325)."""
        epsmat = torch.sqrt(matnorm2) * feps
        den = torch.where(gammabar == 0, epsmat, gammabar)
        lq = torch.hypot(epsdelzeta, epsilonzeta)
        qr = snprod * beta1
        cg = qr * beta / torch.abs(den)
        return lq, qr, cg, den

    while (cgresid > stop_tol and k < itmax and not indefinite
           and not done0 and not stag_stop(stag_since, opts.stagwin)):
        # Norms at the loop top, recorded before the iteration advances
        # (cpsymmlq.m:231-244).
        lq, qr, cg, _ = norms(matnorm2, gammabar, epsdelzeta, epsilonzeta,
                              snprod, beta)

        # Next Lanczos step (cpsymmlq.m:258-285).
        vkm1, qkm1 = vk, qk
        vk_n, qk_n = vkp1, qkp1
        betaold = beta
        (mstate, _, _, alpha, vkp1_n, qkp1_n, beta_n,
         indef) = lanczos_step(A, C, M, mstate, vk_n, qk_n, vkm1, qkm1,
                               betaold, e100)
        lq_h, qr_h, cg_h, indef_h = torch.stack(
            [lq, qr, cg, indef.to(dtype)]).tolist()
        if indef_h:
            # Keep the last good iterate where the reference would throw
            # (cpsymmlq.m:274-278).
            indefinite = True
            break
        lq_hist[k] = lq_h
        qr_hist[k] = qr_h
        cg_hist[k + 1] = cg_h
        if opts.verbose:
            print(f"{k:5d}  {cg_h:9.2e}  {lq_h:9.2e}  {qr_h:9.2e}")

        matnorm2 = (matnorm2 + alpha * alpha + beta_n * beta_n
                    + betaold * betaold)               # cpsymmlq.m:288

        # Plane rotation (cpsymmlq.m:291-297).
        gamma = torch.hypot(gammabar, betaold)
        cs = gammabar / gamma
        sn = betaold / gamma
        delta = cs * deltabar + sn * alpha
        gammabar = sn * deltabar - cs * alpha
        epsilon = sn * beta_n
        deltabar = -cs * beta_n

        # LQ solution update (cpsymmlq.m:300-306).
        zeta = epsdelzeta / gamma
        zcs = zeta * cs
        zsn = zeta * sn
        x = x + zcs * wv + zsn * vk_n
        y = y - zcs * wq - zsn * qk_n
        wv = sn * wv - cs * vk_n
        wq = sn * wq - cs * qk_n

        # Accumulators (cpsymmlq.m:310-313).
        bstep = bstep + snprod * cs * zeta
        snprod = snprod * sn
        epsdelzeta = epsilonzeta - delta * zeta
        epsilonzeta = -epsilon * zeta

        # The minimum-estimate LQ iterate with its bstep, which the end-game
        # needs; the final one in healthy runs.
        if cg_h < best_resid:
            best_x, best_y, best_bstep, best_resid = x, y, bstep, cg_h
        k += 1
        vk, qk, vkp1, qkp1 = vk_n, qk_n, vkp1_n, qkp1_n
        beta = beta_n
        # The loop test reads the CG norm of the loop top: the advance still
        # runs when that norm already meets the tolerance (cpsymmlq.m:229-241).
        cgresid = cg_h
        stag_best, stag_since = stag_update(stag_best, stag_since, cg_h)

    # Wrap-up (cpsymmlq.m:317-347); skipped when the solver never iterated.
    lq_f, qr_f, _, den = norms(matnorm2, gammabar, epsdelzeta, epsilonzeta,
                               snprod, beta)
    lq_fh, qr_fh = torch.stack([lq_f, qr_f]).tolist()
    lq_hist[k] = beta1_h if done0 else lq_fh
    qr_hist[k] = beta1_h if done0 else qr_fh
    cg_hist[0] = beta1_h

    # Fall back to the best-estimate LQ iterate when the final one is worse;
    # the move to the CG point belongs to the final state and is then
    # skipped.
    use_best = best_resid < cgresid
    cgresid_out = min(best_resid, cgresid)
    if done0:
        x_final, y_final = zeron, zerom
    else:
        base_x, base_y, base_bstep = ((best_x, best_y, best_bstep)
                                      if use_best else (x, y, bstep))
        if not use_best and cgresid < lq_fh:
            # Move to the CG point (cpsymmlq.m:334-339).
            zetabar = epsdelzeta / den
            base_bstep = base_bstep + snprod * zetabar
            base_x = base_x + zetabar * wv
            base_y = base_y - zetabar * wq
        # Step along the first Lanczos vector (cpsymmlq.m:341-347).
        _, vk1, w2, _ = M.apply_nm(mstate, b, zerom)
        qk1 = -w2
        step = base_bstep / beta1
        x_final = base_x + step * vk1
        y_final = base_y - step * qk1

    solved = cgresid_out <= stop_tol
    if indefinite:
        istatus = STATUS_INDEFINITE
    elif solved:
        istatus = STATUS_SOLVED
    elif stag_stop(stag_since, opts.stagwin):
        istatus = STATUS_STAGNATED
    else:
        istatus = STATUS_ITMAX
    # Krylov exhaustion fires the indefiniteness guard with an excellent
    # iterate in hand; re-judge `solved` on a fresh residual (common.py).
    solved, _ = breakdown_resid_recheck(solved, istatus, cgresid_out,
                                        stop_tol, b, A, C, M, mstate,
                                        x_final, y_final)
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x_final,
                                          y_final, stop_tol)
    return KrylovResult(x=x_final, y=y_final, niters=k,
                        resid_history=cg_hist, solved=bool(solved),
                        istatus=int(istatus), cg_resid_history=cg_hist,
                        lq_resid_history=lq_hist, qr_resid_history=qr_hist)
