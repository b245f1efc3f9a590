"""Constraint-preconditioned Lanczos-form CG.

Port of ``cpkrylov_tpu/solvers/cpcglanczos.py`` (the reference's
kernels/cpcglanczos.m): the coupled three-term Lanczos recurrence with an
LDL-style solution update (``dg``, ``low``, ``eta``, ``wv``, ``wq``,
cpcglanczos.m:236-268), plus the optional backward-error stop with running
estimates of ``|x|`` (a Givens/LSQR-style recurrence, l.270-291) and
``|op|`` (Frobenius accumulation of alpha and beta).  The loop reads
``(resid, indefinite, bstop_tol)`` to the host once per iteration; on
indefiniteness the last good iterate is kept.
"""
from __future__ import annotations

import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from .common import (KrylovResult, STATUS_BACKWARD, STATUS_INDEFINITE,
                     STATUS_ITMAX, STATUS_SOLVED, STATUS_STAGNATED,
                     apply_manifold_veto, breakdown_resid_recheck, eps100,
                     history_init, initial_lanczos_pair, resolve_itmax,
                     resolve_operators, safe_normalize_pair, stag_init,
                     stag_stop, stag_update, vdot)


def cpcglanczos(b: torch.Tensor, A, C, M: CPPrecond,
                opts: SolverOptions | None = None,
                mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-CG-Lanczos."""
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    itmax = resolve_itmax(opts, n)                     # cpcglanczos.m:113
    e100 = eps100(dtype)
    btol = opts.btol
    mstate = mstate if mstate is not None else M.init_state(dtype)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    zeron = torch.zeros(n, dtype=dtype, device=dev)
    zerom = torch.zeros(m, dtype=dtype, device=dev)

    # Initial Lanczos pair (cpcglanczos.m:153-176).
    mstate, vkp1, qkp1, beta, indefinite0 = initial_lanczos_pair(
        b, m, M, mstate, e100)
    beta1 = beta
    stop_t = opts.atol + opts.rtol * beta1             # cpcglanczos.m:195
    bstop_t = btol * beta1                             # cpcglanczos.m:198
    resid, stop_tol, bstop_tol, indefinite = torch.stack(
        [beta1, stop_t, bstop_t, indefinite0.to(dtype)]).tolist()
    indefinite = bool(indefinite)
    hist = history_init(itmax, resid, dtype)
    stag_best, stag_since = stag_init(resid)

    k = 0
    x, y = zeron, zerom
    best_x, best_y, best_resid = zeron, zerom, resid
    vk, qk = zeron, zerom
    oldbeta = scalar(0.0)
    dg = scalar(0.0)
    low = scalar(1.0)
    eta = beta
    wv, wq = vkp1, qkp1
    opnorm2 = scalar(0.0)
    rhobar = scalar(1.0)
    xxnorm2 = scalar(0.0)
    tau = scalar(0.0)
    delta = scalar(0.0)

    while (resid > stop_tol and resid > bstop_tol and k < itmax
           and not indefinite and not stag_stop(stag_since, opts.stagwin)):
        vkm1, qkm1 = vk, qk
        vk_n, qk_n = vkp1, qkp1

        # u/t/alpha then the x,y update (cpcglanczos.m:232-239).
        u = A.matvec(vk_n)
        t = C.matvec(qk_n)
        alpha = vdot(u, vk_n) + vdot(t, qk_n)
        dg_n = alpha - low * low * dg                 # d_k
        zeta = eta / dg_n
        x_n = x + zeta * wv
        y_n = y - zeta * wq

        # Next Lanczos vectors (cpcglanczos.m:242-262).
        mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
        vkp1_n = w1 - alpha * vk_n - beta * vkm1
        qkp1_n = (qk_n - w2) - alpha * qk_n - beta * qkm1
        beta2 = vdot(u, vkp1_n) + vdot(t, qkp1_n)
        # relative guard; see common.lanczos_step
        indef = beta2 < -e100 * (1 + torch.abs(alpha))
        beta_n = torch.sqrt(torch.abs(beta2))
        vkp1_n, qkp1_n = safe_normalize_pair(vkp1_n, qkp1_n, beta_n)

        # Next-update data (cpcglanczos.m:264-268).
        low_n = beta_n / dg_n
        eta_n = -low_n * eta
        wv_n = vkp1_n - low_n * wv
        wq_n = qkp1_n - low_n * wq

        # Backward-error machinery (cpcglanczos.m:270-291), only with btol.
        if btol > 0:
            rho = torch.sqrt(rhobar * rhobar + low_n * low_n)
            cs = rhobar / rho
            sn = low_n / rho
            num = zeta - delta * tau
            taubar = num / rhobar
            tau_n = num / rho
            xnorm = torch.sqrt(xxnorm2 + taubar * taubar)
            xxnorm2_n = xxnorm2 + tau_n * tau_n
            delta_n = sn
            rhobar_n = -cs
            opnorm2_n = (opnorm2 + alpha * alpha + beta_n * beta_n
                         + oldbeta * oldbeta)
            bkerr = torch.sqrt(opnorm2_n) * xnorm + beta1
            bstop_n = btol * bkerr
        else:
            rhobar_n, xxnorm2_n, tau_n, delta_n = rhobar, xxnorm2, tau, delta
            opnorm2_n = opnorm2
            bstop_n = torch.zeros((), dtype=dtype, device=dev)

        resid_n = beta_n * torch.abs(zeta)             # cpcglanczos.m:293
        resid_h, indef_h, bstop_h = torch.stack(
            [resid_n, indef.to(dtype), bstop_n]).tolist()
        if indef_h:
            # Keep the last good iterate where the reference would throw
            # (cpcglanczos.m:248-254).
            indefinite = True
            break

        k += 1
        x, y = x_n, y_n
        vk, qk, vkp1, qkp1 = vk_n, qk_n, vkp1_n, qkp1_n
        beta, oldbeta = beta_n, beta_n
        dg, low, eta, wv, wq = dg_n, low_n, eta_n, wv_n, wq_n
        opnorm2, rhobar, xxnorm2 = opnorm2_n, rhobar_n, xxnorm2_n
        tau, delta = tau_n, delta_n
        if btol > 0:
            bstop_tol = bstop_h
        resid = resid_h
        # The minimum-estimate iterate: the final one in healthy runs; it
        # matters only past the accuracy floor.
        if resid < best_resid:
            best_x, best_y, best_resid = x, y, resid
        hist[k] = resid
        if opts.verbose:
            print(f"{k:5d}  {resid:9.2e}")
        stag_best, stag_since = stag_update(stag_best, stag_since, resid)

    # Fall back to the best-estimate iterate when the final one is worse.
    if best_resid < resid:
        x_out, y_out, resid_out = best_x, best_y, best_resid
    else:
        x_out, y_out, resid_out = x, y, resid

    # Status resolution (cpcglanczos.m:311-325).
    solved_resid = resid_out <= stop_tol
    solved_bkerr = btol > 0 and resid_out <= bstop_tol
    solved = solved_resid or solved_bkerr
    if indefinite:
        istatus = STATUS_INDEFINITE
    elif solved_resid:
        istatus = STATUS_SOLVED
    elif solved_bkerr:
        istatus = STATUS_BACKWARD
    elif stag_stop(stag_since, opts.stagwin):
        istatus = STATUS_STAGNATED
    else:
        istatus = STATUS_ITMAX
    # Krylov exhaustion fires the indefiniteness guard with an excellent
    # iterate in hand; re-judge `solved` on a fresh residual (common.py).
    solved, _ = breakdown_resid_recheck(solved, istatus, resid_out, stop_tol,
                                        b, A, C, M, mstate, x_out, y_out)
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x_out,
                                          y_out, stop_tol)
    return KrylovResult(x=x_out, y=y_out, niters=k, resid_history=hist,
                        solved=bool(solved), istatus=int(istatus))
