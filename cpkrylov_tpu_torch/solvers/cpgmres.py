"""Constraint-preconditioned restarted GMRES(l).

Port of ``cpkrylov_tpu/solvers/cpgmres.py`` (the reference's
kernels/cpgmres.m) for nonsymmetric A: Krylov bases V ((l+1, n)) and Q
((l+1, m)) with modified Gram-Schmidt under the coupled inner product
``H(j,k) = dot(Vj,u) + dot(Qj,t)`` (cpgmres.m:214-218), SymGivens rotations,
and the restart recomputing the true residual (cpgmres.m:167-171).

The Gram-Schmidt coefficients, rotations and right-hand side stay 0-d
tensors on the device; the inner loop reads ``(resid, breakdown)`` to the
host once per iteration and the restart reads whether the true residual
improved.  The restart's triangular solve is the JAX package's masked
full-size solve (``torch.linalg.solve_triangular``).  The reference's
complex-value guards (cpgmres.m:174-176, 220-222, 244-246) become clamps to
zero of the coupled norms, and a zero norm leaves its pair unnormalized.
"""
from __future__ import annotations

import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from ..utils.device import host_read
from .common import (KrylovResult, STATUS_BREAKDOWN, STATUS_ITMAX,
                     STATUS_SOLVED, apply_manifold_veto, coupled_dot,
                     history_init, resolve_itmax, resolve_operators,
                     safe_normalize_pair, sym_givens, true_resid)


def cpgmres(b: torch.Tensor, A, C, M: CPPrecond,
            opts: SolverOptions | None = None,
            mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-GMRES(restart).

    ``B`` is optional: when given (the driver always does), the final
    iterate is checked against the CP invariant ``B x - C y ~ 0``
    (``common.apply_manifold_veto``).
    """
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    restart = int(opts.restart)                        # cpgmres.m:103
    itmax = resolve_itmax(opts, n + m)                 # cpgmres.m:105
    outermax = -(-itmax // restart)                    # cpgmres.m:148
    mstate = mstate if mstate is not None else M.init_state(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # Initial seed (outer == 1 branch, cpgmres.m:160-180); the coupled norm
    # is clamped at 0 where the reference strips an imaginary part
    # (cpgmres.m:174-176, 220-222).
    zerom = torch.zeros(m, dtype=dtype, device=dev)
    mstate, w1, w2, _ = M.apply_nm(mstate, b, -zerom)
    v1, q1 = w1, -w2
    resid0_t = torch.sqrt(torch.clamp(coupled_dot(b, v1, zerom, q1),
                                      min=0.0))
    v1, q1 = safe_normalize_pair(v1, q1, resid0_t)
    stop_t = opts.atol + opts.rtol * resid0_t          # cpgmres.m:182
    resid0, stop_tol = host_read(torch.stack([resid0_t, stop_t]))

    hist = history_init(outermax * restart, resid0, dtype)
    hidx = 0

    V = torch.zeros((restart + 1, n), dtype=dtype, device=dev)
    Q = torch.zeros((restart + 1, m), dtype=dtype, device=dev)
    V[0] = v1
    Q[0] = q1
    g_seed = resid0_t
    x = torch.zeros(n, dtype=dtype, device=dev)
    y = zerom
    idx = torch.arange(restart, device=dev)
    sqrt_eps = float(torch.finfo(dtype).eps) ** 0.5

    outer = 0
    niters = 0
    degraded = False
    resid_inner = resid_seed = resid0
    while resid_inner > stop_tol and outer < outermax and not degraded:
        # One sweep of at most `restart` Arnoldi steps (cpgmres.m:196-255).
        # g, c, s and the columns of R are lists of 0-d device tensors.
        g = [g_seed] + [zero] * restart
        cs, sn = [zero] * restart, [zero] * restart
        cols = []
        k = 0
        breakdown = False
        resid = resid_seed
        while resid > stop_tol and k < restart and not breakdown:
            vk, qk = V[k], Q[k]
            u = A.matvec(vk)
            t = C.matvec(qk)
            mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
            vnew = w1
            qnew = qk - w2

            # Modified Gram-Schmidt against all previous pairs
            # (cpgmres.m:214-218).
            h = []
            for j in range(k + 1):
                hj = coupled_dot(V[j], u, Q[j], t)
                h.append(hj)
                vnew = vnew - hj * V[j]
                qnew = qnew - hj * Q[j]
            if opts.reorth:
                # Second pass ("twice is enough") against the K_P-image of
                # the candidate's raw preconditioned coordinates: the
                # deflated candidate's raw pair is (vnew, q_k - qnew), and
                # one K_P product gives its duals (cpkrylov_tpu/solvers/
                # cpgmres.py:130-150; the reference documents `reorth` but
                # never implements it, cpgmres.m:81-82).
                kp_im = M.mul_kp(torch.cat([vnew, qk - qnew]))
                u = kp_im[:n]
                t = -kp_im[n:]
                for j in range(k + 1):
                    hj = coupled_dot(V[j], u, Q[j], t)
                    h[j] = h[j] + hj
                    vnew = vnew - hj * V[j]
                    qnew = qnew - hj * Q[j]
            # A nonpositive coupled inner product is a breakdown: lucky or
            # a loss of M-positivity past convergence (the reference goes
            # complex, cpgmres.m:219-222).  The step completes with
            # hsub = 0, the sweep ends and the restart's true residual
            # decides whether the solve is done.
            dsub = coupled_dot(u, vnew, t, qnew)
            hsub = torch.sqrt(torch.clamp(dsub, min=0.0))
            V[k + 1], Q[k + 1] = safe_normalize_pair(vnew, qnew, hsub)

            # Previous rotations (cpgmres.m:229-234).
            h.append(hsub)
            for j in range(k):
                hj = cs[j] * h[j] + sn[j] * h[j + 1]
                hj1 = sn[j] * h[j] - cs[j] * h[j + 1]
                h[j], h[j + 1] = hj, hj1

            # Current rotation (cpgmres.m:236-247).
            ck, sk, dk = sym_givens(h[k], h[k + 1])
            cs[k], sn[k] = ck, sk
            h[k], h[k + 1] = dk, zero
            gk = g[k]
            g[k + 1] = sk * gk
            g[k] = ck * gk
            cols.append(torch.stack(h))

            resid_h, brk = host_read(torch.stack(
                [torch.abs(g[k + 1]), (dsub <= 0).to(dtype)]))
            breakdown = bool(brk)
            resid = resid_h
            k += 1
            hidx += 1
            hist[hidx] = resid
            if opts.verbose:
                print(f"{hidx:5d}  {resid:14.7e}")

        # Triangular solve and basis combination (cpgmres.m:257-260), with
        # the columns >= k masked to the identity so z is zero there.
        # Columns whose rotated diagonal is numerically rank-deficient, or
        # whose rotation gave no residual reduction (|c| ~ 0, the degenerate
        # post-floor regime), are masked the same way: the reference's
        # backslash would blow up there and poison the back substitution.
        R = torch.zeros((restart, restart), dtype=dtype, device=dev)
        for j, col in enumerate(cols):
            col = col[:restart]
            R[: col.shape[0], j] = col
        c_all = torch.stack(cs)
        diag = torch.abs(torch.diagonal(R))
        rank_tol = sqrt_eps * torch.max(diag)
        dead = (idx >= k) | (diag < rank_tol) | (torch.abs(c_all) < 1e-8)
        Rsq = torch.where(dead[:, None], torch.zeros_like(R), R) + torch.diag(
            dead.to(dtype))
        gmask = torch.where(dead, torch.zeros_like(c_all),
                            torch.stack(g[:restart]))
        z = torch.linalg.solve_triangular(Rsq, gmask[:, None],
                                          upper=True)[:, 0]
        x_n = x + z @ V[:restart]
        y_n = y - z @ Q[:restart]

        # Reseed for the next sweep (cpgmres.m:167-180).  The reseed's true
        # residual doubles as a verification: a sweep that made the iterate
        # worse (a degenerate basis amplifying noise through the back
        # substitution) is rolled back and the solver exits.
        mstate, v1, q1, seed_t = true_resid(b, A, C, M, mstate, x_n, y_n)
        v1, q1 = safe_normalize_pair(v1, q1, seed_t)
        seed = host_read(seed_t)

        improved = seed < resid_seed
        if improved:
            x, y = x_n, y_n
            resid_seed = seed
        V[0] = v1
        Q[0] = q1
        g_seed = seed_t
        # After a breakdown the inner estimate is not trustworthy; the
        # freshly computed true residual governs continuation instead.
        resid_inner = resid_seed if breakdown else resid
        degraded = not improved
        outer += 1
        niters += k

    # `solved` requires the in-sweep estimate AND consistency with the true
    # residual of the last restart: in the degenerate post-floor regime the
    # estimate can read arbitrarily small with a corrupted iterate.
    est_ok = resid_inner <= stop_tol
    truth_ok = resid_seed <= max(stop_tol, 10.0 * resid_inner)
    solved = est_ok and truth_ok
    if degraded and not solved:
        istatus = STATUS_BREAKDOWN
    elif solved:
        istatus = STATUS_SOLVED
    else:
        istatus = STATUS_ITMAX
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x, y,
                                          stop_tol)
    return KrylovResult(x=x, y=y, niters=niters, resid_history=hist,
                        solved=bool(solved), istatus=int(istatus))
