"""Constraint-preconditioned DQGMRES (memory-limited quasi-minimum residual).

Port of ``cpkrylov_tpu/solvers/cpdqgmres.py`` (the reference's
kernels/cpdqgmres.m, Saad & Wu, NLAA 1996): circular stacks of ``mem + 1``
rows for the Krylov pairs (V, Q) and the update directions (PV, PQ), ``mem``
rotations, incomplete orthogonalization against the last ``mem`` vectors
only, and a per-iteration solution update with the residual-norm estimate
``|g(k+1)|`` (cpdqgmres.m:264-268).  The band of the Hessenberg column is a
per-iteration list ``h[o]`` indexed by the offset o = k - j, as in the JAX
package (every entry read at iteration k is also written there).

The coefficients stay 0-d tensors on the device; the loop reads
``(resid, breakdown)`` to the host once per iteration.  On a breakdown or
stagnation exit the final and the previous iterates are verified on the
true preconditioned residual and the better one is returned.
"""
from __future__ import annotations

import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond, CPState
from ..utils.device import host_read
from .common import (KrylovResult, STATUS_BREAKDOWN, STATUS_ITMAX,
                     STATUS_SOLVED, STATUS_STAGNATED, apply_manifold_veto,
                     coupled_dot,
                     history_init, resolve_itmax, resolve_operators,
                     safe_normalize_pair, stag_init, stag_stop, stag_update,
                     sym_givens, true_resid, vdot)


def cpdqgmres(b: torch.Tensor, A, C, M: CPPrecond,
              opts: SolverOptions | None = None,
              mstate: CPState | None = None, B=None) -> KrylovResult:
    """Solve [A B'; B -C][x; y] = [b; 0] via CP-DQGMRES(mem)."""
    opts = opts or SolverOptions()
    A, C = resolve_operators(A, C, device=b.device)
    dtype, dev = b.dtype, b.device
    n = A.shape[0]
    m = C.shape[0]
    itmax = resolve_itmax(opts, n + m)                 # cpdqgmres.m:102
    mem = min(max(1, int(opts.mem)), itmax)            # cpdqgmres.m:117, 125
    mstate = mstate if mstate is not None else M.init_state(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    # Initial Krylov pair (cpdqgmres.m:153-164).
    zerom = torch.zeros(m, dtype=dtype, device=dev)
    mstate, w1, w2, _ = M.apply_nm(mstate, b, zerom)
    v1, q1 = w1, -w2
    resid0_t = torch.sqrt(torch.clamp(vdot(b, v1), min=0.0))  # l.157
    v1, q1 = safe_normalize_pair(v1, q1, resid0_t)
    stop_t = opts.atol + opts.rtol * resid0_t          # cpdqgmres.m:169
    resid, stop_tol = host_read(torch.stack([resid0_t, stop_t]))
    stag_best, stag_since = stag_init(resid)
    hist = history_init(itmax, resid, dtype)

    V = torch.zeros((mem + 1, n), dtype=dtype, device=dev)
    Q = torch.zeros((mem + 1, m), dtype=dtype, device=dev)
    PV = torch.zeros((mem + 1, n), dtype=dtype, device=dev)
    PQ = torch.zeros((mem + 1, m), dtype=dtype, device=dev)
    V[0] = v1
    Q[0] = q1
    cs, sn = [zero] * mem, [zero] * mem                # circular rotations
    g = [resid0_t] + [zero] * mem                      # circular rhs
    x = torch.zeros(n, dtype=dtype, device=dev)
    y = zerom
    x_prev, y_prev = x, y

    k = 0
    breakdown = False
    stagnant = 0            # consecutive iterations with an unchanged estimate
    while (resid > stop_tol and k < itmax and not breakdown and stagnant < 3
           and not stag_stop(stag_since, opts.stagwin)):
        k += 1                                         # 1-based
        kpos = (k - 1) % (mem + 1)                     # cpdqgmres.m:199-201
        kp1pos = k % (mem + 1)
        rotpos = (k - 1) % mem

        u = A.matvec(V[kpos])
        t = C.matvec(Q[kpos])
        mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
        vnew = w1
        qnew = Q[kpos] - w2

        # Incomplete MGS over j = max(1, k-mem+1)..k (cpdqgmres.m:210-216).
        # h[o] holds H(j, 2+k-j) for the offset o = k - j; h[mem] stays 0,
        # the never-orthogonalized leading-edge entry the rotations read.
        h = [zero] * (mem + 1)
        for j in range(max(1, k - mem + 1), k + 1):
            jpos = (j - 1) % (mem + 1)
            hj = coupled_dot(V[jpos], u, Q[jpos], t)
            h[k - j] = hj
            vnew = vnew - hj * V[jpos]
            qnew = qnew - hj * Q[jpos]

        # Subdiagonal H(k+1,k); a nonpositive coupled inner product (where
        # the reference goes complex, cpdqgmres.m:218-225) is a breakdown:
        # the iteration completes, then the loop exits.
        dsub = coupled_dot(u, vnew, t, qnew)
        hsub = torch.sqrt(torch.clamp(dsub, min=0.0))
        V[kp1pos], Q[kp1pos] = safe_normalize_pair(vnew, qnew, hsub)

        # Previous rotations over j = max(1, k-mem)..k-1 (l.228-235).
        for j in range(max(1, k - mem), k):
            jrot = (j - 1) % mem
            o = k - j
            hj = cs[jrot] * h[o] + sn[jrot] * h[o - 1]
            hj1 = sn[jrot] * h[o] - cs[jrot] * h[o - 1]
            h[o], h[o - 1] = hj, hj1

        # Current rotation (cpdqgmres.m:243-250).
        ck, sk, dk = sym_givens(h[0], hsub)
        h[0] = dk
        cs[rotpos], sn[rotpos] = ck, sk
        gk = g[kpos]
        g[kp1pos] = sk * gk
        g[kpos] = ck * gk

        # Update directions and solution (cpdqgmres.m:252-265).
        pv = V[kpos]
        pq = Q[kpos]
        for j in range(max(1, k - mem), k):
            jpos = (j - 1) % (mem + 1)
            hj = h[k - j]
            pv = pv - hj * PV[jpos]
            pq = pq - hj * PQ[jpos]
        # A zero rotated diagonal is a post-breakdown direction: skip its
        # update (the reference's division would give Inf, l.262-263).
        alive = h[0] != 0
        hdiag = torch.where(alive, h[0], one)
        pv = pv / hdiag
        pq = pq / hdiag
        PV[kpos] = pv
        PQ[kpos] = pq
        step = torch.where(alive, g[kpos], zero)
        x_prev, y_prev = x, y
        x = x + step * pv
        y = y - step * pq

        resid_h, brk = host_read(torch.stack(
            [torch.abs(g[kp1pos]), (dsub <= 0).to(dtype)]))
        breakdown = bool(brk)
        # An unchanged estimate means |s| = 1, c = 0: the degenerate regime
        # past the method's accuracy floor, where further iterations only
        # corrupt x.  Count it and stop after three.
        stagnant = stagnant + 1 if resid_h == resid else 0
        resid = resid_h                                # cpdqgmres.m:268
        stag_best, stag_since = stag_update(stag_best, stag_since, resid)
        hist[k] = resid
        if opts.verbose:
            print(f"{k:5d}  {resid:14.7e}")

    # On a breakdown or stagnation exit the estimate is untrustworthy (it
    # can read exactly 0 while x is corrupted, cpdqgmres.m:184-192): verify
    # the final and previous iterates on the TRUE preconditioned residual
    # and return the better one.
    bad_exit = (breakdown or stagnant >= 3
                or stag_stop(stag_since, opts.stagwin))
    x_out, y_out, resid_trusted = x, y, resid
    if bad_exit:
        rv_final, rv_prev = host_read(torch.stack(
            [true_resid(b, A, C, M, mstate, xv, yv)[3]
             for xv, yv in ((x, y), (x_prev, y_prev))]))
        if rv_prev < rv_final:
            x_out, y_out = x_prev, y_prev
        resid_trusted = min(rv_final, rv_prev)

    solved = resid_trusted <= stop_tol
    if bad_exit and not solved:
        istatus = (STATUS_STAGNATED if stag_stop(stag_since, opts.stagwin)
                   else STATUS_BREAKDOWN)
    elif solved:
        istatus = STATUS_SOLVED
    else:
        istatus = STATUS_ITMAX
    solved, istatus = apply_manifold_veto(solved, istatus, B, C, x_out,
                                          y_out, stop_tol)
    return KrylovResult(x=x_out, y=y_out, niters=k, resid_history=hist,
                        solved=bool(solved), istatus=int(istatus))
