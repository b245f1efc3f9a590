"""Maros–Mészáros QP KKT suite (analytic generators).

Port of ``cpkrylov_tpu/utils/mm.py`` (numpy/scipy only): the port keeps its
own copy so that importing it never imports the JAX package, and the
generators draw the same seeded numpy streams in the same order, so both
packages build identical systems.  No file is downloaded.

The reference's two shipped fixtures are interior-point KKT matrices of the
Maros–Mészáros problems CVXQP1-M and CVXQP2-S (reference
examples/cpk_exprog1.m:10-40, cpk_exprog2.m:10-17: "CUTEst" / G-2015-117
collection, IPM iteration 10).  This module regenerates that problem family
*from its analytic CUTE definitions* at any size, so the full kernel sweep
(BASELINE.json configs[2]: "Full kernel sweep ... on Maros-Meszaros QP KKT
systems, C=delta*I regularization") runs on genuinely-structured KKT systems
rather than random sparsity.

The CVXQP family (CUTE SIF problems CVXQP1/CVXQP2/CVXQP3) is the convex QP

    minimize   sum_{i=1..n} (i/2) * (x_i + x_{j(i)} + x_{k(i)})^2
    subject to x_i + 2 x_{p(i)} + 3 x_{q(i)} = 6,   i = 1..m
               0.1 <= x <= 10

with the index maps (1-based)  j(i) = mod(2i-1, n)+1,  k(i) = mod(3i-1, n)+1,
p(i) = mod(4i-1, n)+1, q(i) = mod(5i-1, n)+1, and the member-specific
constraint counts m = n/2 (CVXQP1), n/4 (CVXQP2), 3n/4 (CVXQP3).  The
Hessian is Q = Pᵀ diag(1..n) P with P the 3-ones-per-row pattern matrix —
positive semidefinite by construction, positive definite on the bound-
regularized KKT systems below.

A simulated primal-dual interior-point iterate turns each QP into the
regularized saddle-point system the solvers consume:

    [ H  Bᵀ ] [dx]   [b1]        H = Q + diag(z_l/(x-l) + z_u/(u-x)) + rho I
    [ B  -C ] [dy] = [b2],       C = delta I

which is exactly the structure of the shipped fixtures (2x2 block form,
C = 1e-8 I pure delta-regularization; SURVEY.md §2.1 rows 13-14).  The
iterate is deterministic per (family, n, seed): primal strictly interior,
duals log-uniform around mu, so the barrier diagonal spreads as mu -> 0
(the IPM late-iteration ill-conditioning the fixtures exhibit).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .fixtures import SaddleSystem

#: constraint count as a fraction of n, per family member.
CVXQP_M_FRAC = {"cvxqp1": 0.5, "cvxqp2": 0.25, "cvxqp3": 0.75}

#: Maros–Mészáros catalogue sizes for the CVXQP members (S/M/L).
CVXQP_SIZES = {"s": 100, "m": 1000, "l": 10000}


def cvxqp_problem(family: str, n: int):
    """Analytic CVXQP{1,2,3} data: (Q, J, lo, hi, rhs_eq, m).

    Q is n×n PSD, J is m×n with full row rank for the catalogue sizes,
    bounds are the SIF constants 0.1 / 10, equality RHS is 6.
    """
    family = family.lower()
    if family not in CVXQP_M_FRAC:
        raise ValueError(f"unknown CVXQP member {family!r}")
    m = int(round(CVXQP_M_FRAC[family] * n))

    i1 = np.arange(1, n + 1)                 # 1-based problem indices
    rows = np.repeat(np.arange(n), 3)
    cols = np.stack([i1 - 1, (2 * i1 - 1) % n, (3 * i1 - 1) % n],
                    axis=1).reshape(-1)
    P = sp.csr_matrix((np.ones(3 * n), (rows, cols)), shape=(n, n))
    # objective  sum (i/2) * (P x)_i^2  =>  Q = P^T diag(i) P
    Q = (P.T @ sp.diags(i1.astype(np.float64)) @ P).tocsr()
    Q.sum_duplicates()

    ic = np.arange(1, m + 1)
    jrows = np.repeat(np.arange(m), 3)
    jcols = np.stack([ic - 1, (4 * ic - 1) % n, (5 * ic - 1) % n],
                     axis=1).reshape(-1)
    jvals = np.tile(np.array([1.0, 2.0, 3.0]), m)
    J = sp.csr_matrix((jvals, (jrows, jcols)), shape=(m, n))
    J.sum_duplicates()

    lo = np.full(n, 0.1)
    hi = np.full(n, 10.0)
    rhs_eq = np.full(m, 6.0)
    return Q, J, lo, hi, rhs_eq, m


def _cvxqp_iterate(family: str, n: int | str, mu: float, delta: float,
                   seed: int) -> dict:
    """A CVXQP problem at its seeded interior-point iterate: ``Q``, ``J``,
    the bound slacks ``s_lo`` = x - l and ``s_hi`` = u - x, the multipliers
    ``z_lo`` and ``z_hi``, and the Newton right-hand side's rows ``b_dual``
    = -(Qx + J'y - z_l + z_u) and ``b_primal`` = -(Jx - rhs_eq - delta y).
    """
    if isinstance(n, str):
        n = CVXQP_SIZES[n.lower()]
    Q, J, lo, hi, rhs_eq, m = cvxqp_problem(family, n)

    rng = np.random.default_rng(seed)
    # strictly interior primal iterate and positive bound multipliers chosen
    # so the complementarity products x_i*z_i span [mu^2, 1] log-uniformly
    # (geometric center mu) — this is what a primal-dual IPM looks like near
    # convergence; the extra 1/(x-l), 1/(u-x) dual scaling is the source of
    # the fixtures' wide diagonal spread.
    t = rng.uniform(0.15, 0.85, size=n)
    x = lo + t * (hi - lo)
    z_lo = mu ** rng.uniform(0.0, 2.0, size=n) / (x - lo)
    z_hi = mu ** rng.uniform(0.0, 2.0, size=n) / (hi - x)
    # The Newton RHS comes from the actual KKT residuals at the iterate; the
    # nonzero constraint part b_primal exercises the driver's RHS-shift path
    # (reg_cpkrylov.m:152-160), matching the shipped fixtures.
    y = rng.standard_normal(m)
    return dict(Q=Q, J=J, s_lo=x - lo, s_hi=hi - x, z_lo=z_lo, z_hi=z_hi,
                b_dual=-(Q @ x + J.T @ y - z_lo + z_hi),
                b_primal=-(J @ x - rhs_eq - delta * y))


def cvxqp_kkt(family: str, n: int | str = "s", *, mu: float = 1e-4,
              rho: float = 0.0, delta: float = 1e-8, seed: int = 0,
              g_mode: str = "diag") -> SaddleSystem:
    """CVXQP{1,2,3} KKT system at a simulated interior-point iterate.

    ``n`` may be an int or a catalogue size letter ("s"/"m"/"l" — the -S/-M/-L
    suffixes of the Maros–Mészáros names).  ``delta`` defaults to the 1e-8
    pure delta-regularization measured in the shipped fixtures.  ``g_mode``
    selects the preconditioner block G: "diag" (Jacobi of H, as the
    reference's examples build it, cpk_exprog1.m:59-64) or "identity".
    """
    it = _cvxqp_iterate(family, n, mu, delta, seed)
    n, m = it["Q"].shape[0], it["J"].shape[0]
    barrier = it["z_lo"] / it["s_lo"] + it["z_hi"] / it["s_hi"]

    H = (it["Q"] + sp.diags(barrier)).tocsr()
    if rho:
        H = (H + rho * sp.identity(n)).tocsr()
    C = (delta * sp.identity(m)).tocsr()
    if g_mode == "diag":
        G = sp.diags(H.diagonal()).tocsr()
    elif g_mode == "identity":
        G = sp.identity(n, format="csr")
    else:
        raise ValueError(f"unknown g_mode {g_mode!r}")

    K = sp.bmat([[H, it["J"].T], [it["J"], -C]], format="csr")
    b = np.concatenate([it["b_dual"], it["b_primal"]])
    return SaddleSystem(name=f"{family}_{n}", A=H, B=it["J"], C=C, G=G, b=b,
                        K=K)


def cvxqp_kkt_unreduced(family: str, n: int | str = "s", *,
                        mu: float = 1e-4, delta: float = 1e-8,
                        sigma: float = 0.1, seed: int = 0) -> SaddleSystem:
    """CVXQP{1,2,3} Newton system at ``cvxqp_kkt``'s iterate with the bound
    multipliers kept: the unknowns are (dx, dz_l, dz_u | dy) and

        A = [[Q,    -I,    I  ],     B = [J, 0, 0],   C = delta I,
             [Z_l,  X-L,   0  ],     G = diag(A),
             [-Z_u, 0,     U-X]],

    nonsymmetric, as the reference's second example builds its 3x3 system
    (cpk_exprog2.m, solved by CPGMRES with G = diag(A)).  The right-hand
    side is the negated dual residual ``Qx + J'y - z_l + z_u``, the
    centred complementarity ``sigma mu e - (X-L) z_l`` and ``sigma mu e -
    (U-X) z_u``, then the negated primal residual.  The iterate is
    ``cvxqp_kkt``'s: eliminating dz_l and dz_u gives its H = Q + Z_l
    (X-L)^-1 + Z_u (U-X)^-1 and its J and C.
    """
    it = _cvxqp_iterate(family, n, mu, delta, seed)
    Q, J = it["Q"], it["J"]
    (n, m) = Q.shape[0], J.shape[0]
    s_lo, s_hi, z_lo, z_hi = it["s_lo"], it["s_hi"], it["z_lo"], it["z_hi"]
    eye = sp.identity(n, format="csr")
    A = sp.bmat([[Q, -eye, eye],
                 [sp.diags(z_lo), sp.diags(s_lo), None],
                 [sp.diags(-z_hi), None, sp.diags(s_hi)]], format="csr")
    B = sp.hstack([J, sp.csr_matrix((m, 2 * n))], format="csr")
    C = (delta * sp.identity(m)).tocsr()
    G = sp.diags(A.diagonal()).tocsr()
    K = sp.bmat([[A, B.T], [B, -C]], format="csr")
    b = np.concatenate([it["b_dual"], sigma * mu - s_lo * z_lo,
                        sigma * mu - s_hi * z_hi, it["b_primal"]])
    return SaddleSystem(name=f"{family}_{n}_unreduced", A=A, B=B, C=C, G=G,
                        b=b, K=K)


# ---------------------------------------------------------------------------
# AUG2D / AUG3D family — expanded-system grid problems
# ---------------------------------------------------------------------------

#: grid extents per catalogue letter (2-D and 3-D members).
AUG_SIZES = {"2d": {"s": 10, "m": 100, "l": 316},
             "3d": {"s": 5, "m": 16, "l": 48}}


def grid_incidence(dims: tuple[int, ...]) -> sp.csr_matrix:
    """Node-edge incidence matrix of a regular grid graph.

    Rows = nodes (the LAST node is dropped so the matrix has full row
    rank — the incidence of a connected graph is rank #nodes-1), columns =
    edges along each axis; entries +1 at the edge head, -1 at the tail.
    This is the discrete-divergence operator of the AUG2D/AUG3D
    "expanded system" formulation (Maros-Meszaros: min x'x/2 s.t. A x = c
    from a 2-D/3-D framework/Laplacian problem).
    """
    nnodes = int(np.prod(dims))
    node_id = np.arange(nnodes).reshape(dims)
    rows, cols, vals = [], [], []
    edge = 0
    for ax in range(len(dims)):
        head = np.moveaxis(node_id, ax, 0)[1:].reshape(-1)
        tail = np.moveaxis(node_id, ax, 0)[:-1].reshape(-1)
        ne = head.size
        eids = edge + np.arange(ne)
        rows.append(head)
        cols.append(eids)
        vals.append(np.ones(ne))
        rows.append(tail)
        cols.append(eids)
        vals.append(-np.ones(ne))
        edge += ne
    J = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(nnodes, edge))
    return J[:-1]                       # drop one node: full row rank


def aug_kkt(dim: str = "2d", n: int | str = "s", *, mu: float = 1e-4,
            delta: float = 1e-8, seed: int = 0,
            g_mode: str = "identity") -> SaddleSystem:
    """AUG2D/AUG3D-style KKT system (bounded variant, barrier iterate).

    The expanded-system formulation  min 1/2 x'x - b'x  s.t.  J x = c  with
    J the grid divergence gives the KKT blocks H = I (+ barrier diagonal
    for the AUG*CQP bounded variants), B = J, C = delta*I.  With bounds the
    simulated interior-point iterate adds the log-uniform barrier diagonal
    (same iterate model as ``cvxqp_kkt``), so G = I is an *approximation*
    of H and the kernels do real work; g_mode="diag" gives the exact-Jacobi
    preconditioner (H diagonal => one-iteration convergence — the
    degenerate sanity case).
    """
    key = dim.lower()
    if key not in AUG_SIZES:
        raise ValueError(f"unknown AUG member {dim!r} (use '2d' or '3d')")
    if isinstance(n, str):
        n = AUG_SIZES[key][n.lower()]
    dims = (n, n) if key == "2d" else (n, n, n)
    J = grid_incidence(dims)
    m, nvar = J.shape

    rng = np.random.default_rng(seed)
    # bounded variant: barrier diagonal from an interior iterate in
    # 0.1 <= x <= 10 (complementarity products span [mu^2, 1], see
    # cvxqp_kkt).
    lo, hi = 0.1, 10.0
    x = lo + rng.uniform(0.15, 0.85, size=nvar) * (hi - lo)
    z_lo = mu ** rng.uniform(0.0, 2.0, size=nvar) / (x - lo)
    z_hi = mu ** rng.uniform(0.0, 2.0, size=nvar) / (hi - x)
    barrier = z_lo / (x - lo) + z_hi / (hi - x)

    H = sp.diags(1.0 + barrier).tocsr()
    C = (delta * sp.identity(m)).tocsr()
    if g_mode == "identity":
        G = sp.identity(nvar, format="csr")
    elif g_mode == "diag":
        G = sp.diags(H.diagonal()).tocsr()
    else:
        raise ValueError(f"unknown g_mode {g_mode!r}")

    K = sp.bmat([[H, J.T], [J, -C]], format="csr")
    y = rng.standard_normal(m)
    b1 = -(x + J.T @ y - z_lo + z_hi)          # dual residual of min x'x/2
    b2 = -(J @ x - 1.0 - delta * y)            # unit net-flow demand
    b = np.concatenate([b1, b2])
    return SaddleSystem(name=f"aug{key}_{n}", A=H, B=J, C=C, G=G, b=b, K=K)


def mm_suite(size: int | str = "s", *, mu: float = 1e-4,
             delta: float = 1e-8, seed: int = 0,
             families: tuple[str, ...] = ("cvxqp1", "cvxqp2", "cvxqp3",
                                          "aug2d", "aug3d")
             ) -> list[SaddleSystem]:
    """The Maros-Meszaros sweep suite at one catalogue size."""
    out = []
    for f in families:
        if f.startswith("cvxqp"):
            out.append(cvxqp_kkt(f, size, mu=mu, delta=delta, seed=seed))
        elif f.startswith("aug"):
            out.append(aug_kkt(f[3:], size if isinstance(size, str) else "s",
                               mu=mu, delta=delta, seed=seed))
        else:
            raise ValueError(f"unknown family {f!r}")
    return out
