"""CVXQP{1,2,3} KKT systems at a simulated interior-point iterate.

A frozen copy of ``cpkrylov_tpu_torch/utils/mm.py::cvxqp_problem`` and
``cvxqp_kkt`` (numpy and scipy only; the same seeded draws in the same
order, so both build the same matrices bit for bit), with the two kinds of
request the traffic mixes ask of a configuration:

* ``rhs``: a Newton right-hand side at a fresh draw of the primal iterate,
  the bound multipliers and y, around the configuration's own barrier
  matrix (the predictor and corrector solves of one KKT matrix);
* ``iterate``: a whole new iterate at the same mu, so H, G and b change.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

#: constraint count as a fraction of n, per family member.
CVXQP_M_FRAC = {"cvxqp1": 0.5, "cvxqp2": 0.25, "cvxqp3": 0.75}
LO, HI, RHS_EQ = 0.1, 10.0, 6.0


@dataclasses.dataclass
class System:
    """One saddle-point system [A B'; B -C] x = b, with G for the
    preconditioner, as host scipy matrices and a numpy rhs."""

    A: sp.csr_matrix
    B: sp.csr_matrix
    C: sp.csr_matrix
    G: sp.csr_matrix
    b: np.ndarray


def cvxqp_problem(family: str, n: int):
    """Analytic CVXQP data (CUTE SIF): (Q, J, m)."""
    m = int(round(CVXQP_M_FRAC[family] * n))
    i1 = np.arange(1, n + 1)
    rows = np.repeat(np.arange(n), 3)
    cols = np.stack([i1 - 1, (2 * i1 - 1) % n, (3 * i1 - 1) % n],
                    axis=1).reshape(-1)
    P = sp.csr_matrix((np.ones(3 * n), (rows, cols)), shape=(n, n))
    Q = (P.T @ sp.diags(i1.astype(np.float64)) @ P).tocsr()
    Q.sum_duplicates()
    ic = np.arange(1, m + 1)
    jrows = np.repeat(np.arange(m), 3)
    jcols = np.stack([ic - 1, (4 * ic - 1) % n, (5 * ic - 1) % n],
                     axis=1).reshape(-1)
    jvals = np.tile(np.array([1.0, 2.0, 3.0]), m)
    J = sp.csr_matrix((jvals, (jrows, jcols)), shape=(m, n))
    J.sum_duplicates()
    return Q, J, m


def _iterate(rng, n: int, mu: float):
    """Primal iterate strictly inside the bounds and bound multipliers whose
    complementarity products span [mu^2, 1] log-uniformly."""
    x = LO + rng.uniform(0.15, 0.85, size=n) * (HI - LO)
    z_lo = mu ** rng.uniform(0.0, 2.0, size=n) / (x - LO)
    z_hi = mu ** rng.uniform(0.0, 2.0, size=n) / (HI - x)
    return x, z_lo, z_hi


def _newton_rhs(rng, Q, J, x, z_lo, z_hi, delta: float) -> np.ndarray:
    """b1 = -(dual residual), b2 = -(primal residual) at (x, y), y ~ N(0,1)."""
    y = rng.standard_normal(J.shape[0])
    b1 = -(Q @ x + J.T @ y - z_lo + z_hi)
    b2 = -(J @ x - RHS_EQ - delta * y)
    return np.concatenate([b1, b2])


def _system(Q, J, x, z_lo, z_hi, b, delta: float, rho: float) -> System:
    barrier = z_lo / (x - LO) + z_hi / (HI - x)
    H = (Q + sp.diags(barrier)).tocsr()
    if rho:
        H = (H + rho * sp.identity(H.shape[0])).tocsr()
    C = (delta * sp.identity(J.shape[0])).tocsr()
    G = sp.diags(H.diagonal()).tocsr()
    return System(A=H, B=J, C=C, G=G, b=b)


class Family:
    """The generator of one configuration (its ``generator`` block)."""

    def __init__(self, gen: dict):
        self.family = gen["member"]
        self.n = int(gen["n"])
        self.mu = float(gen["mu"])
        self.rho = float(gen["rho"])
        self.delta = float(gen["delta"])
        self.seed = int(gen["seed"])
        self.Q, self.J, self.m = cvxqp_problem(self.family, self.n)

    def base(self) -> System:
        """The configuration's own system: ``cvxqp_kkt`` at its seed."""
        rng = np.random.default_rng(self.seed)
        x, z_lo, z_hi = _iterate(rng, self.n, self.mu)
        b = _newton_rhs(rng, self.Q, self.J, x, z_lo, z_hi, self.delta)
        return _system(self.Q, self.J, x, z_lo, z_hi, b, self.delta,
                       self.rho)

    def rhs(self, rng) -> np.ndarray:
        x, z_lo, z_hi = _iterate(rng, self.n, self.mu)
        return _newton_rhs(rng, self.Q, self.J, x, z_lo, z_hi, self.delta)

    def iterate(self, rng) -> System:
        x, z_lo, z_hi = _iterate(rng, self.n, self.mu)
        b = _newton_rhs(rng, self.Q, self.J, x, z_lo, z_hi, self.delta)
        return _system(self.Q, self.J, x, z_lo, z_hi, b, self.delta,
                       self.rho)
