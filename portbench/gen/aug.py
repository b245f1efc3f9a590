"""AUG2D/AUG3D expanded-system KKT systems at a simulated interior-point
iterate.

A frozen copy of ``cpkrylov_tpu_torch/utils/mm.py::grid_incidence`` and
``aug_kkt`` (numpy and scipy only; the same seeded draws in the same
order, so both build the same matrices bit for bit), with the request the
traffic mixes ask of it:

* ``rhs``: a Newton right-hand side at a fresh draw of the primal iterate,
  the bound multipliers and y, around the configuration's own barrier
  matrix (the predictor and corrector solves of one KKT matrix); b2 is
  the primal residual, nonzero.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .cvxqp import HI, LO, System, _iterate

DEMAND = 1.0


def grid_incidence(dims: tuple) -> sp.csr_matrix:
    """Node-edge incidence of a regular grid, +1 at an edge's head and -1
    at its tail, edges along each axis in turn; the last node dropped for
    full row rank."""
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
    return J[:-1]


def _newton_rhs(rng, J, x, z_lo, z_hi, delta: float) -> np.ndarray:
    """b1 = -(dual residual of min x'x/2), b2 = -(primal residual) at
    (x, y), y ~ N(0, 1)."""
    y = rng.standard_normal(J.shape[0])
    b1 = -(x + J.T @ y - z_lo + z_hi)
    b2 = -(J @ x - DEMAND - delta * y)
    return np.concatenate([b1, b2])


class Family:
    """The generator of one configuration (its ``generator`` block)."""

    def __init__(self, gen: dict):
        self.dim = gen["dim"].lower()
        if self.dim not in ("2d", "3d"):
            raise ValueError(f"unknown AUG member {gen['dim']!r}")
        self.grid = int(gen["grid"])
        self.mu = float(gen["mu"])
        self.delta = float(gen["delta"])
        self.g_mode = gen["g_mode"]
        self.seed = int(gen["seed"])
        dims = (self.grid,) * (2 if self.dim == "2d" else 3)
        self.J = grid_incidence(dims)
        self.m, self.n = self.J.shape

    def base(self) -> System:
        """The configuration's own system: ``aug_kkt`` at its seed."""
        rng = np.random.default_rng(self.seed)
        x, z_lo, z_hi = _iterate(rng, self.n, self.mu)
        barrier = z_lo / (x - LO) + z_hi / (HI - x)
        H = sp.diags(1.0 + barrier).tocsr()
        C = (self.delta * sp.identity(self.m)).tocsr()
        if self.g_mode == "identity":
            G = sp.identity(self.n, format="csr")
        elif self.g_mode == "diag":
            G = sp.diags(H.diagonal()).tocsr()
        else:
            raise ValueError(f"unknown g_mode {self.g_mode!r}")
        b = _newton_rhs(rng, self.J, x, z_lo, z_hi, self.delta)
        return System(A=H, B=self.J, C=C, G=G, b=b)

    def rhs(self, rng) -> np.ndarray:
        x, z_lo, z_hi = _iterate(rng, self.n, self.mu)
        return _newton_rhs(rng, self.J, x, z_lo, z_hi, self.delta)
