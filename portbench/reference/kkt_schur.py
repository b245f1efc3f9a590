"""The solution of a saddle-point system with diagonal H and C, in plain
PyTorch float64: a second reference, independent of the program's factor
path.

For

    [H  J'] [x1]   [b1]
    [J  -C] [x2] = [b2]

with H and C diagonal, it eliminates x1 (the range-space form):

    S = C + J H^-1 J',   S x2 = J H^-1 b1 - b2,   x1 = H^-1 (b1 - J' x2),

and solves S by conjugate gradients preconditioned by S's diagonal, with
``torch.sparse`` products of J and J', to ||r|| <= 1e-13 ||rhs||.  It
shares nothing with the program's LDL, ordering or scan, so a fault in the
factor path cannot hide in it; it imports nothing of the program and no
kernel, takes the host scipy blocks the benchmark made, and runs on the
CPU or the card.  The harness's ``correct`` stays ``residual.py``; this
module serves the comparisons of ``tools/aug_reference.py`` and the tests.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

CG_RTOL = 1e-13


@dataclasses.dataclass(frozen=True)
class Solved:
    """x = [x1; x2] and the reference's own readings of it."""

    x: torch.Tensor
    cg_iters: int
    cg_rel: float        # CG's recursive residual over ||rhs|| at its stop
    schur_rel: float     # ||rhs - S x2|| / ||rhs||, recomputed
    kkt_rel: float       # ||b - K x|| / ||b||, recomputed


def _diagonal(M, name: str) -> np.ndarray:
    coo = M.tocoo()
    if np.any(coo.row != coo.col):
        raise ValueError(f"{name} is not diagonal")
    return np.asarray(M.diagonal(), dtype=np.float64)


def _csr(M, device) -> torch.Tensor:
    M = M.tocsr()
    M.sum_duplicates()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse (CSR tensor support|"
                                "invariant checks)")
        return torch.sparse_csr_tensor(
            torch.as_tensor(M.indptr.astype(np.int64)),
            torch.as_tensor(M.indices.astype(np.int64)),
            torch.as_tensor(M.data.astype(np.float64)),
            size=M.shape, device=device, check_invariants=True)


class KKTSchur:
    """The system's blocks on ``device``, ready for ``solve(b)``.  ``A`` is
    H, ``B`` is J, ``C`` is C: host scipy matrices."""

    def __init__(self, A, B, C, device="cpu"):
        self.device = torch.device(device)
        h = _diagonal(A, "H")
        c = _diagonal(C, "C")
        self.n, self.m = h.shape[0], c.shape[0]
        f64 = dict(dtype=torch.float64, device=self.device)
        self.h = torch.as_tensor(h, **f64)
        self.hinv = 1.0 / self.h
        self.c = torch.as_tensor(c, **f64)
        self.J = _csr(B, self.device)
        self.JT = _csr(B.T, self.device)
        J2 = B.tocsr().multiply(B.tocsr())
        self.sdiag = self.c + torch.as_tensor(J2 @ (1.0 / h), **f64)

    def schur(self, v: torch.Tensor) -> torch.Tensor:
        return self.c * v + self.J @ (self.hinv * (self.JT @ v))

    def kkt(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[: self.n], x[self.n:]
        return torch.cat([self.h * x1 + self.JT @ x2,
                          self.J @ x1 - self.c * x2])

    def solve(self, b, rtol: float = CG_RTOL,
              maxiter: int | None = None) -> Solved:
        """x for the right-hand side ``b`` (numpy or tensor); raises
        RuntimeError when CG does not reach ``rtol``."""
        b = torch.as_tensor(np.asarray(b, dtype=np.float64)).to(self.device)
        b1, b2 = b[: self.n], b[self.n:]
        rhs = self.J @ (self.hinv * b1) - b2
        rhs_norm = float(torch.linalg.vector_norm(rhs))
        maxiter = maxiter or 20 * self.m
        x2 = torch.zeros_like(rhs)
        r = rhs.clone()
        z = r / self.sdiag
        p = z.clone()
        rz = torch.dot(r, z)
        it, rnorm = 0, rhs_norm
        while rnorm > rtol * rhs_norm:
            if it == maxiter:
                raise RuntimeError(f"CG on S: {rnorm / rhs_norm:.3e} after "
                                   f"{it} iterations")
            q = self.schur(p)
            alpha = rz / torch.dot(p, q)
            x2 += alpha * p
            r -= alpha * q
            z = r / self.sdiag
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            rnorm = float(torch.linalg.vector_norm(r))
            it += 1
        x1 = self.hinv * (b1 - self.JT @ x2)
        x = torch.cat([x1, x2])
        schur_rel = float(torch.linalg.vector_norm(rhs - self.schur(x2))
                          / max(rhs_norm, 1e-300))
        kkt_rel = float(torch.linalg.vector_norm(b - self.kkt(x))
                        / max(float(torch.linalg.vector_norm(b)), 1e-300))
        return Solved(x=x, cg_iters=it, cg_rel=rnorm / max(rhs_norm, 1e-300),
                      schur_rel=schur_rel, kkt_rel=kkt_rel)


def rel_err(x, x_ref: torch.Tensor) -> float:
    """||x - x_ref|| / ||x_ref|| in float64, on the reference's device."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float64)
                        if not isinstance(x, torch.Tensor) else x)
    x = x.to(dtype=torch.float64, device=x_ref.device).reshape(-1)
    return float(torch.linalg.vector_norm(x - x_ref)
                 / torch.linalg.vector_norm(x_ref))
