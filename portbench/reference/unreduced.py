"""The solution of an unreduced interior-point Newton system, in plain
PyTorch float64: a reference independent of the program's factor path.

The system's unknowns are (dx, dz_l, dz_u | dy) and its blocks are

    A = [[Q, -I, I], [Z_l, S_l, 0], [-Z_u, 0, S_u]],  B = [J, 0, 0],
    C diagonal,

with Z_l, S_l = X - L, Z_u and S_u = U - X diagonal (as the port's
``utils/mm.py::cvxqp_kkt_unreduced`` builds them).  The rows of the
multipliers give

    dz_l = S_l^-1 (r_l - Z_l dx),   dz_u = S_u^-1 (r_u + Z_u dx),

and eliminating them leaves the reduced system

    [Q + Z_l S_l^-1 + Z_u S_u^-1   J'] [dx]   [r_d + S_l^-1 r_l - S_u^-1 r_u]
    [J                            -C] [dy] = [r_p                          ],

which is solved dense by LU (``torch.linalg.lu_factor``, once a system)
on the CPU or the card; for CVXQP1-L that matrix is 15,000^2, 1.8 GB in
float64.  It checks the blocks' shape, shares nothing with the program's
LDL, ordering, factor or Krylov code, imports nothing of the program, and
turns TF32 off.  The harness's ``correct`` stays ``residual.py``; this
module serves ``tools/unreduced_reference.py`` and the tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .kkt_schur import _csr


@dataclasses.dataclass(frozen=True)
class Solved:
    """x = [dx; dz_l; dz_u; dy] and the reference's own reading of it."""

    x: torch.Tensor
    kkt_rel: float       # ||b - K x|| / ||b||, recomputed from the blocks


def _diag(M, name: str, sign: float = 1.0) -> np.ndarray:
    coo = sp.coo_matrix(M)
    if np.any(coo.row != coo.col):
        raise ValueError(f"{name} is not diagonal")
    return sign * np.asarray(M.diagonal(), dtype=np.float64)


def _dense(M, device) -> torch.Tensor:
    coo = sp.coo_matrix(M)
    out = torch.zeros(M.shape, dtype=torch.float64, device=device)
    idx = (torch.as_tensor(coo.row.astype(np.int64), device=device),
           torch.as_tensor(coo.col.astype(np.int64), device=device))
    out.index_put_(idx, torch.as_tensor(coo.data.astype(np.float64),
                                        device=device), accumulate=True)
    return out


class UnreducedReference:
    """The blocks of one unreduced system on ``device``, the reduced
    matrix factored once, ready for ``solve(b)``.  ``A``, ``B``, ``C``
    are host scipy matrices."""

    def __init__(self, A, B, C, device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        A, B = sp.csr_matrix(A), sp.csr_matrix(B)
        n3, m = A.shape[0], C.shape[0]
        if n3 % 3 or B.shape != (m, n3):
            raise ValueError("not an unreduced system's blocks")
        n = n3 // 3
        self.n, self.m = n, m
        eye = np.ones(n)
        if not (np.array_equal(_diag(A[:n, n:2 * n], "A12", -1.0), eye)
                and np.array_equal(_diag(A[:n, 2 * n:], "A13"), eye)
                and A[n:2 * n, 2 * n:].nnz == 0
                and A[2 * n:, n:2 * n].nnz == 0
                and B[:, n:].nnz == 0):
            raise ValueError("not an unreduced system's blocks")
        f64 = dict(dtype=torch.float64, device=self.device)
        self.z_l = torch.as_tensor(_diag(A[n:2 * n, :n], "Z_l"), **f64)
        self.s_l = torch.as_tensor(_diag(A[n:2 * n, n:2 * n], "S_l"), **f64)
        self.z_u = torch.as_tensor(_diag(A[2 * n:, :n], "Z_u", -1.0), **f64)
        self.s_u = torch.as_tensor(_diag(A[2 * n:, 2 * n:], "S_u"), **f64)
        self.c = torch.as_tensor(_diag(C, "C"), **f64)
        J = B[:, :n]
        K = _dense(sp.bmat([[A[:n, :n], J.T], [J, None]]), self.device)
        diag = K.diagonal()
        diag[:n] += self.z_l / self.s_l + self.z_u / self.s_u
        diag[n:] -= self.c
        self.lu = torch.linalg.lu_factor(K)
        del K
        self.A = _csr(A, self.device)
        self.B = _csr(B, self.device)
        self.BT = _csr(B.T, self.device)

    def kkt(self, x: torch.Tensor) -> torch.Tensor:
        """The unreduced system's product [A B'; B -C] x."""
        x1, x2 = x[:3 * self.n], x[3 * self.n:]
        return torch.cat([self.A @ x1 + self.BT @ x2,
                          self.B @ x1 - self.c * x2])

    def solve(self, b) -> Solved:
        """x for the right-hand side ``b`` (numpy or tensor)."""
        n = self.n
        b = torch.as_tensor(np.asarray(b, dtype=np.float64)).to(self.device)
        r_d, r_l, r_u = b[:n], b[n:2 * n], b[2 * n:3 * n]
        r_p = b[3 * n:]
        rhs = torch.cat([r_d + r_l / self.s_l - r_u / self.s_u, r_p])
        sol = torch.linalg.lu_solve(*self.lu, rhs[:, None])[:, 0]
        dx, dy = sol[:n], sol[n:]
        dz_l = (r_l - self.z_l * dx) / self.s_l
        dz_u = (r_u + self.z_u * dx) / self.s_u
        x = torch.cat([dx, dz_l, dz_u, dy])
        kkt_rel = float(torch.linalg.vector_norm(b - self.kkt(x))
                        / max(float(torch.linalg.vector_norm(b)), 1e-300))
        return Solved(x=x, kkt_rel=kkt_rel)
