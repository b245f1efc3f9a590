"""Test-system fixtures: the shipped CVXQP saddle-point systems plus
synthetic generators.

Port of ``cpkrylov_tpu/utils/fixtures.py`` (numpy/scipy only).  The port keeps
its own copy so that importing it never imports the JAX package.  The
generators draw from the same seeded numpy streams in the same order, so both
packages build identical systems.  The CVXQP systems are read from the
repository's ``data/*.npz``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.sparse as sp

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")

FIXTURES = {
    "cvxqp1_m": ("cvxqp1_m_2x2_symm_iter10", "2x2"),
    "cvxqp2_s": ("cvxqp2_s_3x3_nonsymm_perm_iter10", "3x3"),
}


@dataclasses.dataclass
class SaddleSystem:
    """One regularized saddle-point system split into blocks."""

    name: str
    A: sp.csr_matrix        # (n, n) leading block (Q in the examples)
    B: sp.csr_matrix        # (m, n) constraint block
    C: sp.csr_matrix        # (m, m), -C is the (2,2) block of K
    G: sp.csr_matrix        # preconditioner leading block
    b: np.ndarray           # (n+m,) right-hand side
    K: sp.csr_matrix        # full (n+m, n+m) matrix (oracle direct solves)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.C.shape[0]


def _npz_path(name: str) -> str:
    stem, _ = FIXTURES[name]
    return os.path.join(_DATA_DIR, stem + ".npz")


def load_fixture(name: str) -> SaddleSystem:
    """Load and block-slice one of the shipped CVXQP systems (the slicing of
    the reference examples cpk_exprog1.m:45-64 / cpk_exprog2.m:47-66)."""
    _, kind = FIXTURES[name]
    with np.load(_npz_path(name), allow_pickle=False) as z:
        K = sp.csr_matrix((z["K_data"], z["K_indices"], z["K_indptr"]),
                          shape=tuple(z["K_shape"]))
        rhs = z["rhs"].reshape(-1)
        nH, nJ, nZ = int(z["nH"]), int(z["nJ"]), int(z["nZ"])
    n = nH if kind == "2x2" else nH + nZ
    m = nJ
    Q = K[:n, :n].tocsr()
    B = K[n:, :n].tocsr()
    C = (-K[n:, n:]).tocsr()
    G = sp.diags(Q.diagonal()).tocsr()
    return SaddleSystem(name=name, A=Q, B=B, C=C, G=G, b=rhs, K=K)


def fixture_available(name: str) -> bool:
    return os.path.exists(_npz_path(name))


def random_sqd_system(n: int, m: int, *, density: float = 0.05,
                      delta: float = 1e-4, seed: int = 0,
                      nonsymmetric: bool = False,
                      g_exact: bool = False) -> SaddleSystem:
    """Random regularized saddle-point system with SPD A and C = delta*I.

    ``g_exact=True`` sets G = A; otherwise G = diag(A) as in the reference
    examples.
    """
    rng = np.random.default_rng(seed)
    Araw = sp.random(n, n, density=density, random_state=rng, format="csr")
    A = Araw + Araw.T + sp.diags(np.full(n, 4.0 + density * n * 0.5))
    if nonsymmetric:
        S = sp.random(n, n, density=density / 2, random_state=rng,
                      format="csr")
        A = A + 0.3 * (S - S.T)
    B = sp.random(m, n, density=min(1.0, density * 2), random_state=rng,
                  format="csr")
    B = B + sp.csr_matrix(
        (np.ones(m), (np.arange(m), np.arange(m))), shape=(m, n)
    )  # ensure full row rank
    C = sp.diags(np.full(m, delta)).tocsr()
    Asym = 0.5 * (A + A.T)
    G = Asym.tocsr() if g_exact else sp.diags(Asym.diagonal()).tocsr()
    K = sp.bmat([[A, B.T], [B, -C]], format="csr")
    b = rng.standard_normal(n + m)
    return SaddleSystem(name=f"random_sqd_{n}x{m}", A=A.tocsr(), B=B, C=C,
                        G=G, b=b, K=K)


def banded_saddle_system(n: int, m: int, *, bandwidth: int = 3,
                         delta: float = 1e-4, seed: int = 0,
                         with_oracle: bool = True,
                         g_mode: str = "diag",
                         b_mode: str = "unit") -> SaddleSystem:
    """Large banded regularized saddle-point system (the main-path workload).

    Built from ``sp.diags`` in O(n * bandwidth) memory.  A is SPD banded, B a
    banded (m, n) block with unit main diagonal (full row rank), C = delta*I.
    ``with_oracle=False`` skips assembling K.
    """
    rng = np.random.default_rng(seed)
    main = 4.0 + rng.random(n)
    a_diags = [main]
    a_offsets = [0]
    for off in range(1, bandwidth + 1):
        band = 0.5 * rng.standard_normal(n - off) / off
        a_diags += [band, band]
        a_offsets += [off, -off]
    A = sp.diags(a_diags, a_offsets, shape=(n, n), format="csr")
    if b_mode == "unit":
        b_band = 0.25 * rng.standard_normal(min(m, n - 1))
        B = sp.diags([np.ones(m), b_band], [0, 1], shape=(m, n),
                     format="csr")
    elif b_mode == "slope":
        c = max(1, n // m)
        rows = np.repeat(np.arange(m), 2)
        cols = np.stack([c * np.arange(m),
                         np.minimum(c * np.arange(m) + 1, n - 1)],
                        axis=1).reshape(-1)
        vals = np.stack([np.ones(m), 0.25 * rng.standard_normal(m)],
                        axis=1).reshape(-1)
        B = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
        B.sum_duplicates()
    else:
        raise ValueError(f"unknown b_mode {b_mode!r}")
    C = sp.diags(np.full(m, delta)).tocsr()
    if g_mode == "diag":
        G = sp.diags(A.diagonal()).tocsr()
    elif g_mode == "banded":
        Asym = 0.5 * (A + A.T)
        G = sp.diags([Asym.diagonal(), Asym.diagonal(1), Asym.diagonal(1)],
                     [0, 1, -1]).tocsr()
    else:
        raise ValueError(f"unknown g_mode {g_mode!r}")
    K = (sp.bmat([[A, B.T], [B, -C]], format="csr") if with_oracle
         else sp.csr_matrix((1, 1)))
    b = rng.standard_normal(n + m)
    return SaddleSystem(name=f"banded_{n}x{m}_bw{bandwidth}", A=A, B=B, C=C,
                        G=G, b=b, K=K)


def ipm_kkt_system(n: int, m: int, *, mu: float = 1e-4, rho: float = 1e-6,
                   delta: float = 1e-6, density: float = 0.01,
                   seed: int = 0) -> SaddleSystem:
    """Interior-point-like KKT system (Maros-Meszaros analogue).

    Mirrors the structure of the reference's fixtures
    (examples/cpk_exprog1.m:10-17): leading block H + rho*I plus a barrier
    diagonal S^{-1}Z whose entries spread as mu -> 0 (ill-conditioning knob),
    constraint block J, and -delta*I regularization.  The draws follow the
    JAX package's order, so both build the same matrices and rhs.
    """
    rng = np.random.default_rng(seed)
    Hraw = sp.random(n, n, density=density, random_state=rng, format="csr")
    H = Hraw + Hraw.T
    H = H + sp.diags(np.abs(H).sum(axis=1).A1 + 1.0)  # diagonally dominant
    # barrier diagonal: entries from mu to 1/mu (log-uniform)
    expo = rng.uniform(-1.0, 1.0, size=n)
    barrier = mu ** expo
    Q = (H + sp.diags(barrier) + rho * sp.identity(n)).tocsr()
    J = sp.random(m, n, density=min(1.0, density * 4), random_state=rng,
                  format="csr")
    J = J + sp.csr_matrix((np.ones(m), (np.arange(m), np.arange(m))),
                          shape=(m, n))
    C = (delta * sp.identity(m)).tocsr()
    G = sp.diags(Q.diagonal()).tocsr()
    K = sp.bmat([[Q, J.T], [J, -C]], format="csr")
    b = rng.standard_normal(n + m)
    return SaddleSystem(name=f"ipm_kkt_{n}x{m}_mu{mu:g}", A=Q, B=J, C=C,
                        G=G, b=b, K=K)
