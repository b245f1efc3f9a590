"""The banded regularized saddle-point system of the main path.

A frozen copy of ``cpkrylov_tpu_torch/utils/fixtures.py::
banded_saddle_system`` with its defaults (``b_mode="unit"``,
``g_mode="diag"``, no assembled K; numpy and scipy only, the same seeded
draws in the same order, so both build the same matrices bit for bit).  A
request of kind ``rhs`` is a fresh N(0, 1) right-hand side, the
generator's own law.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .cvxqp import System


def banded_saddle_system(n: int, m: int, *, bandwidth: int, delta: float,
                         seed: int) -> System:
    rng = np.random.default_rng(seed)
    main = 4.0 + rng.random(n)
    a_diags = [main]
    a_offsets = [0]
    for off in range(1, bandwidth + 1):
        band = 0.5 * rng.standard_normal(n - off) / off
        a_diags += [band, band]
        a_offsets += [off, -off]
    A = sp.diags(a_diags, a_offsets, shape=(n, n), format="csr")
    b_band = 0.25 * rng.standard_normal(min(m, n - 1))
    B = sp.diags([np.ones(m), b_band], [0, 1], shape=(m, n), format="csr")
    C = sp.diags(np.full(m, delta)).tocsr()
    G = sp.diags(A.diagonal()).tocsr()
    b = rng.standard_normal(n + m)
    return System(A=A, B=B, C=C, G=G, b=b)


class Family:
    """The generator of one configuration (its ``generator`` block)."""

    def __init__(self, gen: dict):
        self.n = int(gen["n"])
        self.m = int(gen["m"])
        self.bandwidth = int(gen["bandwidth"])
        self.delta = float(gen["delta"])
        self.seed = int(gen["seed"])

    def base(self) -> System:
        return banded_saddle_system(self.n, self.m, bandwidth=self.bandwidth,
                                    delta=self.delta, seed=self.seed)

    def rhs(self, rng) -> np.ndarray:
        return rng.standard_normal(self.n + self.m)
