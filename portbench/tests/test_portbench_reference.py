"""The plain reference on the CPU at small sizes."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from portbench.gen import banded, cvxqp
from portbench.reference.residual import residual_ratio


def _k(s):
    return sp.bmat([[s.A, s.B.T], [s.B, -s.C]], format="csc")


def test_direct_solution_reads_far_below_the_contract():
    s = banded.Family({"n": 3000, "m": 700, "bandwidth": 3, "delta": 1e-4,
                       "seed": 1}).base()
    x = spla.spsolve(_k(s), s.b)
    assert residual_ratio(s.A, s.B, s.C, s.b, x, 0.0, 1e-6) < 1e-3


def test_ratio_matches_the_assembled_product():
    s = cvxqp.Family({"member": "cvxqp3", "n": 100, "mu": 1e-4, "rho": 0.0,
                      "delta": 1e-8, "seed": 0}).base()
    x = np.random.default_rng(0).standard_normal(s.b.size)
    want = (np.linalg.norm(s.b - _k(s).toarray() @ x)
            / (1e-6 + 1e-6 * np.linalg.norm(s.b)))
    got = residual_ratio(s.A, s.B, s.C, s.b, x, 1e-6, 1e-6)
    assert abs(got - want) <= 1e-12 * want


def test_zero_and_non_finite_answers():
    s = banded.Family({"n": 500, "m": 100, "bandwidth": 3, "delta": 1e-4,
                       "seed": 2}).base()
    z = np.zeros(s.b.size)
    assert residual_ratio(s.A, s.B, s.C, s.b, z, 0.0, 1e-6) == \
        pytest.approx(1e6, rel=1e-14)
    z[3] = np.nan
    assert residual_ratio(s.A, s.B, s.C, s.b, z, 0.0, 1e-6) == float("inf")
