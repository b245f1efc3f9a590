"""The frozen generators build the port's own systems bit for bit."""
import numpy as np
import pytest

from cpkrylov_tpu_torch.utils.fixtures import banded_saddle_system
from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt
from portbench.gen import banded, cvxqp


def _same(a, b):
    assert a.shape == b.shape
    d = (a - b).tocsr()
    d.eliminate_zeros()
    assert d.nnz == 0
    assert np.array_equal(a.tocsr().indices, b.tocsr().indices)
    assert np.array_equal(a.tocsr().data, b.tocsr().data)


@pytest.mark.parametrize("member", ["cvxqp1", "cvxqp2", "cvxqp3"])
@pytest.mark.parametrize("seed,mu,rho", [(0, 1e-4, 0.0), (3, 1e-2, 1e-6)])
def test_cvxqp_copy_is_bit_identical(member, seed, mu, rho):
    ref = cvxqp_kkt(member, "s", mu=mu, rho=rho, delta=1e-8, seed=seed)
    got = cvxqp.Family({"member": member, "n": 100, "mu": mu, "rho": rho,
                        "delta": 1e-8, "seed": seed}).base()
    for name in "ABCG":
        _same(getattr(got, name), getattr(ref, name))
    assert np.array_equal(got.b, ref.b)


@pytest.mark.parametrize("seed", [0, 5])
def test_banded_copy_is_bit_identical(seed):
    ref = banded_saddle_system(2000, 500, bandwidth=3, delta=1e-4, seed=seed,
                               with_oracle=False)
    got = banded.Family({"n": 2000, "m": 500, "bandwidth": 3,
                         "delta": 1e-4, "seed": seed}).base()
    for name in "ABCG":
        _same(getattr(got, name), getattr(ref, name))
    assert np.array_equal(got.b, ref.b)


def test_requests_follow_the_seed():
    fam = cvxqp.Family({"member": "cvxqp3", "n": 100, "mu": 1e-4,
                        "rho": 0.0, "delta": 1e-8, "seed": 0})
    r1 = fam.rhs(np.random.default_rng([2**33 + 1, 0, 4]))
    r2 = fam.rhs(np.random.default_rng([2**33 + 1, 0, 4]))
    r3 = fam.rhs(np.random.default_rng([2**33 + 2, 0, 4]))
    assert np.array_equal(r1, r2) and not np.array_equal(r1, r3)
    assert np.any(r1[100:] != 0)          # b2 nonzero: the driver shifts
    it = fam.iterate(np.random.default_rng(9))
    base = fam.base()
    assert (it.A != base.A).nnz > 0 and (it.G != base.G).nnz > 0
    assert (it.B != base.B).nnz == 0
