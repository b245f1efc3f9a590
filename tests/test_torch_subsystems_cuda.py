"""The port's auxiliary subsystems on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture).  No JAX is needed, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_subsystems_cuda.py -q

* a checkpoint of a preconditioner saved and loaded on the card, into a
  template and from the file alone: tensors back on ``cuda:0`` and a
  bit-identical direct solve and full solve;
* the mixed f32 solve (f32 inner solves, f64 true residual on the host) on
  ``cvxqp_kkt("cvxqp3", "s")`` and ``aug_kkt("2d", 20)``, which reaches
  the contract ``|b - K x| <= atol + rtol |b|``;
* ``to_dense_inverse`` on the card against the CPU one (relative 1e-10 in
  f64: the two sum in other orders).
"""
import numpy as np
import pytest
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.utils import fixtures, mm
from cpkrylov_tpu_torch.utils.checkpoint import load_pytree, save_pytree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoint_on_the_card(cuda, tmp_path, dtype):
    s = mm.cvxqp_kkt("cvxqp3", "s")
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=dtype, device=cuda)
    path = str(tmp_path / "m.npz")
    save_pytree(M, path)
    M2 = load_pytree(M, path)
    assert M2.kp.data.device == cuda and M2.factor.dinv.device == cuda
    z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        M.n + M.m), dtype=dtype, device=cuda)
    assert torch.equal(M._direct_solve(z), M2._direct_solve(z))
    # the file alone, loaded to the default device: the card
    M3 = load_pytree(None, path)
    assert M3.kp.data.device == cuda and M3.factor.dinv.device == cuda
    assert torch.equal(M._direct_solve(z), M3._direct_solve(z))
    opts = cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=1000)
    a = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M, opts=opts,
                  dtype=dtype, device=cuda)
    b = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M2, opts=opts,
                  dtype=dtype, device=cuda)
    assert a.solved and a.niters == b.niters
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("system", ["cvxqp3_s", "aug2d_20"])
def test_mixed_f32_reaches_the_contract(cuda, system):
    s = (mm.cvxqp_kkt("cvxqp3", "s") if system == "cvxqp3_s"
         else mm.aug_kkt("2d", 20))
    atol = rtol = 1e-6
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                    opts=cpt.SolverOptions(atol=atol, rtol=rtol, itmax=1000),
                    dtype=torch.float32, device=cuda)
    x = out.x.cpu().numpy().astype(np.float64)
    assert out.solved and out.x.dtype == torch.float64
    assert np.linalg.norm(s.b - s.K @ x) <= atol + rtol * np.linalg.norm(s.b)


def test_to_dense_inverse_on_the_card(cuda):
    s = fixtures.random_sqd_system(60, 25, seed=2, delta=1e-2)
    Mc = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device=cuda)
    Mh = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device="cpu")
    inv = Mc.to_dense_inverse()
    ref = Mh.to_dense_inverse().numpy()
    assert inv.device == cuda and inv.shape == (85, 85)
    got = inv.cpu().numpy()
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)
