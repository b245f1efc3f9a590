"""The port's main path as a whole: ``cpkrylov_tpu_torch.solve("cpminres",
...)`` on the CPU, against the golden baseline and the JAX package.

* cvxqp1_m in f64: 53 +- 2 iterations, rel-err < 5e-6 against scipy
  ``spsolve`` (tests/test_golden.py), and a residual history that overlaps
  ``data/golden_histories.npz`` within a factor 2 point by point
  (tests/test_history_golden.py).
* banded(8192, 2048): the interleave/bidiagonal/DIA layout of the main path;
  iteration count within +-1 of the JAX package's ``solve(...,
  spmv_format="dia")`` and x within 1e-8 relative (2-norm).
* the entry point's errors, and that importing the port leaves JAX out.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.utils import fixtures

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
POPTS = dict(residual_update=True, nitref=1, force_itref=True,
             itref_tol=1e-8)


@pytest.fixture(scope="module")
def cvxqp1_port():
    if not fixtures.fixture_available("cvxqp1_m"):
        pytest.skip("cvxqp1_m fixture unavailable")
    s = fixtures.load_fixture("cvxqp1_m")
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500),
                    precond_opts=cpt.PrecondOptions(**POPTS),
                    dtype=torch.float64, device="cpu")
    return s, out


def test_cvxqp1_golden_count_and_error(cvxqp1_port):
    s, out = cvxqp1_port
    assert out.solved, out.result.status
    assert abs(out.niters - 53) <= 2, out.niters
    x_ref = spla.spsolve(s.K.tocsc(), s.b)
    x = out.x.numpy()
    assert x.dtype == np.float64 and x.shape == (s.n + s.m,)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 5e-6
    np.testing.assert_array_equal(x[: s.n], out.x1.numpy())
    np.testing.assert_array_equal(x[s.n:], out.x2.numpy())


def test_cvxqp1_history_overlaps_golden(cvxqp1_port):
    _, out = cvxqp1_port
    golden = np.load(ROOT / "data" / "golden_histories.npz")
    ours, ref = out.resid_history, golden["cvxqp1_cpminres"]
    assert len(ours) == out.niters + 1
    assert abs(len(ours) - len(ref)) <= 2
    k = min(len(ours), len(ref))
    worst = np.max(np.abs(np.log10(ours[:k] / ref[:k])))
    assert worst <= np.log10(2.0), worst


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_matches_jax_dia(dtype):
    s = fixtures.banded_saddle_system(8192, 2048)
    # A plain f32 solve stalls near 1e-4 here (the JAX package's f32 solve
    # stalls earlier); the f32 route to 1e-6 is the mixed refinement
    # (tests/test_torch_mixed.py).  f32 checks the layout and a 1e-3 solve.
    sopts = dict(atol=0.0, rtol=1e-6 if dtype == torch.float64 else 1e-3,
                 itmax=200)
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                    opts=cpt.SolverOptions(**sopts),
                    precond_opts=cpt.PrecondOptions(**POPTS), dtype=dtype)
    assert out.solved and out.x.dtype == dtype
    if dtype == torch.float32:
        x64 = spla.spsolve(s.K.tocsc(), s.b)
        assert np.linalg.norm(out.x.numpy() - x64) / np.linalg.norm(x64) \
            < 1e-3
        return
    ref = cpk.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                    opts=cpk.SolverOptions(**sopts),
                    precond_opts=cpk.PrecondOptions(**POPTS),
                    spmv_format="dia")
    assert abs(out.niters - ref.niters) <= 1, (out.niters, ref.niters)
    x_ref = np.asarray(ref.x)
    assert (np.linalg.norm(out.x.numpy() - x_ref) / np.linalg.norm(x_ref)
            <= 1e-8)
    r = s.K @ out.x.numpy() - s.b
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(s.b)


def test_operator_a_and_reused_preconditioner():
    """A given as a callable operator, and a prebuilt M, give the matrix
    path's answer."""
    s = fixtures.random_sqd_system(300, 100, seed=4)
    popts = cpt.PrecondOptions(**POPTS)
    base = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                     precond_opts=popts)
    A64 = torch.as_tensor(s.A.toarray())
    M = cpt.make_preconditioner(s.G, s.B, s.C, options=popts)
    op = cpt.aslinearoperator(lambda v: A64 @ v, shape=s.A.shape)
    out = cpt.solve("cpminres", s.b, op, s.B, s.C, s.G, M=M,
                    precond_opts=popts, dtype=torch.float64)
    assert out.solved and base.solved
    assert abs(out.niters - base.niters) <= 1
    np.testing.assert_allclose(out.x.numpy(), base.x.numpy(), rtol=1e-8,
                               atol=1e-10)


def test_entry_point_errors():
    s = fixtures.random_sqd_system(40, 10, seed=1)
    with pytest.raises(ValueError, match="rhs has length"):
        cpt.solve("cpminres", s.b[:-1], s.A, s.B, s.C, s.G)
    with pytest.raises(ValueError, match="unknown solver"):
        cpt.solve("cpfoo", s.b, s.A, s.B, s.C, s.G)
    # refine=True takes the mixed refinement, which needs explicit blocks
    A_op = cpt.aslinearoperator(lambda v: v, shape=s.A.shape)
    with pytest.raises(TypeError, match="explicit matrix"):
        cpt.solve("cpminres", s.b, A_op, s.B, s.C, s.G, refine=True)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    s = fixtures.random_sqd_system(40, 10, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cpt.make_preconditioner(s.G, s.B, s.C, device="cuda")


def test_import_leaves_jax_out():
    """Every module of the port imports with JAX blocked, and importing the
    package does not load JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith('jax.'):\n"
        "            raise ImportError('jax is blocked')\n"
        "for k in [k for k in sys.modules if k.split('.')[0] == 'jax']:\n"
        "    del sys.modules[k]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import cpkrylov_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] == 'jax'))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    for path in (ROOT / "cpkrylov_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
