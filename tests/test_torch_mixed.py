"""The port's mixed-precision solve (``mixed.solve_mixed``: f32 inner
CPMINRES, f64 host or df64 device outer refinement) against the JAX package
on the same inputs, on the CPU.

The outer loop's contract is checked on the true residual in f64.  Inner
iteration counts are f32 trajectories: they depend on the reduction order of
the f32 dot products (XLA's and torch's differ in the last bits, ROADMAP C),
so count parity with the JAX package is held with the port using the JAX
package's f32 dot (``_xla_dot``); the solutions are compared as they are.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.mixed import solve_mixed as jax_solve_mixed
from cpkrylov_tpu_torch.ops.dia import pack_dia
from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
from cpkrylov_tpu_torch.solvers import common, cpminres
from cpkrylov_tpu_torch.utils import fixtures
from cpkrylov_tpu_torch.utils.profiling import MIXED_SPAN, device_profile

torch.set_num_threads(1)

BENCH_POPTS = dict(residual_update=True, nitref=1, force_itref=True)


def _relerr(s, x):
    xref = spla.spsolve(s.K.tocsc(), s.b)
    return np.linalg.norm(x - xref) / np.linalg.norm(xref)


def _xla_dot(a, b):
    """The JAX package's f32 dot, for runs that share its reduction order."""
    if a.dtype != torch.float32:
        return torch.dot(a, b)
    return torch.tensor(float(jnp.dot(jnp.asarray(a.numpy()),
                                      jnp.asarray(b.numpy()))),
                        dtype=torch.float32)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


SQD_OPTS = dict(atol=1e-10, rtol=1e-10, itmax=400)


def test_sqd_reaches_f64_accuracy_like_jax():
    """Solutions, not per-pass counts, are held against the JAX package
    here: this K_P's f32 factor amplifies last-bit differences of its
    products (see the next test)."""
    s = fixtures.random_sqd_system(160, 60, seed=3)
    sopts = SQD_OPTS
    out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpt.SolverOptions(**sopts), device="cpu")
    ref = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpk.SolverOptions(**sopts))
    assert out.solved and ref.solved
    assert isinstance(out.x, np.ndarray) and out.x.dtype == np.float64
    rnorm = np.linalg.norm(s.b - s.K @ out.x)
    assert rnorm <= 1e-10 + 1e-10 * np.linalg.norm(s.b)
    assert _relerr(s, out.x) < 1e-9
    assert out.nouter <= 6 and len(out.inner_outputs) == out.nouter
    assert out.niters == sum(out.inner_niters)
    assert np.all(np.diff(out.resid_history) < 0)
    assert out.resid_history[0] == pytest.approx(np.linalg.norm(s.b))
    assert _rel(out.x, np.asarray(ref.x)) < 1e-8


def test_sqd_inner_counts_depend_on_f32_rounding_in_jax_too():
    """The per-pass inner counts on this system are not a property of the
    algorithm: the JAX package's own counts change when the same code runs
    eagerly instead of compiled (XLA fuses and orders the f32 products
    differently), while the solutions agree.  The f32 factor here is one
    dense panel with element growth (probe residual 1.0e-3), so a last-bit
    difference in a panel product moves the inner trajectory."""
    s = fixtures.random_sqd_system(160, 60, seed=3)
    compiled = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                               opts=cpk.SolverOptions(**SQD_OPTS))
    with jax.disable_jit():
        eager = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                                opts=cpk.SolverOptions(**SQD_OPTS))
    assert compiled.solved and eager.solved
    assert compiled.inner_niters != eager.inner_niters
    assert _rel(np.asarray(eager.x), np.asarray(compiled.x)) < 1e-8


def test_cvxqp1_mixed_matches_jax(monkeypatch):
    """The headline fixture to 1e-8 with the bench's preconditioner options:
    the df64-applied factor, the host loop; with the JAX package's f32 dot
    the total inner count is the JAX package's (+-15)."""
    if not fixtures.fixture_available("cvxqp1_m"):
        pytest.skip("cvxqp1_m fixture unavailable")
    s = fixtures.load_fixture("cvxqp1_m")
    sopts = dict(atol=1e-8, rtol=1e-8, itmax=500)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                    options=cpt.PrecondOptions(**BENCH_POPTS),
                                    device="cpu")
        assert isinstance(M.factor, DFFactorApply)
        own = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, M=M,
                              opts=cpt.SolverOptions(**sopts), device="cpu")
        ref = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                              opts=cpk.SolverOptions(**sopts),
                              precond_opts=cpk.PrecondOptions(**BENCH_POPTS))
        monkeypatch.setattr(common, "vdot", _xla_dot)
        monkeypatch.setattr(cpminres, "vdot", _xla_dot)
        same = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, M=M,
                               opts=cpt.SolverOptions(**sopts), device="cpu")
    for out in (own, same):
        assert out.solved
        assert _relerr(s, out.x) < 1e-7
        assert out.nouter <= 5
        assert out.inner_outputs             # the host loop (CPU device)
    assert ref.solved
    assert abs(same.niters - ref.niters) <= 15, (same.inner_niters,
                                                 ref.inner_niters)


@pytest.fixture(scope="module")
def banded_mixed():
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                      with_oracle=False)
    sopts = dict(atol=0.0, rtol=1e-10, itmax=300)
    host = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                           opts=cpt.SolverOptions(**sopts),
                           device_resident=False, device="cpu")
    dev = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpt.SolverOptions(**sopts),
                          device_resident=True, device="cpu")
    K = sp.bmat([[s.A, s.B.T], [s.B, -s.C]]).tocsr()
    return s, K, sopts, host, dev


def test_banded_device_loop_matches_host_loop(banded_mixed):
    """tests/test_df64.py:72-93 on the port: the df64 device loop and the
    f64 host loop reach the same solution."""
    s, K, _, host, dev = banded_mixed
    assert host.solved and dev.solved
    assert host.inner_outputs and dev.inner_outputs == ()
    assert dev.nouter <= host.nouter + 1
    for out in (host, dev):
        r = s.b - K @ out.x
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(s.b)
    assert _rel(dev.x, host.x) < 1e-8
    assert len(dev.resid_history) == dev.nouter + 1


def test_banded_device_loop_matches_jax_device_loop(banded_mixed):
    """Both device loops on the interleave ordering (the JAX side with
    ``spmv_format="dia"``)."""
    s, _, sopts, _, dev = banded_mixed
    ref = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpk.SolverOptions(**sopts),
                          device_resident=True, spmv_format="dia")
    assert ref.solved and dev.solved
    assert _rel(dev.x, np.asarray(ref.x)) < 1e-8


def test_max_outer_one_is_honest():
    s = fixtures.random_sqd_system(100, 30, seed=7)
    out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpt.SolverOptions(atol=0.0, rtol=1e-14,
                                                 itmax=300),
                          max_outer=1, device="cpu")
    assert not out.solved              # one f32 pass cannot reach 1e-14
    assert out.nouter == 1


def test_entry_errors():
    s = fixtures.random_sqd_system(60, 20, seed=0)
    A_op = cpt.aslinearoperator(lambda v: v, shape=s.A.shape)
    with pytest.raises(TypeError, match="explicit matrix"):
        cpt.solve_mixed("cpminres", s.b, A_op, s.B, s.C, s.G, device="cpu")
    with pytest.raises(ValueError, match="rhs has length"):
        cpt.solve_mixed("cpminres", s.b[:-1], s.A, s.B, s.C, s.G, device="cpu")
    C_tri = (s.C + sp.eye(20, k=1) * 1e-6).tocsr()
    with pytest.raises(ValueError, match="df64 DIA form"):
        cpt.solve_mixed("cpminres", s.b, s.A, s.B, C_tri, s.G,
                        device_resident=True, device="cpu")
    # unforced on the CPU: the host loop, which takes any explicit C
    out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, C_tri, s.G,
                          opts=cpt.SolverOptions(atol=1e-9, rtol=1e-9,
                                                 itmax=300), device="cpu")
    assert out.solved and out.inner_outputs


def test_device_loop_packs_each_block_once():
    """The inner solves' f32 A and B are the hi parts of the df64 packs,
    equal to the f32 DIA packs the driver would build."""
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                      with_oracle=False)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device="cpu")
    solver = cpt.prepare_mixed_device("cpminres", s.b, s.A, s.B, s.C, M,
                                      cpt.SolverOptions(), device="cpu")
    for op, df, X in ((solver.A_op, solver.Kdf.a, s.A),
                      (solver.B_op, solver.Kdf.b, s.B)):
        ref = pack_dia(X, dtype=torch.float32, device="cpu")
        assert op.mat.data is df.hi
        assert op.mat.offsets == ref.offsets and op.mat.shape == ref.shape
        assert torch.equal(op.mat.data, ref.data)


def test_prepare_rejects_blocks_without_df64_form():
    s = fixtures.random_sqd_system(120, 40, seed=2)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device="cpu")
    assert cpt.prepare_mixed_device("cpminres", s.b, s.A, s.B, s.C, M,
                                    cpt.SolverOptions(), device="cpu") is None


def test_refine_routes_through_solve_mixed():
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3)
    sopts = cpt.SolverOptions(atol=0.0, rtol=1e-9, itmax=300)
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=sopts,
                    dtype=torch.float32, refine=True, device="cpu")
    mixed = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, opts=sopts,
                            device="cpu")
    assert out.solved and out.istatus == common.STATUS_SOLVED
    assert out.x.dtype == torch.float64
    np.testing.assert_array_equal(out.x.numpy(), mixed.x)
    np.testing.assert_array_equal(out.resid_history, mixed.resid_history)
    assert out.niters == mixed.niters
    r = s.b - s.K @ out.x.numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(s.b)
    # "auto" refines only on a CUDA device: on the CPU an f32 solve stays a
    # single f32 Krylov solve
    plain = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=sopts,
                      dtype=torch.float32, device="cpu")
    assert plain.x.dtype == torch.float32 and not plain.solved


def test_mixed_span_in_profile():
    s = fixtures.random_sqd_system(60, 20, seed=3)
    outs = []
    prof = device_profile(lambda: outs.append(cpt.solve_mixed(
        "cpminres", s.b, s.A, s.B, s.C, s.G,
        opts=cpt.SolverOptions(atol=1e-9, rtol=1e-9, itmax=200),
                                                              device="cpu")),
        span=MIXED_SPAN)
    assert outs[0].solved
    assert 0 < prof.wall_ms <= 1e3 * outs[0].stime * 1.5 + 5
    assert (prof.device_ops, prof.launches) == (0, 0)
