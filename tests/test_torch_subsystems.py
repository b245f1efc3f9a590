"""The port's auxiliary subsystems against the JAX package, on the CPU.

The port's counterparts of ``tests/test_subsystems.py``, each holding the
port (``device="cpu"``) against the JAX package on the same numpy inputs:

* ``utils.fixtures.ipm_kkt_system``: the same matrices and rhs, bit for bit;
* ``utils.checkpoint``: a preconditioner roundtrip (the direct solve bit
  for bit, a full solve with the same count), the structure mismatch of
  the ``nitref=7`` template, and a roundtrip of each factor form (the
  bidiagonal scan with the interleave permute and DIA K_P; blocked
  substitution with the gather permute and CSR K_P; the reduced-state scan
  and the df64-applied factor from ``aug_kkt("2d", 20)`` in f32) and of a
  ``SolveOutput``;
* ``ops.io``: MatrixMarket roundtrip, and ``load_mat`` on a .mat the test
  writes with ``scipy.io.savemat``, equal to the JAX loader's result;
* ``utils.debug``: the same validation messages, ``solve(debug=True)``
  with the same count as without, and ``check_finite``;
* the 16 ``test_ipm_kkt_sweep`` cases: the port's counts within +-1 of the
  JAX package's and the same ``solved`` flags; the operator-only A
  (BASELINE.json configs[3]) with nitref 2, port against JAX;
* ``utils.profiling``: ``work_model`` equal to the JAX ``WorkModel`` field
  by field for the bidiagonal, blocked and reduced-scan forms,
  ``profile_solve``'s fields, and ``trace`` writing events;
* ``CPPrecond.to_dense_inverse`` against the JAX one and
  ``numpy.linalg.inv(K_P)``, relative 1e-10 in f64;
* ``ops.spmv.matmat`` against the JAX ``matmat`` on CSR, DIA and
  ``Diagonal`` at r = 3;
* ``examples/exprog1_torch.py`` run on the CPU as a subprocess.

The JAX tests of jit retracing and of the device-form fingerprint cache
have no counterpart: the port has no jit and caches nothing across calls.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.utils import fixtures as jfix
from cpkrylov_tpu_torch.precond.cp import assemble_kp, factorize_kp
from cpkrylov_tpu_torch.utils import fixtures as tfix
from cpkrylov_tpu_torch.utils import mm as tmm
from cpkrylov_tpu_torch.utils.checkpoint import load_pytree, save_pytree

torch.set_num_threads(1)

CPU = "cpu"
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GHN = dict(residual_update=True, nitref=1, force_itref=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _same_sparse(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (a.shape == b.shape and a.nnz == b.nnz
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


# ---------------------------------------------------------------------------
# ipm_kkt_system
# ---------------------------------------------------------------------------

IPM_CASES = [dict(n=150, m=60, mu=1e-2, seed=0),
             dict(n=200, m=50, mu=1e-3, seed=2),
             dict(n=120, m=120, mu=1e-5, seed=9, density=0.03)]


@pytest.mark.parametrize("cfg", IPM_CASES)
def test_ipm_kkt_system_equals_jax(cfg):
    mine, ref = tfix.ipm_kkt_system(**cfg), jfix.ipm_kkt_system(**cfg)
    assert mine.name == ref.name
    for blk in ("A", "B", "C", "G", "K"):
        assert _same_sparse(getattr(mine, blk), getattr(ref, blk)), blk
    assert np.array_equal(mine.b, ref.b)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _direct(M, z):
    return M._direct_solve(torch.as_tensor(z, dtype=M.kp.dtype)).numpy()


def test_preconditioner_checkpoint_roundtrip(tmp_path):
    s = tfix.random_sqd_system(60, 25, seed=2, delta=1e-2)
    M = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device=CPU)
    path = os.path.join(tmp_path, "precond.npz")
    save_pytree(M, path)
    M2 = load_pytree(M, path)
    assert M2 is not M and M2.factor is not M.factor
    z = np.random.default_rng(0).standard_normal(85)
    np.testing.assert_array_equal(_direct(M, z), _direct(M2, z))
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M2, device=CPU)
    ref = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device=CPU)
    jref = cpk.solve("cpminres", s.b, s.A, s.B, s.C, s.G, panel=16)
    assert out.solved and out.niters == ref.niters
    assert abs(out.niters - int(jref.niters)) <= 1
    np.testing.assert_array_equal(out.x.numpy(), ref.x.numpy())
    # the file holds no pickle and names its classes
    with np.load(path, allow_pickle=False) as data:
        sig = json.loads(bytes(data["__signature__"]).decode())
    assert sig["dataclass"].endswith("precond.cp.CPPrecond")


def test_checkpoint_structure_mismatch(tmp_path):
    s = tfix.random_sqd_system(30, 10, seed=3)
    M = cpt.make_preconditioner(s.G, s.B, s.C, panel=8, device=CPU)
    path = os.path.join(tmp_path, "p.npz")
    save_pytree(M, path)
    other = cpt.make_preconditioner(s.G, s.B, s.C, panel=8, device=CPU,
                                    options=cpt.PrecondOptions(nitref=7))
    with pytest.raises(ValueError, match="mismatch"):
        load_pytree(other, path)
    # a different panel changes the leaves' shapes: also a mismatch
    wide = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device=CPU)
    with pytest.raises(ValueError, match="mismatch"):
        load_pytree(wide, path)



@pytest.mark.parametrize("form", ["bidiag", "block", "reduced", "df64"])
def test_checkpoint_roundtrip_of_each_factor_form(tmp_path, form):
    from cpkrylov_tpu_torch.ops.dia import DIA
    from cpkrylov_tpu_torch.ops.formats import CSR
    from cpkrylov_tpu_torch.precond.cuda_bidiag import BidiagTriFactor
    from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
    from cpkrylov_tpu_torch.precond.permute import (GatherPermute,
                                                    InterleavePermute)
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor,
                                                     build_reduced_scan_tri,
                                                     tri_solve)

    path = os.path.join(tmp_path, f"{form}.npz")
    if form == "reduced":
        # the reduced-state scan form of aug_kkt("2d", 20)'s factor L, in
        # f32 (at this size the rule keeps blocked substitution)
        s = tmm.aug_kkt("2d", 20)
        hf = factorize_kp(s.G, s.B, s.C)
        L1 = (hf.fac.L + sp.identity(hf.fac.L.shape[0])).tocsr()
        low = L1.tocoo()
        reach = int((low.row - low.col).max())
        tf = build_reduced_scan_tri(L1, torch.float32, CPU,
                                    panel=-(-reach // 8) * 8)
        assert isinstance(tf, ReducedScanTriFactor)
        save_pytree(tf, path)
        tf2 = load_pytree(tf, path)
        b = torch.as_tensor(np.random.default_rng(1).standard_normal(
            tf.n), dtype=torch.float32)
        assert (tf2.panel, tf2.r, tf2.n) == (tf.panel, tf.r, tf.n)
        np.testing.assert_array_equal(tri_solve(tf, b).numpy(),
                                      tri_solve(tf2, b).numpy())
        return
    if form == "bidiag":
        s = tfix.banded_saddle_system(4096, 1024, bandwidth=3)
        M = cpt.make_preconditioner(s.G, s.B, s.C, options=cpt.PrecondOptions(
            **GHN), device=CPU)
        assert isinstance(M.factor.tf1, BidiagTriFactor)
        assert isinstance(M.factor.pin, InterleavePermute)
        assert isinstance(M.kp, DIA)
    elif form == "block":
        s = tfix.random_sqd_system(200, 80, seed=4, delta=1e-2)
        M = cpt.make_preconditioner(s.G, s.B, s.C, panel=32, device=CPU)
        assert isinstance(M.factor.tf1, BlockTriFactor)
        assert isinstance(M.factor.pin, GatherPermute)
        assert isinstance(M.kp, CSR)
    else:
        # aug_kkt("2d", 20) in f32: the build probe swaps in the
        # df64-applied factor
        s = tmm.aug_kkt("2d", 20)
        M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                    device=CPU)
        assert isinstance(M.factor, DFFactorApply)
    save_pytree(M, path)
    M2 = load_pytree(M, path)
    z = np.random.default_rng(5).standard_normal(M.n + M.m)
    np.testing.assert_array_equal(_direct(M, z), _direct(M2, z))
    # the file alone rebuilds the same factor form
    M3 = load_pytree(None, path, device=CPU)
    assert type(M3.factor.tf1) is type(M.factor.tf1)
    np.testing.assert_array_equal(_direct(M, z), _direct(M3, z))
    dtype = M.kp.dtype
    kw = dict(device=CPU, dtype=dtype, refine=dtype == torch.float32,
              opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=400))
    a = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M, **kw)
    b = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M2, **kw)
    assert a.solved and b.niters == a.niters
    np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())


def test_checkpoint_loads_without_a_template(tmp_path):
    """``load_pytree(None, path)`` rebuilds a preconditioner and a solve's
    output from the file alone; it refuses a file naming a class outside
    the package, and an operator whose callable only a template holds."""
    s = tfix.random_sqd_system(60, 25, seed=2, delta=1e-2)
    M = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device=CPU)
    path = os.path.join(tmp_path, "precond.npz")
    save_pytree(M, path)
    M2 = load_pytree(None, path, device=CPU)
    assert type(M2) is type(M) and M2.options == M.options
    assert (M2.n, M2.m, M2.factor_nitref) == (M.n, M.m, M.factor_nitref)
    z = np.random.default_rng(0).standard_normal(85)
    np.testing.assert_array_equal(_direct(M, z), _direct(M2, z))
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M2, device=CPU)
    ref = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device=CPU)
    assert out.niters == ref.niters
    np.testing.assert_array_equal(out.x.numpy(), ref.x.numpy())
    save_pytree(ref, path)
    back = load_pytree(None, path, device=CPU)
    assert (back.niters, back.solved, back.stime) == (
        ref.niters, ref.solved, ref.stime)
    np.testing.assert_array_equal(back.x.numpy(), ref.x.numpy())

    with np.load(path, allow_pickle=False) as data:
        arrays = dict(data)
    sig = bytes(arrays["__signature__"]).decode().replace(
        "cpkrylov_tpu_torch.driver.SolveOutput", "collections.OrderedDict")
    arrays["__signature__"] = np.frombuffer(sig.encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="outside"):
        load_pytree(None, path, device=CPU)

    A_op = cpt.aslinearoperator(lambda v: v, shape=(4, 4))
    save_pytree(A_op, path)
    assert load_pytree(A_op, path) is A_op
    with pytest.raises(ValueError, match="template"):
        load_pytree(None, path, device=CPU)


def test_solve_output_roundtrip(tmp_path):
    s = tfix.random_sqd_system(60, 25, seed=2, delta=1e-2)
    out = cpt.solve("cpsymmlq", s.b, s.A, s.B, s.C, s.G, panel=16,
                    device=CPU)
    other = cpt.solve("cpsymmlq", s.b, s.A, s.B, s.C, s.G, panel=16,
                      device=CPU)
    path = os.path.join(tmp_path, "out.npz")
    save_pytree(out, path)
    back = load_pytree(other, path)     # same structure, other times
    assert (back.niters, back.solved, back.istatus) == (
        out.niters, out.solved, out.istatus)
    assert back.stime == out.stime and back.ptime == out.ptime
    np.testing.assert_array_equal(back.x.numpy(), out.x.numpy())
    np.testing.assert_array_equal(back.resid_history, out.resid_history)
    np.testing.assert_array_equal(back.result.cg_resid_history,
                                  out.result.cg_resid_history)
    # a mixed solve's output: its pass counts are data too
    kw = dict(device=CPU, panel=16,
              opts=cpt.SolverOptions(atol=1e-10, rtol=1e-10, itmax=300))
    mixed = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, **kw)
    save_pytree(mixed, path)
    again = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, **kw)
    mback = load_pytree(again, path)
    assert (mback.nouter, mback.inner_niters, mback.niters) == (
        mixed.nouter, mixed.inner_niters, mixed.niters)
    np.testing.assert_array_equal(mback.x, mixed.x)
    assert mback.inner_outputs[0].niters == mixed.inner_niters[0]


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------

def test_matrix_market_roundtrip(tmp_path):
    from cpkrylov_tpu.ops.io import load_matrix_market as jload
    from cpkrylov_tpu_torch.ops.io import (load_matrix_market,
                                           save_matrix_market)

    s = tfix.random_sqd_system(20, 8, seed=5)
    path = os.path.join(tmp_path, "k.mtx")
    save_matrix_market(path, s.K)
    back = load_matrix_market(path)
    assert isinstance(back, sp.csr_matrix)
    assert abs(s.K - back).max() < 1e-12
    assert _same_sparse(back, jload(path))


def test_load_mat_equals_jax(tmp_path):
    from cpkrylov_tpu.ops.io import load_mat as jload_mat
    from cpkrylov_tpu_torch.ops.io import load_mat

    s = tfix.random_sqd_system(30, 12, seed=7)
    path = os.path.join(tmp_path, "k.mat")
    sio.savemat(path, {"K": s.K.tocsc(), "nH": 30, "rhs": s.b[:, None]})
    d, ref = load_mat(path), jload_mat(path)
    assert sorted(d) == sorted(ref) == ["K", "nH", "rhs"]
    assert isinstance(d["K"], sp.csr_matrix) and _same_sparse(d["K"], s.K)
    assert int(d["nH"]) == 30 and d["nH"] == ref["nH"]
    np.testing.assert_array_equal(d["rhs"], ref["rhs"])


# ---------------------------------------------------------------------------
# validation / debug
# ---------------------------------------------------------------------------

def _messages(validate, s):
    """The messages of the same bad inputs through ``validate``."""
    Cbad = s.C.tolil()
    Cbad[0, 5] = 1.0
    Bdead = s.B.tolil()
    Bdead[3, :] = 0.0
    Cdead = s.C.tolil()
    Cdead[3, 3] = 0.0
    cases = [(s.A[:, :-1], s.B, s.C, s.G, None),
             (s.A, s.B[:, :-1], s.C, s.G, None),
             (s.A, s.B, s.C[:-1, :-1], s.G, None),
             (s.A, s.B, s.C, s.G[:-1, :-1], None),
             (s.A, s.B, s.C, s.G, s.b[:-1]),
             (s.A, s.B, Cbad.tocsr(), s.G, None),
             (s.A, Bdead.tocsr(), Cdead.tocsr(), s.G, None)]
    out = []
    for args in cases:
        with pytest.raises(ValueError) as exc:
            validate(*args)
        out.append((type(exc.value).__name__, str(exc.value)))
    return out


def test_validation_messages_equal_jax():
    from cpkrylov_tpu.utils.debug import validate_system as jvalidate
    from cpkrylov_tpu_torch.utils.debug import (ValidationError,
                                                validate_system)

    s = tfix.random_sqd_system(30, 10, seed=1)
    mine = _messages(validate_system, s)
    assert mine == _messages(jvalidate, s)
    assert all(kind == "ValidationError" for kind, _ in mine)
    assert "expected" in mine[1][1] and "symmetric" in mine[5][1]
    assert issubclass(ValidationError, ValueError)
    validate_system(s.A, s.B, s.C, s.G, s.b)       # a good system passes


def test_driver_debug_mode():
    from cpkrylov_tpu_torch.utils.debug import ValidationError, check_finite

    s = tfix.random_sqd_system(40, 15, seed=6, delta=1e-2)
    kw = dict(panel=16, device=CPU)
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, debug=True, **kw)
    plain = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, **kw)
    jout = cpk.solve("cpminres", s.b, s.A, s.B, s.C, s.G, debug=True,
                     panel=16)
    assert out.solved and out.niters == plain.niters
    assert abs(out.niters - int(jout.niters)) <= 1
    check_finite(out)
    with pytest.raises(ValidationError, match="expected"):
        cpt.solve("cpminres", s.b, s.A, s.B[:, :-1], s.C, s.G, debug=True,
                  **kw)


@pytest.mark.parametrize("where", ["rhs", "G", "C", "B"])
def test_debug_mode_raises_on_a_non_finite_solution(where):
    """A NaN in the constraint part of the rhs or in a block of the
    preconditioner reaches the solution: with ``debug=True`` both packages
    raise FloatingPointError with the same message after the solve, and
    so does the port's mixed route."""
    s = tfix.random_sqd_system(60, 25, seed=2, delta=1e-2)
    b = s.b.copy()
    blocks = {"G": s.G.tocsr(copy=True), "C": s.C.tocsr(copy=True),
              "B": s.B.tocsr(copy=True)}
    if where == "rhs":
        b[s.A.shape[0] + 3] = np.nan
    else:
        blocks[where].data[0] = np.nan
    args = (b, s.A, blocks["B"], blocks["C"], blocks["G"])
    with np.errstate(invalid="ignore"):
        with pytest.raises(FloatingPointError) as mine:
            cpt.solve("cpminres", *args, debug=True, panel=16, device=CPU)
        with pytest.raises(FloatingPointError) as ref:
            cpk.solve("cpminres", *args, debug=True, panel=16)
        with pytest.raises(FloatingPointError, match="non-finite"):
            cpt.solve("cpminres", *args, debug=True, panel=16, device=CPU,
                      dtype=torch.float32, refine=True)
        quiet = cpt.solve("cpminres", *args, panel=16, device=CPU)
    assert str(mine.value) == str(ref.value)
    assert "NaN" in str(mine.value)
    assert not bool(torch.isfinite(quiet.x).all())


def test_check_finite_walks_the_port_objects():
    from cpkrylov_tpu_torch.precond.cp import CPState
    from cpkrylov_tpu_torch.utils.debug import check_finite

    good = CPState(aty=torch.ones(3), cy=torch.zeros(2))
    check_finite(good)
    check_finite({"a": (good, [np.arange(3)])})
    bad = CPState(aty=torch.tensor([1.0, float("nan")]), cy=torch.zeros(2))
    with pytest.raises(FloatingPointError, match="1 NaN, 0 Inf"):
        check_finite({"a": (1, [bad])})
    with pytest.raises(FloatingPointError, match="0 NaN, 1 Inf"):
        check_finite(np.array([np.inf]), what="x")


# ---------------------------------------------------------------------------
# Maros-Meszaros-style sweep (configs[2]) and operator-A (configs[3])
# ---------------------------------------------------------------------------

SWEEP = [
    dict(n=150, m=60, mu=1e-2, seed=0),
    dict(n=150, m=60, mu=1e-4, seed=1),
    dict(n=200, m=50, mu=1e-3, seed=2),
    dict(n=120, m=120, mu=1e-2, seed=3),   # square constraint block
]
SWEEP_SOLVERS = ["cpminres", "cpcg", "cpcglanczos", "cpsymmlq"]
SWEEP_KW = dict(panel=64)


def _sweep_opts(pkg):
    return dict(opts=pkg.SolverOptions(atol=1e-6, rtol=1e-6, itmax=800),
                precond_opts=pkg.PrecondOptions(**GHN))


@pytest.mark.parametrize("cfg", SWEEP)
@pytest.mark.parametrize("name", SWEEP_SOLVERS)
def test_ipm_kkt_sweep(cfg, name):
    s = tfix.ipm_kkt_system(**cfg)
    out = cpt.solve(name, s.b, s.A, s.B, s.C, s.G, device=CPU,
                    dtype=F64, **SWEEP_KW, **_sweep_opts(cpt))
    ref = cpk.solve(name, s.b, s.A, s.B, s.C, s.G, **SWEEP_KW,
                    **_sweep_opts(cpk))
    assert out.solved == bool(ref.solved), (s.name, name)
    assert abs(out.niters - int(ref.niters)) <= 1, (
        s.name, name, out.niters, int(ref.niters))
    x_ref = spla.spsolve(s.K.tocsc(), s.b)
    rel = _rel(out.x.numpy(), x_ref)
    if out.solved:
        assert rel < 1e-3, (s.name, name, rel)
    else:
        assert out.istatus != 0, (s.name, name)


def test_operator_only_A_with_itref():
    import jax.numpy as jnp

    s = tfix.ipm_kkt_system(n=150, m=60, mu=1e-5, seed=9)
    kw = dict(panel=64)
    Adense = torch.as_tensor(s.A.toarray())
    A_op = cpt.aslinearoperator(lambda v: Adense @ v, shape=(150, 150))
    popts = dict(residual_update=True, nitref=2, force_itref=True)
    out = cpt.solve("cpminres", s.b, A_op, s.B, s.C, s.G, device=CPU,
                    dtype=F64,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=800),
                    precond_opts=cpt.PrecondOptions(**popts), **kw)
    Aj = jnp.asarray(s.A.toarray())
    ref = cpk.solve("cpminres", s.b,
                    cpk.aslinearoperator(lambda v: Aj @ v, shape=(150, 150)),
                    s.B, s.C, s.G,
                    opts=cpk.SolverOptions(atol=1e-6, rtol=1e-6, itmax=800),
                    precond_opts=cpk.PrecondOptions(**popts), **kw)
    explicit = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device=CPU,
                         dtype=F64,
                         opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6,
                                                itmax=800),
                         precond_opts=cpt.PrecondOptions(**popts), **kw)
    x_ref = spla.spsolve(s.K.tocsc(), s.b)
    rel = _rel(out.x.numpy(), x_ref)
    assert out.solved and bool(ref.solved) and rel < 1e-2
    assert abs(out.niters - int(ref.niters)) <= 1
    assert abs(out.niters - explicit.niters) <= 1
    assert rel <= 1.1 * _rel(np.asarray(ref.x), x_ref) + 1e-12


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def _jax_bidiag_precond(Mj, s):
    """The JAX package's preconditioner with its factor solves in the
    bidiagonal form the port picks (the JAX package builds it for f32 on
    the TPU, for n >= 32768; its count does not depend on the dtype)."""
    from cpkrylov_tpu.precond.pallas_bidiag import (build_bidiag_tri,
                                                    build_bidiag_tri_upper)

    hf = factorize_kp(s.G, s.B, s.C)
    N = s.n + s.m
    L1 = (hf.fac.L + sp.identity(N)).tocsr()
    U = L1.T.tocsr()
    f = dataclasses.replace(
        Mj.factor, tf1=build_bidiag_tri(L1, dtype=np.float32),
        tf2=build_bidiag_tri_upper(U, dtype=np.float32))
    return dataclasses.replace(Mj, factor=f)


@pytest.mark.parametrize("form", ["bidiag", "block", "reduced"])
def test_work_model_equals_jax(form):
    from cpkrylov_tpu.utils.profiling import work_model as jwork_model
    from cpkrylov_tpu_torch.precond.cuda_bidiag import BidiagTriFactor
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor)
    from cpkrylov_tpu_torch.utils.profiling import work_model

    popts = dict(residual_update=True, nitref=2, force_itref=True)
    if form == "bidiag":
        s = tfix.banded_saddle_system(32768, 8192, bandwidth=3)
        kind = BidiagTriFactor
    elif form == "block":
        s = tfix.ipm_kkt_system(150, 60, mu=1e-3, seed=1)
        kind = BlockTriFactor
    else:
        s = tmm.aug_kkt("2d", 40)
        kind = ReducedScanTriFactor
        popts = {}
    M = cpt.make_preconditioner(s.G, s.B, s.C, device=CPU,
                                options=cpt.PrecondOptions(**popts))
    Mj = cpk.make_preconditioner(s.G, s.B, s.C,
                                 options=cpk.PrecondOptions(**popts))
    assert isinstance(M.factor.tf1, kind) and isinstance(M.factor.tf2, kind)
    if form == "bidiag":
        Mj = _jax_bidiag_precond(Mj, s)
    else:
        assert type(Mj.factor.tf1).__name__ == kind.__name__
    mine = work_model(M, s.A.nnz, s.C.nnz)
    ref = jwork_model(Mj, s.A.nnz, s.C.nnz)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.nnz_per_iter == ref.nnz_per_iter


def test_schur_work_is_shared_over_the_ranks():
    """The ranks' ``SchurFactor.work_nnz`` shares sum to the JAX package's
    ``_factor_nnz`` of its stacked factor (utils/profiling.py:58-66), on a
    split in which every rank's interior has device 0's size and both
    packages take blocked substitution for the local factor, so that
    device 0's count times the device count is every device's.  Each rank's
    local factor counts what the JAX device's own slice counts.  One term
    differs by design: the JAX device multiplies by A_dS as a padded ELL
    block and counts its slots (n_loc x K a device), the port by CSR and
    counts its stored entries; the JAX figure is held with its slots
    replaced by its own nonzero entries.  The ranks are built in this
    process from the JAX package's plan (``convert.schur_from_jax``): the
    plan needs no collective."""
    import types

    import jax

    from cpkrylov_tpu.parallel.schur import plan_schur_precond as jplan
    from cpkrylov_tpu.utils.profiling import _factor_nnz as jfactor_nnz
    from cpkrylov_tpu_torch.parallel.schur import _factor_share
    from cpkrylov_tpu_torch.precond.trisolve import BlockTriFactor
    from cpkrylov_tpu_torch.utils import convert
    from cpkrylov_tpu_torch.utils.profiling import _factor_nnz

    ndev = 2
    ss = tfix.banded_saddle_system(400, 100, bandwidth=3, seed=1,
                                   g_mode="banded", b_mode="slope")
    Mj = jplan(ss.G, ss.B, ss.C, ndev, panel=16)
    jf = Mj.factor
    ksp = assemble_kp(ss.G, ss.B, ss.C).tocsr()
    ads = np.asarray(jf.a_ds_data)
    total = 0
    for rank in range(ndev):
        comm = types.SimpleNamespace(rank=rank, size=ndev,
                                     device=torch.device(CPU))
        f, _ = _factor_share(convert.schur_from_jax(jf, rank), ksp, ss.n,
                             ss.m, comm, panel=16)
        jl = jax.tree_util.tree_map(lambda a: a[rank], jf.local_factor)
        lf = f.local_factor
        assert f.s == int(jf.s) > 0 and f.interior.numel() == jf.n_loc
        assert isinstance(lf.tf1, BlockTriFactor)
        assert isinstance(lf.tf2, BlockTriFactor)
        assert type(jl.tf1).__name__ == type(jl.tf2).__name__ == \
            "BlockTriFactor"
        local = _factor_nnz(types.SimpleNamespace(factor=lf))
        assert local == (jl.tf1.work_nnz + jl.tf2.work_nnz
                         + jl.dinv.shape[0])
        assert f.a_ds.nnz == np.count_nonzero(ads[rank])
        share = _factor_nnz(types.SimpleNamespace(factor=f))
        assert share == f.work_nnz == (2 * local + 2 * f.a_ds.nnz
                                       + (f.s * f.s if rank == 0 else 0))
        total += share
    ell_slots, stored = ads.size, np.count_nonzero(ads)
    assert ell_slots > stored
    assert total == jfactor_nnz(Mj) - 2 * (ell_slots - stored)


def test_profile_solve_reports_throughput(tmp_path):
    from cpkrylov_tpu_torch.utils.profiling import profile_solve

    s = tfix.ipm_kkt_system(n=150, m=60, mu=1e-2, seed=0)
    opts = cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=400)
    prof = profile_solve("cpminres", s.b, s.A, s.B, s.C, s.G, repeats=2,
                         opts=opts, device=CPU, dtype=F64,
                         trace_dir=str(tmp_path / "tr"))
    ref = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=opts,
                    device=CPU, dtype=F64)
    assert prof.method == "cpminres" and prof.solved
    assert prof.niters == ref.niters > 0
    assert prof.ptime > 0 and prof.compile_time > 0 and prof.stime > 0
    assert prof.iters_per_s == pytest.approx(prof.niters / prof.stime)
    assert prof.nnz_per_s == pytest.approx(
        prof.niters * prof.work.nnz_per_iter / prof.stime)
    assert prof.work.nnz_a == s.A.nnz and prof.work.nnz_c == s.C.nnz
    assert prof.work.nnz_per_iter >= prof.work.nnz_a + prof.work.nnz_c
    assert "nnz/s" in prof.summary()
    assert os.path.exists(tmp_path / "tr" / "trace.json")


def test_profiler_trace_writes_events(tmp_path):
    from cpkrylov_tpu_torch.utils.profiling import trace

    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones(128).sum()
    found = [f for _, _, fs in os.walk(logdir) for f in fs]
    assert found, "no trace written"
    with open(os.path.join(logdir, found[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("sum" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# to_dense_inverse and matmat
# ---------------------------------------------------------------------------

def test_to_dense_inverse_equals_jax_and_numpy():
    s = tfix.random_sqd_system(60, 25, seed=2, delta=1e-2)
    M = cpt.make_preconditioner(s.G, s.B, s.C, panel=16, device=CPU)
    Mj = cpk.make_preconditioner(s.G, s.B, s.C, panel=16)
    inv = M.to_dense_inverse()
    assert inv.shape == (85, 85) and inv.dtype == F64
    kp = assemble_kp(s.G, s.B, s.C).toarray()
    assert _rel(inv.numpy(), np.asarray(Mj.to_dense_inverse())) <= 1e-10
    assert _rel(inv.numpy(), np.linalg.inv(kp)) <= 1e-10


@pytest.mark.parametrize("fmt", ["csr", "dia", "diagonal"])
def test_matmat_equals_jax(fmt):
    import jax.numpy as jnp

    from cpkrylov_tpu.ops import dia as jdia
    from cpkrylov_tpu.ops import formats as jformats
    from cpkrylov_tpu.ops.spmv import matmat as jmatmat
    from cpkrylov_tpu_torch.ops import dia as tdia
    from cpkrylov_tpu_torch.ops import formats as tformats
    from cpkrylov_tpu_torch.ops.spmv import matmat

    rng = np.random.default_rng(11)
    if fmt == "csr":
        mat = sp.random(70, 50, density=0.1, random_state=rng, format="csr")
        mine = tformats.csr_from_scipy(mat, dtype=F64, device=CPU)
        ref = jformats.csr_from_scipy(mat, dtype=np.float64)
    elif fmt == "dia":
        mat = sp.diags([rng.standard_normal(60 - abs(o))
                        for o in (-2, 0, 3)], [-2, 0, 3], format="csr")
        mine = tdia.pack_dia(mat, dtype=F64, device=CPU)
        ref = jdia.pack_dia(mat, dtype=np.float64)
    else:
        mat = sp.diags(rng.standard_normal(60)).tocsr()
        mine = tformats.Diagonal(diag=torch.as_tensor(mat.diagonal()))
        ref = jformats.Diagonal(diag=jnp.asarray(mat.diagonal()))
    X = rng.standard_normal((mat.shape[1], 3))
    Y = matmat(mine, torch.as_tensor(X)).numpy()
    assert Y.shape == (mat.shape[0], 3)
    assert _rel(Y, np.asarray(jmatmat(ref, jnp.asarray(X)))) <= 1e-14
    assert _rel(Y, mat @ X) <= 1e-14
    dense = torch.as_tensor(mat.toarray())
    assert _rel(matmat(dense, torch.as_tensor(X)).numpy(), mat @ X) <= 1e-14


# ---------------------------------------------------------------------------
# the example program
# ---------------------------------------------------------------------------

def test_exprog1_torch_runs_on_the_cpu(tmp_path):
    # one thread, as this module's own torch: a subprocess with a thread
    # per core beside the other test workers spins on busy cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "exprog1_torch.py"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = dict(line.split(":", 1) for line in res.stdout.splitlines()
                 if ":" in line and not line.startswith("system"))
    assert lines["solved     "].split()[0] == "True"
    assert abs(int(lines["iterations "]) - 54) <= 2
    assert float(lines["rel. error "]) < 5e-6
