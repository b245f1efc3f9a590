"""What a caller of the JAX package can pass, the port accepts: the
container formats ELL and BSR, ``spmv_format`` and ``tile_rows``, the
mixed solve's ``inner_rtol``, ``lean_inner`` and ``max_outer``, and the
distributed solve's ``halo`` and reusable ``M``.  On the CPU, against the
JAX package on the same inputs.

* (a) Inventory: every name of ``cpkrylov_tpu.__all__`` exists in
  ``cpkrylov_tpu_torch``, and every keyword of the JAX entry points is a
  keyword of the port's counterpart, except ``mesh`` and ``ndev``
  (``REPLACED``, each with its reason).
* (b) ELL and BSR products (and a CSR padded by ``pad_to``) against the
  JAX package's ``ell_matvec``, ``bsr_matvec`` and ``matmat`` on the same
  scipy matrices, to 1e-14 relative, with the packed fields equal.
* (c) ``spmv_format`` on ``cvxqp1_m`` and a banded system against the JAX
  solve with the same value: counts within +-2 (``tests/test_golden.py``'s
  slack), the layouts chosen, ValueError for an unknown value.
* (d) ``solve_mixed(lean_inner=False)`` and ``inner_rtol=1e-6`` on
  ``cvxqp1_m`` against the JAX host loop with the same options, the port
  on the JAX package's f32 dot (f32 trajectories follow the dot's
  reduction order, ROADMAP C): pass count and per-pass inner counts
  within +-2, and the f64 contract.
* (e) On two gloo CPU ranks: ``dist_solve_mixed(M=...)`` solves twice and
  factors once; ``halo=False`` plans no halo block and gives x within
  1e-12 of ``halo=True``.
"""
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.mixed import solve_mixed as jax_solve_mixed
from cpkrylov_tpu.ops import formats as jformats
from cpkrylov_tpu.ops import spmv as jspmv
from cpkrylov_tpu_torch import driver, mixed
from cpkrylov_tpu_torch.ops import formats, spmv
from cpkrylov_tpu_torch.ops.dia import DIA
from cpkrylov_tpu_torch.ops.formats import BSR, CSR, ELL, Diagonal
from cpkrylov_tpu_torch.parallel.dryrun import run_ranks
from cpkrylov_tpu_torch.precond import cp
from cpkrylov_tpu_torch.solvers import common
from cpkrylov_tpu_torch.utils import convert, fixtures

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
BENCH_POPTS = dict(residual_update=True, nitref=1, force_itref=True)

# ---------------------------------------------------------------------------
# (a) the inventory
# ---------------------------------------------------------------------------

# The JAX package's keywords that the port replaces, and why.
REPLACED = {
    "mesh": "a jax.sharding.Mesh of devices in one process; the port runs "
            "one process a rank on torch.distributed, and its entry points "
            "take that rank's group as ``comm`` in the mesh's place",
    "ndev": "the mesh's device count; the port reads the rank count from "
            "``comm.size`` (``comm`` takes its place)",
}


def _entry_points():
    from cpkrylov_tpu.mixed import prepare_mixed_device as j_prepare
    from cpkrylov_tpu.parallel.mixed import dist_solve_mixed as j_dmixed
    from cpkrylov_tpu.parallel.solve import dist_solve as j_dsolve
    from cpkrylov_tpu.parallel.solve import plan_dist as j_plan
    from cpkrylov_tpu_torch.parallel import (dist_solve, dist_solve_mixed,
                                             plan_dist)

    return {
        "solve": (cpk.solve, cpt.solve),
        "solve_mixed": (cpk.solve_mixed, cpt.solve_mixed),
        "prepare_mixed_device": (j_prepare, cpt.prepare_mixed_device),
        "make_preconditioner": (cpk.make_preconditioner,
                                cpt.make_preconditioner),
        "plan_dist": (j_plan, plan_dist),
        "dist_solve": (j_dsolve, dist_solve),
        "dist_solve_mixed": (j_dmixed, dist_solve_mixed),
        "csr_from_scipy": (jformats.csr_from_scipy, formats.csr_from_scipy),
        "ell_from_scipy": (jformats.ell_from_scipy, formats.ell_from_scipy),
        "bsr_from_scipy": (jformats.bsr_from_scipy, formats.bsr_from_scipy),
    }


ENTRY_POINTS = tuple(_entry_points())

# Keywords this PR restored, with the JAX package's defaults: the port's
# must be the same values.
RESTORED_DEFAULTS = ("spmv_format", "tile_rows", "inner_rtol", "lean_inner",
                     "max_outer", "halo", "M", "pad_to", "row_width",
                     "lane_pad", "blocksize")


def test_every_top_level_name_has_a_counterpart():
    missing = [n for n in cpk.__all__ if not hasattr(cpt, n)]
    assert not missing, missing
    for name in ("ELL", "ell_from_scipy"):
        assert name in cpt.__all__


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_every_keyword_is_accepted(name):
    jfn, pfn = _entry_points()[name]
    jpar = inspect.signature(jfn).parameters
    ppar = inspect.signature(pfn).parameters
    missing = [k for k in jpar if k not in ppar and k not in REPLACED]
    assert not missing, f"{name}: the port lacks {missing}"
    for k in REPLACED:
        if k in jpar:
            assert "comm" in ppar, f"{name}: {k} has no replacement"
    for k in RESTORED_DEFAULTS:
        if k in jpar:
            assert ppar[k].default == jpar[k].default, (name, k)


# ---------------------------------------------------------------------------
# (b) ELL and BSR products against the JAX package
# ---------------------------------------------------------------------------

def _ragged(seed=5):
    """Rows of every length: empty rows, a near-dense row, random ones."""
    rng = np.random.default_rng(seed)
    A = sp.random(37, 53, density=0.12, random_state=rng,
                  format="lil")
    A[4, :] = 0
    A[20, :] = 0
    A[11, :40] = rng.standard_normal(40)
    return A.tocsr()


MATRICES = {
    "ragged": _ragged,
    "empty": lambda: sp.csr_matrix((5, 5)),
    "grid_pad": lambda: sp.random(100, 90, density=0.08,
                                  random_state=np.random.default_rng(11),
                                  format="csr"),
    "dense_input": lambda: np.random.default_rng(2).standard_normal((9, 7)),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.linalg.norm(b)
    if scale == 0:
        return float(np.abs(a).max(initial=0.0))
    return float(np.linalg.norm(a - b) / scale)


def _operands(shape, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape[1]), rng.standard_normal((shape[1], 5))


@pytest.mark.parametrize("lane_pad", [1, 8])
@pytest.mark.parametrize("name", tuple(MATRICES))
def test_ell_products_match_jax(name, lane_pad):
    A = MATRICES[name]()
    je = jformats.ell_from_scipy(A, lane_pad=lane_pad)
    own = formats.ell_from_scipy(A, F64, CPU, lane_pad=lane_pad)
    carried = convert.ell_from_jax(je, device=CPU)
    for e in (own, carried):
        assert isinstance(e, ELL) and e.shape == tuple(je.shape)
        assert np.array_equal(e.data.numpy(), np.asarray(je.data))
        assert np.array_equal(e.cols.numpy(), np.asarray(je.cols))
    x, X = _operands(A.shape)
    want = np.asarray(jspmv.ell_matvec(je, jnp.asarray(x)))
    want_m = np.asarray(jspmv.matmat(je, jnp.asarray(X)))
    for e in (own, carried):
        got = spmv.matvec(e, torch.as_tensor(x)).numpy()
        got_m = spmv.matmat(e, torch.as_tensor(X)).numpy()
        assert got.shape == want.shape and got_m.shape == want_m.shape
        assert _rel(got, want) <= 1e-14
        assert _rel(got_m, want_m) <= 1e-14
        assert _rel(got, A @ x) <= 1e-14


def test_ell_row_width_pads_rows():
    A = _ragged()
    je = jformats.ell_from_scipy(A, row_width=64)
    e = formats.ell_from_scipy(A, F64, CPU, row_width=64)
    assert e.row_width == 64 == je.row_width
    x, _ = _operands(A.shape)
    assert _rel(spmv.matvec(e, torch.as_tensor(x)).numpy(),
                np.asarray(jspmv.ell_matvec(je, jnp.asarray(x)))) <= 1e-14


@pytest.mark.parametrize("blocksize", [4, 8])
@pytest.mark.parametrize("name", tuple(MATRICES))
def test_bsr_products_match_jax(name, blocksize):
    A = MATRICES[name]()
    jb = jformats.bsr_from_scipy(A, blocksize=blocksize)
    own = formats.bsr_from_scipy(A, blocksize, device=CPU)
    carried = convert.bsr_from_jax(jb, device=CPU)
    for b in (own, carried):
        assert isinstance(b, BSR) and b.shape == tuple(jb.shape)
        assert b.blocksize == jb.blocksize
        assert np.array_equal(b.data.numpy(), np.asarray(jb.data))
        assert np.array_equal(b.block_cols.numpy(),
                              np.asarray(jb.block_cols))
        assert np.array_equal(b.block_rows.numpy(),
                              np.asarray(jb.block_rows))
    # the operand padded to the block grid, as the JAX tests pass it
    x, X = _operands(jb.shape, seed=8)
    x[A.shape[1]:] = 0.0
    want = np.asarray(jspmv.bsr_matvec(jb, jnp.asarray(x)))
    want_m = np.asarray(jspmv.matmat(jb, jnp.asarray(X)))
    for b in (own, carried):
        got = spmv.matvec(b, torch.as_tensor(x)).numpy()
        got_m = spmv.matmat(b, torch.as_tensor(X)).numpy()
        assert got.shape == want.shape and got_m.shape == want_m.shape
        assert _rel(got, want) <= 1e-14
        assert _rel(got_m, want_m) <= 1e-14


@pytest.mark.parametrize("name", tuple(MATRICES))
def test_ell_and_bsr_sum_rows_like_the_csr_product(name):
    """ELL and BSR sum each row in stored order, as B5 and the CSR's plain
    version do: the same bits as the matrix's CSR product."""
    A = MATRICES[name]()
    x, X = _operands(A.shape, seed=3)
    c = formats.csr_from_scipy(A, F64, CPU)
    y, Y = spmv.matvec(c, torch.as_tensor(x)), spmv.matmat(
        c, torch.as_tensor(X))
    e = formats.ell_from_scipy(A, F64, CPU, lane_pad=8)
    assert torch.equal(spmv.matvec(e, torch.as_tensor(x)), y)
    assert torch.equal(spmv.matmat(e, torch.as_tensor(X)), Y)
    b = formats.bsr_from_scipy(A, 8, device=CPU)
    xp = np.zeros(b.shape[1])
    xp[:A.shape[1]] = x
    Xp = np.zeros((b.shape[1], X.shape[1]))
    Xp[:A.shape[1]] = X
    yb = spmv.matvec(b, torch.as_tensor(xp))
    Yb = spmv.matmat(b, torch.as_tensor(Xp))
    assert torch.equal(yb[:A.shape[0]], y) and not torch.any(yb[A.shape[0]:])
    assert torch.equal(Yb[:A.shape[0]], Y)


def test_bsr_slots_sum_each_block_row_in_stored_order():
    """The padded (block rows, blocks a row) index: row r's blocks in
    stored order, then the pad index (the block count)."""
    rows = np.array([0, 0, 2, 2, 2, 3])
    slots = formats.bsr_slots(rows, 5)
    assert slots.tolist() == [[0, 1, 6], [6, 6, 6], [2, 3, 4], [5, 6, 6],
                              [6, 6, 6]]
    with pytest.raises(ValueError, match="sorted"):
        formats.bsr_parts(np.zeros((2, 2, 2)), [0, 0], [1, 0], (4, 4), 2,
                          F64, CPU)


def test_csr_padding_is_inert():
    """``tests/test_sparse.py::test_csr_padding_is_inert`` on the port, and
    the padded CSR against the JAX package's."""
    rng = np.random.default_rng(4)
    A = sp.random(10, 12, density=0.3, random_state=rng, format="csr")
    jc = jformats.csr_from_scipy(A, pad_to=A.nnz + 37)
    c = formats.csr_from_scipy(A, F64, CPU, pad_to=A.nnz + 37)
    assert c.nnz == jc.nnz == A.nnz + 37
    x, X = _operands(A.shape)
    y = rng.standard_normal(10)
    got = spmv.matvec(c, torch.as_tensor(x)).numpy()
    assert _rel(got, np.asarray(jspmv.csr_matvec(jc, jnp.asarray(x)))) \
        <= 1e-14
    assert _rel(got, A @ x) <= 1e-14
    assert _rel(spmv.matmat(c, torch.as_tensor(X)).numpy(), A @ X) <= 1e-14
    assert _rel(spmv.rmatvec(c, torch.as_tensor(y)).numpy(), A.T @ y) \
        <= 1e-14
    back = formats.csr_to_scipy(c)
    assert abs(back - A).max() == 0.0
    assert abs(back - jformats.csr_to_scipy(jc)).max() == 0.0


def test_ell_and_bsr_operators_have_no_rmatvec():
    """``MatrixOperator.rmatvec`` refuses ELL and BSR, as the JAX one
    does; ``aslinearoperator`` wraps both."""
    A = _ragged()
    for mat in (formats.ell_from_scipy(A, F64, CPU),
                formats.bsr_from_scipy(A, 8, device=CPU)):
        op = cpt.aslinearoperator(mat)
        assert op.mat is mat
        with pytest.raises(TypeError):
            op.rmatvec(torch.zeros(mat.shape[0], dtype=F64))


def test_format_constructors_default_to_the_card():
    """Like every entry point, the ``*_from_scipy`` constructors run on the
    card unless asked for the CPU: without CUDA the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (formats.ell_from_scipy, formats.bsr_from_scipy,
                  formats.csr_from_scipy):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(_ragged())


# ---------------------------------------------------------------------------
# (c) spmv_format
# ---------------------------------------------------------------------------

FORMATS = ("auto", "dia", "csr", "pgell")
FMT_OPTS = dict(atol=1e-6, rtol=1e-6, itmax=500)
# the layout of (A, B, K_P) each system takes under each value
LAYOUT = {
    ("banded", "auto"): (DIA, DIA, DIA),
    ("banded", "dia"): (DIA, DIA, DIA),
    ("cvxqp1_m", "auto"): (CSR, CSR, CSR),
    ("cvxqp1_m", "dia"): (DIA, DIA, DIA),
}
for _s in ("banded", "cvxqp1_m"):
    for _f in ("csr", "pgell"):
        LAYOUT[(_s, _f)] = (CSR, CSR, CSR)


@pytest.fixture(scope="module")
def fmt_systems():
    out = {"banded": fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                                   with_oracle=False)}
    if fixtures.fixture_available("cvxqp1_m"):
        out["cvxqp1_m"] = fixtures.load_fixture("cvxqp1_m")
    return out


def _spied_solve(monkeypatch, s, **kw):
    """``cpt.solve`` with the preconditioner it builds and the device
    operands of A and B recorded."""
    seen = {"ops": []}
    build, operand = driver.make_preconditioner, driver._device_operand

    def spy_build(*a, **k):
        seen["M"] = build(*a, **k)
        seen["build_format"] = k.get("spmv_format")
        return seen["M"]

    def spy_operand(*a, **k):
        op = operand(*a, **k)
        seen["ops"].append(op)
        return op

    monkeypatch.setattr(driver, "make_preconditioner", spy_build)
    monkeypatch.setattr(driver, "_device_operand", spy_operand)
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device="cpu",
                    dtype=F64, opts=cpt.SolverOptions(**FMT_OPTS), **kw)
    return out, seen


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("system", ("banded", "cvxqp1_m"))
def test_spmv_format_matches_jax(fmt_systems, monkeypatch, system, fmt):
    if system not in fmt_systems:
        pytest.skip(f"{system} fixture unavailable")
    s = fmt_systems[system]
    out, seen = _spied_solve(monkeypatch, s, spmv_format=fmt)
    ref = cpk.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                    opts=cpk.SolverOptions(**FMT_OPTS), spmv_format=fmt)
    assert out.solved and ref.solved
    assert abs(out.niters - ref.niters) <= 2, (out.niters, ref.niters)
    assert _rel(out.x.numpy(), np.asarray(ref.x)) <= 1e-8
    want_a, want_b, want_kp = LAYOUT[(system, fmt)]
    a_op, b_op = seen["ops"]
    assert a_op is out.A_op
    assert isinstance(a_op.mat, want_a), type(a_op.mat)
    assert isinstance(b_op.mat, want_b), type(b_op.mat)
    assert seen["build_format"] == fmt
    assert isinstance(seen["M"].kp, want_kp), type(seen["M"].kp)
    assert isinstance(cpt.aslinearoperator(s.C, dtype=F64,
                                           device="cpu").mat, Diagonal)


def test_solve_pgell_format_matches_csr(fmt_systems):
    """``tests/test_pgell.py::test_solve_pgell_format_matches_csr`` on the
    port: "pgell" (kernel B5's CSR here) converges like "csr"."""
    if "cvxqp1_m" not in fmt_systems:
        pytest.skip("cvxqp1_m fixture unavailable")
    s = fmt_systems["cvxqp1_m"]
    opts = cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=200)
    base = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=opts,
                     spmv_format="csr", device="cpu", dtype=F64)
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=opts,
                    spmv_format="pgell", device="cpu", dtype=F64)
    assert out.solved
    assert abs(out.niters - base.niters) <= 2
    ref = base.x.numpy()
    np.testing.assert_allclose(out.x.numpy(), ref, rtol=0,
                               atol=1e-5 * np.linalg.norm(ref))


def test_tile_rows_has_no_effect(fmt_systems):
    """PGELL pages exist only on a TPU: any ``tile_rows`` gives the same
    bits."""
    s = fmt_systems["banded"]
    outs = [cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device="cpu",
                      dtype=F64, opts=cpt.SolverOptions(**FMT_OPTS),
                      spmv_format="pgell", tile_rows=t)
            for t in (2048, 64)]
    assert outs[0].niters == outs[1].niters
    assert torch.equal(outs[0].x, outs[1].x)


def test_dia_format_lifts_the_fill_gate():
    """A scattered matrix fails the "auto" gate and still packs as DIA
    under "dia"; a rectangular K_P cannot be DIA-packed by
    ``pack_sym_dia`` and stays CSR."""
    rng = np.random.default_rng(9)
    M = sp.random(60, 60, density=0.05, random_state=rng, format="csr")
    M = (M + M.T + sp.identity(60)).tocsr()
    assert isinstance(cp.pack_device_format(M, F64, CPU), CSR)
    d = cp.pack_device_format(M, F64, CPU, "dia")
    assert isinstance(d, DIA)
    x = rng.standard_normal(60)
    assert _rel(spmv.matvec(d, torch.as_tensor(x)).numpy(), M @ x) <= 1e-14
    rect = sp.random(30, 60, density=0.1, random_state=rng, format="csr")
    assert isinstance(cp.pack_device_format(rect, F64, CPU, "dia"), CSR)


def _unknown_format_calls(s):
    opts = cpt.SolverOptions(itmax=5)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device="cpu")
    return {
        "solve": lambda f: cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                                     device="cpu", dtype=F64, opts=opts,
                                     spmv_format=f),
        "make_preconditioner": lambda f: cpt.make_preconditioner(
            s.G, s.B, s.C, dtype=F64, device="cpu", spmv_format=f),
        "solve_mixed": lambda f: cpt.solve_mixed(
            "cpminres", s.b, s.A, s.B, s.C, s.G, device="cpu", opts=opts,
            spmv_format=f),
        "prepare_mixed_device": lambda f: cpt.prepare_mixed_device(
            "cpminres", s.b, s.A, s.B, s.C, M, opts, device="cpu",
            spmv_format=f),
    }


@pytest.mark.parametrize("entry", ("solve", "make_preconditioner",
                                   "solve_mixed", "prepare_mixed_device"))
def test_unknown_spmv_format_raises(entry):
    s = fixtures.banded_saddle_system(64, 16, bandwidth=3,
                                      with_oracle=False)
    call = _unknown_format_calls(s)[entry]
    with pytest.raises(ValueError, match="unknown spmv_format 'ell'"):
        call("ell")
    with pytest.raises(ValueError, match="unknown spmv_format"):
        cpk.solve("cpminres", s.b, s.A, s.B, s.C, s.G, spmv_format="ell")


def test_mixed_device_loop_takes_the_format():
    """``prepare_mixed_device`` reads A and B through their df64 packs'
    hi parts under "auto" and "dia", and as f32 CSR under "csr" and
    "pgell"; both loops reach the contract with the same count."""
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                      with_oracle=False)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device="cpu")
    outs = {}
    for fmt in ("auto", "csr"):
        dm = cpt.prepare_mixed_device("cpminres", s.b, s.A, s.B, s.C, M,
                                      opts, device="cpu", spmv_format=fmt)
        want = CSR if fmt == "csr" else DIA
        assert isinstance(dm.A_op.mat, want)
        assert isinstance(dm.B_op.mat, want)
        assert dm.A_op.mat.dtype == torch.float32
        outs[fmt] = cpt.solve_mixed(
            "cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device="cpu",
            opts=opts, device_resident=True, spmv_format=fmt)
    K = sp.bmat([[s.A, s.B.T], [s.B, -s.C]]).tocsr()
    for out in outs.values():
        assert out.solved and out.inner_outputs == ()
        assert np.linalg.norm(s.b - K @ out.x) <= 1e-10 * np.linalg.norm(s.b)
    assert abs(outs["csr"].niters - outs["auto"].niters) <= 2


# ---------------------------------------------------------------------------
# (d) the mixed options
# ---------------------------------------------------------------------------

MIXED_OPTS = dict(atol=1e-8, rtol=1e-8, itmax=500)


def _xla_dot(a, b):
    """The JAX package's f32 dot, for runs that share its reduction order."""
    if a.dtype != torch.float32:
        return torch.dot(a, b)
    return torch.tensor(float(jnp.dot(jnp.asarray(a.numpy()),
                                      jnp.asarray(b.numpy()))),
                        dtype=torch.float32)


@pytest.fixture(scope="module")
def cvxqp1_m32():
    if not fixtures.fixture_available("cvxqp1_m"):
        pytest.skip("cvxqp1_m fixture unavailable")
    s = fixtures.load_fixture("cvxqp1_m")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                    options=cpt.PrecondOptions(**BENCH_POPTS),
                                    device="cpu")
    return s, M


@pytest.mark.parametrize("kw", [dict(lean_inner=False),
                                dict(inner_rtol=1e-6)],
                         ids=["lean_inner_false", "inner_rtol_1e-6"])
def test_mixed_options_match_jax(cvxqp1_m32, monkeypatch, kw):
    s, M = cvxqp1_m32
    rtols = []
    inner = mixed.solve

    def spy(*a, **k):
        rtols.append(k["opts"].rtol)
        return inner(*a, **k)

    monkeypatch.setattr(mixed, "solve", spy)
    monkeypatch.setattr(common, "vdot", _xla_dot)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, M=M,
                              opts=cpt.SolverOptions(**MIXED_OPTS),
                              device="cpu", **kw)
        ref = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                              opts=cpk.SolverOptions(**MIXED_OPTS),
                              precond_opts=cpk.PrecondOptions(**BENCH_POPTS),
                              **kw)
    assert out.solved and ref.solved
    assert out.inner_outputs                 # the host loop
    r = s.b - s.K @ out.x
    assert np.linalg.norm(r) <= 1e-8 + 1e-8 * np.linalg.norm(s.b)
    assert abs(out.nouter - ref.nouter) <= 2
    for got, want in zip(out.inner_niters, ref.inner_niters):
        assert abs(got - want) <= 2, (out.inner_niters, ref.inner_niters)
    # this factor is not exact at f32: every pass asks for inner_rtol
    assert not M.factor_exact
    assert rtols == [kw.get("inner_rtol", mixed.INNER_RTOL)] * out.nouter


def test_lean_inner_keeps_or_strips_the_options(cvxqp1_m32):
    _, M = cvxqp1_m32
    assert M.factor_nitref == 0
    assert mixed._lean_inner_options(M, False) is M
    lean = mixed._lean_inner_options(M, True)
    assert (lean.options.nitref, lean.options.force_itref,
            lean.options.residual_update) == (0, False, False)
    assert lean.factor is M.factor


@pytest.fixture(scope="module")
def banded_lean_runs():
    """The banded system's mixed solve in both loops, lean and not, with
    the direct solves of the inner preconditioner counted."""
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                      with_oracle=False)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    popts = cpt.PrecondOptions(**BENCH_POPTS)
    calls = [0]
    direct = cp.CPPrecond._direct_solve

    def spy(self, z):
        calls[0] += 1
        return direct(self, z)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cp.CPPrecond, "_direct_solve", spy)
        for resident in (False, True):
            for lean in (True, False):
                calls[0] = 0
                o = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                                    opts=opts, precond_opts=popts,
                                    device="cpu", lean_inner=lean,
                                    device_resident=resident)
                out[(resident, lean)] = (o, calls[0])
    return s, out


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host_loop", "device_loop"])
def test_lean_inner_false_refines_every_application(banded_lean_runs,
                                                    resident):
    """Both loops honour ``lean_inner=False``: the caller's refinement
    runs, so each inner iteration takes more direct solves than the lean
    run's, and the f64 contract holds."""
    s, runs = banded_lean_runs
    K = sp.bmat([[s.A, s.B.T], [s.B, -s.C]]).tocsr()
    per_iter = {}
    for lean in (True, False):
        o, calls = runs[(resident, lean)]
        assert o.solved
        assert (o.inner_outputs == ()) == resident
        assert np.linalg.norm(s.b - K @ o.x) <= 1e-10 * np.linalg.norm(s.b)
        per_iter[lean] = calls / o.niters
    assert per_iter[False] > 1.5 * per_iter[True], per_iter


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host_loop", "device_loop"])
def test_max_outer_bounds_the_passes(resident):
    s = fixtures.banded_saddle_system(2048, 512, bandwidth=3,
                                      with_oracle=False)
    out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpt.SolverOptions(atol=0.0, rtol=1e-12,
                                                 itmax=300),
                          device="cpu", max_outer=1,
                          device_resident=resident)
    ref = jax_solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=cpk.SolverOptions(atol=0.0, rtol=1e-12,
                                                 itmax=300),
                          max_outer=1, device_resident=False)
    assert out.nouter == ref.nouter == 1
    assert not out.solved and not ref.solved


# ---------------------------------------------------------------------------
# (e) the distributed options, on two gloo CPU ranks
# ---------------------------------------------------------------------------

DIST_SYS = dict(n=2048, m=512, bandwidth=3)


def _dist_worker(comm):
    """One rank: two mixed solves with one prebuilt f32 preconditioner
    (the host factorizations counted), and dist_solve with and without
    the halo plans."""
    from cpkrylov_tpu_torch.parallel import (dist_solve, dist_solve_mixed,
                                             plan_dist)
    from cpkrylov_tpu_torch.parallel.mixed import build_dist_precond
    from cpkrylov_tpu_torch.parallel.solve import GatherBlock, HaloBlock
    from cpkrylov_tpu_torch.precond import ldl_host

    s = fixtures.banded_saddle_system(DIST_SYS["n"], DIST_SYS["m"],
                                      bandwidth=DIST_SYS["bandwidth"],
                                      with_oracle=False)
    factorize = ldl_host.factorize
    count = [0]

    def counted(*a, **k):
        count[0] += 1
        return factorize(*a, **k)

    ldl_host.factorize = counted
    popts = cpt.PrecondOptions(**BENCH_POPTS)
    mopts = cpt.SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    out = {}
    M = build_dist_precond(s.G, s.B, s.C, comm, precond_opts=popts,
                           dtype=torch.float32)
    out["built"] = count[0]
    b2 = np.random.default_rng(1).standard_normal(s.b.shape[0])
    runs = []
    for rhs in (s.b, b2):
        mo = dist_solve_mixed(comm, "cpminres", rhs, s.A, s.B, s.C, s.G,
                              opts=mopts, M=M)
        runs.append((mo.solved, mo.nouter, mo.x, mo.ptime))
    out["reused"] = count[0] - out["built"]
    out["mixed"] = runs
    mo = dist_solve_mixed(comm, "cpminres", s.b, s.A, s.B, s.C, s.G,
                          opts=mopts, M=M, max_outer=1, lean_inner=False,
                          inner_rtol=1e-6, halo=False)
    out["one_pass"] = (mo.solved, mo.nouter)
    ldl_host.factorize = factorize

    Mr = cpt.make_preconditioner(s.G, s.B, s.C, dtype=F64, device="cpu")
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    xs = {}
    for halo in (True, False):
        plan = plan_dist(s.A, s.B, s.C, comm, dtype=F64, halo=halo)
        kinds = {k: type(v) for k, v in plan.blocks.items()}
        res, x1, x2 = dist_solve(comm, "cpminres", s.b, s.A, s.B, s.C, s.G,
                                 opts=opts, M=Mr, halo=halo)
        xs[halo] = (int(res.niters), torch.cat([x1, x2]).numpy(),
                    {k: v is HaloBlock for k, v in kinds.items()},
                    all(v in (HaloBlock, GatherBlock)
                        for v in kinds.values()))
    out["halo"] = xs
    return out


@pytest.fixture(scope="module")
def dist_runs():
    return run_ranks(_dist_worker, 2, backend="gloo", device="cpu",
                     timeout_s=600)


def test_dist_solve_mixed_reuses_M(dist_runs):
    s = fixtures.banded_saddle_system(DIST_SYS["n"], DIST_SYS["m"],
                                      bandwidth=DIST_SYS["bandwidth"])
    b2 = np.random.default_rng(1).standard_normal(s.b.shape[0])
    for r in dist_runs:
        assert r["built"] >= 1
        assert r["reused"] == 0          # two solves, no factorization
        for (solved, nouter, x, _), rhs in zip(r["mixed"], (s.b, b2)):
            assert solved and nouter >= 1
            assert (np.linalg.norm(rhs - s.K @ x)
                    <= 1e-10 * np.linalg.norm(rhs))
        # max_outer, lean_inner, inner_rtol and halo are taken
        assert r["one_pass"][1] == 1


def test_dist_solve_halo_false_plans_no_halo(dist_runs):
    for r in dist_runs:
        (k_on, x_on, halo_on, ok_on) = r["halo"][True]
        (k_off, x_off, halo_off, ok_off) = r["halo"][False]
        assert ok_on and ok_off
        assert any(halo_on.values())
        assert not any(halo_off.values())
        assert k_off == k_on
        assert _rel(x_off, x_on) <= 1e-12
