"""The port's DIA SpMV (``cpkrylov_tpu_torch/ops``) against the JAX package.

The same packed arrays (made with numpy from a seed and packed by the JAX
package) go through JAX ``ops/dia.py::dia_matvec``, the Pallas kernel
``pallas_dia_matvec`` in interpret mode, and the port's plain version.  Both
plain versions sum the diagonals in ascending order with separately rounded
multiplies and adds, so they agree to the last bit; the stated tolerances
are f64 1e-14 and f32 1e-6 relative to the largest output entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _host_dia import gate_cases, host_dia, placement_cases

import cpkrylov_tpu_torch as cpt

from cpkrylov_tpu.ops.dia import dia_matvec as jax_dia_matvec
from cpkrylov_tpu.ops.dia import dia_rmatvec as jax_dia_rmatvec
from cpkrylov_tpu.ops.dia import pack_dia as jax_pack_dia
from cpkrylov_tpu.ops.pallas_dia import pack_pallas_dia, pallas_dia_matvec
from cpkrylov_tpu_torch.ops import cuda_dia, spmv
from cpkrylov_tpu_torch.ops import dia as tdia
from cpkrylov_tpu_torch.ops.dia import dia_matvec, dia_rmatvec, pack_dia
from cpkrylov_tpu_torch.utils import fixtures
from cpkrylov_tpu_torch.utils.convert import dia_from_numpy
from cpkrylov_tpu_torch.utils.profiling import (COUNTS, launch_counts,
                                                path_counts)

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-14}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _near(rng):
    """7-diagonal square band (the main path's A)."""
    n = 3000
    offs = [-3, -2, -1, 0, 1, 2, 3]
    return sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                    format="csr")


def _kp_far(rng):
    """Natural-order K_P: diagonal plus B/B' at offsets ~ +-n (the case of
    tests/test_sparse.py::test_pallas_dia_far_offset_groups)."""
    n, m = 1500, 400
    N = n + m
    K = sp.lil_matrix((N, N))
    K.setdiag(rng.standard_normal(N))
    for g in range(m):
        K[n + g, g] = rng.standard_normal()
        K[g, n + g] = K[n + g, g]
    return K.tocsr()


def _rect(rng):
    """Rectangular B (m x n) with offsets {0, 1}."""
    m, n = 700, 2000
    return sp.diags([np.ones(m), 0.25 * rng.standard_normal(m)], [0, 1],
                    shape=(m, n), format="csr")


CASES = {"near": _near, "kp_far": _kp_far, "rect": _rect}


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return (np.max(np.abs(np.asarray(got, np.float64) - ref))
            / max(np.max(np.abs(ref)), 1e-300))


def _pair(case, dtype, seed=3):
    rng = np.random.default_rng(seed)
    mat = CASES[case](rng)
    jd = jax_pack_dia(mat, dtype=dtype, max_bytes_ratio=0)
    td = dia_from_numpy(np.asarray(jd.data), jd.offsets, jd.shape,
                        dtype=TORCH[dtype], nnz=jd.nnz, device="cpu")
    return rng, mat, jd, td


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_matvec_matches_jax(case, dtype):
    rng, mat, jd, td = _pair(case, dtype)
    x = rng.standard_normal(mat.shape[1]).astype(dtype)
    y_ref = np.asarray(jax_dia_matvec(jd, jnp.asarray(x)))
    y = dia_matvec(td, torch.as_tensor(x))
    assert y.dtype == TORCH[dtype]
    assert _rel(y.numpy(), y_ref) <= TOL[dtype]
    # the CPU tensor goes to the plain version through the wrapper and the
    # dispatcher, and launches nothing
    before = launch_counts()
    np.testing.assert_array_equal(
        cuda_dia.dia_spmv(td, torch.as_tensor(x)).numpy(), y.numpy())
    np.testing.assert_array_equal(
        spmv.matvec(td, torch.as_tensor(x)).numpy(), y.numpy())
    assert launch_counts() == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_rmatvec_matches_jax(case, dtype):
    rng, mat, jd, td = _pair(case, dtype, seed=4)
    y = rng.standard_normal(mat.shape[0]).astype(dtype)
    x_ref = np.asarray(jax_dia_rmatvec(jd, jnp.asarray(y)))
    x = dia_rmatvec(td, torch.as_tensor(y))
    assert _rel(x.numpy(), x_ref) <= TOL[dtype]
    assert _rel(x.numpy(), mat.T @ y.astype(np.float64)) <= 1e3 * TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["near", "kp_far"])
def test_dia_matvec_matches_pallas_interpret(case, dtype):
    """The Pallas kernel the port replaces, run in interpret mode on the
    same packed operand (square matrices: the kernel served A and K_P)."""
    rng, mat, jd, td = _pair(case, dtype, seed=5)
    pd = pack_pallas_dia(jd, chunk=256)
    assert pd is not None
    x = rng.standard_normal(mat.shape[1]).astype(dtype)
    y_ref = np.asarray(pallas_dia_matvec(pd, jnp.asarray(x), interpret=True))
    y = dia_matvec(td, torch.as_tensor(x)).numpy()
    assert _rel(y, y_ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_dia_matches_jax_pack(dtype):
    """The port's own packer stores the JAX packer's diagonals, and its fill
    gate decides the same way in f32 and f64."""
    rng = np.random.default_rng(8)
    for case in sorted(CASES):
        mat = CASES[case](rng)
        jd = jax_pack_dia(mat, dtype=np.float64, max_bytes_ratio=0)
        td = pack_dia(mat, dtype=dtype, device="cpu")
        assert td is not None and td.offsets == jd.offsets
        np.testing.assert_array_equal(
            td.data.numpy(), np.asarray(jd.data).astype(td.data.numpy().dtype))
        assert td.offsets_t.tolist() == list(jd.offsets)
    # scattered entries: far more padded slots than entries -> rejected
    scattered = sp.random(2000, 2000, density=0.002, random_state=rng,
                          format="csr")
    assert pack_dia(scattered, dtype=dtype, device="cpu") is None
    assert pack_dia(scattered, dtype=dtype, device="cpu",
                    max_fill_ratio=0) is not None


def test_dia_from_numpy_validates():
    with pytest.raises(ValueError):
        dia_from_numpy(np.zeros((2, 5)), (1, 0), (5, 5), device="cpu")
    with pytest.raises(ValueError):
        dia_from_numpy(np.zeros((2, 4)), (0, 1), (5, 5), device="cpu")


# ---------------------------------------------------------------------------
# The placement on the operand's device (``place_dia``), bit for bit against
# the host placement it replaced (tests/_host_dia.py) and the JAX packer
# ---------------------------------------------------------------------------

PLACEMENT_CASES = placement_cases(np.random.default_rng(11))
GATE_CASES = gate_cases()
BITS = {torch.float32: np.uint32, torch.float64: np.uint64}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _same_dia(got, ref, dtype):
    data, offsets, shape, nnz = ref
    assert got.offsets == offsets and got.shape == shape and got.nnz == nnz
    assert got.offsets_t.dtype == torch.int64
    assert got.offsets_t.tolist() == list(offsets)
    assert got.data.dtype == dtype and got.data.is_contiguous()
    np.testing.assert_array_equal(
        _bits(got.data.numpy()),
        _bits(data.astype(got.data.numpy().dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(PLACEMENT_CASES))
def test_placement_matches_host_and_jax_pack(case, dtype):
    mat = PLACEMENT_CASES[case].copy()
    before = mat.copy()
    got = pack_dia(mat, dtype=dtype, device="cpu", max_fill_ratio=0)
    # the caller's matrix keeps its own arrays, canonical or not
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(mat, a), getattr(before, a))
    _same_dia(got, host_dia(mat, max_fill_ratio=0), dtype)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    jd = jax_pack_dia(mat, dtype=npdt, max_bytes_ratio=0)
    assert got.offsets == jd.offsets and got.nnz == jd.nnz
    np.testing.assert_array_equal(_bits(got.data.numpy()),
                                  _bits(np.asarray(jd.data)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_placement_gate_at_its_boundary(case, dtype):
    """4.5 padded slots an entry passes and one entry fewer does not, as
    the host pack and the JAX package's f32 gate (the same 4.5 slots)
    decide."""
    mat, passes = GATE_CASES[case]
    got = pack_dia(mat, dtype=dtype, device="cpu")
    ref = host_dia(mat)
    assert (got is not None) == passes == (ref is not None)
    assert (jax_pack_dia(mat, dtype=np.float32) is not None) == passes
    if passes:
        _same_dia(got, ref, dtype)


def test_upload_keeps_a_canonical_csr_and_its_index_dtype():
    mat = PLACEMENT_CASES["int64"]
    up = tdia.upload_csr(mat, "cpu")
    assert up.indices.dtype == up.indptr.dtype == torch.int64
    assert up.data.dtype == torch.float64 and up.shape == mat.shape
    # on the host the uploaded arrays are the matrix's own: no copy
    assert up.indices.data_ptr() == mat.indices.ctypes.data
    up32 = tdia.upload_csr(PLACEMENT_CASES["rect"], "cpu")
    assert up32.indices.dtype == torch.int32
    # a non-canonical matrix is canonicalized on a copy
    dups = PLACEMENT_CASES["dups_unsorted"]
    up = tdia.upload_csr(dups, "cpu")
    assert up.nnz == 599 < dups.nnz and not dups.has_canonical_format


def test_cpu_placements_count_nothing(monkeypatch):
    monkeypatch.setitem(COUNTS, "dia_card_packs", 0)
    monkeypatch.setitem(COUNTS, "dia_gate_refusals", 0)
    pack_dia(GATE_CASES["at_gate"][0], torch.float64, "cpu")
    pack_dia(GATE_CASES["past_gate"][0], torch.float64, "cpu")
    assert path_counts()["dia_card_packs"] == 0
    assert path_counts()["dia_gate_refusals"] == 0


def test_solve_sees_inplace_updates():
    """The f64 path's twin of test_torch_df64.py::
    test_mixed_sees_inplace_updates: A is packed anew on every call, so an
    in-place change of its values between two solves changes the answer."""
    sysm = fixtures.banded_saddle_system(1024, 256, bandwidth=3,
                                         with_oracle=False)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-8, itmax=300)
    out1 = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                     opts=opts, dtype=torch.float64, device="cpu")
    assert out1.solved
    sysm.A.data *= 1.5
    sysm.G = sp.diags(sysm.A.diagonal()).tocsr()
    out2 = cpt.solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                     opts=opts, dtype=torch.float64, device="cpu")
    assert out2.solved
    assert not torch.equal(out1.x, out2.x)
    K2 = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    r2 = sysm.b - K2 @ out2.x.numpy()
    assert np.linalg.norm(r2) <= 1e-6 * np.linalg.norm(sysm.b), (
        "stale operator: the second solve used the old A")
