"""The port's banded triangular solve (``precond/trisolve.py``'s
reduced-state scan form, ``precond/cuda_tri.py``: kernels B4 and B6 and
their plain versions) against the JAX package and scipy.

On a CPU tensor the port runs the plain versions.  Inputs are the banded
lower matrices of ``tests/test_pallas_tri.py:22-80`` (diagonal 4, reach
subdiagonals of N(0, 0.3^2)).

* packing: the port's ``pack_reduced_scan_np`` equals the JAX package's bit
  for bit (inverse panels, W blocks, n, panel, r);
* f32 solve: held against ``pallas_tri_solve(..., interpret=True)`` (a
  multi-chunk case included), ``pallas_tri_solve_xla`` and
  ``reduced_scan_tri_solve`` on identical operands, and against scipy's
  f64 ``spsolve_triangular``: relative 2-norm <= 1e-5 (f32 rounding of the
  dense panel products and the scan);
* f64 solve: against the JAX ``reduced_scan_tri_solve`` and scipy,
  <= 1e-12 (measured 0.8e-16 to 2.2e-16 against scipy: both are
  backward-stable forms of the same substitution on a diagonally dominant
  matrix; f32 measured 4.0e-8 to 5.0e-8);
* B6's plain version against the Pallas scan kernel in interpret mode
  (f32, two chunks, atol/rtol 2e-4 as in tests/test_pallas_tri.py) and
  ``affine_lane_scan_reference`` (f64, <= 1e-12);
* ``utils/convert.reduced_scan_from`` round-trips both JAX factor kinds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpkrylov_tpu.precond import trisolve as jtri
from cpkrylov_tpu.precond.pallas_tri import (_affine_scan_kernel,
                                             affine_lane_scan_reference,
                                             build_pallas_tri,
                                             pallas_tri_solve,
                                             pallas_tri_solve_xla)
from cpkrylov_tpu_torch.precond import cuda_tri
from cpkrylov_tpu_torch.precond.cuda_tri import (affine_scan,
                                                 affine_scan_plain,
                                                 band_tri_solve,
                                                 band_tri_solve_plain)
from cpkrylov_tpu_torch.precond.trisolve import (ReducedScanTriFactor,
                                                 build_reduced_scan_tri,
                                                 pack_reduced_scan_np,
                                                 tri_solve)
from cpkrylov_tpu_torch.utils.convert import reduced_scan_from

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _banded_lower(n, reach, seed=0):
    rng = np.random.default_rng(seed)
    diags = [np.full(n, 4.0)] + [rng.standard_normal(n) * 0.3
                                 for _ in range(reach)]
    offs = [0] + [-(k + 1) for k in range(reach)]
    return sp.diags(diags, offs, shape=(n, n), format="csr")


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


# (n, reach, panel): the cases of tests/test_pallas_tri.py, an n that is not
# a multiple of the panel, and a reach equal to the panel
CASES = [(2048, 5, 16), (1024, 3, 16), (2048, 1, 8), (2000, 7, 24),
         (1500, 16, 16)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,reach,panel", CASES)
def test_pack_matches_jax_bitwise(n, reach, panel, dtype):
    T = _banded_lower(n, reach)
    ours = pack_reduced_scan_np(T, panel=panel, dtype=dtype)
    ref = jtri.pack_reduced_scan_np(T, panel=panel, dtype=dtype)
    assert ours[2:] == ref[2:] == (n, panel, max(1, reach))
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
    if reach > 1:
        assert pack_reduced_scan_np(T, panel=reach - 1) is None


@pytest.mark.parametrize("n,reach,panel,chunk", [(2048, 5, 16, 64),
                                                  (1024, 3, 16, 16),
                                                  (2048, 1, 8, 32)])
def test_plain_matches_pallas_f32(n, reach, panel, chunk):
    T = _banded_lower(n, reach, seed=reach)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x64 = spla.spsolve_triangular(T, b.astype(np.float64), lower=True)
    jtf = build_pallas_tri(T, panel=panel, chunk=chunk)
    assert jtf is not None and jtf.nb * panel >= n
    refs = {
        "pallas_interpret": pallas_tri_solve(jtf, jnp.asarray(b),
                                             interpret=True),
        "pallas_xla": pallas_tri_solve_xla(jtf, jnp.asarray(b)),
        "reduced_scan": jtri.reduced_scan_tri_solve(
            jtri.build_reduced_scan_tri(T, panel=panel, dtype=np.float32),
            jnp.asarray(b)),
    }
    tf = reduced_scan_from(jtf, dtype=torch.float32, device="cpu")
    x = band_tri_solve_plain(tf, torch.as_tensor(b))
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), x64) <= TOL[np.float32]
    for name, ref in refs.items():
        assert _rel(x.numpy(), np.asarray(ref, np.float64)) <= \
            TOL[np.float32], name


@pytest.mark.parametrize("n,reach,panel", CASES)
def test_plain_matches_jax_and_scipy_f64(n, reach, panel):
    T = _banded_lower(n, reach, seed=n)
    b = np.random.default_rng(2).standard_normal(n)
    x64 = spla.spsolve_triangular(T, b, lower=True)
    jtf = jtri.build_reduced_scan_tri(T, panel=panel, dtype=np.float64)
    xj = np.asarray(jtri.reduced_scan_tri_solve(jtf, jnp.asarray(b)))
    tf = build_reduced_scan_tri(T, torch.float64, "cpu", panel=panel)
    assert isinstance(tf, ReducedScanTriFactor)
    assert (tf.panel, tf.r, tf.nblocks) == (panel, max(1, reach),
                                            -(-n // panel))
    x = tri_solve(tf, torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), x64) <= TOL[np.float64]
    assert _rel(x.numpy(), xj) <= TOL[np.float64]


def _pallas_scan_interpret(mr, cr, r, K):
    nb = mr.shape[2]
    kernel = functools.partial(_affine_scan_kernel, r=r, K=K)
    return pl.pallas_call(
        kernel, grid=(nb // K,),
        in_specs=[pl.BlockSpec((r, r, K), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((r, K), lambda i: (0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((r, K), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((r, nb), jnp.float32),
        scratch_shapes=[pltpu.VMEM((r, 128), jnp.float32)],
        interpret=True)(mr, cr)


def test_affine_scan_plain_matches_pallas_f32():
    rng = np.random.default_rng(4)
    r, nb = 8, 128
    mr = (rng.standard_normal((r, r, nb)) * 0.1).astype(np.float32)
    cr = rng.standard_normal((r, nb)).astype(np.float32)
    got = affine_scan(torch.as_tensor(mr), torch.as_tensor(cr))
    ref = np.asarray(_pallas_scan_interpret(jnp.asarray(mr), jnp.asarray(cr),
                                            r, K=64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("r,nb", [(8, 128), (1, 37), (33, 50)])
def test_affine_scan_plain_matches_reference_f64(r, nb):
    rng = np.random.default_rng(r + nb)
    mr = rng.standard_normal((r, r, nb)) * (0.5 / np.sqrt(r))
    cr = rng.standard_normal((r, nb))
    ref = np.asarray(affine_lane_scan_reference(jnp.asarray(mr),
                                                jnp.asarray(cr)))
    # a strided view of the same maps scans the same
    mr_t = torch.as_tensor(np.ascontiguousarray(mr.transpose(2, 0, 1)))
    for m in (torch.as_tensor(mr), mr_t.permute(1, 2, 0)):
        got = affine_scan_plain(m, torch.as_tensor(cr))
        assert got.shape == (r, nb) and got.dtype == torch.float64
        assert _rel(got.numpy(), ref) <= TOL[np.float64]


def test_reduced_scan_from_round_trip():
    n, reach, panel = 2000, 7, 24
    T = _banded_lower(n, reach, seed=5)
    b = np.random.default_rng(6).standard_normal(n)
    own = build_reduced_scan_tri(T, torch.float32, "cpu", panel=panel)
    from_xla = reduced_scan_from(
        jtri.build_reduced_scan_tri(T, panel=panel, dtype=np.float32),
        dtype=torch.float32, device="cpu")
    from_pallas = reduced_scan_from(build_pallas_tri(T, panel=panel,
                                                     chunk=64),
                                    dtype=torch.float32, device="cpu")
    for tf in (from_xla, from_pallas):
        assert (tf.n, tf.panel, tf.r) == (own.n, own.panel, own.r)
        assert torch.equal(tf.inv_diag, own.inv_diag)
        assert torch.equal(tf.w_blocks, own.w_blocks)
        assert tf.inv_diag.is_contiguous() and tf.w_blocks.is_contiguous()
        x = band_tri_solve(tf, torch.as_tensor(b, dtype=torch.float32))
        assert torch.equal(x, band_tri_solve(own, torch.as_tensor(
            b, dtype=torch.float32)))


def test_cpu_dispatch_counts_no_launch_and_checks_length():
    T = _banded_lower(600, 4, seed=7)
    tf = build_reduced_scan_tri(T, torch.float64, "cpu", panel=8)
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(600))
    before = (cuda_tri.LAUNCHES, cuda_tri.SCAN_LAUNCHES)
    np.testing.assert_array_equal(tri_solve(tf, b).numpy(),
                                  band_tri_solve_plain(tf, b).numpy())
    assert (cuda_tri.LAUNCHES, cuda_tri.SCAN_LAUNCHES) == before
    with pytest.raises(ValueError, match="rhs has shape"):
        band_tri_solve(tf, b[:-1])
    assert build_reduced_scan_tri(T, torch.float64, "cpu", panel=3) is None
