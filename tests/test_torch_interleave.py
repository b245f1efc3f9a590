"""The interleave riffle B7 and its inverse B8: the plain versions that the
CPU runs (``precond/cuda_interleave.py``), held bit for bit against the JAX
package's Pallas kernels in interpret mode (``interleave_head`` /
``uninterleave_head``) and its ``InterleavePermute``, on inputs made from a
numpy seed.  A riffle moves entries without arithmetic, so every comparison
is exact.

Cases: c = 1 and c = 4, f32 and f64, a last group block that is ragged for
the Pallas block size G, and an empty x-tail (n = c m).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpkrylov_tpu.precond import permute as jperm
from cpkrylov_tpu.precond.pallas_interleave import (interleave_head,
                                                    uninterleave_head)
from cpkrylov_tpu_torch.precond import cuda_interleave as ci
from cpkrylov_tpu_torch.precond.permute import InterleavePermute
from cpkrylov_tpu_torch.utils.profiling import launch_counts

# (n, m, c, G): G is the Pallas kernel's group block (m % G != 0 is ragged)
CASES = [(80, 20, 4, 8),            # empty tail, ragged
         (100, 20, 4, 8),           # tail of 20, ragged
         (50, 37, 1, 16),           # c = 1, tail of 13, ragged
         (37 * 4, 37, 4, 16),       # empty tail, ragged
         (65_600, 16_389, 4, 8192)]  # ragged last block of the real G
DTYPES = [np.float32, np.float64]


def _z(n, m, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n + m).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,c,G", CASES)
def test_plain_riffle_equals_pallas_interpret(n, m, c, G, dtype):
    z = _z(n, m, dtype, seed=n + c)
    cm = c * m
    head = np.asarray(interleave_head(jnp.asarray(z[:cm]),
                                      jnp.asarray(z[n:]), c=c, G=G,
                                      interpret=True))
    w = ci.interleave_plain(torch.as_tensor(z), n, m, c).numpy()
    assert w.dtype == dtype
    np.testing.assert_array_equal(w[: m * (c + 1)], head)
    np.testing.assert_array_equal(w[m * (c + 1):], z[cm:n])

    xh, y = uninterleave_head(jnp.asarray(w[: m * (c + 1)]), c=c, G=G,
                              interpret=True)
    back = ci.uninterleave_plain(torch.as_tensor(w), n, m, c).numpy()
    np.testing.assert_array_equal(back[:cm], np.asarray(xh))
    np.testing.assert_array_equal(back[n:], np.asarray(y))
    np.testing.assert_array_equal(back, z)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,c,G", CASES)
def test_port_permute_equals_jax_permute(n, m, c, G, dtype):
    z = _z(n, m, dtype, seed=3 * n + c)
    jp = jperm.InterleavePermute(n=n, m=m, c=c)
    tp = InterleavePermute(n=n, m=m, c=c)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    w = tp.apply(torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(w, np.asarray(jp.apply(jnp.asarray(z))))
    np.testing.assert_array_equal(w, z[tp.perm])
    back = tp.apply_inv(torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jp.apply_inv(jnp.asarray(w))))
    np.testing.assert_array_equal(back, z)


def test_cpu_tensors_take_the_plain_version_without_counting():
    n, m, c = 100, 20, 4
    z = torch.as_tensor(_z(n, m, np.float64, seed=1))
    before = launch_counts()
    w = ci.interleave(z, n, m, c)
    back = ci.uninterleave(w, n, m, c)
    assert launch_counts() == before
    assert torch.equal(w, ci.interleave_plain(z, n, m, c))
    assert torch.equal(back, z)


def test_other_devices_raise():
    """Only a CPU tensor reaches the plain version; any other goes to the
    kernel's wrapper, which takes CUDA tensors alone."""
    z = torch.empty(25, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ci.interleave(z, 20, 5, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        ci.uninterleave(z, 20, 5, 4)
