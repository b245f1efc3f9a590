"""Bidiagonal triangular solves: the hand-written CUDA scan kernel
(``csrc/bidiag_scan.cu``), its wrapper, and its plain PyTorch version.

Replaces the JAX package's Pallas kernel
``precond/pallas_bidiag.py::_bidiag_kernel``.  A reach-1 factor (the
interleave-ordered main-path factor) is the first-order recurrence

    x_i = a_i x_{i-1} + invd_i b_i      (lower, ``reverse=False``)
    x_i = a_i x_{i+1} + invd_i b_i      (upper, ``reverse=True``)

with ``a_i = -l_i / d_i`` and ``invd_i = 1 / d_i``, held in natural order.
The upper form solves U directly (no flips), and with D folded in (D U) it
also absorbs the block-diagonal scale of the LDL^T solve.

``bidiag_tri_solve`` launches the kernel for a CUDA tensor and raises on
anything it does not take; a CPU tensor goes to ``bidiag_scan_plain``, a
Hillis-Steele scan of the affine maps in log2(n) vectorized passes.
``LAUNCHES`` counts kernel solves (one per call; a call is three launches on
one stream).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build

LAUNCHES = 0

_ENTRY = {torch.float32: "cpkt_bidiag_scan_f32",
          torch.float64: "cpkt_bidiag_scan_f64"}


@dataclasses.dataclass(frozen=True)
class BidiagTriFactor:
    """Bidiagonal factor as recurrence coefficients in natural order."""

    a: torch.Tensor      # (n,) coupling coefficient; 0 at the chain start
    invd: torch.Tensor   # (n,) 1 / d_i
    n: int
    reverse: bool = False


def _bidiag_parts(T, upper: bool, dtype: torch.dtype):
    """(d, off) of a scipy bidiagonal matrix, off[i] the coupling entry of
    row i; None when T has entries off the two diagonals, a zero diagonal,
    or ``dtype`` is neither float32 nor float64."""
    import scipy.sparse as sp

    if dtype not in _ENTRY:
        return None
    coo = sp.csr_matrix(T).tocoo()
    n = T.shape[0]
    off = (coo.col - coo.row) if upper else (coo.row - coo.col)
    if coo.nnz and (off.min() < 0 or off.max() > 1):
        return None
    d = np.zeros(n)
    cpl = np.zeros(n)
    np.add.at(d, coo.row[off == 0], coo.data[off == 0])
    np.add.at(cpl, coo.row[off == 1], coo.data[off == 1])
    if np.any(d == 0.0):
        return None
    return d, cpl


def build_bidiag_tri(T, dtype: torch.dtype, device) -> BidiagTriFactor | None:
    """Prepare a scipy lower-BIDIAGONAL matrix (diagonal + first
    subdiagonal); None on any other structure or a zero diagonal."""
    parts = _bidiag_parts(T, upper=False, dtype=dtype)
    if parts is None:
        return None
    d, lo = parts
    n = d.shape[0]
    a = np.zeros(n)
    a[1:] = -lo[1:] / d[1:]
    return BidiagTriFactor(
        a=torch.as_tensor(a).to(device=device, dtype=dtype),
        invd=torch.as_tensor(1.0 / d).to(device=device, dtype=dtype),
        n=int(n), reverse=False)


def build_bidiag_tri_upper(U, dtype: torch.dtype,
                           device) -> BidiagTriFactor | None:
    """Prepare a scipy UPPER-bidiagonal matrix (diagonal + first
    superdiagonal) for the right-to-left scan; None on the same gates."""
    parts = _bidiag_parts(U, upper=True, dtype=dtype)
    if parts is None:
        return None
    d, up = parts
    n = d.shape[0]
    a = np.zeros(n)
    a[: n - 1] = -up[: n - 1] / d[: n - 1]
    return BidiagTriFactor(
        a=torch.as_tensor(a).to(device=device, dtype=dtype),
        invd=torch.as_tensor(1.0 / d).to(device=device, dtype=dtype),
        n=int(n), reverse=True)


def bidiag_scan_plain(a: torch.Tensor, invd: torch.Tensor, b: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    """Plain version: inclusive Hillis-Steele scan of the maps (a_i, c_i),
    combining an earlier (a1, c1) with a later (a2, c2) as
    (a2 a1, a2 c1 + c2)."""
    A = a.to(b.dtype)
    C = invd.to(b.dtype) * b
    if reverse:
        A, C = A.flip(0), C.flip(0)
    n = C.shape[0]
    d = 1
    while d < n:
        C = torch.cat([C[:d], A[d:] * C[:-d] + C[d:]])
        A = torch.cat([A[:d], A[d:] * A[:-d]])
        d *= 2
    return C.flip(0) if reverse else C


def bidiag_scan(a: torch.Tensor, invd: torch.Tensor, b: torch.Tensor,
                reverse: bool) -> torch.Tensor:
    """Solve the recurrence: the CUDA kernel for a CUDA tensor, else the
    plain version."""
    global LAUNCHES
    if b.device.type == "cpu":
        return bidiag_scan_plain(a, invd, b, reverse)
    if b.device.type != "cuda":
        raise ValueError(f"bidiag_scan: unsupported device {b.device}")
    if b.dtype not in _ENTRY:
        raise TypeError(f"bidiag_scan: unsupported dtype {b.dtype}")
    n = int(b.shape[0])
    for name, t in (("a", a), ("invd", invd), ("b", b)):
        if t.dtype != b.dtype:
            raise TypeError(f"bidiag_scan: {name} dtype {t.dtype} != "
                            f"{b.dtype}")
        if t.device != b.device:
            raise ValueError(f"bidiag_scan: {name} on {t.device}, "
                             f"b on {b.device}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"bidiag_scan: {name} must be a contiguous "
                             f"({n},) tensor")
    lib = _build.kernel_library()
    ntiles = max(1, -(-n // lib.cpkt_bidiag_tile()))
    x = torch.empty(n, dtype=b.dtype, device=b.device)
    agg = torch.empty(2 * ntiles, dtype=b.dtype, device=b.device)
    carry = torch.empty(ntiles, dtype=b.dtype, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    status = getattr(lib, _ENTRY[b.dtype])(
        a.data_ptr(), invd.data_ptr(), b.data_ptr(), x.data_ptr(),
        agg.data_ptr(), carry.data_ptr(), n, int(reverse), stream)
    _build.check(status, "bidiag_scan")
    LAUNCHES += 1
    return x


def bidiag_tri_solve(tf: BidiagTriFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b for a prepared bidiagonal factor."""
    if b.shape[0] != tf.n:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {tf.n}")
    return bidiag_scan(tf.a, tf.invd, b.contiguous(), tf.reverse)
