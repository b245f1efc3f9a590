"""Double-f32 ("df64") arithmetic for f64-accurate residuals in f32 storage.

Port of ``cpkrylov_tpu/ops/df64.py``.  Vectors (x, r, b) and the operand
diagonals of K are stored as unevaluated pairs (hi, lo) of f32 tensors with
|lo| <= ulp(hi)/2, about 2^-48 relative: six digits beyond f32, ample for
the stopping contract ``||r|| <= atol + rtol ||b||`` at rtol 1e-6..1e-10
(reg_cpkrylov.m:163, cpminres.m:164).  The building blocks are the
error-free transforms of Dekker (1971) and Knuth (TAOCP v2).

Every function here is written with separate ``*``, ``+`` and ``-`` tensor
operations, each rounded on its own: a fused multiply-add (``addcmul``,
``lerp``, ``torch.compile``) would change the rounding the transforms rely
on.  ``df_dia_matvec`` is the plain version of the CUDA kernel
``csrc/df_dia_spmv.cu``; :class:`DFSaddle` goes through the kernel's
wrapper (``cuda_df_dia.df_dia_spmv``), which uses this plain version for
CPU tensors.

Used by ``mixed.py``'s device-resident outer loop: the f64-accurate DIA
matvec of K = [A B'; B -C], the df64 accumulation of the solution, and the
residual update.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device, upload
from .dia import DIA

_SPLITTER = 4097.0   # 2^12 + 1 for binary32 (Dekker split)


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = a * _SPLITTER
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


DF = Tuple[torch.Tensor, torch.Tensor]   # (hi, lo) unevaluated pair


def df_from_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side split of an f64 array into an (hi, lo) f32 pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def df_to_f64(hi, lo) -> np.ndarray:
    """hi + lo in f64 on the host (tensors or arrays)."""
    return _host(hi) + _host(lo)


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x[0], y[0])
    return quick_two_sum(s, e + x[1] + y[1])


def df_neg(x: DF) -> DF:
    return (-x[0], -x[1])


def df_scale_f32(x: DF, a) -> DF:
    """df64 x * f32 scalar a."""
    p, e = two_prod(x[0], a)
    return quick_two_sum(p, e + x[1] * a)


def df_axpy(alpha, d: torch.Tensor, x: DF) -> DF:
    """x + alpha * d with an f32 scalar alpha and an f32 vector d."""
    alpha = torch.as_tensor(alpha, dtype=d.dtype, device=d.device)
    p, e = two_prod(alpha.expand(d.shape), d)
    s, e2 = two_sum(x[0], p)
    return quick_two_sum(s, e2 + e + x[1])


def df_norm_hi(x: DF) -> torch.Tensor:
    """2-norm of the hi parts: f32 relative accuracy, ample for a
    tolerance comparison."""
    return torch.linalg.vector_norm(x[0])


# ---------------------------------------------------------------------------
# df64 DIA operands
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DFDia:
    """DIA matrix stored as an (hi, lo) f32 pair of diagonal stacks.

    ``hi[k, i] + lo[k, i]`` reproduces M[i, i + offsets[k]] to ~2^-48
    relative; rectangular blocks follow ``ops/dia.py``'s offset convention.
    ``offsets_t`` holds the offsets as an int64 tensor on the data's device
    (the kernel's operand)."""

    hi: torch.Tensor          # (ndiag, nrows) f32, contiguous
    lo: torch.Tensor          # (ndiag, nrows) f32, contiguous
    offsets: Tuple[int, ...]
    offsets_t: torch.Tensor   # (ndiag,) int64
    shape: Tuple[int, int]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    def hi_dia(self) -> DIA:
        """The f32 ``DIA`` of the same matrix, sharing ``hi``: both round
        each entry to the nearest f32 in the same layout, so this is what
        ``pack_dia(M, torch.float32)`` stores."""
        return DIA(data=self.hi, offsets=self.offsets,
                   offsets_t=self.offsets_t, shape=self.shape)


def df_dia(hi, lo, offsets, shape, device=None) -> DFDia:
    """A ``DFDia`` on ``device`` (default the CUDA card) from (ndiag,
    nrows) hi/lo arrays."""
    device = resolve_device(device)
    offsets = tuple(int(o) for o in offsets)
    return DFDia(hi=upload(np.require(hi, np.float32, ["C", "W"]), device),
                 lo=upload(np.require(lo, np.float32, ["C", "W"]), device),
                 offsets=offsets,
                 offsets_t=upload(offsets, device, torch.int64),
                 shape=(int(shape[0]), int(shape[1])))


def pack_df_dia(mat, device=None, max_bytes_ratio: float = 3.0
                ) -> DFDia | None:
    """Pack a scipy matrix into df64 DIA form on ``device`` (default the
    CUDA card); None when the padded
    diagonals would exceed ``max_bytes_ratio`` times the CSR bytes (the JAX
    package's gate, df64.py:148, so the device loop engages on the same
    inputs)."""
    csr = sp.csr_matrix(mat).astype(np.float64)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    coo = csr.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(off) if coo.nnz else np.array([0], np.int64)
    if csr.nnz and uniq.size * nrows * 8 > max_bytes_ratio * csr.nnz * 12.0:
        return None
    data = np.zeros((uniq.size, nrows), np.float64)
    if coo.nnz:
        k = np.searchsorted(uniq, off)
        data[k, coo.row] = coo.data
    hi, lo = df_from_f64(data)
    return df_dia(hi, lo, uniq, (nrows, ncols), device=device)


def _pads(offsets, nrows, ncols):
    neg = max(0, -min(offsets))
    pos = max(0, max(offsets) + nrows - ncols)
    return neg, pos


def df_dia_matvec(mat: DFDia, x: DF) -> DF:
    """y = mat @ x in df64, the plain version of the CUDA kernel: per term
    the error-free product of the hi parts plus the cross terms hi*lo +
    lo*hi (the lo*lo term, ~2^-96, is dropped), accumulated by a two_sum
    chain in ascending k, then renormalized."""
    nrows, ncols = mat.shape
    neg, pos = _pads(mat.offsets, nrows, ncols)
    xh = F.pad(x[0], (neg, pos))
    xl = F.pad(x[1], (neg, pos))
    acc_h = torch.zeros(nrows, dtype=torch.float32, device=xh.device)
    acc_l = torch.zeros(nrows, dtype=torch.float32, device=xh.device)
    for k, off in enumerate(mat.offsets):
        s = neg + off
        vh = xh[s: s + nrows]
        vl = xl[s: s + nrows]
        dh = mat.hi[k]
        dl = mat.lo[k]
        p, e = two_prod(dh, vh)
        e = e + dh * vl + dl * vh
        acc_h, e2 = two_sum(acc_h, p)
        acc_l = acc_l + e + e2
    return quick_two_sum(acc_h, acc_l)


@dataclasses.dataclass(frozen=True)
class DFSaddle:
    """df64 saddle operator K = [A B'; B -C] as three DIA blocks and the
    diagonal of C.  ``bt`` stores B' as its own rectangular ``DFDia``, so
    both products are row-parallel shifted chains (no transposed product
    needed)."""

    a: DFDia             # (n, n)
    bt: DFDia            # (n, m), B transpose
    b: DFDia             # (m, n)
    c_diag: DF           # (m,) diagonal of C
    n: int
    m: int

    def matvec(self, x: DF) -> DF:
        from .cuda_df_dia import df_dia_spmv   # the wrapper imports this module

        n = self.n
        x1 = (x[0][:n], x[1][:n])
        x2 = (x[0][n:], x[1][n:])
        y1 = df_add(df_dia_spmv(self.a, *x1), df_dia_spmv(self.bt, *x2))
        cy_h, cy_e = two_prod(self.c_diag[0], x2[0])
        cy = quick_two_sum(
            cy_h, cy_e + self.c_diag[0] * x2[1] + self.c_diag[1] * x2[0])
        y2 = df_add(df_dia_spmv(self.b, *x1), df_neg(cy))
        return (torch.cat([y1[0], y2[0]]), torch.cat([y1[1], y2[1]]))


def pack_df_saddle(A, B, C, device=None) -> DFSaddle | None:
    """Pack explicit host blocks into a df64 saddle operator on ``device``
    (default the CUDA card); None when C is not diagonal or a block fails
    the DIA gate (the caller then keeps the host-resident refinement
    loop)."""
    device = resolve_device(device)
    C = sp.csr_matrix(C)
    offd = C - sp.diags(C.diagonal())
    if offd.nnz:
        return None
    a = pack_df_dia(A, device=device)
    B = sp.csr_matrix(B)
    b = pack_df_dia(B, device=device)
    bt = pack_df_dia(B.T.tocsr(), device=device)
    if a is None or b is None or bt is None:
        return None
    ch, cl = df_from_f64(C.diagonal())
    return DFSaddle(a=a, bt=bt, b=b,
                    c_diag=(upload(ch, device), upload(cl, device)),
                    n=int(A.shape[0]), m=int(C.shape[0]))
