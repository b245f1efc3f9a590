"""DIA — diagonal sparse storage for banded matrices, and its plain products.

Port of ``cpkrylov_tpu/ops/dia.py`` (natural order only).  Stored by
diagonal, SpMV is ``y = sum_k data[k] * shift(x, offset_k)``: no index
metadata, ``ndiag * nrows`` values read per product.  On a CUDA tensor the
product runs in the hand-written kernel (``ops/cuda_dia.py``); the functions
here are its plain PyTorch version, which CPU tensors use and which the
kernel is checked against.

Whether a matrix is stored as DIA is decided by its structure alone: the
padded diagonals may hold at most ``max_fill_ratio`` slots per stored entry.
The default 4.5 is the JAX package's f32 gate (padded bytes <= 1.5x the
12 bytes per entry of its CSR) counted in slots, so f32 and f64 get the same
layout on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..utils.device import upload

MAX_FILL_RATIO = 4.5


@dataclasses.dataclass(frozen=True)
class DIA:
    """Sparse matrix stored by diagonals (square or rectangular).

    ``data[k, i] = M[i, i + offsets[k]]`` (zero where out of range or not
    stored); offsets are column minus row, ascending.  ``offsets_t`` holds
    the same offsets as an int64 tensor on the data's device (the kernel's
    operand).
    """

    data: torch.Tensor          # (ndiag, nrows), contiguous
    offsets: Tuple[int, ...]
    offsets_t: torch.Tensor     # (ndiag,) int64
    shape: Tuple[int, int]
    nnz: int = 0

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndiag(self) -> int:
        return len(self.offsets)


def pack_dia(mat, dtype: torch.dtype, device,
             max_fill_ratio: float = MAX_FILL_RATIO) -> DIA | None:
    """Pack a scipy matrix by diagonals; None when the padded diagonals would
    hold more than ``max_fill_ratio`` slots per stored entry (0 = no limit)."""
    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    coo = csr.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(off)
    ndiag = int(uniq.size) if uniq.size else 1
    if (max_fill_ratio > 0 and csr.nnz
            and ndiag * nrows > max_fill_ratio * csr.nnz):
        return None
    data = np.zeros((ndiag, nrows), dtype=np.float64)
    if csr.nnz:
        k = np.searchsorted(uniq, off)
        data[k, coo.row] = coo.data
    offsets = tuple(int(o) for o in (uniq if uniq.size else [0]))
    return DIA(data=upload(data, device, dtype),
               offsets=offsets,
               offsets_t=upload(offsets, device, torch.int64),
               shape=(int(nrows), int(ncols)), nnz=int(csr.nnz))


def pack_sym_dia(mat, dtype: torch.dtype, device,
                 max_fill_ratio: float = MAX_FILL_RATIO) -> DIA | None:
    """Pack a square scipy matrix by diagonals in natural order.

    A saddle-point K_P = [G B'; B -C] with banded blocks is diagonal-sparse
    in natural order (the B/B' blocks sit on offsets near +-n).  None when
    the matrix is not square or fails the fill gate; the JAX package's RCM
    and spill fallbacks are not ported, so the caller then keeps CSR.
    """
    csr = sp.csr_matrix(mat)
    if csr.shape[0] != csr.shape[1]:
        return None
    return pack_dia(csr, dtype=dtype, device=device,
                    max_fill_ratio=max_fill_ratio)


def _pads(mat: DIA):
    """Left/right padding of the operand so every shifted slice is valid."""
    nrows, ncols = mat.shape
    neg = max(0, -min(mat.offsets))
    pos = max(0, max(mat.offsets) + nrows - ncols)
    return neg, pos


def dia_matvec(mat: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x as a chain of shifted multiply-adds, ascending k."""
    nrows = mat.shape[0]
    neg, pos = _pads(mat)
    xp = F.pad(x, (neg, pos))
    d = mat.data.to(x.dtype)
    acc = torch.zeros(nrows, dtype=x.dtype, device=x.device)
    for k, off in enumerate(mat.offsets):
        s = neg + off
        acc = acc + d[k] * xp[s: s + nrows]
    return acc


def dia_rmatvec(mat: DIA, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y.  M.T's diagonal at offset -o holds ``data[k]`` shifted
    by o, so each term is a shifted add of the elementwise product."""
    nrows, ncols = mat.shape
    neg, pos = _pads(mat)
    d = mat.data.to(y.dtype)
    acc = torch.zeros(ncols + neg + pos, dtype=y.dtype, device=y.device)
    for k, off in enumerate(mat.offsets):
        s = neg + off
        acc[s: s + nrows] = acc[s: s + nrows] + d[k] * y
    return acc[neg: neg + ncols]
