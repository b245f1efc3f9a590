"""Sparse matrix-vector products and their dispatch.

Port of ``cpkrylov_tpu/ops/spmv.py``: DIA and CSR (the hand-written CUDA
kernels B1 and B5 on a CUDA tensor, their plain versions on a CPU tensor;
see ``cuda_dia.py`` and ``cuda_spmv.py``), ELL and BSR (plain PyTorch on
every device: the JAX package computes them in XLA, with no Pallas kernel),
Diagonal and dense tensors, and the products by a dense block of
right-hand sides (``matmat``).  They replace the
implicit native SpMV of the MATLAB reference (every ``A*v`` / ``C*q`` /
``B'*y``, cpminres.m:187-188).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_dia import dia_spmv
from .cuda_spmv import csr_rmatvec, csr_spmv
from .dia import DIA, dia_rmatvec
from .formats import BSR, CSR, ELL, Diagonal


def diag_matvec(mat: Diagonal, x: torch.Tensor) -> torch.Tensor:
    return mat.diag * x


def ell_matvec(mat: ELL, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x (``ell_matmat``)."""
    return ell_matmat(mat, x[:, None])[:, 0]


def ell_matmat(mat: ELL, X: torch.Tensor) -> torch.Tensor:
    """Y = mat @ X: every slot's product at once, then one add a slot for
    all rows, so each row is summed in stored order, the order of kernel
    B5 and of the CSR's plain version (the padding slots add zeros), every
    step rounded: the same bits on every call and as the matrix's CSR
    product."""
    prod = mat.data.to(X.dtype)[:, :, None] * X[mat.cols]    # (rows, K, r)
    Y = torch.zeros_like(prod[:, 0])
    for k in range(mat.row_width):
        Y = Y + prod[:, k]
    return Y[: mat.shape[0]]


def bsr_matvec(mat: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x (``bsr_matmat``)."""
    return bsr_matmat(mat, x[:, None])[:, 0]


def bsr_matmat(mat: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = mat @ X, ``X`` zero-padded to the block grid: every stored
    entry's product at once, laid out by ``mat.slots`` (a block row's j-th
    stored block, or a zero block), then one add a (slot, block column)
    for all rows.  Each row is so summed in stored order (blocks by block
    column, then columns), the order of B5 on the matrix's CSR (the
    blocks' zeros add zeros), with no atomics: the same bits on every
    call."""
    bs, r = mat.blocksize, X.shape[1]
    Xb = F.pad(X, (0, 0, 0, mat.shape[1] - X.shape[0])).reshape(-1, bs, r)
    prod = (mat.data.to(X.dtype)[:, :, :, None]
            * Xb[mat.block_cols][:, None, :, :])        # (nb, bs, bs, r)
    prod = torch.cat([prod, prod.new_zeros(1, bs, bs, r)])    # the pad slot
    prod = prod[mat.slots]                     # (block rows, slots, bs, bs, r)
    Y = torch.zeros_like(prod[:, 0, :, 0])
    for j in range(mat.slots.shape[1]):
        for c in range(bs):
            Y = Y + prod[:, j, :, c]
    return Y.reshape(mat.shape[0], r)


def matvec(mat, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mat, DIA):
        return dia_spmv(mat, x)
    if isinstance(mat, CSR):
        return csr_spmv(mat, x)
    if isinstance(mat, ELL):
        return ell_matvec(mat, x)
    if isinstance(mat, BSR):
        return bsr_matvec(mat, x)
    if isinstance(mat, Diagonal):
        return diag_matvec(mat, x)
    if isinstance(mat, torch.Tensor):
        return mat @ x
    raise TypeError(f"unsupported matrix type {type(mat)}")


def rmatvec(mat, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y.  DIA takes its plain version on every device: in the
    JAX package this product is the XLA ``dia_rmatvec``, not a Pallas
    kernel.  ELL and BSR have none (TypeError), as in the JAX package's
    ``MatrixOperator.rmatvec``."""
    if isinstance(mat, DIA):
        return dia_rmatvec(mat, y)
    if isinstance(mat, CSR):
        return csr_rmatvec(mat, y)
    if isinstance(mat, Diagonal):
        return diag_matvec(mat, y)
    if isinstance(mat, torch.Tensor):
        return mat.T @ y
    raise TypeError(f"unsupported matrix type {type(mat)}")


def matmat(mat, X: torch.Tensor) -> torch.Tensor:
    """Y = mat @ X for a dense (ncols, r) block of right-hand sides.

    DIA and CSR take one product a column, each through ``matvec`` (kernel
    B1 or B5 on a CUDA tensor): the same sums in the same order as a single
    product, so the block is as deterministic as one product (a scatter of
    the entries' contributions would add them by atomics on the card).
    ELL and BSR take every column at once, in the order of their single
    products.  Diagonal scales the rows; a dense tensor is a matmul."""
    if isinstance(mat, (DIA, CSR)):
        return torch.stack([matvec(mat, X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)
    if isinstance(mat, ELL):
        return ell_matmat(mat, X)
    if isinstance(mat, BSR):
        return bsr_matmat(mat, X)
    if isinstance(mat, Diagonal):
        return mat.diag[:, None] * X
    if isinstance(mat, torch.Tensor):
        return mat @ X
    raise TypeError(f"unsupported matrix type {type(mat)}")
