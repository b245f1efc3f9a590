"""Sparse matrix-vector products and their dispatch.

Port of ``cpkrylov_tpu/ops/spmv.py`` for the formats the port has: DIA and
CSR (the hand-written CUDA kernels B1 and B5 on a CUDA tensor, their plain
versions on a CPU tensor; see ``cuda_dia.py`` and ``cuda_spmv.py``),
Diagonal and dense tensors, and the products by a dense block of
right-hand sides (``matmat``).  They replace the
implicit native SpMV of the MATLAB reference (every ``A*v`` / ``C*q`` /
``B'*y``, cpminres.m:187-188).
"""
from __future__ import annotations

import torch

from .cuda_dia import dia_spmv
from .cuda_spmv import csr_rmatvec, csr_spmv
from .dia import DIA, dia_rmatvec
from .formats import CSR, Diagonal


def diag_matvec(mat: Diagonal, x: torch.Tensor) -> torch.Tensor:
    return mat.diag * x


def matvec(mat, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mat, DIA):
        return dia_spmv(mat, x)
    if isinstance(mat, CSR):
        return csr_spmv(mat, x)
    if isinstance(mat, Diagonal):
        return diag_matvec(mat, x)
    if isinstance(mat, torch.Tensor):
        return mat @ x
    raise TypeError(f"unsupported matrix type {type(mat)}")


def rmatvec(mat, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y.  DIA takes its plain version on every device: in the
    JAX package this product is the XLA ``dia_rmatvec``, not a Pallas
    kernel."""
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
    Diagonal scales the rows; a dense tensor is a matmul."""
    if isinstance(mat, (DIA, CSR)):
        return torch.stack([matvec(mat, X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)
    if isinstance(mat, Diagonal):
        return mat.diag[:, None] * X
    if isinstance(mat, torch.Tensor):
        return mat @ X
    raise TypeError(f"unsupported matrix type {type(mat)}")
