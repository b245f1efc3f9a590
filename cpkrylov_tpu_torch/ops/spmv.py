"""Sparse matrix-vector products and their dispatch.

Port of ``cpkrylov_tpu/ops/spmv.py`` for the formats the port has: DIA (the
hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU tensor;
see ``cuda_dia.py``), CSR, Diagonal and dense tensors.  They replace the
implicit native SpMV of the MATLAB reference (every ``A*v`` / ``C*q`` /
``B'*y``, cpminres.m:187-188).
"""
from __future__ import annotations

import torch

from .cuda_dia import dia_spmv
from .dia import DIA, dia_rmatvec
from .formats import CSR, Diagonal


def csr_matvec(mat: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x: gather, multiply, sum by row."""
    vals = mat.data * x[mat.indices]
    y = torch.zeros(mat.shape[0], dtype=x.dtype, device=x.device)
    return y.index_add_(0, mat.row_ids, vals)


def csr_rmatvec(mat: CSR, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y: multiply, scatter-add by column."""
    vals = mat.data * y[mat.row_ids]
    x = torch.zeros(mat.shape[1], dtype=y.dtype, device=y.device)
    return x.index_add_(0, mat.indices, vals)


def diag_matvec(mat: Diagonal, x: torch.Tensor) -> torch.Tensor:
    return mat.diag * x


def matvec(mat, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mat, DIA):
        return dia_spmv(mat, x)
    if isinstance(mat, CSR):
        return csr_matvec(mat, x)
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
