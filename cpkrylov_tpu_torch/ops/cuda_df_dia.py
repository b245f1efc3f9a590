"""df64 DIA SpMV: the hand-written CUDA kernel (``csrc/df_dia_spmv.cu``) and
its wrapper.

Replaces the JAX package's Pallas kernel
``ops/pallas_dia.py::_df_dia_kernel``.  ``df_dia_spmv`` launches the kernel
for CUDA tensors and raises on anything the kernel does not take; CPU
tensors go to the plain PyTorch version (``ops/df64.py::df_dia_matvec``),
which computes the same chain in the same order with the same roundings.

Each launch (one per product) counts ``df_dia_spmv``
(``utils/profiling.py``), so a run can show that its outer residuals went
through the kernel.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, P, Entry
from .df64 import DFDia, df_dia_matvec

# hi, lo, offsets (int64, device), ndiag, nrows, ncols, xh, xl, yh, yl
_DF_DIA = Entry("cpkt_df_dia_spmv", (P, P, P, I32, I64, I64, P, P, P, P),
                dtypes=(torch.float32,), counters=("df_dia_spmv",))


def df_dia_spmv(mat: DFDia, xh: torch.Tensor, xl: torch.Tensor):
    """(yh, yl) = mat @ (xh, xl) in df64: the CUDA kernel for CUDA tensors,
    else the plain version."""
    if xh.device.type == "cpu" and xl.device.type == "cpu":
        return df_dia_matvec(mat, (xh, xl))
    if xh.device.type != "cuda":
        raise ValueError(f"df_dia_spmv: unsupported device {xh.device}")
    nrows, ncols = mat.shape
    for name, t in (("hi", mat.hi), ("lo", mat.lo), ("xh", xh), ("xl", xl)):
        if t.dtype != torch.float32:
            raise TypeError(f"df_dia_spmv: {name} has dtype {t.dtype}, the "
                            "kernel takes float32 pairs")
        if t.device != xh.device:
            raise ValueError(f"df_dia_spmv: {name} on {t.device}, xh on "
                             f"{xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"df_dia_spmv: {name} must be contiguous")
    for name, t in (("hi", mat.hi), ("lo", mat.lo)):
        if tuple(t.shape) != (mat.ndiag, nrows):
            raise ValueError(f"df_dia_spmv: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"({mat.ndiag}, {nrows})")
    for name, t in (("xh", xh), ("xl", xl)):
        if t.dim() != 1 or t.shape[0] != ncols:
            raise ValueError(f"df_dia_spmv: {name} has shape "
                             f"{tuple(t.shape)}, expected ({ncols},)")
    if (mat.offsets_t.dtype != torch.int64
            or tuple(mat.offsets_t.shape) != (mat.ndiag,)
            or mat.offsets_t.device != xh.device):
        raise ValueError("df_dia_spmv: offsets_t must be (ndiag,) int64 on "
                         "the vector's device")
    yh = torch.empty(nrows, dtype=torch.float32, device=xh.device)
    yl = torch.empty(nrows, dtype=torch.float32, device=xh.device)
    _DF_DIA.launch(xh, mat.hi.data_ptr(), mat.lo.data_ptr(),
                   mat.offsets_t.data_ptr(), mat.ndiag, nrows, ncols,
                   xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr())
    return yh, yl
