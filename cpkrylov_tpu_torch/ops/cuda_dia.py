"""DIA SpMV: the hand-written CUDA kernel (``csrc/dia_spmv.cu``) and its
wrapper.

Replaces the JAX package's Pallas kernel ``ops/pallas_dia.py::_dia_kernel``.
``dia_spmv`` launches the kernel for a CUDA tensor and raises on anything the
kernel does not take; a CPU tensor goes to the plain PyTorch version
(``ops/dia.py::dia_matvec``), which computes the same sum in the same order.

Each launch (one per product) counts ``dia_spmv``
(``utils/profiling.py``), so a run can show that its SpMVs went through the
kernel.
"""
from __future__ import annotations

import torch

from .._build import I32, I64, P, Entry
from .dia import DIA, dia_matvec

# data, offsets (int64, device), ndiag, nrows, ncols, x, y
_DIA = Entry("cpkt_dia_spmv", (P, P, I32, I64, I64, P, P),
             dtypes=(torch.float32, torch.float64), counters=("dia_spmv",))


def dia_spmv(mat: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    if x.device.type == "cpu":
        return dia_matvec(mat, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
    nrows, ncols = mat.shape
    data = mat.data
    if x.dtype not in _DIA.dtypes:
        raise TypeError(f"dia_spmv: unsupported dtype {x.dtype}")
    if data.dtype != x.dtype:
        raise TypeError(f"dia_spmv: matrix dtype {data.dtype} != vector "
                        f"dtype {x.dtype}")
    if data.device != x.device or mat.offsets_t.device != x.device:
        raise ValueError("dia_spmv: matrix and vector on different devices")
    if x.dim() != 1 or x.shape[0] != ncols:
        raise ValueError(f"dia_spmv: x has shape {tuple(x.shape)}, "
                         f"expected ({ncols},)")
    if tuple(data.shape) != (mat.ndiag, nrows) or not data.is_contiguous():
        raise ValueError("dia_spmv: data must be a contiguous "
                         f"({mat.ndiag}, {nrows}) tensor")
    if (mat.offsets_t.dtype != torch.int64
            or tuple(mat.offsets_t.shape) != (mat.ndiag,)):
        raise ValueError("dia_spmv: offsets_t must be (ndiag,) int64")
    if not x.is_contiguous():
        raise ValueError("dia_spmv: x must be contiguous")
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    _DIA.launch(x, data.data_ptr(), mat.offsets_t.data_ptr(), mat.ndiag,
                nrows, ncols, x.data_ptr(), y.data_ptr())
    return y
