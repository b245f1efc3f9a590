"""Linear-operator protocol — the Spot-toolbox replacement.

Port of ``cpkrylov_tpu/operators/linop.py``.  The solvers only evaluate
``A*v`` (and ``B'*y`` on the shift path); an operand is a container from
``ops/`` or a dense tensor wrapped in ``MatrixOperator``, or a user callable
wrapped in ``FunctionOperator``.  There is no cross-call device cache: each
``solve`` converts its host operands once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import spmv
from ..ops.dia import DIA
from ..ops.formats import BSR, CSR, ELL, Diagonal, csr_from_scipy
from ..utils.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class MatrixOperator:
    """Wraps an explicit (sparse or dense) matrix as an operator."""

    mat: object  # DIA | CSR | ELL | BSR | Diagonal | torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.mat.shape)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return spmv.matvec(self.mat, x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        return spmv.rmatvec(self.mat, y)

    def __call__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class FunctionOperator:
    """Operator defined by a callable ``fn(params, x) -> y`` (the
    reference's "A may be a linear operator" contract)."""

    params: object
    fn: Callable
    rfn: Callable | None
    shape: Tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.params, x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        if self.rfn is None:
            raise NotImplementedError("operator has no rmatvec")
        return self.rfn(self.params, y)

    def __call__(self, x):
        return self.matvec(x)


LinearOperator = (MatrixOperator, FunctionOperator)


def aslinearoperator(obj, shape=None, dtype=None, device=None):
    """Coerce matrices / callables / operators to an operator.

    A scipy matrix becomes ``Diagonal`` when strictly diagonal (C = delta*I:
    one elementwise multiply) and ``CSR`` otherwise (kernel B5), a numpy
    array a dense tensor, on ``device`` (default the CUDA card; "cpu" on
    request) in ``dtype`` (default: the matrix's own dtype).  A tensor
    moves to ``device`` when one is given and otherwise stays where it is;
    a container of ``ops/`` (DIA, CSR, ELL, BSR, Diagonal) is wrapped as it
    is.
    """
    import scipy.sparse as sp

    if isinstance(obj, LinearOperator):
        return obj
    if isinstance(obj, (DIA, CSR, ELL, BSR, Diagonal)):
        return MatrixOperator(obj)
    if callable(obj) and not hasattr(obj, "shape"):
        if shape is None:
            raise ValueError("shape required when wrapping a callable")
        return FunctionOperator(params=None, fn=lambda _, x: obj(x),
                                rfn=None,
                                shape=tuple(int(s) for s in shape))
    if isinstance(obj, torch.Tensor):
        if obj.dim() != 2:
            raise ValueError(f"expected 2-D operand, got {tuple(obj.shape)}")
        return MatrixOperator(obj.to(
            device=obj.device if device is None else resolve_device(device),
            dtype=dtype or obj.dtype))
    device = resolve_device(device)
    tdtype = torch_dtype(dtype if dtype is not None else obj.dtype)
    if sp.issparse(obj):
        if obj.shape[0] == obj.shape[1] and obj.nnz <= obj.shape[0]:
            coo = obj.tocoo()
            if not coo.nnz or bool((coo.row == coo.col).all()):
                d = np.zeros(obj.shape[0], dtype=np.float64)
                # duplicate (i, i) entries sum, as in CSR
                np.add.at(d, coo.row, coo.data)
                return MatrixOperator(Diagonal(
                    diag=torch.as_tensor(d).to(device=device, dtype=tdtype)))
        return MatrixOperator(csr_from_scipy(obj, dtype=tdtype,
                                             device=device))
    arr = np.asarray(obj)
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D operand, got shape {arr.shape}")
    return MatrixOperator(torch.as_tensor(arr).to(device=device,
                                                  dtype=tdtype))
