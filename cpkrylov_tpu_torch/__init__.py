"""cpkrylov_tpu_torch — the PyTorch + CUDA port of cpkrylov_tpu.

Constraint-preconditioned Krylov solvers for regularized saddle-point
systems

    [ A  B' ] [x1]   [b1]
    [ B  -C ] [x2] = [b2]

on PyTorch tensors, with hand-written CUDA kernels for Hopper (sm_90a) where
the JAX package had Pallas TPU kernels: the DIA SpMV (``ops/cuda_dia.py``),
the bidiagonal triangular solve (``precond/cuda_bidiag.py``), the df64 DIA
SpMV of the mixed refinement's true residual (``ops/cuda_df_dia.py``), the
banded triangular solve with its affine scan (``precond/cuda_tri.py``) and
the CSR SpMV (``ops/cuda_spmv.py``).  Every entry point runs on the CUDA
card unless the caller passes ``device="cpu"``.  The JAX package
``cpkrylov_tpu`` is the reference this port is tested against; this
package never imports JAX.
"""

from .config import PrecondOptions, SolverOptions
from .driver import SolveOutput, solve
from .mixed import MixedSolveOutput, prepare_mixed_device, solve_mixed
from .operators.linop import (FunctionOperator, MatrixOperator,
                              aslinearoperator)
from .ops.dia import DIA
from .ops.formats import CSR, Diagonal, csr_from_scipy
from .precond.cp import CPPrecond, CPState, make_preconditioner
from .solvers.common import KrylovResult
from .solvers.cpminres import cpminres

__all__ = [
    "CSR", "DIA", "Diagonal", "csr_from_scipy",
    "MatrixOperator", "FunctionOperator", "aslinearoperator",
    "PrecondOptions", "SolverOptions",
    "CPPrecond", "CPState", "make_preconditioner",
    "KrylovResult", "SolveOutput", "solve",
    "MixedSolveOutput", "prepare_mixed_device", "solve_mixed",
    "cpminres",
]

__version__ = "0.1.0"
