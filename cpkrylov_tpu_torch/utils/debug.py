"""Validation and debug checks.

Port of ``cpkrylov_tpu/utils/debug.py``: structural validation of the
saddle-point blocks before an expensive factorization (the same checks and
messages), and a finite-ness check of solver outputs that walks the port's
tensors, arrays, dataclasses, NamedTuples, tuples, lists and dicts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


class ValidationError(ValueError):
    pass


def validate_system(A, B, C, G, b=None, *, check_symmetry: bool = True,
                    sym_tol: float = 1e-10) -> None:
    """Structural validation of [A B'; B -C] and the preconditioner blocks.

    Raises ValidationError with an actionable message; mirrors (and extends)
    the dimension checks of opLDL2's constructor (opLDL2.m:66-75).
    """
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValidationError(f"A must be square, got {A.shape}")
    m, nb = B.shape
    if nb != n:
        raise ValidationError(f"B is {B.shape}, expected (m, {n})")
    if C.shape != (m, m):
        raise ValidationError(f"C is {C.shape}, expected ({m}, {m})")
    if G.shape != (n, n):
        raise ValidationError(f"G is {G.shape}, expected ({n}, {n})")
    if m > n:
        raise ValidationError(f"m = {m} > n = {n}; B must have m <= n rows")
    if b is not None and np.asarray(b).reshape(-1).shape[0] != n + m:
        raise ValidationError(
            f"rhs has length {np.asarray(b).size}, expected {n + m}")

    if check_symmetry:
        for name, M_ in (("C", C), ("G", G)):
            Ms = sp.csr_matrix(M_) if not sp.issparse(M_) else M_
            asym = abs(Ms - Ms.T)
            worst = asym.max() if asym.nnz else 0.0
            scale = abs(Ms).max() if Ms.nnz else 1.0
            if worst > sym_tol * max(scale, 1.0):
                raise ValidationError(
                    f"{name} is not symmetric (max |{name}-{name}'| = "
                    f"{worst:.2e}); the constraint preconditioner requires "
                    f"symmetric {name}")

    # full row rank of B is required for a nonsingular preconditioner when
    # C = 0; cheap necessary check: no zero rows.
    Bs = sp.csr_matrix(B) if not sp.issparse(B) else B.tocsr()
    row_nnz = np.diff(Bs.indptr)
    Cs = sp.csr_matrix(C) if not sp.issparse(C) else C
    c_row_nnz = np.diff(Cs.tocsr().indptr)
    dead = (row_nnz == 0) & (c_row_nnz == 0)
    if dead.any():
        raise ValidationError(
            f"rows {np.where(dead)[0][:5].tolist()}... of [B -C] are zero: "
            "the saddle-point matrix is singular")


def _leaves(obj):
    """The tensors and arrays inside ``obj``, depth first.  A residual
    history beside an iteration count (``KrylovResult``) is NaN-padded past
    ``niters + 1`` entries; only its filled part is a leaf."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        niters = getattr(obj, "niters", None)
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if (niters is not None and f.name.endswith("resid_history")
                    and isinstance(value, np.ndarray)):
                value = value[: int(niters) + 1]
            yield from _leaves(value)
    elif isinstance(obj, (tuple, list)):          # NamedTuples too
        for item in obj:
            yield from _leaves(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _leaves(item)


def check_finite(out, what: str = "solution") -> None:
    """Raise FloatingPointError if a solver output holds NaN or Inf."""
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            arr = leaf.detach()
            nan = int(torch.isnan(arr).sum())
            inf = int(torch.isinf(arr).sum())
        else:
            if leaf.dtype.kind != "f":
                continue
            nan = int(np.isnan(leaf).sum())
            inf = int(np.isinf(leaf).sum())
        if nan or inf:
            raise FloatingPointError(
                f"{what} contains non-finite values ({nan} NaN, {inf} Inf)")
