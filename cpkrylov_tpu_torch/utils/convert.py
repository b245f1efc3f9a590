"""Carry state across from the JAX package (or any numpy/scipy source).

These take plain numpy/scipy fields, never JAX objects' methods, so the port
stays free of JAX: a caller that holds the JAX package's ``HostLDL`` or a
packed DIA passes it (or its numpy arrays) here and gets the port's
equivalent, with identical numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PrecondOptions
from ..ops.df64 import DFDia, DFSaddle, df_dia
from ..ops.dia import DIA
from ..precond import ldl_host
from ..precond.cp import CPPrecond, build_factor_apply, build_precond
from ..precond.df_factor import DFFactorApply, build_df_factor_apply
from ..precond.permute import interleave_candidates
from ..utils.device import resolve_device, torch_dtype


def host_ldl_from(fac) -> ldl_host.HostLDL:
    """The port's ``HostLDL`` from any object with the same fields
    (``perm``, ``L``, ``d``, ``e``, ``nperturbed``)."""
    e = getattr(fac, "e", None)
    return ldl_host.HostLDL(
        perm=np.asarray(fac.perm), L=fac.L.tocsc(),
        d=np.asarray(fac.d, np.float64),
        e=None if e is None else np.asarray(e, np.float64),
        nperturbed=int(getattr(fac, "nperturbed", 0)),
        n2x2=int(getattr(fac, "n2x2", 0)))


def _interleave_base(perm, n: int, m: int):
    """The interleave candidate equal to ``perm``, else None."""
    for cand in interleave_candidates(n, m):
        if np.array_equal(np.asarray(perm), cand.perm):
            return cand
    return None


def precond_from_host(fac, ksp, n: int, m: int,
                      options: PrecondOptions | None = None,
                      dtype=torch.float64, device="cpu",
                      panel: int = 256) -> CPPrecond:
    """The port's ``CPPrecond`` for a host LDL^T factorization of
    ``ksp`` = K_P.  The interleave is recognised from ``fac.perm`` so the
    permutes take the reshape form, as ``make_preconditioner`` would."""
    fac = host_ldl_from(fac)
    return build_precond(fac, ksp, n, m,
                         options=options or PrecondOptions(), panel=panel,
                         dtype=torch_dtype(dtype),
                         device=resolve_device(device),
                         base_order=_interleave_base(fac.perm, n, m))


def df_factor_from_host(fac, n: int, m: int, device="cpu",
                        panel: int = 256, nref: int = 1) -> DFFactorApply:
    """The port's df64-applied f32 factor (``precond/df_factor.py``) for a
    host LDL^T factorization, built unfolded as ``make_preconditioner``
    builds it for the swap."""
    fac = host_ldl_from(fac)
    factor = build_factor_apply(fac, n + m, panel, torch.float32,
                                resolve_device(device),
                                base_order=_interleave_base(fac.perm, n, m),
                                fold_dinv=False)
    return build_df_factor_apply(factor, fac, n + m, nref=nref)


def df_dia_from(d, device="cpu") -> DFDia:
    """The port's ``DFDia`` from any object with numpy-convertible ``hi``
    and ``lo`` (ndiag, nrows) stacks, ``offsets`` and ``shape``."""
    return df_dia(np.asarray(d.hi), np.asarray(d.lo), d.offsets, d.shape,
                  device=resolve_device(device))


def df_saddle_from(s, device="cpu") -> DFSaddle:
    """The port's ``DFSaddle`` from any object with DFDia-like ``a``,
    ``bt`` and ``b``, a (hi, lo) ``c_diag`` pair and ``n``, ``m``."""
    device = resolve_device(device)
    return DFSaddle(
        a=df_dia_from(s.a, device), bt=df_dia_from(s.bt, device),
        b=df_dia_from(s.b, device),
        c_diag=tuple(torch.tensor(np.asarray(c, np.float32)).to(device)
                     for c in s.c_diag),
        n=int(s.n), m=int(s.m))


def dia_from_numpy(data, offsets, shape, dtype=torch.float64, device="cpu",
                   nnz: int = 0) -> DIA:
    """The port's ``DIA`` from a packed (ndiag, nrows) array and its
    offsets (column minus row, ascending)."""
    device = resolve_device(device)
    offsets = tuple(int(o) for o in offsets)
    if list(offsets) != sorted(offsets):
        raise ValueError("DIA offsets must be ascending")
    data = np.asarray(data)
    if data.shape != (len(offsets), int(shape[0])):
        raise ValueError(f"data shape {data.shape} does not match "
                         f"{len(offsets)} diagonals of {int(shape[0])} rows")
    return DIA(data=torch.tensor(data).to(device=device,
                                          dtype=torch_dtype(dtype)),
               offsets=offsets,
               offsets_t=torch.tensor(offsets, dtype=torch.int64,
                                      device=device),
               shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))
