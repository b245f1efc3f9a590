"""Carry state across from the JAX package (or any numpy/scipy source).

These take plain numpy/scipy fields, never JAX objects' methods, so the port
stays free of JAX: a caller that holds the JAX package's ``HostLDL``, a
packed DIA, a reduced-scan triangle or a CSR passes it (or its numpy
arrays) here and gets the port's equivalent, with identical numbers, on
``device`` (default the CUDA card; "cpu" on request).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PrecondOptions
from ..ops.df64 import DFDia, DFSaddle, df_dia
from ..ops.dia import DIA
from ..ops.formats import CSR, csr_from_scipy
from ..precond import ldl_host
from ..precond.cp import CPPrecond, build_factor_apply, build_precond
from ..precond.df_factor import DFFactorApply, build_df_factor_apply
from ..precond.permute import interleave_candidates
from ..precond.trisolve import ReducedScanTriFactor, reduced_scan_tri
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
                      dtype=torch.float64, device=None,
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


def df_factor_from_host(fac, n: int, m: int, device=None,
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


def df_dia_from(d, device=None) -> DFDia:
    """The port's ``DFDia`` from any object with numpy-convertible ``hi``
    and ``lo`` (ndiag, nrows) stacks, ``offsets`` and ``shape``."""
    return df_dia(np.asarray(d.hi), np.asarray(d.lo), d.offsets, d.shape,
                  device=resolve_device(device))


def df_saddle_from(s, device=None) -> DFSaddle:
    """The port's ``DFSaddle`` from any object with DFDia-like ``a``,
    ``bt`` and ``b``, a (hi, lo) ``c_diag`` pair and ``n``, ``m``."""
    device = resolve_device(device)
    return DFSaddle(
        a=df_dia_from(s.a, device), bt=df_dia_from(s.bt, device),
        b=df_dia_from(s.b, device),
        c_diag=tuple(torch.tensor(np.asarray(c, np.float32)).to(device)
                     for c in s.c_diag),
        n=int(s.n), m=int(s.m))


def dia_from_numpy(data, offsets, shape, dtype=torch.float64, device=None,
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


def reduced_scan_from(f, dtype=torch.float64,
                      device=None) -> ReducedScanTriFactor:
    """The port's reduced-scan triangle (kernel B4's operand) from the
    numpy fields of the JAX package's ``ReducedScanTriFactor``
    (``inv_diag (nb, p, p)``, ``w_blocks (nb, p, r)``) or of its lane-major
    ``PallasTriFactor`` (``inv_t (p, p, nb_pad)``, ``w_t (p, r, nb_pad)``,
    un-padded to ``nb``), with ``n``, ``panel`` and ``r``."""
    if hasattr(f, "inv_t"):
        nb = int(f.nb)
        inv = np.asarray(f.inv_t)[:, :, :nb].transpose(2, 0, 1)
        w = np.asarray(f.w_t)[:, :, :nb].transpose(2, 0, 1)
    else:
        inv, w = np.asarray(f.inv_diag), np.asarray(f.w_blocks)
    return reduced_scan_tri(inv, w, int(f.n), int(f.panel), int(f.r),
                            torch_dtype(dtype), resolve_device(device))


def csr_from_numpy(data, indices, indptr, shape, dtype=torch.float64,
                   device=None, transpose: bool = True) -> CSR:
    """The port's ``CSR`` (kernel B5's operand) from CSR arrays (values,
    column indices, row pointers) of the given shape."""
    import scipy.sparse as sp

    mat = sp.csr_matrix((np.asarray(data), np.asarray(indices),
                         np.asarray(indptr)),
                        shape=(int(shape[0]), int(shape[1])))
    return csr_from_scipy(mat, dtype=torch_dtype(dtype),
                          device=resolve_device(device), transpose=transpose)


def schur_from_jax(f, rank: int):
    """One rank's ``parallel.schur.SchurShare`` (host arrays) from the
    numpy-convertible fields of the JAX package's ``SchurFactor``: its
    interior permutation, A_dS, the interface and S^-1, and its exchange
    indices, with the padding that ``shard_map`` needed cut off.  Handing
    it to ``plan_schur_precond(..., share=)`` gives both packages the same
    plan, so that a test compares their device sides alone."""
    import scipy.sparse as sp

    from ..parallel.schur import SchurShare

    N, s = int(f.N), int(f.s)
    g = np.asarray(f.gather_idx)[rank]
    n_int = int(np.count_nonzero(g < N))    # the valid entries lead
    if s:
        data = np.asarray(f.a_ds_data)[rank][:n_int]
        cols = np.asarray(f.a_ds_cols)[rank][:n_int]
        rows = np.repeat(np.arange(n_int), data.shape[1])
        a_ds = sp.csr_matrix((data.reshape(-1), (rows, cols.reshape(-1))),
                             shape=(n_int, s))
        a_ds.eliminate_zeros()
    else:
        a_ds = sp.csr_matrix((n_int, 0))
    exchange = None
    if getattr(f, "shard_gidx", None) is not None:
        exchange = dict(
            gidx=np.asarray(f.shard_gidx)[rank][:n_int].astype(np.int64),
            ssrc=np.asarray(f.shard_ssrc)[rank].astype(np.int64),
            ysdst=np.asarray(f.shard_ysdst)[rank].astype(np.int64),
            hx=int(f.shard_hx), hy=int(f.shard_hy),
            nloc=int(f.shard_nloc), mloc=int(f.shard_mloc))
    return SchurShare(interior=g[:n_int].astype(np.int64), a_ds=a_ds,
                      s_nat=np.asarray(f.s_gather).astype(np.int64),
                      s_inv=np.asarray(f.s_inv, np.float64),
                      exchange=exchange)
