"""Distributed exact constraint-preconditioner solve through a Schur
complement on interface unknowns.

Counterpart of ``cpkrylov_tpu/parallel/schur.py``.  The replicated direct
solve costs every rank the GLOBAL factor; this one costs a rank its own
partition.  The host plan is the JAX package's:

1. order K_P = [G B'; B -C] by the interleave of least bandwidth when that
   bandwidth is <= 128, else by reverse Cuthill-McKee, oriented so that
   chunk d's natural indices increase with d;
2. cut the ordered index range into ``ndev`` contiguous chunks;
3. the interface S is the set of unknowns coupled across a chunk boundary;
   the interiors I_d then decouple, and in the order [I_0 | ... | S] K_P is
   block-diagonal-bordered;
4. rank d factors ONLY its own interior block A_dd (a principal submatrix
   of the quasi-definite K_P, so nonsingular) with the port's host LDL^T
   and packs it with the port's trisolve rule (``precond/cp.py``: the
   bidiagonal scan B2, the reduced scan B4/B6 or blocked substitution);
5. rank d computes its part -A_Sd A_dd^-1 A_dS of the dense Schur
   complement S = A_SS - sum_d A_Sd A_dd^-1 A_dS; one all-reduce sums the
   parts, and every rank inverts S (s = |S| is small for banded systems).

Apply, ``SchurFactor.solve_sharded`` on the caller's vector slices:

    u_d = A_dd^-1 z_d                       local trisolves
    g   = z_S - sum_d A_dS' u_d             one all-reduce of 2s entries
    y_S = S^-1 g                            replicated (s, s) product
    y_d = u_d - A_dd^-1 (A_dS y_S)          second local trisolve
    y   = scatter(y_d) + scatter(y_S)

with the rank's z_d read from its halo-extended slices and y_d folded back
onto the neighbours that own its entries.  ``SchurFactor.solve`` does the
same on a full replicated z.  The A_dS products run in kernel B5 (CSR and
its stored transpose).  The JAX package's ``_pad_factor_widths`` and
``permute="gather"`` exist only to give every device one structure under
``shard_map`` and are not ported: each rank keeps its own interior size and
factor form.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..config import PrecondOptions
from ..ops import spmv
from ..ops.formats import CSR, csr_from_scipy
from ..precond import ldl_host
from ..precond.cp import (CPPrecond, FactorApply, assemble_kp,
                          build_factor_apply, choose_ordering,
                          pack_device_format)
from ..utils.device import torch_dtype
from .halo import halo_extend, halo_fold
from .partition import loc_size


@dataclasses.dataclass(frozen=True)
class SchurShare:
    """One rank's share of a Schur plan, host arrays only.

    ``interior``: natural indices of the rank's interior unknowns, in the
    plan's order; ``a_ds``: the (len(interior), s) interior-to-interface
    block; ``s_nat``: natural indices of the interface; ``s_inv``: the
    inverse Schur complement; ``exchange``: the sharded-exchange plan of
    :func:`plan_shard_exchange` for this rank, or None when some interior
    reaches past one neighbour's slice (then only the full-vector solve
    applies)."""

    interior: np.ndarray
    a_ds: sp.csr_matrix
    s_nat: np.ndarray
    s_inv: np.ndarray
    exchange: dict | None


@dataclasses.dataclass(frozen=True)
class SchurFactor:
    """Distributed direct solve  y = K_P^-1 z  of one rank (device side)."""

    local_factor: FactorApply   # A_dd^-1 solves
    a_ds: CSR | None            # (n_int, s) with its transpose; None if s=0
    interior: torch.Tensor      # (n_int,) int64 natural indices
    s_gather: torch.Tensor      # (s,) int64 natural indices of S
    s_inv: torch.Tensor         # (s, s)
    N: int
    s: int
    comm: object
    # sharded-exchange plan (None: only ``solve`` on a full z applies)
    shard_gidx: torch.Tensor | None = None    # (n_int,) -> ext buffers
    shard_ssrc: torch.Tensor | None = None    # (s,) owned -> ext buffer
    shard_ysdst: torch.Tensor | None = None   # (s,) -> (n_loc + m_loc) out
    shard_hx: int = 0
    shard_hy: int = 0
    shard_nloc: int = 0
    shard_mloc: int = 0

    @property
    def has_shard_plan(self) -> bool:
        return self.shard_gidx is not None

    @property
    def work_nnz(self) -> int:
        """This rank's share of one distributed direct solve's arithmetic
        volume (``utils.profiling.work_model``): two local solves and two
        products by A_dS, and on rank 0 the s x s interface solve.  The
        shares sum to the JAX package's count for the device stack
        (utils/profiling.py:58-66) where every rank's blocks have device
        0's sizes and form (the JAX count is device 0's times the device
        count), with one difference: the JAX device multiplies by A_dS as
        a padded ELL block and counts its slots, this rank by CSR and
        counts its stored entries."""
        lf = self.local_factor
        local = lf.tf1.work_nnz + lf.tf2.work_nnz + int(lf.dinv.shape[0])
        ads = self.a_ds.nnz if self.a_ds is not None else 0
        return (2 * local + 2 * ads
                + (self.s * self.s if self.comm.rank == 0 else 0))

    def _interface(self, u_d, z_s_part):
        """y_S and y_d from u_d = A_dd^-1 z_d and this rank's part of z_S
        (all of it, or the entries it owns): one all-reduce of 2s
        entries."""
        both = self.comm.allreduce_sum(
            torch.cat([z_s_part, spmv.rmatvec(self.a_ds, u_d)]))
        g = both[: self.s] - both[self.s:]
        y_s = self.s_inv @ g
        y_d = u_d - self.local_factor.solve(spmv.matvec(self.a_ds, y_s))
        return y_s, y_d

    def solve(self, z: torch.Tensor) -> torch.Tensor:
        """Full replicated z in, full y out (an all-reduce of N entries)."""
        u_d = self.local_factor.solve(z[self.interior])
        if self.s:
            # every rank holds all of z_S: only rank 0 contributes it
            zs = z[self.s_gather]
            y_s, y_d = self._interface(
                u_d, zs if self.comm.rank == 0 else torch.zeros_like(zs))
        else:
            y_d = u_d
        out = torch.zeros(self.N, dtype=z.dtype, device=z.device)
        out = self.comm.allreduce_sum(out.index_copy_(0, self.interior, y_d))
        if self.s:
            out[self.s_gather] = y_s
        return out

    def solve_sharded(self, zn_loc: torch.Tensor, zm_loc: torch.Tensor):
        """This rank's slices of z in, the same slices of y out.  Traffic:
        two halo exchanges in, one all-reduce of 2s entries, two halo
        folds out: O(halo + s) a rank instead of the full vector."""
        hx, hy = self.shard_hx, self.shard_hy
        nl, ml = self.shard_nloc, self.shard_mloc
        zx_ext = halo_extend(zn_loc, hx, self.comm)
        zy_ext = halo_extend(zm_loc, hy, self.comm)
        buf = torch.cat([zx_ext, zy_ext, zn_loc.new_zeros(1)])
        u_d = self.local_factor.solve(buf[self.shard_gidx])
        if self.s:
            # entries of S this rank does not own read the zero slot
            y_s, y_d = self._interface(u_d, buf[self.shard_ssrc])
        else:
            y_d = u_d
        nx = nl + 2 * hx
        out_ext = zn_loc.new_zeros(nx + ml + 2 * hy)
        out_ext.index_copy_(0, self.shard_gidx, y_d)
        yx = halo_fold(out_ext[:nx], hx, self.comm)
        yy = halo_fold(out_ext[nx:], hy, self.comm)
        yout = torch.cat([yx, yy, zn_loc.new_zeros(1)])
        if self.s:
            yout[self.shard_ysdst] = y_s
        return yout[:nl], yout[nl: nl + ml]


def plan_shard_exchange(interiors, s_nat, n: int, m: int, ndev: int,
                        rank: int):
    """The sharded-exchange plan of ``rank``: every natural index its
    interior and interface touch, mapped into its halo-extended buffer
    ``[zx_ext | zy_ext | 0]`` (the JAX package's ``_plan_shard_exchange``,
    with one index set per rank: its gather and scatter indices
    coincide).
    ``interiors`` holds every rank's natural interior indices, so that all
    ranks agree on the halo widths.  None when some interior reaches past
    one neighbour's slice."""
    N = n + m
    n_loc, m_loc = loc_size(n, ndev), loc_size(m, ndev)
    hx = hy = 0
    for d, g in enumerate(interiors):
        g = np.asarray(g, np.int64)
        gx = g[g < n]
        gy = g[(g >= n) & (g < N)] - n
        if gx.size:
            hx = max(hx, int(d * n_loc - gx.min()),
                     int(gx.max() - ((d + 1) * n_loc - 1)))
        if gy.size:
            hy = max(hy, int(d * m_loc - gy.min()),
                     int(gy.max() - ((d + 1) * m_loc - 1)))
    hx, hy = max(hx, 0), max(hy, 0)
    if hx > n_loc or hy > m_loc:
        return None
    ext_len = (n_loc + 2 * hx) + (m_loc + 2 * hy)

    def to_ext(idx_nat):
        idx_nat = np.asarray(idx_nat, np.int64)
        out = np.full(idx_nat.shape, ext_len, np.int64)   # -> zero slot
        isx = idx_nat < n
        isy = (idx_nat >= n) & (idx_nat < N)
        out[isx] = hx + (idx_nat[isx] - rank * n_loc)
        out[isy] = (n_loc + 2 * hx) + hy + (idx_nat[isy] - n - rank * m_loc)
        return out

    # hx and hy bound every rank's reach, so the indices land inside
    gidx = to_ext(interiors[rank])
    s_nat = np.asarray(s_nat, np.int64)
    owner = np.where(s_nat < n, s_nat // n_loc, (s_nat - n) // m_loc)
    mine = owner == rank
    ssrc = np.where(mine, to_ext(s_nat), ext_len)
    ysdst = np.where(mine, np.where(s_nat < n, s_nat - rank * n_loc,
                                    n_loc + (s_nat - n - rank * m_loc)),
                     n_loc + m_loc)
    return dict(gidx=gidx, ssrc=ssrc, ysdst=ysdst,
                hx=int(hx), hy=int(hy), nloc=int(n_loc), mloc=int(m_loc))


def _schur_ordering(ksp, n: int, m: int, chunk: int) -> np.ndarray:
    """The interleave of least bandwidth <= 128, else RCM; oriented so that
    chunk d's natural indices increase with d."""
    p, _ = choose_ordering(ksp, n, m)
    if isinstance(p, str):
        p = ldl_host._ordering(ksp, "rcm")
    p = np.asarray(p)
    if np.mean(p[:chunk]) > np.mean(p[-chunk:]):
        p = p[::-1]
    return p


def plan_schur_share(ksp, n: int, m: int, comm,
                     max_interface: int | None = None) -> SchurShare:
    """This rank's share of the Schur plan of K_P = ``ksp``; the parts of
    the Schur complement are summed over ``comm`` (every rank must call
    it).  Raises ValueError on every rank alike when the interface exceeds
    ``max_interface`` (default min(N // 4, 8192)) or some chunk has no
    interior."""
    from scipy.sparse.linalg import splu

    ksp = sp.csr_matrix(ksp)
    N = n + m
    ndev, rank = comm.size, comm.rank
    if max_interface is None:
        # S^-1 is dense and replicated on every rank; past a few thousand
        # interface unknowns the replicated factor is the better strategy
        max_interface = max(1, min(N // 4, 8192))
    chunk = -(-N // ndev)
    p = _schur_ordering(ksp, n, m, chunk)
    Kp = ksp[p][:, p].tocsr()
    chunk_of = np.arange(N) // chunk
    coo = Kp.tocoo()
    cross = chunk_of[coo.row] != chunk_of[coo.col]
    interface = np.zeros(N, dtype=bool)
    interface[coo.row[cross]] = True
    interface[coo.col[cross]] = True
    S_perm = np.where(interface)[0]
    s = int(S_perm.size)
    if s > max_interface:
        raise ValueError(
            f"Schur interface size {s} exceeds {max_interface}; the "
            "ordering's profile is too wide for chunked partitioning - use "
            "the replicated preconditioner")
    interiors = [np.where(~interface & (chunk_of == d))[0]
                 for d in range(ndev)]
    if any(I.size == 0 for I in interiors):
        raise ValueError("some rank has no interior unknowns; use fewer "
                         "ranks or the replicated preconditioner")

    I = interiors[rank]
    A_dS = Kp[I][:, S_perm].tocsr() if s else sp.csr_matrix((I.size, 0))
    part = np.zeros((s, s))
    if s:
        # Only interface columns with a nonzero in this chunk's rows
        # contribute (O(bandwidth) columns for banded K_P), so the dense
        # solve is restricted to them.
        A_dS_csc = A_dS.tocsc()
        nzc = np.where(np.diff(A_dS_csc.indptr) > 0)[0]
        if nzc.size:
            X = splu(Kp[I][:, I].tocsc()).solve(A_dS_csc[:, nzc].toarray())
            part[:, nzc] = -(Kp[S_perm][:, I] @ X.reshape(I.size, -1))
    S_mat = (Kp[S_perm][:, S_perm].toarray()
             + comm.allreduce_sum(torch.as_tensor(part)).numpy()) if s \
        else np.zeros((0, 0))
    s_inv = np.linalg.inv(S_mat) if s else np.zeros((0, 0))
    s_nat = p[S_perm] if s else np.zeros(0, np.int64)
    nat_interiors = [p[J] for J in interiors]
    return SchurShare(interior=nat_interiors[rank], a_ds=A_dS, s_nat=s_nat,
                      s_inv=s_inv,
                      exchange=plan_shard_exchange(nat_interiors, s_nat, n,
                                                   m, ndev, rank))


def _factor_share(share: SchurShare, ksp, n: int, m: int, comm,
                  *, panel: int = 64, dtype=torch.float64):
    """Factor this rank's interior block of ``ksp`` and pack the share on
    ``comm.device``.  Returns ``(SchurFactor, is_ldl)``."""
    dtype = torch_dtype(dtype)
    device = comm.device
    ksp = sp.csr_matrix(ksp)
    interior = np.asarray(share.interior, np.int64)
    A_dd = ksp[interior][:, interior].tocsc()
    signs = np.where(interior < n, 1.0, -1.0)
    fac = ldl_host.factorize(A_dd, ordering="rcm", pivot_signs=signs)
    lf = build_factor_apply(fac, int(interior.size), panel, dtype, device)
    s = int(np.asarray(share.s_nat).size)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    ex = share.exchange or {}
    shard = {}
    if ex:
        shard = dict(shard_gidx=ix(ex["gidx"]), shard_ssrc=ix(ex["ssrc"]),
                     shard_ysdst=ix(ex["ysdst"]), shard_hx=int(ex["hx"]),
                     shard_hy=int(ex["hy"]), shard_nloc=int(ex["nloc"]),
                     shard_mloc=int(ex["mloc"]))
    factor = SchurFactor(
        local_factor=lf,
        a_ds=(csr_from_scipy(share.a_ds, dtype=dtype, device=device)
              if s else None),
        interior=ix(interior), s_gather=ix(share.s_nat),
        s_inv=torch.as_tensor(np.asarray(share.s_inv, np.float64)).to(
            device=device, dtype=dtype),
        N=int(n + m), s=s, comm=comm, **shard)
    return factor, isinstance(fac, ldl_host.HostLDL)


def plan_schur_precond(G, B, C, comm, *,
                       options: PrecondOptions | None = None,
                       panel: int = 64, dtype=torch.float64,
                       share: SchurShare | None = None) -> CPPrecond:
    """A ``CPPrecond`` whose direct solve is this rank's ``SchurFactor``
    (the distributed paths' drop-in for ``make_preconditioner``; the GHN
    update and iterative refinement are unchanged).  Every rank of
    ``comm`` calls it.  ``share`` hands in a plan made elsewhere (such as
    ``utils.convert.schur_from_jax``) instead of planning here.  When the
    plan has a sharded exchange, ``kp`` is None: the preconditioner is then
    applied on the slices with K_P's row blocks (``solve.ShardedPrecond``).

    Raises ValueError when the interface grows beyond
    :func:`plan_schur_share`'s ``max_interface``: systems whose profile
    stays wide are better served by the replicated factor."""
    options = options or PrecondOptions()
    dtype = torch_dtype(dtype)
    n, m = G.shape[0], C.shape[0]
    ksp = assemble_kp(G, B, C).tocsr()
    if share is None:
        share = plan_schur_share(ksp, n, m, comm)
    factor, is_ldl = _factor_share(share, ksp, n, m, comm, panel=panel,
                                   dtype=dtype)
    # one refinement step after every direct solve when any rank's factor
    # is an LDL^T (the JAX package's rule); all ranks must agree on it
    any_ldl = float(comm.allreduce_sum(
        torch.tensor([float(is_ldl)], dtype=torch.float64)).item())
    # With an exchange plan the products by K_P run on row blocks of G, B,
    # B' and C (``solve.DistPlan.kp_mvs``), so the device holds no global
    # K_P; without one the factor is applied on full vectors and needs it.
    kp = (None if factor.has_shard_plan
          else pack_device_format(ksp, dtype, comm.device))
    return CPPrecond(factor=factor, kp=kp,
                     n=int(n), m=int(m), options=options,
                     factor_nitref=1 if any_ldl > 0 else 0)
