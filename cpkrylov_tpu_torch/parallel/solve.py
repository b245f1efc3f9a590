"""Distributed solves for the whole kernel family on row shards.

Counterpart of ``cpkrylov_tpu/parallel/solve.py``: the generic driver that
runs ANY of the six serial kernels (``solvers/``) with ROW-SHARDED vectors.
The blocks A, B, B', C are 1-D row-partitioned over the ranks, every Krylov
vector (and the whole GMRES/DQGMRES basis) lives as an O(N/ndev) slice on
its rank, and every reduction inside the kernels goes through
``solvers.common.vdot``/``coupled_dot``, which ``reduce_group`` turns into a
local dot plus one all-reduce.  Scalar recurrence state is replicated: every
rank reads the same all-reduced scalars and takes the same branches.

SpMV operands move by halo exchange where the block is banded enough
(``halo.plan_halo_block``: edge-only neighbour exchanges) and by all-gather
otherwise.  The preconditioner is either replicated (applied on gathered
vectors, the port's ``CPPrecond`` with B7/B8 and B2 on the banded system)
or the exact Schur factor (``schur.SchurFactor``), whose application,
including the GHN update and refinement, runs on the slices.

Driver semantics (RHS shift and un-shift, reg_cpkrylov.m:152-173) wrap the
kernel, so ``dist_solve`` is the distributed ``driver.solve``.  Nothing is
cached across calls: a caller that solves one system repeatedly holds the
``DistPlan`` of :func:`plan_dist` and passes it back in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..config import PrecondOptions, SolverOptions
from ..operators.linop import FunctionOperator
from ..ops import spmv
from ..precond.cp import CPPrecond, CPState
from ..solvers import SOLVERS
from ..solvers.common import reduce_group
from ..utils.device import torch_dtype
from .halo import HaloBlock, halo_extend, halo_matvec, plan_halo_block
from .partition import loc_size, pack_block, row_slice, shard_vector


_NO_KP = ("this Schur factor keeps no global K_P: apply it with K_P's row "
          "blocks (plan_dist(..., G=G), as dist_solve does) or with options "
          "that need no K_P product (nitref=0, factor_nitref=0, no GHN)")


class ShardedPrecond:
    """Slice-facing adapter over a ``CPPrecond`` (the replicated factor or
    this rank's Schur factor).  Three modes, fixed at construction:

    * **sharded_full**: the factor carries a Schur exchange plan for these
      slice sizes AND the caller gives row-partitioned K_P block products
      (``kp_mvs``): the whole reference application (GHN input correction,
      direct solve with the factor's refinement, GHN cache refresh, outer
      refinement; opLDL2.m:161-188) runs on the slices, the GHN caches
      included;
    * **sharded_lean**: an exchange plan but no K_P products: the direct
      solve runs on the slices, for options with no refinement and no GHN;
    * **gather**: all-gather the slices, apply the preconditioner on full
      vectors on every rank, keep this rank's slice.

    A Schur factor with an exchange plan keeps no global K_P (``kp`` is
    None), so it takes the first two modes only; for any other use it
    raises ValueError.
    """

    def __init__(self, inner: CPPrecond, comm, n_loc: int, m_loc: int,
                 kp_mvs=None):
        self.inner = inner
        self.comm = comm
        self.n_loc = n_loc
        self.m_loc = m_loc
        self.kp_mvs = kp_mvs          # (gmv, btmv, bmv, cmv) or None
        self.mode = self._mode()

    def _mode(self) -> str:
        f = self.inner.factor
        if (getattr(f, "has_shard_plan", False)
                and f.shard_nloc == self.n_loc
                and f.shard_mloc == self.m_loc):
            if self.kp_mvs is not None:
                return "sharded_full"
            opts = self.inner.options
            if (self.inner.factor_nitref == 0 and opts.nitref == 0
                    and not opts.force_itref and not opts.residual_update):
                return "sharded_lean"
        if self.inner.kp is None:
            raise ValueError(_NO_KP)
        return "gather"

    def init_state(self, dtype=None) -> CPState:
        if self.mode != "gather":
            dtype = dtype or self.inner.factor.s_inv.dtype
            dev = self.comm.device
            return CPState(aty=torch.zeros(self.n_loc, dtype=dtype,
                                           device=dev),
                           cy=torch.zeros(self.m_loc, dtype=dtype,
                                          device=dev))
        return self.inner.init_state(dtype)

    def _slice(self, vfull: torch.Tensor, loc: int) -> torch.Tensor:
        r0 = self.comm.rank * loc
        piece = vfull[r0: r0 + loc]
        if piece.shape[0] < loc:
            piece = torch.cat([piece, piece.new_zeros(loc - piece.shape[0])])
        return piece

    def _gather_pair(self, zn, zm) -> torch.Tensor:
        return torch.cat([self.comm.all_gather_vec(zn, self.inner.n),
                          self.comm.all_gather_vec(zm, self.inner.m)])

    def _pnorm(self, vn, vm) -> torch.Tensor:
        return torch.sqrt(self.comm.allreduce_sum(
            torch.dot(vn, vn) + torch.dot(vm, vm)))

    def _kp_mv(self, xn, xm):
        gmv, btmv, bmv, cmv = self.kp_mvs
        return gmv(xn) + btmv(xm), bmv(xn) - cmv(xm)

    def _direct(self, dn, dm):
        f = self.inner.factor
        yn, ym = f.solve_sharded(dn, dm)
        for _ in range(self.inner.factor_nitref):
            kn, km = self._kp_mv(yn, ym)
            cn, cm = f.solve_sharded(dn - kn, dm - km)
            yn, ym = yn + cn, ym + cm
        return yn, ym

    def _apply_sharded_full(self, state, zn, zm):
        """The reference's application order (opLDL2.m:161-188) on the
        slices, as ``CPPrecond.apply`` does on full vectors."""
        opts = self.inner.options
        if opts.residual_update:
            yn, ym = self._direct(zn - state.aty, zm - state.cy)
            # gv = K_P [0; y2] = [B' y2; -C y2]: no G product needed
            _, btmv, _, cmv = self.kp_mvs
            state = CPState(aty=btmv(ym), cy=-cmv(ym))
        else:
            yn, ym = self._direct(zn, zm)
        rnorm = torch.zeros((), dtype=zn.dtype, device=zn.device)
        if opts.nitref > 0:
            kn, km = self._kp_mv(yn, ym)
            rn, rm = zn - kn, zm - km
            rnorm = self._pnorm(rn, rm)
            xnorm = None if opts.force_itref else self._pnorm(zn, zm)
            nit = 0
            # forced: exactly nitref steps (opLDL2.m:176)
            while nit < opts.nitref and (
                    opts.force_itref
                    or bool(rnorm >= opts.itref_tol * xnorm)):
                cn, cm = self._direct(rn, rm)
                yn, ym = yn + cn, ym + cm
                kn, km = self._kp_mv(yn, ym)
                rn, rm = zn - kn, zm - km
                rnorm = self._pnorm(rn, rm)
                nit += 1
        return state, yn, ym, rnorm

    def apply_nm(self, state, zn, zm):
        """Apply on this rank's (n_loc, m_loc) slices; returns
        ``(state, yn, ym, rnorm)``."""
        if self.mode == "sharded_full":
            return self._apply_sharded_full(state, zn, zm)
        if self.mode == "sharded_lean":
            yn, ym = self.inner.factor.solve_sharded(zn, zm)
            return state, yn, ym, torch.zeros((), dtype=zn.dtype,
                                              device=zn.device)
        n = self.inner.n
        state, y, rnorm = self.inner.apply(state, self._gather_pair(zn, zm))
        return (state, self._slice(y[:n], self.n_loc),
                self._slice(y[n:], self.m_loc), rnorm)

    def apply(self, state, z_pair):
        """Apply on the (n_loc + m_loc,) pair of slices."""
        state, yn, ym, _ = self.apply_nm(state, z_pair[: self.n_loc],
                                         z_pair[self.n_loc:])
        return state, torch.cat([yn, ym])

    def mul_kp(self, z_pair):
        """K_P times the pair of slices (CPGMRES's reorthogonalisation)."""
        zn, zm = z_pair[: self.n_loc], z_pair[self.n_loc:]
        if self.kp_mvs is not None:
            return torch.cat(self._kp_mv(zn, zm))
        if self.inner.kp is None:
            raise ValueError(_NO_KP)
        n = self.inner.n
        y = self.inner.mul_kp(self._gather_pair(zn, zm))
        return torch.cat([self._slice(y[:n], self.n_loc),
                          self._slice(y[n:], self.m_loc)])


@dataclasses.dataclass(frozen=True)
class GatherBlock:
    """A row block with global column indices: its product all-gathers
    the operand first."""

    mat: object
    in_size: int


def _try_halo(mat, comm, rows_loc, cols_loc, dtype) -> HaloBlock | None:
    try:
        return plan_halo_block(mat, comm, rows_loc, cols_loc, dtype=dtype,
                               max_halo=max(1, cols_loc // 2))
    except ValueError:
        return None


def block_matvec(blk, comm):
    """The product of this rank's row block with a vector of slices:
    through the halo exchange or the all-gather."""
    if isinstance(blk, HaloBlock):
        return lambda x_loc: halo_matvec(blk, halo_extend(x_loc, blk.halo,
                                                          comm))
    return lambda x_loc: spmv.matvec(
        blk.mat, comm.all_gather_vec(x_loc, blk.in_size))


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """This rank's operands: for each of "a", "b", "bt", "c" (and "g",
    the G block of K_P, when the preconditioner is applied on slices) a
    ``HaloBlock`` or a ``GatherBlock``."""

    blocks: dict
    n: int
    m: int
    n_loc: int
    m_loc: int
    dtype: torch.dtype

    def matvec(self, name: str, comm):
        return block_matvec(self.blocks[name], comm)

    def kp_mvs(self, comm):
        """The products by K_P's row blocks ``(G, B', B, C)`` that
        ``ShardedPrecond`` takes, or None when G was not partitioned."""
        if "g" not in self.blocks:
            return None
        return tuple(self.matvec(k, comm) for k in ("g", "bt", "b", "c"))


def plan_dist(A, B, C, comm, dtype=torch.float64, G=None) -> DistPlan:
    """Partition this rank's rows of A, B, B', C (and G when given) and
    plan a halo exchange for each block banded enough for one (a reach of
    at most half a slice), an all-gather for the others."""
    dtype = torch_dtype(dtype)
    n, m = A.shape[0], C.shape[0]
    n_loc, m_loc = loc_size(n, comm.size), loc_size(m, comm.size)
    Bc = sp.csr_matrix(B)
    # name -> (matrix, rows_loc, cols_loc, operand length)
    spec = {"a": (A, n_loc, n_loc, n), "b": (Bc, m_loc, n_loc, n),
            "bt": (Bc.T.tocsr(), n_loc, m_loc, m), "c": (C, m_loc, m_loc, m)}
    if G is not None:
        spec["g"] = (G, n_loc, n_loc, n)
    blocks = {}
    for name, (mat, rows_loc, cols_loc, in_size) in spec.items():
        hb = _try_halo(mat, comm, rows_loc, cols_loc, dtype)
        blocks[name] = hb if hb is not None else GatherBlock(
            mat=pack_block(row_slice(mat, comm.rank, rows_loc), dtype,
                           comm.device), in_size=int(in_size))
    return DistPlan(blocks=blocks, n=int(n), m=int(m), n_loc=int(n_loc),
                    m_loc=int(m_loc), dtype=dtype)


def default_itmax(method: str, n: int, m: int) -> int:
    """The kernels' itmax defaults in GLOBAL sizes (cpcg.m:99 itmax = n,
    cpgmres.m:105 itmax = n + m): on a rank the blocks are local."""
    return int(n + m if method in ("cpgmres", "cpdqgmres") else n)


def dist_solve(comm, method, b, A, B, C, G, *,
               opts: SolverOptions | None = None,
               precond_opts: PrecondOptions | None = None,
               M: CPPrecond | None = None, plan: DistPlan | None = None,
               panel: int = 256, dtype=None):
    """Distributed ``solve`` on ``comm``'s ranks: any kernel, row-sharded
    matrices AND vectors.  Every rank calls it with the same host system.

    Builds the preconditioner unless ``M`` is given (the Schur factor where
    the system allows it, else the replicated one: ``mixed.
    build_dist_precond``), partitions the blocks unless ``plan`` is given,
    and runs shift -> kernel -> un-shift on the slices.  Returns
    ``(res, x1, x2)`` like the serial driver's core: the kernel's
    ``KrylovResult`` with its x and y gathered, and the solution's global
    parts, on every rank."""
    from .mixed import build_dist_precond

    opts = opts or SolverOptions()
    if callable(method):
        method = method.__name__
    if method not in SOLVERS:
        raise ValueError(f"unknown solver {method!r}")
    kernel = SOLVERS[method]
    b = np.asarray(b).reshape(-1)
    dtype = torch_dtype(dtype if dtype is not None else b.dtype)
    n, m = A.shape[0], C.shape[0]
    if b.shape[0] != n + m:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")
    if opts.itmax is None:
        opts = dataclasses.replace(opts, itmax=default_itmax(method, n, m))

    if M is None:
        M = build_dist_precond(G, B, C, comm, precond_opts=precond_opts,
                               panel=panel, dtype=dtype)
    # a Schur factor with an exchange plan and G's row blocks apply the
    # whole preconditioner on the slices
    shard_g = getattr(M.factor, "has_shard_plan", False)
    if plan is None:
        plan = plan_dist(A, B, C, comm, dtype=dtype,
                         G=G if shard_g else None)
    n_loc, m_loc = plan.n_loc, plan.m_loc
    amv, bmv = plan.matvec("a", comm), plan.matvec("b", comm)
    btmv, cmv = plan.matvec("bt", comm), plan.matvec("c", comm)
    A_op = FunctionOperator(params=None, fn=lambda _, x: amv(x), rfn=None,
                            shape=(n_loc, n_loc))
    C_op = FunctionOperator(params=None, fn=lambda _, x: cmv(x), rfn=None,
                            shape=(m_loc, m_loc))
    B_op = FunctionOperator(params=None, fn=lambda _, x: bmv(x),
                            rfn=lambda _, y: btmv(y), shape=(m_loc, n_loc))
    Msh = ShardedPrecond(M, comm, n_loc, m_loc, kp_mvs=plan.kp_mvs(comm))
    b1 = shard_vector(b[:n], comm, n_loc, dtype)
    b2 = shard_vector(b[n:], comm, m_loc, dtype)
    shift = bool(np.any(b[n:]))                     # reg_cpkrylov.m:154

    with reduce_group(comm):
        mstate = Msh.init_state(dtype)
        if shift:
            # xy0 = M * [0; b2]; b1' = b1 - A*xy0_1 - B'*xy0_2
            mstate, xy0 = Msh.apply(mstate, torch.cat(
                [torch.zeros_like(b1), b2]))
            xy0n, xy0m = xy0[:n_loc], xy0[n_loc:]
            b1 = b1 - amv(xy0n) - btmv(xy0m)
        res = kernel(b1, A_op, C_op, Msh, opts, mstate, B=B_op)
    x1 = xy0n + res.x if shift else res.x          # reg_cpkrylov.m:166-172
    x2 = xy0m + res.y if shift else res.y
    res = dataclasses.replace(res, x=comm.all_gather_vec(res.x, n),
                              y=comm.all_gather_vec(res.y, m))
    return res, comm.all_gather_vec(x1, n), comm.all_gather_vec(x2, m)
