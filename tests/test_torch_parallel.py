"""The port's distributed solve (``cpkrylov_tpu_torch.parallel``) against
the JAX package's ``cpkrylov_tpu.parallel`` on the same inputs, on the CPU.

The port's ranks are processes of a gloo group on the CPU, spawned once per
``ndev`` by a module-scoped fixture that runs every check of that ``ndev``
in the workers and returns their results; the JAX package runs on the
conftest's virtual CPU devices at the same ``ndev`` meanwhile, in this
process.  Checks:

* halo plans equal ``plan_halo_block``'s arrays, rank by rank, and the halo
  product equals the all-gather product to 1e-14;
* the Schur solve equals scipy's ``spsolve`` of K_P to 1e-12
  (``banded_saddle_system(400, 100, bandwidth=3, seed=1)``, G diagonal and
  banded), and, given the JAX plan through ``schur_from_jax``, the JAX
  ``SchurFactor``'s output to 1e-12; its sharded solve equals its
  full-vector solve, and a factor with an exchange keeps no global K_P;
* on ``banded_saddle_system(2048, 512, bandwidth=3)``: ``dist_solve``
  (CPMINRES and CPGMRES, with the Schur and the replicated factor) and
  ``dist_cpminres`` take the JAX package's count at the same ``ndev`` and
  the port's serial count, each within +-1, and x agrees with the JAX
  result within 1e-8 relative (f64);
* ``dist_cpminres`` on ``random_sqd_system(96, 40, seed=17, delta=1e-2)``
  agrees with the serial solve within rtol 1e-6 / atol 1e-8;
* with the main path's options (GHN update, forced refinement) the Schur
  factor's application on the slices keeps the serial count and x, and a
  lean Schur factor applies on the slices inside ``dist_cpminres``;
* ``dist_solve_mixed`` reaches the f64 contract;
* a ``max_interface`` overrun and a halo reach too wide raise ValueError;
* with no group active the serial reductions and golden count are as
  before.
"""
import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from jax.sharding import Mesh, PartitionSpec as P

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.parallel import (dist_cpminres, dist_solve,
                                         dist_solve_mixed, partition_blocks,
                                         plan_dist, plan_halo_block,
                                         plan_schur_precond, shard_vector,
                                         unshard_vector)
from cpkrylov_tpu_torch.ops import spmv
from cpkrylov_tpu_torch.parallel.dryrun import run_ranks
from cpkrylov_tpu_torch.parallel.halo import halo_extend, halo_matvec
from cpkrylov_tpu_torch.parallel.partition import (loc_size, pack_block,
                                                   row_slice)
from cpkrylov_tpu_torch.parallel.schur import SchurShare, plan_schur_share
from cpkrylov_tpu_torch.parallel.solve import ShardedPrecond
from cpkrylov_tpu_torch.precond.cp import assemble_kp
from cpkrylov_tpu_torch.utils import convert
from cpkrylov_tpu_torch.utils.fixtures import (banded_saddle_system,
                                               random_sqd_system)

CPU = torch.device("cpu")
F64 = torch.float64
BANDED = dict(n=2048, m=512, bandwidth=3)
SCHUR_SYS = dict(n=400, m=100, bandwidth=3, seed=1)
SOLVE_OPTS = dict(atol=0.0, rtol=1e-6, itmax=500)
# the main path's preconditioner options (bench.py:148)
GHN = cpt.PrecondOptions(residual_update=True, nitref=1, force_itref=True)
FAMILY = (("cpminres", {}), ("cpgmres", {"restart": 50}))
MORE = (("cpcg", {}), ("cpcglanczos", {}), ("cpsymmlq", {}),
        ("cpdqgmres", {"mem": 50}))


def _banded(**kw):
    return banded_saddle_system(BANDED["n"], BANDED["m"],
                                bandwidth=BANDED["bandwidth"],
                                with_oracle=False, **kw)


def _schur_sys(g_mode):
    return banded_saddle_system(SCHUR_SYS["n"], SCHUR_SYS["m"],
                                bandwidth=SCHUR_SYS["bandwidth"],
                                seed=SCHUR_SYS["seed"], g_mode=g_mode)


def _z(N):
    return np.random.default_rng(0).standard_normal(N)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-300))


def _host_comm(rank, ndev):
    """A stand-in for ``Comm`` in host-only plans (rank, size, device)."""
    return types.SimpleNamespace(rank=rank, size=ndev, device=CPU)


# ---------------------------------------------------------------------------
# The port's ranks (run in spawned gloo workers on the CPU)
# ---------------------------------------------------------------------------

def _worker(comm, jax_shares, methods):
    """Every distributed check of one ``ndev`` on this rank; rank 0 returns
    the global results, every rank its counts (which must agree)."""
    out = {"counts": {}}
    n, m = BANDED["n"], BANDED["m"]

    # halo product against the all-gather product (A and C of the system)
    s_ = _banded()
    rng = np.random.default_rng(3)
    for name, mat, size in (("a", s_.A, n), ("c", s_.C, m)):
        loc = loc_size(size, comm.size)
        x = rng.standard_normal(size)
        x_loc = shard_vector(x, comm, loc, F64)
        hb = plan_halo_block(mat, comm, loc, loc)
        y_halo = halo_matvec(hb, halo_extend(x_loc, hb.halo, comm))
        blk = pack_block(row_slice(mat, comm.rank, loc), F64, CPU)
        y_gather = spmv.matvec(blk, comm.all_gather_vec(x_loc, size))
        out[f"halo_{name}"] = (unshard_vector(y_halo, size, comm).numpy(),
                               unshard_vector(y_gather, size, comm).numpy())

    # the Schur solve: the port's own plan, and the JAX plan
    for g_mode in ("diag", "banded"):
        ss = _schur_sys(g_mode)
        z = torch.as_tensor(_z(ss.n + ss.m))
        own = plan_schur_share(assemble_kp(ss.G, ss.B, ss.C), ss.n, ss.m,
                               comm)
        out["counts"][f"share_{g_mode}"] = own   # every rank's own share
        for which, share in (("own", own),
                             ("jax", jax_shares[g_mode][comm.rank])):
            M = plan_schur_precond(ss.G, ss.B, ss.C, comm, panel=16,
                                   share=share)
            f = M.factor
            res = {"solve": f.solve(z).numpy(), "s": f.s,
                   "shard": f.has_shard_plan, "kp_none": M.kp is None}
            if f.has_shard_plan:
                nl, ml = f.shard_nloc, f.shard_mloc
                zn = shard_vector(z[: ss.n].numpy(), comm, nl, F64)
                zm = shard_vector(z[ss.n:].numpy(), comm, ml, F64)
                yn, ym = f.solve_sharded(zn, zm)
                res["sharded"] = np.concatenate([
                    unshard_vector(yn, ss.n, comm).numpy(),
                    unshard_vector(ym, ss.m, comm).numpy()])
                # no global K_P on the device: the application (with the
                # factor's refinement) runs on K_P's row blocks
                plan = plan_dist(ss.A, ss.B, ss.C, comm, dtype=F64, G=ss.G)
                Msh = ShardedPrecond(M, comm, nl, ml,
                                     kp_mvs=plan.kp_mvs(comm))
                _, yn, ym, _ = Msh.apply_nm(Msh.init_state(F64), zn, zm)
                res["apply"] = np.concatenate([
                    unshard_vector(yn, ss.n, comm).numpy(),
                    unshard_vector(ym, ss.m, comm).numpy()])
                try:
                    ShardedPrecond(M, comm, nl, ml)
                    res["gather_refused"] = False
                except ValueError:
                    res["gather_refused"] = True
            else:
                res["apply"] = M.apply(M.init_state(F64), z)[1].numpy()
            out[f"schur_{g_mode}_{which}"] = res

    # the family on the banded system: Schur and replicated factors
    Mr = cpt.make_preconditioner(s_.G, s_.B, s_.C, dtype=F64, device=CPU)
    for method, extra in methods:
        opts = cpt.SolverOptions(**SOLVE_OPTS, **extra)
        for fac in ("schur", "rep"):
            res, x1, x2 = dist_solve(comm, method, s_.b, s_.A, s_.B, s_.C,
                                     s_.G, opts=opts, dtype=F64,
                                     M=Mr if fac == "rep" else None)
            out["counts"][f"{method}_{fac}"] = (res.niters, res.solved)
            out[f"x_{method}_{fac}"] = torch.cat([x1, x2]).numpy()
    # the main path's options (GHN update, forced refinement) on the Schur
    # factor: the GHN caches live on the slices
    res, x1, x2 = dist_solve(comm, "cpminres", s_.b, s_.A, s_.B, s_.C, s_.G,
                             opts=cpt.SolverOptions(**SOLVE_OPTS),
                             precond_opts=GHN, dtype=F64)
    out["counts"]["ghn"] = (res.niters, res.solved)
    out["x_ghn"] = torch.cat([x1, x2]).numpy()

    # the hand-fused CPMINRES on the b2 = 0 system, replicated factor
    blocks = partition_blocks(s_.A, s_.B, s_.C, comm, dtype=F64)
    b_loc = shard_vector(s_.b[:n], comm, blocks.n_loc, F64)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=400)
    x_loc, _, k, _, _ = dist_cpminres(comm, blocks, Mr, b_loc, opts)
    out["counts"]["dist_cpminres"] = (k, True)
    out["x_dist_cpminres"] = unshard_vector(x_loc, n, comm).numpy()

    # ... with a lean Schur factor (no refinement, no GHN): its direct
    # solve runs on the slices wherever the plan has an exchange
    Ms = plan_schur_precond(s_.G, s_.B, s_.C, comm, panel=128,
                            options=cpt.PrecondOptions(nitref=0))
    Ml = dataclasses.replace(Ms, factor_nitref=0)
    mode = ShardedPrecond(Ml, comm, blocks.n_loc, blocks.m_loc).mode
    x_loc, _, k, _, _ = dist_cpminres(comm, blocks, Ml, b_loc, opts)
    out["counts"]["lean"] = (k, mode, Ms.factor.has_shard_plan)
    out["x_lean"] = unshard_vector(x_loc, n, comm).numpy()

    # dist_cpminres on the random SQD system (all-gather products)
    q = random_sqd_system(96, 40, seed=17, delta=1e-2)
    Mq = cpt.make_preconditioner(q.G, q.B, q.C, panel=16, dtype=F64,
                                 device=CPU)
    bq = partition_blocks(q.A, q.B, q.C, comm, dtype=F64)
    xq, yq, kq, rq, hq = dist_cpminres(
        comm, bq, Mq, shard_vector(q.b[: q.n], comm, bq.n_loc, F64),
        cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=200))
    out["sqd"] = (unshard_vector(xq, q.n, comm).numpy(),
                  unshard_vector(yq, q.m, comm).numpy(), kq, rq, hq)

    # distributed mixed precision to the f64 contract
    mix = dist_solve_mixed(comm, "cpminres", s_.b, s_.A, s_.B, s_.C, s_.G,
                           opts=cpt.SolverOptions(atol=0.0, rtol=1e-10,
                                                  itmax=300))
    out["mixed"] = (mix.solved, mix.x, mix.nouter, mix.niters)
    return out if comm.rank == 0 else {"counts": out["counts"]}


# ---------------------------------------------------------------------------
# The JAX package on the virtual CPU devices
# ---------------------------------------------------------------------------

def _jax_schur(g_mode, ndev):
    """The JAX Schur plan and its raw factor solve of z."""
    from cpkrylov_tpu.parallel.schur import (
        plan_schur_precond as jax_plan_schur)
    from cpkrylov_tpu.parallel.solve import precond_spec

    ss = _schur_sys(g_mode)
    M = jax_plan_schur(ss.G, ss.B, ss.C, ndev, panel=16)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    y = jax.jit(jax.shard_map(lambda M_loc, z: M_loc.factor.solve(z),
                              mesh=mesh, in_specs=(precond_spec(M), P()),
                              out_specs=P(), check_vma=False))(
        M, jnp.asarray(_z(ss.n + ss.m)))
    return M, np.asarray(y)


def _jax_solves(ndev, methods):
    from cpkrylov_tpu.parallel import (dist_cpminres as jax_dist_cpminres,
                                       partition_blocks as jax_partition,
                                       shard_vector as jax_shard,
                                       unshard_vector as jax_unshard)
    from cpkrylov_tpu.parallel.schur import (
        plan_schur_precond as jax_plan_schur)
    from cpkrylov_tpu.parallel.solve import dist_solve as jax_dist_solve
    from cpkrylov_tpu.precond.cp import (
        make_preconditioner as jax_make_precond)
    from cpkrylov_tpu import SolverOptions

    s_ = _banded()
    n = BANDED["n"]
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    Mr = jax_make_precond(s_.G, s_.B, s_.C)
    Ms = jax_plan_schur(s_.G, s_.B, s_.C, ndev, panel=128)
    out = {}
    for method, extra in methods:
        opts = SolverOptions(**SOLVE_OPTS, **extra)
        for fac, M in (("schur", Ms), ("rep", Mr)):
            res, x1, x2 = jax_dist_solve(mesh, method, s_.b, s_.A, s_.B,
                                         s_.C, s_.G, opts=opts, M=M)
            out[f"{method}_{fac}"] = (
                int(res.niters), np.concatenate([np.asarray(x1),
                                                 np.asarray(x2)]))
    blocks = jax_partition(s_.A, s_.B, s_.C, ndev)
    opts = SolverOptions(atol=0.0, rtol=1e-6, itmax=400)
    x_sh, _, k, _, _ = jax.jit(lambda b: jax_dist_cpminres(
        mesh, blocks, Mr, b, opts))(jax_shard(s_.b[:n], ndev, blocks.n_loc))
    out["dist_cpminres"] = (int(k), np.asarray(jax_unshard(x_sh, n)))
    return out


def _serial_counts(methods):
    """The port's serial counts on the banded system (CPU, f64)."""
    s_ = _banded()
    n, m = BANDED["n"], BANDED["m"]
    out = {}
    for method, extra in methods:
        o = cpt.solve(method, s_.b, s_.A, s_.B, s_.C, s_.G, device="cpu",
                      dtype=F64, opts=cpt.SolverOptions(**SOLVE_OPTS,
                                                        **extra))
        out[method] = o.niters
    b0 = np.concatenate([s_.b[:n], np.zeros(m)])
    o = cpt.solve("cpminres", b0, s_.A, s_.B, s_.C, s_.G, device="cpu",
                  dtype=F64, opts=cpt.SolverOptions(atol=0.0, rtol=1e-6,
                                                    itmax=400))
    out["dist_cpminres"] = o.niters
    o = cpt.solve("cpminres", b0, s_.A, s_.B, s_.C, s_.G, device="cpu",
                  dtype=F64, opts=cpt.SolverOptions(atol=0.0, rtol=1e-6,
                                                    itmax=400),
                  precond_opts=cpt.PrecondOptions(nitref=0))
    out["lean"] = (o.niters, o.x1.numpy())
    o = cpt.solve("cpminres", s_.b, s_.A, s_.B, s_.C, s_.G, device="cpu",
                  dtype=F64, opts=cpt.SolverOptions(**SOLVE_OPTS),
                  precond_opts=GHN)
    out["ghn"] = (o.niters, o.x.numpy())
    return out


def _run(ndevs, methods):
    """Spawn the port's ranks for every ndev at once, and run the JAX
    package meanwhile; returns each ndev's results."""
    jax_schur = {d: {g: _jax_schur(g, d) for g in ("diag", "banded")}
                 for d in ndevs}
    shares = {d: {g: [convert.schur_from_jax(M.factor, r) for r in range(d)]
                  for g, (M, _) in js.items()}
              for d, js in jax_schur.items()}
    with concurrent.futures.ThreadPoolExecutor(len(ndevs)) as ex:
        futs = {d: ex.submit(run_ranks, _worker, d, shares[d], methods,
                             backend="gloo", device="cpu", timeout_s=600)
                for d in ndevs}
        jax_out = {d: _jax_solves(d, methods) for d in ndevs}
        serial = _serial_counts(methods)
        ranks = {d: f.result() for d, f in futs.items()}
    return {d: dict(ranks=ranks[d], jax=jax_out[d], jax_schur=jax_schur[d],
                    serial=serial, ndev=d, methods=methods) for d in ndevs}


@pytest.fixture(scope="module")
def default_runs():
    """ndev 2 and 4, spawned together (spawning is paid once)."""
    return _run((2, 4), FAMILY)


@pytest.fixture(scope="module",
                params=[2, 4, pytest.param(8, marks=pytest.mark.slow)])
def run(request):
    if request.param == 8:
        return _run((8,), FAMILY)[8]
    return request.getfixturevalue("default_runs")[request.param]


# ---------------------------------------------------------------------------
# Host plans (no process group needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4])
def test_halo_plans_equal_jax(ndev):
    from cpkrylov_tpu.parallel import plan_halo_block as jax_plan_halo

    s_ = _banded()
    n, m = BANDED["n"], BANDED["m"]
    n_loc, m_loc = loc_size(n, ndev), loc_size(m, ndev)
    for mat, rows_loc, cols_loc in ((s_.A, n_loc, n_loc),
                                    (s_.C, m_loc, m_loc),
                                    (s_.G, n_loc, n_loc)):
        ref = jax_plan_halo(mat, ndev, rows_loc, cols_loc)
        data, cols = np.asarray(ref.data), np.asarray(ref.cols)
        for d in range(ndev):
            hb = plan_halo_block(mat, _host_comm(d, ndev), rows_loc,
                                 cols_loc)
            assert hb.halo == ref.halo
            width = 2 * hb.halo + cols_loc
            dense = np.zeros((rows_loc, width))
            rr = np.repeat(np.arange(rows_loc), data.shape[2])
            np.add.at(dense, (rr, cols[d].reshape(-1)), data[d].reshape(-1))
            np.testing.assert_array_equal(hb.local.toarray(), dense)


@pytest.mark.parametrize("n,ndev", [(2048, 2), (2049, 4), (5, 8)])
def test_local_row_range_equals_jax(n, ndev):
    from cpkrylov_tpu.parallel.bootstrap import (
        local_row_range as jax_row_range)
    from cpkrylov_tpu_torch.parallel.bootstrap import local_row_range

    for d in range(ndev):
        assert local_row_range(n, ndev, d) == jax_row_range(n, ndev, d)


def test_bootstrap_takes_the_backend_explicitly():
    from cpkrylov_tpu_torch.parallel.bootstrap import init_process_group

    with pytest.raises(ValueError, match="backend"):
        init_process_group("mpi", 0, 1, "tcp://127.0.0.1:1", device="cpu")


def _fail_on_rank_one(comm):
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails")
    return comm.rank


def test_a_failing_rank_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(_fail_on_rank_one, 2, backend="gloo", device="cpu",
                  timeout_s=300)


def test_halo_plan_rejects_wide_reach():
    A = sp.lil_matrix((64, 64))
    A[0, :] = 1.0
    with pytest.raises(ValueError, match="halo width"):
        plan_halo_block(A.tocsr(), _host_comm(0, 4), 16, 16, max_halo=8)


def test_schur_rejects_wide_interface():
    s_ = random_sqd_system(64, 24, density=0.4, seed=0)
    ksp = assemble_kp(s_.G, s_.B, s_.C)
    with pytest.raises(ValueError, match="interface"):
        plan_schur_share(ksp, 64, 24, _host_comm(0, 4), max_interface=4)


def _assert_share_equal(mine: SchurShare, ref: SchurShare):
    np.testing.assert_array_equal(mine.interior, ref.interior)
    np.testing.assert_array_equal(mine.s_nat, ref.s_nat)
    np.testing.assert_allclose(mine.a_ds.toarray(), ref.a_ds.toarray(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(mine.s_inv, ref.s_inv, rtol=1e-12,
                               atol=1e-12)
    assert (mine.exchange is None) == (ref.exchange is None)
    if mine.exchange is not None:
        for k, v in ref.exchange.items():
            np.testing.assert_array_equal(mine.exchange[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The workers' results
# ---------------------------------------------------------------------------

def test_ranks_agree(run):
    """Every rank took the same counts (the replicated scalar state)."""
    def counts(r):
        return {k: v for k, v in r["counts"].items()
                if not k.startswith("share_")}

    assert all(counts(r) == counts(run["ranks"][0]) for r in run["ranks"])


@pytest.mark.parametrize("g_mode", ["diag", "banded"])
def test_schur_plan_equals_jax(run, g_mode):
    """Each rank's share of the port's Schur plan equals the JAX plan's
    share of that device: interior, interface, A_dS, S^-1, exchange."""
    M, _ = run["jax_schur"][g_mode]
    for d, r in enumerate(run["ranks"]):
        _assert_share_equal(r["counts"][f"share_{g_mode}"],
                            convert.schur_from_jax(M.factor, d))


def test_halo_matvec_equals_allgather(run):
    r0 = run["ranks"][0]
    for name in ("a", "c"):
        y_halo, y_gather = r0[f"halo_{name}"]
        assert _rel(y_halo, y_gather) <= 1e-14, name


@pytest.mark.parametrize("g_mode", ["diag", "banded"])
def test_schur_solve_is_exact(run, g_mode):
    """Against scipy's spsolve of K_P (the port's own plan and the JAX
    plan), against the JAX SchurFactor given the same plan, and the
    sharded solve against the full-vector one.  The preconditioner's
    application runs on full vectors, or on the slices with K_P's row
    blocks where the plan has an exchange (then no global K_P is kept)."""
    ss = _schur_sys(g_mode)
    yref = spla.spsolve(assemble_kp(ss.G, ss.B, ss.C).tocsc(),
                        _z(ss.n + ss.m))
    r0 = run["ranks"][0]
    _, y_jax = run["jax_schur"][g_mode]
    for which in ("own", "jax"):
        res = r0[f"schur_{g_mode}_{which}"]
        assert _rel(res["solve"], yref) < 1e-12, which
        assert _rel(res["apply"], yref) < 1e-12, which
        # a sharded factor keeps no global K_P and refuses the gather mode
        assert res["kp_none"] == res["shard"], which
        if res["shard"]:
            assert _rel(res["sharded"], res["solve"]) < 1e-12, which
            assert res["gather_refused"], which
    assert _rel(r0[f"schur_{g_mode}_jax"]["solve"], y_jax) < 1e-12
    assert r0[f"schur_{g_mode}_own"]["s"] == r0[f"schur_{g_mode}_jax"]["s"]


def _check_family(run, methods):
    r0 = run["ranks"][0]
    for method, _ in methods:
        for fac in ("schur", "rep"):
            key = f"{method}_{fac}"
            k, solved = r0["counts"][key]
            k_jax, x_jax = run["jax"][key]
            assert solved, key
            assert abs(k - k_jax) <= 1, (key, k, k_jax)
            assert abs(k - run["serial"][method]) <= 1, (
                key, k, run["serial"][method])
            assert _rel(r0[f"x_{key}"], x_jax) < 1e-8, key


def test_dist_solve_matches_jax_and_serial(run):
    _check_family(run, run["methods"])


def test_dist_cpminres_matches_jax_and_serial(run):
    r0 = run["ranks"][0]
    k, _ = r0["counts"]["dist_cpminres"]
    k_jax, x_jax = run["jax"]["dist_cpminres"]
    assert abs(k - k_jax) <= 1, (k, k_jax)
    assert abs(k - run["serial"]["dist_cpminres"]) <= 1
    assert _rel(r0["x_dist_cpminres"], x_jax) < 1e-8


def test_dist_solve_ghn_itref_on_slices(run):
    """The main path's preconditioner options through the Schur factor
    (the GHN update and forced refinement on the slices, where the plan has
    an exchange): the serial count and x."""
    r0 = run["ranks"][0]
    k, solved = r0["counts"]["ghn"]
    k_ser, x_ser = run["serial"]["ghn"]
    assert solved and abs(k - k_ser) <= 1, (k, k_ser)
    assert _rel(r0["x_ghn"], x_ser) < 1e-8


def test_dist_cpminres_lean_schur_apply(run):
    """A Schur factor with no refinement and no GHN applies on the slices
    (where its plan has an exchange) and keeps the serial count."""
    r0 = run["ranks"][0]
    k, mode, sharded = r0["counts"]["lean"]
    k_ser, x_ser = run["serial"]["lean"]
    assert mode == ("sharded_lean" if sharded else "gather")
    assert abs(k - k_ser) <= 1, (k, k_ser)
    assert _rel(r0["x_lean"], x_ser) < 1e-6


def test_dist_cpminres_sqd_matches_serial(run):
    """random_sqd_system(96, 40): the hand-fused path against the port's
    serial kernel on the same unshifted system."""
    from cpkrylov_tpu_torch.solvers.cpminres import cpminres

    q = random_sqd_system(96, 40, seed=17, delta=1e-2)
    opts = cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=200)
    M = cpt.make_preconditioner(q.G, q.B, q.C, panel=16, dtype=F64,
                                device="cpu")
    ref = cpminres(torch.as_tensor(q.b[: q.n]), torch.as_tensor(
        q.A.toarray()), torch.as_tensor(q.C.toarray()), M, opts)
    x, y, k, resid, hist = run["ranks"][0]["sqd"]
    stop = opts.atol + opts.rtol * hist[0]
    assert resid <= 10 * stop, (resid, stop)
    np.testing.assert_allclose(x, ref.x.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(y, ref.y.numpy(), rtol=1e-6, atol=1e-8)
    ncmp = min(5, k, ref.niters)
    np.testing.assert_allclose(hist[:ncmp], ref.resid_history[:ncmp],
                               rtol=1e-4)


def test_dist_solve_mixed_reaches_f64_contract(run):
    s_ = banded_saddle_system(BANDED["n"], BANDED["m"],
                              bandwidth=BANDED["bandwidth"])
    solved, x, nouter, niters = run["ranks"][0]["mixed"]
    assert solved, (nouter, niters)
    r = s_.b - s_.K @ x
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(s_.b)
    assert nouter >= 1 and niters > 0


@pytest.mark.slow
def test_more_solvers_at_two_ranks():
    """CPCG, CP-CG-Lanczos, CPSYMMLQ and CPDQGMRES on two ranks, against
    the JAX package and the port's serial solves."""
    run2 = _run((2,), MORE)[2]
    _check_family(run2, MORE)


def test_no_group_keeps_serial_bits(cvxqp1):
    """Outside any group the reductions are the plain local dots, and the
    serial golden count (53 +- 2, BASELINE.md) holds."""
    from cpkrylov_tpu_torch.solvers import common

    assert common._REDUCE_GROUP.get() is None
    g = torch.Generator().manual_seed(0)
    u, v, t, q = (torch.randn(50, dtype=F64, generator=g) for _ in range(4))
    assert torch.equal(common.coupled_dot(u, v, t, q),
                       torch.dot(u, v) + torch.dot(t, q))
    with common.reduce_group(None):
        assert torch.equal(common.vdot(u, v), torch.dot(u, v))
    out = cpt.solve("cpminres", cvxqp1.b, cvxqp1.A, cvxqp1.B, cvxqp1.C,
                    cvxqp1.G, device="cpu", dtype=F64,
                    opts=cpt.SolverOptions(itmax=500))
    assert out.solved and abs(out.niters - 53) <= 2
