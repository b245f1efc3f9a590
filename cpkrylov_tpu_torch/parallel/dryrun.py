"""Run a function on n ranks of a fresh gloo or NCCL group, and the
distributed dry run: solves checked for CONVERGENCE and serial iteration
parity, not just finiteness.

Counterpart of ``cpkrylov_tpu/parallel/dryrun.py``.  :func:`run_ranks`
spawns one process per rank (``torch.multiprocessing``, spawn start
method), joins each to a new process group through a file store in a
fresh temporary directory (no port to race for) and calls
``fn(comm, *args)`` there; it returns the ranks' results in rank order.  A
rank that raises makes the whole run raise (the others are terminated).

:func:`run_dryrun` checks the two distributed paths on
``banded_saddle_system(2048, 512, bandwidth=3)`` in f64:

* ``dist_cpminres``, the hand-fused CPMINRES, on the b2 = 0 system with the
  replicated factor;
* ``dist_solve`` with CPMINRES and CPGMRES (shifted RHS, the default
  preconditioner: the Schur factor where the system allows it);
* ``dist_solve`` CPMINRES with the main path's preconditioner options
  (GHN update, forced refinement) through the Schur factor on the slices,
  on the same sizes with a banded G and a slope-matched B, where the plan
  has an interface (s > 0) and a sharded exchange; on the card its A_dS
  products must launch B5.

Each asserts ``solved``, a count within +-1 of the port's serial solve and
x within 1e-6 relative of the serial x.
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time

import numpy as np


def _rank_main(rank, fn, world_size, init_method, backend, device, args,
               results):
    from .bootstrap import init_process_group

    comm = init_process_group(backend, rank, world_size, init_method,
                              device=device)
    try:
        results.put((rank, fn(comm, *args)))
    finally:
        comm.close()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              device=None, timeout_s: float = 1800.0) -> list:
    """``[fn(comm, *args) on rank r for r in range(world_size)]``, each rank
    in a process of its own.  ``fn`` and ``args`` must pickle (``fn`` by
    its import path); ``device`` is every rank's device (None:
    ``cuda:<rank>``; "cuda:0" when ranks share a card; "cpu")."""
    import torch.multiprocessing as tmp

    results = tmp.get_context("spawn").Queue()
    store_dir = tempfile.mkdtemp(prefix="cpkt_ranks_")
    init_method = "file://" + os.path.join(store_dir, "store")
    try:
        pc = tmp.start_processes(
            _rank_main, args=(fn, world_size, init_method, backend,
                              None if device is None else str(device), args,
                              results),
            nprocs=world_size, join=False, start_method="spawn")
        out = {}
        deadline = time.monotonic() + timeout_s
        done = False
        while not done:
            # drain the queue before joining: a writer blocks until read
            try:
                while True:
                    rank, value = results.get(timeout=0.2)
                    out[rank] = value
            except queue_mod.Empty:
                pass
            done = pc.join(timeout=0.2)
            if not done and time.monotonic() > deadline:
                for p in pc.processes:
                    p.terminate()
                raise TimeoutError(f"run_ranks: no result in {timeout_s} s")
        while len(out) < world_size:
            rank, value = results.get(timeout=60)
            out[rank] = value
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _dryrun_rank(comm):
    """One rank's checks of :func:`run_dryrun`; raises on a failure."""
    import torch

    from ..config import PrecondOptions, SolverOptions
    from ..driver import solve
    from ..precond.cp import make_preconditioner
    from ..utils.fixtures import banded_saddle_system
    from ..utils.profiling import launch_counts, reset_launches
    from .cpminres import dist_cpminres
    from .partition import partition_blocks, shard_vector, unshard_vector
    from .schur import plan_schur_precond
    from .solve import dist_solve

    dtype = torch.float64
    drift_tol = 1e-6   # serial-vs-distributed solution drift at f64
    n, m = 2048, 512
    sys_ = banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    opts = SolverOptions(atol=0.0, rtol=1e-6, itmax=400)
    dev = comm.device

    def rel(x, ref):
        ref = ref.cpu().numpy()
        return (np.linalg.norm(x.cpu().numpy() - ref)
                / max(np.linalg.norm(ref), 1e-300))

    counts = {}
    # the hand-fused path on the b2 = 0 system, replicated factor
    b0 = np.concatenate([sys_.b[:n], np.zeros(m)])
    serial = solve("cpminres", b0, sys_.A, sys_.B, sys_.C, sys_.G,
                   opts=opts, dtype=dtype, device=dev)
    _check(serial.solved, f"serial cpminres: status {serial.istatus}")
    M = make_preconditioner(sys_.G, sys_.B, sys_.C, dtype=dtype, device=dev)
    blocks = partition_blocks(sys_.A, sys_.B, sys_.C, comm, dtype=dtype)
    b_loc = shard_vector(sys_.b[:n], comm, blocks.n_loc, dtype)
    x_loc, _, k, _, _ = dist_cpminres(comm, blocks, M, b_loc, opts)
    x = unshard_vector(x_loc, n, comm)
    _check(bool(torch.isfinite(x).all()), "dist_cpminres: x not finite")
    _check(abs(k - serial.niters) <= 1, (
        f"dist_cpminres iteration drift: {k} vs serial {serial.niters}"))
    err = rel(x, serial.x1)
    _check(err < drift_tol, f"dist_cpminres solution drift: {err}")
    counts["dist_cpminres"] = (k, serial.niters)

    # the generic family path (shifted RHS): CPMINRES and CPGMRES
    for method, extra in (("cpminres", {}), ("cpgmres", {"restart": 50})):
        mopts = SolverOptions(atol=0.0, rtol=1e-6, itmax=500, **extra)
        sref = solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                     opts=mopts, dtype=dtype, device=dev)
        _check(sref.solved, f"serial {method}: status {sref.istatus}")
        res, x1, _ = dist_solve(comm, method, sys_.b, sys_.A, sys_.B,
                                sys_.C, sys_.G, opts=mopts, dtype=dtype)
        _check(res.solved, f"dist_solve({method}) did not converge")
        _check(abs(res.niters - sref.niters) <= 1, (
            f"dist_solve({method}) iteration drift: {res.niters} vs "
            f"serial {sref.niters}"))
        err = rel(x1, sref.x1)
        _check(err < drift_tol,
               f"dist_solve({method}) solution drift: {err}")
        counts[f"dist_solve_{method}"] = (res.niters, sref.niters)

    # the main path's options through the Schur factor on the slices, on a
    # system whose plan has an interface: banded G, slope-matched B
    popts = PrecondOptions(residual_update=True, nitref=1, force_itref=True)
    sysb = banded_saddle_system(n, m, bandwidth=3, with_oracle=False,
                                b_mode="slope", g_mode="banded")
    Ms = plan_schur_precond(sysb.G, sysb.B, sysb.C, comm, options=popts,
                            panel=16, dtype=dtype)
    f = Ms.factor
    _check(f.has_shard_plan and f.s > 0,
           f"Schur plan: s = {f.s}, exchange {f.has_shard_plan}")
    sref = solve("cpminres", sysb.b, sysb.A, sysb.B, sysb.C, sysb.G,
                 opts=opts, precond_opts=popts, panel=16, dtype=dtype,
                 device=dev)
    reset_launches()
    res, x1, _ = dist_solve(comm, "cpminres", sysb.b, sysb.A, sysb.B,
                            sysb.C, sysb.G, opts=opts, M=Ms, dtype=dtype)
    _check(dev.type != "cuda" or launch_counts()["csr_spmv"] > 0,
           "sharded Schur dist_solve: the A_dS products launched no B5")
    _check(res.solved, "sharded Schur dist_solve did not converge")
    _check(abs(res.niters - sref.niters) <= 1, (
        f"sharded Schur dist_solve iteration drift: {res.niters} vs "
        f"serial {sref.niters}"))
    err = rel(x1, sref.x1)
    _check(err < drift_tol, f"sharded Schur dist_solve drift: {err}")
    counts["dist_solve_schur_sharded"] = (res.niters, sref.niters)
    return counts


def run_dryrun(n_ranks: int, device=None) -> dict:
    """The dry run on ``n_ranks`` gloo ranks that all use ``device`` (the
    CUDA card when None; "cpu" on request).  Returns rank 0's counts
    ``{path: (distributed, serial)}``; raises if any rank fails."""
    from ..utils.device import resolve_device

    device = resolve_device(device if device is not None else "cuda:0")
    return run_ranks(_dryrun_rank, n_ranks, backend="gloo",
                     device=device)[0]
