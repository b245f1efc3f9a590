"""Device-time profile of a solve, read from one ``torch.profiler`` trace.

:func:`device_profile` runs a callable once under the profiler and reads
the trace it wrote: the wall time of a named span (one of the spans below,
``SOLVE_SPAN`` by default), the device's busy time inside that span (the
union of its kernel, memcpy and memset intervals), and the host's kernel
launches.  Busy
time and wall time come from the same trace, so the idle share they give is
that of the profiled run: the profiler's own host overhead counts as idle,
which makes it an upper bound of the unprofiled idle share.

Port of ``cpkrylov_tpu/utils/profiling.py``: :func:`trace` writes a
Chrome trace of the enclosed block; :func:`work_model` is the static
per-iteration work in nonzeros touched (2 SpMVs + the preconditioner's
direct solves and K_P products, SURVEY.md section 3.2), and
:func:`profile_solve` times a solve (first call apart, then the best of
warm repeats) and reports iterations/s and work-model nnz/s.  The work
model counts entries, not bytes: it implies no bandwidth.

Counters.  Every counter of the port lives in ``COUNTS``, this module's
registry, and grows only through :func:`count`.  The kernel counters
(``KERNELS``) hold the launches of the hand-written kernels B1-B10: each
wrapper declares its entries with the keys they add to
(``_build.Entry``), so a run can show which kernels carried it.  The path
counters (``PATHS``) hold the paths a solve took:

* ``mixed_device_loops``: the unforced device loops of
  ``mixed.solve_mixed`` that reached ``dispatch()``; ``mixed_fallbacks``,
  those of them that did not converge and sent the solve to the host loop;
* ``dia_card_packs``: the DIA placements of ``ops/dia.py::place_dia`` made
  on a CUDA device; ``dia_gate_refusals``, the CUDA-device attempts whose
  padded diagonals failed the caller's gate, which then keeps CSR;
* ``tri_reduced_scan_builds``, ``tri_block_builds``,
  ``tri_bidiag_builds``: the triangles that ``precond/cp.py::_build_tri``
  and ``_build_tri_upper`` built in each form, on any device;
* ``block_card_packs``: the blocked-substitution factors that
  ``precond/trisolve.py::build_block_tri`` placed on a CUDA device;
* ``scan_pack_us``: the host microseconds spent in
  ``precond/trisolve.py::pack_reduced_scan_np``;
* ``scan_grid_launches``, ``scan_cluster_launches``: the B6 scans of
  ``precond/cuda_tri.py`` on the persistent grid and on one cluster;
* ``gmres_restarts``: the restart blocks of ``solvers/cpgmres.py`` (the
  triangular solve, basis combination and reseed that end each sweep, the
  last one included).

:func:`launch_counts` and :func:`path_counts` read the two kinds;
:func:`reset_launches` sets every counter to 0.  A new counter is its name
in ``KERNELS`` or ``PATHS`` and the line that counts.

Spans.  Every span of the port is a ``torch.profiler.record_function``
span opened through :func:`span`, which costs one check of the profiler's
state when no profiler records.  The spans sit in the same trace as the
device's records, on its clock:

* ``cpkrylov.solve`` (``SOLVE_SPAN``): ``driver.solve``'s Krylov iteration
  and its final synchronize;
* ``cpkrylov.operands``: ``driver.solve``'s packing of A, B, C and b onto
  the device, with the synchronize that ends it;
* ``cpkrylov.upload``: every host-to-device copy of the request and build
  paths (``utils.device.upload``);
* ``cpkrylov.build``: ``make_preconditioner``; inside it
  ``cpkrylov.build.order`` (K_P's assembly and ordering),
  ``cpkrylov.build.ldl`` (the host factorization), ``cpkrylov.build.probe``
  (the probe solve and the df64 re-probe) and ``cpkrylov.build.pack`` (the
  factor's and K_P's device packs; the df64 rebuild sits inside the probe);
  inside a pack ``cpkrylov.build.scan_pack``, one host packing of a
  reduced-scan triangle (``pack_reduced_scan_np``: the panels' trtri and
  the batched matmul);
* ``cpkrylov.solve_mixed`` (``MIXED_SPAN``): a whole ``mixed.solve_mixed``;
  inside it ``cpkrylov.mixed.pack`` (``prepare_mixed_device``'s packing),
  ``cpkrylov.mixed_loop`` (``MIXED_LOOP_SPAN``, the device loop),
  ``cpkrylov.mixed.readback`` (the answer to the host) and
  ``cpkrylov.mixed.host_loop`` (the host loop);
* ``cpkrylov.apply``: one ``CPPrecond.apply``;
* ``cpkrylov.arnoldi``: one Arnoldi step's Gram-Schmidt and rotations in
  ``solvers/cpgmres.py`` (after the step's products and apply, before its
  read of the residual); ``cpkrylov.gmres.restart``: one restart block
  there (the triangular solve, the basis combination and the reseed);
* ``cpkrylov.host_read``: one device-to-host read of a value the host
  loop needs (``utils.device.host_read``): the kernels' stopping tests,
  the refinement trigger of ``CPPrecond.apply``, the mixed device loop's
  scalars.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

SOLVE_SPAN = "cpkrylov.solve"   # record_function span around the iteration
MIXED_SPAN = "cpkrylov.solve_mixed"   # ... around a whole mixed solve
MIXED_LOOP_SPAN = "cpkrylov.mixed_loop"   # ... around its device loop
OPERANDS_SPAN = "cpkrylov.operands"       # driver.solve: A, B, C, b on device
UPLOAD_SPAN = "cpkrylov.upload"           # one host-to-device copy
BUILD_SPAN = "cpkrylov.build"             # make_preconditioner
BUILD_ORDER_SPAN = "cpkrylov.build.order"     # assemble K_P, choose ordering
BUILD_LDL_SPAN = "cpkrylov.build.ldl"         # the host factorization
BUILD_PROBE_SPAN = "cpkrylov.build.probe"     # the build probe solve(s)
BUILD_PACK_SPAN = "cpkrylov.build.pack"       # factor and K_P device packs
BUILD_SCAN_PACK_SPAN = "cpkrylov.build.scan_pack"  # a reduced-scan host pack
MIXED_PACK_SPAN = "cpkrylov.mixed.pack"       # prepare_mixed_device's packing
MIXED_READBACK_SPAN = "cpkrylov.mixed.readback"   # device answer to host
MIXED_HOST_LOOP_SPAN = "cpkrylov.mixed.host_loop"  # the host outer loop
APPLY_SPAN = "cpkrylov.apply"             # CPPrecond.apply
ARNOLDI_SPAN = "cpkrylov.arnoldi"         # cpgmres: a step's Gram-Schmidt
GMRES_RESTART_SPAN = "cpkrylov.gmres.restart"  # cpgmres: one restart block
HOST_READ_SPAN = "cpkrylov.host_read"     # one device-to-host read

# the counter registry: the kernels' launches (B1-B10), then the paths
KERNELS = ("dia_spmv", "bidiag_scan", "df_dia_spmv", "band_tri", "csr_spmv",
           "affine_scan", "interleave", "uninterleave", "block_tri",
           "df_tri_matvec")
PATHS = ("mixed_device_loops", "mixed_fallbacks", "dia_card_packs",
         "dia_gate_refusals", "tri_reduced_scan_builds", "tri_block_builds",
         "tri_bidiag_builds", "scan_pack_us", "scan_grid_launches",
         "scan_cluster_launches", "block_card_packs", "gmres_restarts")
COUNTS = dict.fromkeys(KERNELS + PATHS, 0)
_COUNTS_LOCK = threading.Lock()

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """What one profiled span shows (times in ms on the trace's clock)."""

    wall_ms: float      # the span's host duration
    busy_ms: float      # union of device activity inside the span
    device_ops: int     # kernels, copies and memsets inside the span
    launches: int       # host kernel-launch calls inside the span
    table: str          # key_averages table of the whole profiled call

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.wall_ms if self.wall_ms > 0 else 0.0


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span called ``name`` while a profiler records;
    otherwise a shared null context, so that a span costs one check of the
    profiler's state when nobody traces."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(key: str, k: int = 1) -> None:
    """Add ``k`` to the registry's counter ``key``."""
    with _COUNTS_LOCK:
        COUNTS[key] += k


def launch_counts() -> dict:
    """Each kernel's launches since the counters were last reset."""
    return {key: COUNTS[key] for key in KERNELS}


def path_counts() -> dict:
    """Each path counter since the counters were last reset."""
    return {key: COUNTS[key] for key in PATHS}


def reset_launches() -> None:
    """Set every kernel's launch counter and every path counter to 0."""
    with _COUNTS_LOCK:
        for key in COUNTS:
            COUNTS[key] = 0


def union_ms(intervals, lo: float, hi: float) -> float:
    """Total length (µs in, ms out) of the union of ``(start, end)``
    intervals clipped to ``[lo, hi]``."""
    total, cursor = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, cursor), min(e, hi)
        if e > s:
            total += e - s
            cursor = e
    return total / 1e3


def summarize_trace(events, table: str = "",
                    span: str = SOLVE_SPAN) -> DeviceProfile:
    """Read a Chrome-trace event list: the last ``span`` annotation and the
    device activity and launches inside it."""
    spans = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not spans:
        raise ValueError(f"the trace holds no {span!r} span")
    lo = float(spans[-1]["ts"])
    hi = lo + float(spans[-1]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") in _DEVICE_CATS
           and e.get("ph") == "X"]
    inside = [(s, e) for s, e in dev if e > lo and s < hi]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") in _LAUNCH_NAMES
                   and lo <= float(e["ts"]) <= hi)
    return DeviceProfile(wall_ms=(hi - lo) / 1e3,
                         busy_ms=union_ms(inside, lo, hi),
                         device_ops=len(inside), launches=launches,
                         table=table)


def device_profile(fn, *, trace_path: str | None = None,
                   span: str = SOLVE_SPAN) -> DeviceProfile:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and, when present,
    CUDA activity) and summarize its last ``span``.  The Chrome trace is
    kept at ``trace_path`` when one is given."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        fn()
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return summarize_trace(events, table, span)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace over the enclosed block (host ops and, with
    CUDA, device kernels), written as a Chrome trace ``trace.json`` into
    ``logdir`` for Perfetto or chrome://tracing."""
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass(frozen=True)
class WorkModel:
    """Static per-iteration work in nonzeros touched (SURVEY.md 3.2)."""

    nnz_a: int              # A*v
    nnz_c: int              # C*q
    nnz_factor: int         # one direct solve: trisolves + diag + perms
    nnz_kp: int             # one K_P SpMV (refinement residual / GHN cache)
    solves_per_iter: float  # direct solves per iteration (incl. refinement)
    kp_spmv_per_iter: float

    @property
    def nnz_per_iter(self) -> float:
        return (self.nnz_a + self.nnz_c
                + self.solves_per_iter * self.nnz_factor
                + self.kp_spmv_per_iter * self.nnz_kp)


def _factor_nnz(M) -> int:
    """Arithmetic volume of one direct solve: each factor form reports its
    own (``work_nnz``), plus the block-diagonal scale.  A distributed
    ``SchurFactor`` reports this rank's share (``parallel/schur.py``)."""
    f = M.factor
    if hasattr(f, "local_factor"):          # parallel.schur.SchurFactor
        return f.work_nnz
    return f.tf1.work_nnz + f.tf2.work_nnz + int(f.dinv.shape[0])


def work_model(M, nnz_a: int, nnz_c: int) -> WorkModel:
    """Work model for a solve with preconditioner ``M`` (``CPPrecond``)."""
    opts = M.options
    # Each direct solve runs factor_nitref refinement passes
    # (CPPrecond._direct_solve), each one K_P SpMV and one factor solve.
    per_direct_solves = 1 + M.factor_nitref
    per_direct_kp = M.factor_nitref
    # The kernel applies M once an iteration; opts.nitref adds up to nitref
    # outer refinement passes (always taken when force_itref).
    outer = opts.nitref if opts.force_itref else 0
    kp_spmv = per_direct_kp * (1 + outer) + (1 if opts.nitref > 0 else 0) \
        + outer + (1 if opts.residual_update else 0)
    return WorkModel(
        nnz_a=int(nnz_a), nnz_c=int(nnz_c),
        nnz_factor=_factor_nnz(M), nnz_kp=int(M.kp.nnz),
        solves_per_iter=float(per_direct_solves * (1 + outer)),
        kp_spmv_per_iter=float(kp_spmv),
    )


@dataclasses.dataclass(frozen=True)
class SolveProfile:
    """Measured solve performance, the first call apart."""

    method: str
    niters: int
    solved: bool
    ptime: float            # preconditioner build (host factorization)
    compile_time: float     # the first call: kernel build, first launches
    stime: float            # warm solve wall clock (best of repeats)
    iters_per_s: float
    nnz_per_s: float        # work-model nnz / stime
    work: WorkModel
    # the last timed call's SolveOutput (not in the JAX package's profile)
    output: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def summary(self) -> str:
        return (f"{self.method}: {self.niters} iters in {self.stime:.4f}s "
                f"({self.iters_per_s:.1f} it/s, {self.nnz_per_s:.3g} nnz/s; "
                f"compile {self.compile_time:.2f}s, "
                f"precond build {self.ptime:.2f}s)")


def _nnz(X) -> int:
    import scipy.sparse as sp

    if sp.issparse(X):
        return int(X.nnz)
    if isinstance(X, torch.Tensor):
        return int(torch.count_nonzero(X))
    if isinstance(X, np.ndarray):
        return int(np.count_nonzero(X))
    return 0                                # an operator: no stored entries


def profile_solve(method, b, A, B, C, G, *, opts=None, precond_opts=None,
                  repeats: int = 3, trace_dir: str | None = None,
                  device=None, **solve_kwargs) -> SolveProfile:
    """Profile ``cpkrylov_tpu_torch.solve`` on ``device`` (default the CUDA
    card): build the preconditioner, make a first call, then time
    ``repeats`` warm calls and keep the best.

    ``compile_time`` is the first call's wall time: on the card it holds
    the CUDA kernels' build (when the process has not built them yet) and
    their first launches; on the CPU nothing is compiled, and it is one
    more call.  When ``trace_dir`` is given, one traced call is written
    there (:func:`trace`).  ``output`` holds the last timed call's
    ``SolveOutput``."""
    from ..driver import solve
    from ..precond.cp import make_preconditioner
    from .device import resolve_device
    from .timing import sync

    device = resolve_device(device)
    dtype = solve_kwargs.get("dtype") or np.asarray(b).dtype
    t0 = time.perf_counter()
    M = make_preconditioner(G, B, C, options=precond_opts, dtype=dtype,
                            device=device)
    sync(device)
    ptime = time.perf_counter() - t0

    def call():
        return solve(method, b, A, B, C, G, opts=opts,
                     precond_opts=precond_opts, M=M, device=device,
                     **solve_kwargs)

    t0 = time.perf_counter()
    call()
    compile_time = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, repeats)):
        t1 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t1)
    if trace_dir is not None:
        with trace(trace_dir):
            call()

    work = work_model(M, _nnz(A), _nnz(C))
    niters = int(out.niters)
    return SolveProfile(
        method=method if isinstance(method, str) else method.__name__,
        niters=niters, solved=bool(out.solved), ptime=ptime,
        compile_time=compile_time, stime=best,
        iters_per_s=niters / best if best > 0 else float("inf"),
        nnz_per_s=niters * work.nnz_per_iter / best if best > 0 else 0.0,
        work=work, output=out,
    )
