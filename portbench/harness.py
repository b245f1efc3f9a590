"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the system, its generator and the
solver settings) and a traffic mix (``mixes/<traffic>.json``: the pool, the
checks, the precision, and the kind of request, ``requests/<kind>.py``, that
draws the pool and may shape the call).  Set-up draws every input of the run
from the seed into a pool, builds what the mix builds in set-up, and warms
the request path.  The window then calls ``cpkrylov_tpu_torch.solve`` in a
closed loop, one caller waiting for each answer, for the run's seconds.
Afterwards the plain reference (``reference/``) judges a sample of the
answers drawn from the seed, against the cell's limits
(``limits/<cell>.json``), and each metric's reader (``metrics/<metric>.py``)
reads its number from the run.  Nothing here
names a cell, a mix, a kind of request or a metric: each is found by its
name.
"""
from __future__ import annotations

import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from .reference.residual import residual_ratio
from .trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(HERE, "out")
REQUEST_SPAN = "portbench.request"
#: top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cpkrylov_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def names(kind: str, ext: str) -> list:
    """The names of the files of one kind (``mixes``, ``metrics``, ...)."""
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(HERE, kind, "*" + ext)))


def _load(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded from its file."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, each where its ``workloads`` list
    (if any) names the cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Request:
    """One call of the entry in the window."""

    index: int
    pool_index: int
    wall_s: float
    ptime_s: float
    niters: int
    solved: bool
    span: tuple | None = None      # (start, end) µs on the trace's clock,
    #                                for a traced request


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    mix: dict
    setup_s: float
    window_s: float
    requests: list
    trace: Trace | None = None
    triangles: dict = dataclasses.field(default_factory=dict)
    value_bytes: int = 8
    dtype_name: str = "float64"

    @property
    def traced(self) -> list:
        return [r for r in self.requests if r.span is not None]

    def traced_window(self):
        """(start, end) µs of the traced stretch of whole requests."""
        spans = [r.span for r in self.traced]
        return spans[0][0], spans[-1][1]

    def loop_spans(self, req: Request) -> list:
        lo, hi = req.span
        return [(s, e) for s, e in self.trace.spans(self.mix["loop_span"])
                if s >= lo and e <= hi]


def _rng(seed: int, *salt: int):
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def _torch_dtype(torch, name: str):
    return {"float64": torch.float64, "float32": torch.float32}[name]


class Cell:
    """The inputs and the request of one cell, drawn from one seed."""

    def __init__(self, bench: dict, workload: str, seed: int, *,
                 config: dict | None = None):
        entry = next((w for w in bench["workloads"]
                      if w["name"] == workload), None)
        if entry is None:
            raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entry
        self.config = config or load_json(
            ROOT, next(c["file"] for c in bench["configs"]
                       if c["name"] == entry["config"]))
        self.mix = load_json(HERE, "mixes", entry["traffic"] + ".json")
        fam = importlib.import_module(
            "portbench.gen." + self.config["family"]).Family(
                self.config["generator"])
        solver = self.config["solver"]
        self.dtype_name = (solver["dtype"] if self.mix["dtype"] == "config"
                           else self.mix["dtype"])
        self.atol, self.rtol = float(solver["atol"]), float(solver["rtol"])
        self.kind = _load("requests", self.mix["request"])
        streams = [_rng(seed, 0, i) for i in range(int(self.mix["pool"]))]
        self.base, self.pool = self.kind.draw(fam, streams, self.mix)

    def system(self, i: int):
        """(system, rhs) of request i: the pool in order, reused in turn."""
        return self.pool[i % len(self.pool)]


#: the control of ``correct``: the program's own path one precision down
#: (``portbench/control.py``)
CONTROL = {"dtype": "float32", "refine": False}


def _program(cell: Cell, device: str, *, dtype: str | None = None,
             refine: bool | None = None):
    """The program's side: its options, the preconditioner the mix builds
    in set-up, and the call of one request on (system, rhs).  ``dtype``
    and ``refine`` replace the mix's (the control)."""
    import torch

    import cpkrylov_tpu_torch as cpt

    cfg, mix = cell.config, cell.mix
    s = cfg["solver"]
    refine = bool(mix.get("refine")) if refine is None else refine
    # The mixed form's options (bench.py:180-184) where the call refines.
    stagwin = cfg["mixed"]["stagwin"] if refine else s["stagwin"]
    opts = cpt.SolverOptions(atol=s["atol"], rtol=s["rtol"],
                             itmax=s["itmax"], stagwin=stagwin)
    popts = cpt.PrecondOptions(**cfg["precond"])
    dtype = _torch_dtype(torch, dtype or cell.dtype_name)
    M = None
    if mix["M"] == "setup":
        b0 = cell.base
        M = cpt.make_preconditioner(b0.G, b0.B, b0.C, options=popts,
                                    panel=cfg["panel"], dtype=dtype,
                                    device=device)
    kw = dict(opts=opts, precond_opts=popts, panel=cfg["panel"], dtype=dtype,
              device=device, M=M, refine=refine)
    shape = getattr(cell.kind, "call", None)

    def call(sysm, b):
        if shape is not None:
            return shape(cpt.solve, sysm, b, method=s["method"], **kw)
        return cpt.solve(s["method"], b, sysm.A, sysm.B, sysm.C, sysm.G,
                         **kw)

    return call, M


def _triangles(cell: Cell, kernel_maps: dict, requests: range) -> dict:
    """pool index -> (stored entries, rows) of the host factor's triangle L,
    for the traced requests, where a kernel map counts by the triangle."""
    if not any(k.get("count") == "triangle" for k in kernel_maps.values()):
        return {}
    from cpkrylov_tpu_torch.precond.cp import factorize_kp

    out = {}
    for i in requests:
        sysm, _ = cell.system(i)
        key = id(sysm)
        if key not in out:
            L = getattr(factorize_kp(sysm.G, sysm.B, sysm.C).fac, "L", None)
            out[key] = None if L is None else (int(L.nnz), int(L.shape[0]))
    return {i % len(cell.pool): out[id(cell.system(i)[0])] for i in requests}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", bench: dict | None = None,
             config: dict | None = None, limits: dict | None = None,
             program: dict | None = None):
    """One run: returns (result dict, check lines).  ``config`` and
    ``limits`` replace the cell's files (the CPU tests run tiny sizes);
    ``program`` replaces the call's dtype and refine (``CONTROL``)."""
    import torch

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, workload, seed, config=config)
    limits = limits or load_json(HERE, "limits", workload + ".json")
    mix = cell.mix
    on_card = device != "cpu"
    card = power_limit() if on_card else None
    kernel_maps = {n: load_json(HERE, "kernels", n + ".json")
                   for n in names("kernels", ".json")}
    call, M = _program(cell, device, **(program or {}))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for w in range(int(mix["warm"])):
        call(*cell.system(w))
    sync()
    ntrace = int(mix["trace_requests"]) if trace else 0
    triangles = _triangles(cell, kernel_maps, range(ntrace)) if trace else {}

    checks_k = int(mix["checks"])
    sampler = _rng(seed, 1)
    kept: dict = {}                      # reservoir slot -> (index, x)
    requests = []
    prof = None
    if ntrace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
    setup_s = time.perf_counter() - t_start

    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        traced = i < ntrace
        if traced and i == 0:
            prof.__enter__()
        t0 = time.perf_counter()
        if traced:
            with record_function(REQUEST_SPAN):
                out = call(*cell.system(i))
                sync()
        else:
            out = call(*cell.system(i))
            sync()
        wall = time.perf_counter() - t0
        if traced and i == ntrace - 1:
            prof.__exit__(None, None, None)
        requests.append(Request(
            index=i, pool_index=i % len(cell.pool), wall_s=wall,
            ptime_s=float(out.ptime), niters=int(out.niters),
            solved=bool(out.solved)))
        if i < checks_k:
            kept[i] = (i, out.x)
        else:
            j = int(sampler.integers(0, i + 1))
            if j < checks_k:
                kept[j] = (i, out.x)
        del out
        i += 1
    window_s = time.perf_counter() - w0
    if prof is not None and i < ntrace:
        prof.__exit__(None, None, None)
        ntrace = i

    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    answers = sorted((idx, x.detach().cpu().numpy().astype(np.float64))
                     for idx, x in kept.values())
    del kept, M, call
    if on_card:
        torch.cuda.empty_cache()

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{workload}.requests.json"), "w") as f:
        json.dump([dataclasses.asdict(r) for r in requests], f)
    tr = None
    if ntrace:
        path = os.path.join(OUT_DIR, f"{workload}.trace.json")
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
        spans = tr.spans(REQUEST_SPAN)
        for r, span in zip(requests[:ntrace], spans):
            r.span = span

    # The plain reference judges the sampled answers.
    ratios = []
    for idx, x in answers:
        sysm, b = cell.system(idx)
        ratios.append(residual_ratio(sysm.A, sysm.B, sysm.C, b, x,
                                     cell.atol, cell.rtol))
    unsolved = sum(1 for r in requests if not r.solved)
    rho = max(ratios) if ratios else float("inf")
    checks = {
        "resid_ratio_max": {"value": rho, "limit": limits["resid_ratio"]},
        "unsolved": {"value": unsolved, "limit": limits["unsolved"]},
    }
    over = sum(1 for v in ratios if not v <= limits["resid_ratio"])
    correct = (len(ratios) >= 1 and over == 0
               and unsolved <= limits["unsolved"])

    run = Run(mix=mix, setup_s=setup_s, window_s=window_s, requests=requests,
              trace=tr, triangles=triangles,
              value_bytes=4 if cell.dtype_name == "float32" else 8,
              dtype_name=cell.dtype_name)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": peak}
    if card is not None:
        dev["card"] = card
    # the host libraries run at their defaults; the line says what those were
    dev["host_threads"] = torch.get_num_threads()
    dev["host_cpus"] = len(os.sched_getaffinity(0))
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": over + unsolved, "metrics": metrics, "device": dev}
    if run.traced:
        lo, hi = run.traced_window()
        dev["busy_s"] = tr.busy_s(lo, hi)
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": tr.device_ops(lo, hi),
                               "idle_gaps": tr.idle_gaps(lo, hi)}
    result["checks"] = checks
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    if card is not None:
        lines.insert(0, f"card {card}")
    return result, lines
