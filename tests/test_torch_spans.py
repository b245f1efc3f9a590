"""The port's spans and path counters, and the benchmark readers of them.

Under ``torch.profiler`` a solve puts each span of ``utils/profiling.py``
in the trace, nested where the work happens; without a profiler no span
calls ``record_function``; the profiler changes no answer, iteration count
or launch count; the mixed solve counts its device loops and fallbacks;
and each per-layer metric that reads a span or counter reads a number at
the benchmark's CPU sizes, and nothing from a program that lacks it.  A
build counts its triangles by form and times its reduced-scan packs, each
inside a ``cpkrylov.build.scan_pack`` span.
"""
import json
import os

import numpy as np
import pytest
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch import mixed
from cpkrylov_tpu_torch.precond.cp import factorize_kp
from cpkrylov_tpu_torch.utils import device as devutil
from cpkrylov_tpu_torch.utils import profiling as prof
from portbench import harness, roofline, spans
from portbench.tests._tiny import run_tiny, tiny_config
from portbench.trace import Trace

SEED = 2**33 + 17
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NEW_METRICS = ("driver.pack_ms", "driver.upload_ms", "precond.ldl_ms",
               "precond.probe_ms", "precond.pack_ms",
               "krylov.apply_ms_per_iter", "krylov.host_reads_per_iter",
               "krylov.read_wait_ms_per_iter", "mixed.fallback_share",
               "driver.dia_card_pack_share", "kernel.band_tri_roofline",
               "precond.scan_pack_s", "kernel.scan_grid_share",
               "precond.block_card_pack_share")
# the AUG2D-L cell at grid 40: the reduced-scan factor at p 80, r 79
AUG_GRID = 40


def _tiny_config(name):
    if name.startswith("aug2d_l."):
        cfg = harness.load_json(harness.ROOT, "portbench/configs/aug2d_l.json")
        cfg["generator"]["grid"] = AUG_GRID
        return cfg
    return tiny_config(name)


def _cell(name):
    return harness.Cell(BENCH, name, SEED, config=_tiny_config(name))


def _opts(cell, **kw):
    s = cell.config["solver"]
    return cpt.SolverOptions(atol=s["atol"], rtol=s["rtol"],
                             itmax=s["itmax"], **kw)


def _popts(cell):
    return cpt.PrecondOptions(**cell.config["precond"])


def _solve(cell, M):
    sysm, b = cell.system(0)
    return cpt.solve("cpminres", b, sysm.A, sysm.B, sysm.C, sysm.G,
                     opts=_opts(cell), precond_opts=_popts(cell),
                     panel=cell.config["panel"], dtype=torch.float64,
                     device="cpu", M=M)


def _setup_M(cell, dtype=torch.float64):
    b0 = cell.base
    return cpt.make_preconditioner(b0.G, b0.B, b0.C, options=_popts(cell),
                                   panel=cell.config["panel"], dtype=dtype,
                                   device="cpu")


def _mixed(cell, M32, resident):
    sysm, b = cell.system(0)
    return mixed.solve_mixed("cpminres", b, sysm.A, sysm.B, sysm.C, sysm.G,
                             opts=_opts(cell, stagwin=25),
                             precond_opts=_popts(cell), M=M32, device="cpu",
                             device_resident=resident)


def _traced(fn, tmp_path):
    """fn()'s result and the program's spans: name -> [(start, end)]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    path = os.path.join(tmp_path, "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            s = float(e["ts"])
            found.setdefault(e["name"], []).append((s, s + float(e["dur"])))
    return out, found


def _nested(found, child, *parents):
    kids = found.get(child, [])
    outer = [sp for p in parents for sp in found.get(p, [])]
    assert kids, f"no {child} span"
    assert len(spans.inside(kids, outer)) == len(kids), (
        f"a {child} span lies outside {parents}")


CASES = {
    # case: (cell, how the preconditioner comes, the path)
    "cvxqp_build": ("cvxqp3_l.ipm_steps", None, "solve"),
    "cvxqp_setup": ("cvxqp3_l.rhs_stream", "setup", "solve"),
    "banded_build": ("banded_1m.rhs_stream", None, "solve"),
    "banded_setup": ("banded_1m.rhs_stream", "setup", "solve"),
    "aug_build": ("aug2d_l.rhs_stream", None, "solve"),
    "aug_setup": ("aug2d_l.rhs_stream", "setup", "solve"),
    "mixed_host_loop": ("banded_1m.mixed_stream", "setup", False),
    "mixed_device_loop": ("banded_1m.mixed_stream", "setup", True),
}


def _run_case(case):
    name, how, path = CASES[case]
    cell = _cell(name)
    if path == "solve":
        M = _setup_M(cell) if how == "setup" else None
        return lambda: _solve(cell, M)
    M32 = _setup_M(cell, torch.float32)
    return lambda: _mixed(cell, M32, path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_traced_solve_nests_every_span(case, tmp_path):
    out, found = _traced(_run_case(case), tmp_path)
    assert out.solved
    name, how, path = CASES[case]
    if path == "solve":
        loops = (prof.SOLVE_SPAN,)
        assert len(found[prof.OPERANDS_SPAN]) == 1
        assert not spans.inside(found[prof.OPERANDS_SPAN],
                                found[prof.SOLVE_SPAN])
        assert len(found[prof.SOLVE_SPAN]) == 1
    elif path is False:
        loops = (prof.SOLVE_SPAN,)
        _nested(found, prof.MIXED_HOST_LOOP_SPAN, prof.MIXED_SPAN)
        for sp in (prof.OPERANDS_SPAN, prof.SOLVE_SPAN):
            _nested(found, sp, prof.MIXED_HOST_LOOP_SPAN)
        assert prof.MIXED_LOOP_SPAN not in found
    else:
        loops = (prof.MIXED_LOOP_SPAN,)
        for sp in (prof.MIXED_PACK_SPAN, prof.MIXED_LOOP_SPAN,
                   prof.MIXED_READBACK_SPAN):
            _nested(found, sp, prof.MIXED_SPAN)
        assert prof.MIXED_HOST_LOOP_SPAN not in found
        assert not spans.inside(found[prof.MIXED_PACK_SPAN],
                                found[prof.MIXED_LOOP_SPAN])
    _nested(found, prof.APPLY_SPAN, *loops)
    _nested(found, prof.HOST_READ_SPAN, *loops)
    if how is None:
        assert len(found[prof.BUILD_SPAN]) == 1
        for sp in (prof.BUILD_ORDER_SPAN, prof.BUILD_LDL_SPAN,
                   prof.BUILD_PROBE_SPAN, prof.BUILD_PACK_SPAN):
            _nested(found, sp, prof.BUILD_SPAN)
        assert len(found[prof.BUILD_PACK_SPAN]) == 2   # factor, then K_P
        if name.startswith("aug2d_l."):                # L, then reversed U
            assert len(found[prof.BUILD_SCAN_PACK_SPAN]) == 2
            _nested(found, prof.BUILD_SCAN_PACK_SPAN, prof.BUILD_PACK_SPAN)
        else:
            assert prof.BUILD_SCAN_PACK_SPAN not in found
    else:
        assert prof.BUILD_SPAN not in found
    # every upload of the call sits in a pack of the request or the build,
    # or is one of a kernel's scalars inside its loop
    _nested(found, prof.UPLOAD_SPAN, prof.OPERANDS_SPAN, prof.BUILD_PACK_SPAN,
            prof.BUILD_PROBE_SPAN, prof.MIXED_PACK_SPAN, *loops)
    assert spans.inside(found[prof.UPLOAD_SPAN],
                        found.get(prof.OPERANDS_SPAN, [])
                        + found.get(prof.MIXED_PACK_SPAN, []))


@pytest.mark.filterwarnings("ignore:constraint preconditioner")
def test_the_df64_rebuild_packs_inside_the_probe(tmp_path):
    cell = _cell("cvxqp3_l.rhs_stream")
    b0 = cell.base
    popts = cpt.PrecondOptions(**dict(cell.config["precond"],
                                      apply_df64=True))
    M, found = _traced(lambda: cpt.make_preconditioner(
        b0.G, b0.B, b0.C, options=popts, dtype=torch.float32,
        device="cpu"), tmp_path)
    assert type(M.factor).__name__ == "DFFactorApply"
    packs = found[prof.BUILD_PACK_SPAN]
    assert len(packs) == 3 and len(spans.inside(
        packs, found[prof.BUILD_PROBE_SPAN])) == 1


def _fingerprint(out):
    """x's bits, the iterations and every count; ``scan_pack_us`` is a
    time, so only whether it counted anything."""
    x = out.x if isinstance(out.x, np.ndarray) else out.x.numpy()
    paths = prof.path_counts()
    paths["scan_pack_us"] = paths["scan_pack_us"] > 0
    return (x.tobytes(), out.niters, prof.launch_counts(), paths)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_profiler_changes_no_bit_or_count(case, tmp_path):
    fn = _run_case(case)
    prof.reset_launches()
    off = _fingerprint(fn())
    prof.reset_launches()
    on = _fingerprint(_traced(fn, tmp_path)[0])
    assert on == off
    assert on[3]["scan_pack_us"] is (case == "aug_build")


def test_without_a_profiler_no_span_is_opened(monkeypatch):
    calls = []

    def record_function(name):
        calls.append(name)
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    assert prof.span(prof.APPLY_SPAN) is prof.span(prof.UPLOAD_SPAN)
    for case in ("cvxqp_build", "banded_setup", "mixed_host_loop",
                 "mixed_device_loop"):
        assert _run_case(case)().solved
    assert calls == []


def test_a_span_opens_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("zz.span") as s:
            assert isinstance(s, torch.profiler.record_function)
    assert not torch.autograd._profiler_enabled()


def test_upload_and_host_read_move_the_same_values():
    a = np.random.default_rng(4).standard_normal(17)
    for dtype in (None, torch.float32, torch.float64):
        got = devutil.upload(a, "cpu", dtype)
        want = torch.as_tensor(a).to(device="cpu", dtype=dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)
    t = torch.as_tensor(a[:3], dtype=torch.float32)
    assert devutil.host_read(t) == t.tolist()
    assert devutil.host_read(t[0] > 100) is False


def _device_mixed(cell, M32, opts, forced):
    sysm, b = cell.system(0)
    return mixed._try_solve_mixed_device(
        "cpminres", b, mixed._as_host_matrix(sysm.A, "A"),
        mixed._as_host_matrix(sysm.B, "B"), mixed._as_host_matrix(sysm.C, "C"),
        M32, opts, inner_rtol=mixed.INNER_RTOL, inner_stagwin=30,
        max_outer=1, spmv_format="auto", tile_rows=2048, device="cpu",
        ptime=0.0, t_all=0.0, forced=forced)


def _counts(loops, fallbacks):
    """The path counters after CPU solves: the placements of CPU tensors
    are no card packs and no card refusals."""
    return {"mixed_device_loops": loops, "mixed_fallbacks": fallbacks,
            "dia_card_packs": 0, "dia_gate_refusals": 0,
            "tri_reduced_scan_builds": 0, "tri_block_builds": 0,
            "tri_bidiag_builds": 0, "scan_pack_us": 0,
            "scan_grid_launches": 0, "scan_cluster_launches": 0,
            "block_card_packs": 0, "gmres_restarts": 0}


def test_a_fallback_is_counted():
    cell = _cell("banded_1m.mixed_stream")
    M32 = _setup_M(cell, torch.float32)
    prof.reset_launches()
    never = cpt.SolverOptions(atol=0.0, rtol=1e-30, itmax=200)
    assert _device_mixed(cell, M32, never, forced=False) is None
    assert prof.path_counts() == _counts(1, 1)
    # a forced loop is no fallback, and returns its unconverged answer
    assert not _device_mixed(cell, M32, never, forced=True).solved
    assert prof.path_counts() == _counts(1, 1)
    # a converged unforced loop counts as a loop only
    loose = cpt.SolverOptions(atol=0.0, rtol=1e-3, itmax=200)
    assert _device_mixed(cell, M32, loose, forced=False).solved
    assert prof.path_counts() == _counts(2, 1)
    # the solve then takes the host loop, and solves
    prof.reset_launches()
    sysm, b = cell.system(0)
    out = mixed.solve_mixed("cpminres", b, sysm.A, sysm.B, sysm.C, sysm.G,
                            opts=never, M=M32, device="cpu", max_outer=1,
                            device_resident="auto")
    assert out.nouter == 1 and prof.path_counts()["mixed_device_loops"] == 0
    prof.reset_launches()
    assert prof.path_counts() == _counts(0, 0)


def test_without_a_profiler_the_scan_pack_opens_no_span(monkeypatch):
    """(Under a profiler it opens inside the pack: the aug cases of
    ``test_a_traced_solve_nests_every_span``.)"""
    build = _run_case("aug_build")
    calls = []

    def record_function(name):
        calls.append(name)
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    prof.reset_launches()
    assert build().solved
    assert calls == [] and prof.path_counts()["scan_pack_us"] > 0


BUILD_COUNTS = {
    # case: the cell whose set-up system is built, and (reduced-scan,
    # block, bidiagonal) triangles
    "aug": ("aug2d_l.rhs_stream", (2, 0, 0)),
    "cvxqp": ("cvxqp3_l.rhs_stream", (0, 2, 0)),
    "banded": ("banded_1m.rhs_stream", (0, 0, 2)),
}


@pytest.mark.parametrize("case", sorted(BUILD_COUNTS) + ["factorize_kp"])
def test_a_build_counts_its_triangles(case):
    name, want = BUILD_COUNTS.get(case, ("aug2d_l.rhs_stream", (0, 0, 0)))
    cell = _cell(name)
    prof.reset_launches()
    if case == "factorize_kp":
        # the harness's traced run factors K_P again for the rooflines
        b0 = cell.base
        factorize_kp(b0.G, b0.B, b0.C)
    else:
        _setup_M(cell)
    c = prof.path_counts()
    assert (c["tri_reduced_scan_builds"], c["tri_block_builds"],
            c["tri_bidiag_builds"]) == want
    assert (c["scan_pack_us"] > 0) is (want[0] > 0)
    prof.reset_launches()
    assert not any(prof.path_counts().values())


def test_the_benchmark_names_the_ports_spans():
    for name in ("OPERANDS", "UPLOAD", "BUILD", "BUILD_ORDER", "BUILD_LDL",
                 "BUILD_PROBE", "BUILD_PACK", "MIXED_PACK", "APPLY",
                 "HOST_READ"):
        assert getattr(spans, name) == getattr(prof, name + "_SPAN")
    for loop in (prof.SOLVE_SPAN, prof.MIXED_LOOP_SPAN):
        assert any(harness.load_json(harness.HERE, "mixes", m + ".json")
                   ["loop_span"] == loop
                   for m in harness.names("mixes", ".json"))


def _pairs():
    out = []
    for m in BENCH["per_layer"]:
        if m["name"] in NEW_METRICS and m["source"] == "program_span":
            out += [(m["name"], c) for c in m["workloads"]]
    return out


_RUNS: dict = {}


def _tiny_run(cell):
    """The Run of a traced tiny run of ``cell``, kept for the module; the
    mixed cell runs its device loop, as it does on the card."""
    if cell not in _RUNS:
        got = {}
        real_reader = harness.metric_reader

        def keep(name):
            def read(run):
                got["run"] = run
                return real_reader(name)(run)
            return read

        real_mixed = mixed.solve_mixed

        def device_loop(*a, **kw):
            return real_mixed(*a, **dict(kw, device_resident=True))

        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(harness, "metric_reader", keep)
            if "mixed" in cell:
                mp.setattr(mixed, "solve_mixed", device_loop)
            res, _ = run_tiny(cell, trace=True, seed=SEED)
        finally:
            mp.undo()
        assert res["correct"]
        _RUNS[cell] = (res, got["run"])
    return _RUNS[cell]


@pytest.mark.parametrize("metric,cell", _pairs())
def test_each_span_metric_reads_its_cells(metric, cell):
    res, run = _tiny_run(cell)
    assert res["metrics"][metric]["value"] > 0
    assert harness.metric_reader(metric)(run) == res["metrics"][metric][
        "value"]


def test_the_span_metrics_split_the_remainder():
    res, run = _tiny_run("cvxqp3_l.ipm_steps")
    m = {k: v["value"] for k, v in res["metrics"].items()}
    parts = m["precond.ldl_ms"] + m["precond.probe_ms"] + m["precond.pack_ms"]
    assert parts <= 1e3 * np.mean([r.ptime_s for r in run.traced])
    assert m["driver.pack_ms"] <= m["driver.host_ms"]
    reads = spans.in_loops(run, spans.HOST_READ)
    assert len(reads) >= run.traced[0].niters


def _only(monkeypatch, keep):
    """Make ``path_counts()`` report only the counters that ``keep``
    accepts: a program with fewer counters."""
    counts = prof.path_counts
    monkeypatch.setattr(prof, "path_counts", lambda: {
        k: v for k, v in counts().items() if keep(k)})


def test_the_fallback_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("mixed.fallback_share")
    monkeypatch.setitem(prof.COUNTS, "mixed_device_loops", 0)
    monkeypatch.setitem(prof.COUNTS, "mixed_fallbacks", 0)
    assert read(run) is None
    monkeypatch.setitem(prof.COUNTS, "mixed_device_loops", 8)
    monkeypatch.setitem(prof.COUNTS, "mixed_fallbacks", 2)
    assert read(run) == pytest.approx(25.0)
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def test_the_card_pack_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("driver.dia_card_pack_share")
    monkeypatch.setitem(prof.COUNTS, "dia_card_packs", 0)
    monkeypatch.setitem(prof.COUNTS, "dia_gate_refusals", 0)
    assert read(run) is None
    monkeypatch.setitem(prof.COUNTS, "dia_card_packs", 6)
    monkeypatch.setitem(prof.COUNTS, "dia_gate_refusals", 2)
    assert read(run) == pytest.approx(75.0)
    monkeypatch.setitem(prof.COUNTS, "dia_card_packs", 0)
    assert read(run) == 0.0
    # a program with the mixed counters alone, or with none
    _only(monkeypatch, lambda k: k.startswith("mixed"))
    assert read(run) is None
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def test_the_scan_grid_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("kernel.scan_grid_share")
    monkeypatch.setitem(prof.COUNTS, "scan_grid_launches", 0)
    monkeypatch.setitem(prof.COUNTS, "scan_cluster_launches", 0)
    assert read(run) is None
    monkeypatch.setitem(prof.COUNTS, "scan_grid_launches", 28)
    assert read(run) == pytest.approx(100.0)
    monkeypatch.setitem(prof.COUNTS, "scan_cluster_launches", 4)
    assert read(run) == pytest.approx(87.5)
    monkeypatch.setitem(prof.COUNTS, "scan_grid_launches", 0)
    assert read(run) == 0.0
    # a program with the other counters alone, or with none
    _only(monkeypatch, lambda k: not k.startswith("scan_"))
    assert read(run) is None
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def test_the_block_card_pack_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("cvxqp3_l.ipm_steps")
    read = harness.metric_reader("precond.block_card_pack_share")
    # the CPU run built blocked factors and placed none on a card
    assert prof.path_counts()["tri_block_builds"] > 0
    assert read(run) == 0.0
    monkeypatch.setitem(prof.COUNTS, "tri_block_builds", 0)
    monkeypatch.setitem(prof.COUNTS, "block_card_packs", 0)
    assert read(run) is None
    monkeypatch.setitem(prof.COUNTS, "tri_block_builds", 8)
    monkeypatch.setitem(prof.COUNTS, "block_card_packs", 8)
    assert read(run) == pytest.approx(100.0)
    monkeypatch.setitem(prof.COUNTS, "block_card_packs", 6)
    assert read(run) == pytest.approx(75.0)
    # a program without the card pack's counter, or with no counters
    _only(monkeypatch, lambda k: k != "block_card_packs")
    assert read(run) is None
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def test_the_scan_pack_reader_reads_the_counter(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("precond.scan_pack_s")
    monkeypatch.setitem(prof.COUNTS, "scan_pack_us", 0)
    assert read(run) is None
    monkeypatch.setitem(prof.COUNTS, "scan_pack_us", 2_500_000)
    assert read(run) == pytest.approx(2.5)
    # a program without the counter, or without any
    _only(monkeypatch, lambda k: k != "scan_pack_us")
    assert read(run) is None
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def _band_run(events, triangles):
    tr = Trace([_ev("portbench.request", "user_annotation", 0, 1000),
                _ev("cpkrylov.solve", "user_annotation", 5, 990), *events])
    return harness.Run(mix={"loop_span": "cpkrylov.solve"}, setup_s=1.0,
                       window_s=1.0, trace=tr, triangles=triangles,
                       requests=[harness.Request(
                           index=0, pool_index=0, wall_s=1e-3, ptime_s=0.0,
                           niters=1, solved=True, span=(0.0, 1000.0))])


def test_the_band_tri_roofline_counts_solves_by_the_c_kernel():
    c = "void (anonymous namespace)::band_c_kernel<double>(double const*)"
    scan = "void (anonymous namespace)::affine_scan_kernel<double, true>()"
    # two solves: B4's c kernel and its scan each, and a kernel of no solve
    events = [_ev(c, "kernel", 10, 10), _ev(scan, "kernel", 20, 40),
              _ev(c, "kernel", 100, 10), _ev(scan, "kernel", 110, 40),
              _ev("void csr_spmv_kernel<double>()", "kernel", 200, 30)]
    nnz, rows = 94_714_174, 298_935
    read = harness.metric_reader("kernel.band_tri_roofline")
    nbytes, flops = roofline.triangle_work(nnz, rows, 8)
    least = roofline.least_s(nbytes, flops, "float64", roofline.peaks())
    want = 100.0 * 2 * least / 100e-6
    assert read(_band_run(events, {0: (nnz, rows)})) == pytest.approx(want)
    # no factor of the request, or no solve in it: nothing to read
    assert read(_band_run(events, {})) is None
    assert read(_band_run(events[4:], {0: (nnz, rows)})) is None


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_a_program_without_the_spans_reads_nothing(metric, monkeypatch):
    """A trace with only the request and loop spans (the program before
    these spans existed) gives None, and no reader raises."""
    tr = Trace([_ev("portbench.request", "user_annotation", 0, 100),
                _ev("cpkrylov.solve", "user_annotation", 20, 70),
                _ev("aten::mul", "cpu_op", 30, 5)])
    run = harness.Run(mix={"loop_span": "cpkrylov.solve"}, setup_s=1.0,
                      window_s=1.0, trace=tr, requests=[harness.Request(
                          index=0, pool_index=0, wall_s=1e-4, ptime_s=0.0,
                          niters=3, solved=True, span=(0.0, 100.0))])
    monkeypatch.delattr(prof, "path_counts")
    assert harness.metric_reader(metric)(run) is None
