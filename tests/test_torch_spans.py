"""The port's spans and path counters, and the benchmark readers of them.

Under ``torch.profiler`` a solve puts each span of ``utils/profiling.py``
in the trace, nested where the work happens; without a profiler no span
calls ``record_function``; the profiler changes no answer, iteration count
or launch count; the mixed solve counts its device loops and fallbacks;
and each per-layer metric that reads a span or counter reads a number at
the benchmark's CPU sizes, and nothing from a program that lacks it.
"""
import json
import os

import numpy as np
import pytest
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch import mixed
from cpkrylov_tpu_torch.ops import dia as tdia
from cpkrylov_tpu_torch.utils import device as devutil
from cpkrylov_tpu_torch.utils import profiling as prof
from portbench import harness, spans
from portbench.tests._tiny import run_tiny, tiny_config
from portbench.trace import Trace

SEED = 2**33 + 17
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NEW_METRICS = ("driver.pack_ms", "driver.upload_ms", "precond.ldl_ms",
               "precond.probe_ms", "precond.pack_ms",
               "krylov.apply_ms_per_iter", "krylov.host_reads_per_iter",
               "krylov.read_wait_ms_per_iter", "mixed.fallback_share",
               "driver.dia_card_pack_share")


def _cell(name):
    return harness.Cell(BENCH, name, SEED, config=tiny_config(name))


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
    x = out.x if isinstance(out.x, np.ndarray) else out.x.numpy()
    return (x.tobytes(), out.niters, prof.launch_counts(),
            prof.path_counts())


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_profiler_changes_no_bit_or_count(case, tmp_path):
    fn = _run_case(case)
    prof.reset_launches()
    off = _fingerprint(fn())
    prof.reset_launches()
    on = _fingerprint(_traced(fn, tmp_path)[0])
    assert on == off


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
            "dia_card_packs": 0, "dia_gate_refusals": 0}


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


def test_the_fallback_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("mixed.fallback_share")
    monkeypatch.setattr(mixed, "DEVICE_LOOPS", 0)
    monkeypatch.setattr(mixed, "FALLBACKS", 0)
    assert read(run) is None
    monkeypatch.setattr(mixed, "DEVICE_LOOPS", 8)
    monkeypatch.setattr(mixed, "FALLBACKS", 2)
    assert read(run) == pytest.approx(25.0)
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def test_the_card_pack_share_reads_the_counters(monkeypatch):
    _, run = _tiny_run("banded_1m.rhs_stream")
    read = harness.metric_reader("driver.dia_card_pack_share")
    monkeypatch.setattr(tdia, "CARD_PACKS", 0)
    monkeypatch.setattr(tdia, "GATE_REFUSALS", 0)
    assert read(run) is None
    monkeypatch.setattr(tdia, "CARD_PACKS", 6)
    monkeypatch.setattr(tdia, "GATE_REFUSALS", 2)
    assert read(run) == pytest.approx(75.0)
    monkeypatch.setattr(tdia, "CARD_PACKS", 0)
    assert read(run) == 0.0
    # a program with the mixed counters alone, or with none
    monkeypatch.setitem(prof.__dict__, "PATH_COUNTERS", {
        k: v for k, v in prof.PATH_COUNTERS.items()
        if k.startswith("mixed")})
    assert read(run) is None
    monkeypatch.delattr(prof, "path_counts")
    assert read(run) is None


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


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
