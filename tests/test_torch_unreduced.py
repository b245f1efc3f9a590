"""CVXQP's Newton system in its unreduced form at CPU sizes, and the form
rule that puts CVXQP1-L's unreduced factor on blocked substitution.

* ``utils/mm.py::cvxqp_kkt_unreduced`` draws ``cvxqp_kkt``'s iterate, and
  eliminating its bound multipliers gives ``cvxqp_kkt``'s system bit for
  bit;
* ``solve("cpgmres", ...)`` meets the stopping contract on the unreduced
  CVXQP1-M system, against the plain PyTorch reference
  ``portbench/reference/unreduced.py`` (which matches scipy's
  ``spsolve``), and so does ``tools/unreduced_reference.py``;
* the form rule never gives the reduced-scan form a panel above
  ``cuda_tri.MAX_PANEL``: a lower factor of reach above it takes blocked
  substitution, one of reach up to it keeps the reduced-scan form, at the
  panel the JAX package's rule picks;
* CPGMRES opens one ``cpkrylov.arnoldi`` span a step and one
  ``cpkrylov.gmres.restart`` span a restart block, and counts the restart
  blocks;
* ``cvxqp1_l.rhs_stream`` is the configuration's one cell;
* on the card (``cuda``; skips without one), the unreduced CVXQP1-M system
  solved through ``solve`` with the preconditioner built there.
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.precond import cp
from cpkrylov_tpu_torch.precond.cuda_tri import MAX_PANEL
from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                 ReducedScanTriFactor)
from cpkrylov_tpu_torch.utils import profiling as prof
from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt, cvxqp_kkt_unreduced
from portbench import harness, spans
from portbench.gen import cvxqp
from portbench.reference.kkt_schur import rel_err
from portbench.reference.residual import residual_ratio
from portbench.reference.unreduced import UnreducedReference
from portbench.trace import Trace

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CONFIG = harness.load_json(harness.ROOT, "portbench/configs/cvxqp1_l.json")
# CVXQP1-M's unreduced system against the reference: the reference itself
# reads 9.4e-11 from spsolve (K's conditioning at delta = 1e-8), so 1e-9;
# the program's answer meets the contract atol = rtol = 1e-6, whose
# residual (||b|| 8.3e5) leaves it 9.9e-4 from x_ref in f64 and 1.0e-3 in
# f32 on the CPU: 1e-2 sits 10x above both
REF_TOL = 1e-9
ANSWER_TOL = 1e-2


def _family(n, seed=0):
    return cvxqp.Family(dict(CONFIG["generator"], n=n, seed=seed))


def _popts():
    return cpt.PrecondOptions(**CONFIG["precond"])


def _opts(restart=100):
    s = CONFIG["solver"]
    return cpt.SolverOptions(atol=s["atol"], rtol=s["rtol"],
                             itmax=s["itmax"], restart=restart)


def _same(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


def _blocks(s, n):
    A = s.A.tocsr()
    return {"Q": A[:n, :n], "z_l": A[n:2 * n, :n].diagonal(),
            "s_l": A[n:2 * n, n:2 * n].diagonal(),
            "z_u": -A[2 * n:, :n].diagonal(),
            "s_u": A[2 * n:, 2 * n:].diagonal()}


@pytest.mark.parametrize("family", ["cvxqp1", "cvxqp3"])
def test_eliminating_the_multipliers_gives_cvxqp_kkt(family):
    n = 300
    u = cvxqp_kkt_unreduced(family, n, seed=3)
    r = cvxqp_kkt(family, n, seed=3)
    k = _blocks(u, n)
    m = r.B.shape[0]
    H = (k["Q"] + sp.diags(k["z_l"] / k["s_l"] + k["z_u"] / k["s_u"]))
    _same(H, r.A)
    _same(u.B[:, :n], r.B)
    assert u.B[:, n:].nnz == 0 and u.B.shape == (m, 3 * n)
    _same(u.C, r.C)
    _same(u.G, sp.diags(u.A.diagonal()))
    # the dual and primal rows of the right-hand side are cvxqp_kkt's
    assert np.array_equal(u.b[:n], r.b[:n])
    assert np.array_equal(u.b[3 * n:], r.b[n:])
    # the unreduced solution's (dx, dy) solves the reduced system with the
    # eliminated right-hand side
    x = spla.spsolve(u.K.tocsc(), u.b)
    r_l, r_u = u.b[n:2 * n], u.b[2 * n:3 * n]
    b_red = np.concatenate([u.b[:n] + r_l / k["s_l"] - r_u / k["s_u"],
                            u.b[3 * n:]])
    xr = spla.spsolve(r.K.tocsc(), b_red)
    both = np.concatenate([x[:n], x[3 * n:]])
    assert np.linalg.norm(both - xr) <= 1e-8 * np.linalg.norm(xr)


def test_the_unreduced_system_is_nonsymmetric():
    u = cvxqp_kkt_unreduced("cvxqp1", 100)
    assert abs(u.A - u.A.T).max() > 0
    assert u.A.shape == (300, 300) and u.b.shape == (350,)


@pytest.fixture(scope="module")
def cvxqp1_m():
    u = cvxqp_kkt_unreduced("cvxqp1", 1000)
    return u, UnreducedReference(u.A, u.B, u.C).solve(u.b)


def test_the_reference_matches_spsolve(cvxqp1_m):
    u, ref = cvxqp1_m
    x = spla.spsolve(u.K.tocsc(), u.b)
    assert ref.kkt_rel <= 1e-14
    assert rel_err(x, ref.x) <= REF_TOL


def test_the_reference_refuses_other_blocks():
    r = cvxqp_kkt("cvxqp1", 90)
    with pytest.raises(ValueError):
        UnreducedReference(r.A, r.B, r.C)


def test_cpgmres_solves_the_unreduced_system(cvxqp1_m):
    u, ref = cvxqp1_m
    prof.reset_launches()
    out = cpt.solve("cpgmres", u.b, u.A, u.B, u.C, u.G, opts=_opts(),
                    precond_opts=_popts(), panel=CONFIG["panel"],
                    dtype=torch.float64, device="cpu")
    assert out.solved
    x = out.x.numpy()
    assert residual_ratio(u.A, u.B, u.C, u.b, x, 1e-6, 1e-6) <= 1.0
    assert rel_err(x, ref.x) <= ANSWER_TOL
    # restart 100: the sweeps' restart blocks, the last one included
    assert prof.path_counts()["gmres_restarts"] == -(-out.niters // 100)


def _lower(n, reach):
    """A unit lower triangle with one entry at ``reach`` below the diagonal
    in every row that has one."""
    rows = np.arange(reach, n)
    T = sp.identity(n, format="csr") + sp.csr_matrix(
        (np.full(rows.shape, 0.5), (rows, rows - reach)), shape=(n, n))
    return T.tocsr()


def _jax_choice(T, monkeypatch):
    """(form, panel) the JAX package's rule picks for ``T``, its two
    builders stubbed so that nothing is built."""
    from cpkrylov_tpu.precond import cp as jcp

    monkeypatch.setattr(jcp, "build_reduced_scan_tri",
                        lambda T, panel, dtype: ("scan", panel))
    monkeypatch.setattr(jcp, "build_block_tri",
                        lambda T, panel, dtype: ("block", panel))
    return jcp._build_tri(T, 256, np.float64)


@pytest.mark.parametrize("reach,form,jax_panel", [
    (100, ReducedScanTriFactor, 104),             # p0 104, both rules
    (MAX_PANEL, ReducedScanTriFactor, MAX_PANEL),  # p 1024, both rules
    (MAX_PANEL + 1, BlockTriFactor, 1032),         # p0 1032 > MAX_PANEL
    (1643, BlockTriFactor, 1648),                  # CVXQP1-L's unreduced L
])
def test_the_form_rule_caps_the_reduced_scan_panel(reach, form, jax_panel,
                                                   monkeypatch):
    p0 = -(-reach // 8) * 8
    n = max(16 * p0, 2048)    # the size gate n >= max(16 p0, 2048) passes
    T = _lower(n, reach)
    # the JAX rule takes the reduced-scan form at p0 whatever the reach
    assert _jax_choice(T, monkeypatch) == ("scan", jax_panel)
    prof.reset_launches()
    tf = cp._build_tri(T, 256, torch.float64, "cpu")
    assert isinstance(tf, form)
    if form is ReducedScanTriFactor:
        # up to the cap the port's rule picks the JAX rule's panel
        assert tf.panel == jax_panel
        assert prof.path_counts()["tri_reduced_scan_builds"] == 1
    else:
        assert tf.panel == 256
        assert prof.path_counts()["tri_block_builds"] == 1
    prof.reset_launches()


def test_the_unreduced_cvxqp1_l_factor_is_blocked():
    """CVXQP1-L's unreduced K_P: L's reach is 1643 and n = 35,000 passes
    the size gate, so the JAX rule's reduced-scan form at p 1648 would be
    chosen; the port's rule takes blocked substitution for both
    triangles."""
    u = cvxqp_kkt_unreduced("cvxqp1", "l")
    hf = cp.factorize_kp(u.G, u.B, u.C)
    assert cp._reach(hf.fac.L, upper=False) == 1643
    prof.reset_launches()
    M = cpt.make_preconditioner(u.G, u.B, u.C, options=_popts(),
                                panel=CONFIG["panel"], dtype=torch.float64,
                                device="cpu")
    c = prof.path_counts()
    assert (c["tri_reduced_scan_builds"], c["tri_block_builds"]) == (0, 2)
    assert isinstance(M.factor.tf1, BlockTriFactor)
    prof.reset_launches()


def _traced(fn, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    path = os.path.join(tmp_path, "trace.json")
    p.export_chrome_trace(path)
    return out, Trace.load(path)


def test_cpgmres_opens_a_span_a_step_and_a_restart(tmp_path):
    u = cvxqp_kkt_unreduced("cvxqp1", 100)
    M = cpt.make_preconditioner(u.G, u.B, u.C, options=_popts(),
                                dtype=torch.float64, device="cpu")

    opts = dataclasses.replace(_opts(restart=10), itmax=30)

    def run():
        return cpt.solve("cpgmres", u.b, u.A, u.B, u.C, u.G, opts=opts,
                         precond_opts=_popts(), dtype=torch.float64,
                         device="cpu", M=M)

    prof.reset_launches()
    out, tr = _traced(run, tmp_path)
    assert out.niters == 30           # three sweeps of ten steps
    loop = tr.spans(prof.SOLVE_SPAN)
    steps = tr.spans(prof.ARNOLDI_SPAN)
    restarts = tr.spans(prof.GMRES_RESTART_SPAN)
    assert len(steps) == out.niters and len(restarts) == 3
    assert len(spans.inside(steps + restarts, loop)) == len(steps + restarts)
    assert not spans.inside(steps, restarts)
    # each step's read of its residual lies outside its Arnoldi span, and
    # the applies (the step's product) lie outside it too
    assert not spans.inside(tr.spans(prof.HOST_READ_SPAN), steps)
    assert not spans.inside(tr.spans(prof.APPLY_SPAN), steps)
    c = prof.path_counts()
    assert c["gmres_restarts"] == len(restarts)
    # the profiler changes no bit and no count
    prof.reset_launches()
    again = run()
    assert torch.equal(again.x, out.x) and again.niters == out.niters
    assert prof.path_counts() == c
    prof.reset_launches()


def test_without_a_profiler_cpgmres_opens_no_span(monkeypatch):
    u = cvxqp_kkt_unreduced("cvxqp1", 100)
    calls = []

    def record_function(name):
        calls.append(name)
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    out = cpt.solve("cpgmres", u.b, u.A, u.B, u.C, u.G, opts=_opts(),
                    precond_opts=_popts(), dtype=torch.float64, device="cpu")
    assert out.solved and calls == []


def test_the_config_states_its_sizes():
    fam = _family(CONFIG["generator"]["n"])
    assert (fam.n, fam.m) == (CONFIG["n"], CONFIG["m"]) == (10000, 5000)
    assert CONFIG["N"] == fam.n + fam.m
    assert CONFIG["reduced"] == []
    cells = [w for w in BENCH["workloads"] if w["config"] == "cvxqp1_l"]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [
        ("cvxqp1_l.rhs_stream", "rhs_stream", 1)]
    # the tail metric and the per-layer metrics of the layers the cell runs
    # list it
    for name in ("solve_p95_ms", "kernel.trisolve_roofline", "driver.pack_ms",
                 "driver.upload_ms", "krylov.apply_ms_per_iter",
                 "krylov.host_reads_per_iter", "krylov.read_wait_ms_per_iter",
                 "driver.dia_card_pack_share",
                 "precond.block_card_pack_share"):
        m = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == name)
        assert "cvxqp1_l.rhs_stream" in m["workloads"]


@pytest.mark.cuda
def test_the_unreduced_cvxqp1_m_system_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", 0)
    u = cvxqp_kkt_unreduced("cvxqp1", "m")
    ref = UnreducedReference(u.A, u.B, u.C, device=cuda).solve(u.b)
    prof.reset_launches()
    M = cpt.make_preconditioner(u.G, u.B, u.C, options=_popts(),
                                panel=CONFIG["panel"], dtype=torch.float64,
                                device=cuda)
    out = cpt.solve("cpgmres", u.b, u.A, u.B, u.C, u.G, opts=_opts(),
                    precond_opts=_popts(), panel=CONFIG["panel"],
                    dtype=torch.float64, device=cuda, M=M)
    assert out.solved and out.x.device.type == "cuda"
    x = out.x.cpu().numpy()
    assert residual_ratio(u.A, u.B, u.C, u.b, x, 1e-6, 1e-6) <= 1.0
    assert rel_err(x, ref.x) <= ANSWER_TOL
    assert prof.path_counts()["gmres_restarts"] == -(-out.niters // 100)
    prof.reset_launches()


def test_the_tool_compares_both_sides_at_a_small_size(tmp_path):
    path = os.path.join(harness.ROOT, "tools", "unreduced_reference.py")
    spec = importlib.util.spec_from_file_location("unreduced_reference",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "s.jsonl")
    rc = tool.main(["--seeds", "3", "--device", "cpu", "--n", "100",
                    "--out", out])
    with open(out) as f:
        summary = json.loads(f.readline())
    assert rc == 0
    assert summary["reference_kkt_rel_max"] <= 1e-13
    prog, ctl = summary["program"], summary["control"]
    assert prog["passes_tol"] and prog["unsolved"] == 0
    assert prog["blocked_only"]
    assert ctl["resid_ratio_min"] > prog["resid_ratio_max"]
