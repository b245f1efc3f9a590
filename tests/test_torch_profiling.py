"""The port's device profile: busy time, idle share and launches are read
from one trace, inside the driver's solve span."""
import numpy as np
import pytest
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.utils import fixtures
from cpkrylov_tpu_torch.utils.profiling import (SOLVE_SPAN, device_profile,
                                                summarize_trace, union_ms)

torch.set_num_threads(1)


def test_union_merges_overlaps_and_clips():
    iv = [(0.0, 1000.0), (500.0, 1500.0), (3000.0, 4000.0), (9000.0, 9500.0)]
    assert union_ms(iv, 0.0, 5000.0) == pytest.approx(2.5)
    assert union_ms(iv, 1200.0, 3500.0) == pytest.approx(0.8)
    assert union_ms([], 0.0, 10.0) == 0.0


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ph": "X", "ts": ts, "dur": dur}


def test_summary_counts_only_inside_the_last_span():
    events = [
        _ev("user_annotation", SOLVE_SPAN, 0, 100),       # an earlier solve
        _ev("kernel", "k0", 10, 50),
        _ev("user_annotation", SOLVE_SPAN, 1000, 10000),
        _ev("cuda_runtime", "cudaLaunchKernel", 1100, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 1200, 5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1300, 5),
        _ev("kernel", "k1", 1500, 2000),
        _ev("kernel", "k2", 2500, 2000),                  # overlaps k1
        _ev("gpu_memcpy", "DtoH", 8000, 1000),
        _ev("gpu_user_annotation", SOLVE_SPAN, 1000, 10000),
    ]
    p = summarize_trace(events)
    assert p.wall_ms == pytest.approx(10.0)
    assert p.busy_ms == pytest.approx(4.0)
    assert p.idle_share == pytest.approx(0.6)
    assert (p.device_ops, p.launches) == (3, 2)
    with pytest.raises(ValueError, match="no 'cpkrylov.solve' span"):
        summarize_trace([e for e in events
                         if e["cat"] != "user_annotation"])


def test_cpu_solve_profile_finds_the_span():
    s = fixtures.random_sqd_system(60, 20, seed=3)
    outs = []

    def run():
        outs.append(cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G,
                              device="cpu", dtype=torch.float64,
                              opts=cpt.SolverOptions(itmax=200)))

    p = device_profile(run)
    assert outs[0].solved
    assert 0 < p.wall_ms <= 1e3 * outs[0].stime * 1.5 + 5
    assert (p.busy_ms, p.device_ops, p.launches) == (0.0, 0, 0)
    assert p.idle_share == 1.0
    assert "aten::" in p.table
    assert np.isfinite(outs[0].x.numpy()).all()
