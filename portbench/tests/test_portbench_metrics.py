"""The metric arithmetic on the CPU."""
import numpy as np
import pytest

from cpkrylov_tpu_torch.utils.profiling import union_ms
from portbench import roofline, stats
from portbench.trace import Trace, union_s


@pytest.mark.parametrize("seed", range(4))
def test_union_matches_the_ports_copy(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1000, 50)
    iv = list(zip(s, s + rng.uniform(0, 80, 50)))
    assert union_s(iv, 100.0, 900.0) == pytest.approx(
        union_ms(iv, 100.0, 900.0) / 1e3, rel=1e-15)


def test_union_of_nested_and_disjoint_intervals():
    iv = [(0, 10), (2, 5), (20, 30), (25, 40), (50, 60)]
    assert union_s(iv, 0, 55) == pytest.approx((10 + 20 + 5) / 1e6)


@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_is_numpys_linear(q):
    v = np.random.default_rng(1).exponential(size=217)
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q),
                                                   rel=1e-14)


def test_triangle_bytes_count_stored_entries():
    # 748,042 stored entries of CVXQP3-L's L, 17,500 rows, float64
    nbytes, flops = roofline.triangle_work(748_042, 17_500, 8)
    assert nbytes == 748_042 * 12 + 4 * 17_501 + 16 * 17_500
    assert flops == 2 * 748_042 + 17_500
    pk = roofline.peaks()
    t = roofline.least_s(nbytes, flops, "float64", pk)
    assert t == pytest.approx(nbytes / 3.35e12)
    assert pk["flops_per_s"]["float64"] == 34e12


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def _trace():
    return Trace([
        _ev("portbench.request", "user_annotation", 0, 100),
        _ev("cpkrylov.solve", "user_annotation", 20, 70),
        _ev("aten::copy_", "cpu_op", 2, 8),
        _ev("cudaLaunchKernel", "cuda_runtime", 25, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 40, 1),
        _ev("cudaLaunchKernel", "cuda_runtime", 95, 1),
        _ev("cudaMemcpyAsync", "cuda_runtime", 3, 1),
        _ev("Memcpy HtoD", "gpu_memcpy", 4, 6),
        _ev("block_tri_kernel<double, 16, true>", "kernel", 30, 10),
        _ev("dia_spmv_kernel", "kernel", 45, 5),
        _ev("block_tri_kernel<double, 16, true>", "kernel", 60, 10),
    ])


def test_trace_reads_spans_launches_busy_and_kernels():
    tr = _trace()
    assert tr.spans("cpkrylov.solve") == [(20.0, 90.0)]
    assert tr.launches_in(20, 90) == 2
    assert tr.busy_s(0, 100) == pytest.approx(31e-6)
    assert len(tr.kernels(["block_tri_kernel"], 0, 100)) == 2
    ops = tr.device_ops(0, 100)
    assert ops[0][0].startswith("block_tri_kernel")
    assert ops[0][1] == pytest.approx(20e-6)


def test_idle_gaps_are_labelled_by_the_host():
    gaps = dict(map(tuple, _trace().idle_gaps(0, 100)))
    assert gaps == pytest.approx({"portbench.request / aten::copy_": 4e-6,
                                  "cpkrylov.solve / python": 65e-6})
