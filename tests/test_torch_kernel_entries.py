"""The seam between the port's wrappers and its hand-written kernels, on the
CPU (no nvcc, no card).

* Every ``Entry`` a wrapper declares (``cpkrylov_tpu_torch/_build.py``) has
  its symbols among the ``extern "C"`` functions of ``csrc/*.cu``, with the
  same arity, the same width for each argument (pointer, ``int``,
  ``int64_t``, ``double``) and the same return type; and every ``cpkt_*``
  function there is declared exactly once (``cpkt_error_string`` is bound by
  ``_build.py`` itself).  ctypes passes a wrong width silently.
* ``Entry.launch`` and ``Entry.__call__`` against a stand-in library: the
  dtype's symbol, the stream last, the status checked with the wrapper's
  text, and the declared counters counted.
* The counter registry (``utils/profiling.py``) holds the twenty counters
  and ``reset_launches()`` zeroes them all.
"""
import ctypes
import glob
import os
import re

import pytest
import torch

from cpkrylov_tpu_torch import _build
from cpkrylov_tpu_torch.ops import cuda_df_dia, cuda_dia, cuda_spmv  # noqa
from cpkrylov_tpu_torch.precond import (cuda_bidiag, cuda_block_tri,  # noqa
                                        cuda_df_tri, cuda_interleave,
                                        cuda_tri)
from cpkrylov_tpu_torch.utils import profiling

_BLOCK = re.compile(r'extern "C" \{(.*?)\}\s*// extern "C"', re.S)
_FUNC = re.compile(r"^([\w ]+\**)\s*(cpkt_\w+)\(([^)]*)\)\s*\{", re.M)
_C_WIDTH = {"int": "int", "int64_t": "int64", "double": "double",
            "void": "void"}
_CTYPES_WIDTH = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
                 ctypes.c_int64: "int64", ctypes.c_double: "double",
                 None: "void", _build.STATUS: "int"}
# bound by _build.py itself, not through an Entry
_SELF_BOUND = {"cpkt_error_string"}


def _width(decl: str) -> str:
    """The width of a C parameter or return type."""
    decl = decl.strip()
    if "*" in decl:
        return "ptr"
    words = decl.replace("const ", "").split()
    return _C_WIDTH[words[0]]


def _c_functions() -> dict:
    """name -> (return width, argument widths) of every function inside
    the ``extern "C"`` blocks of ``csrc/*.cu``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        with open(path) as fh:
            src = fh.read()
        for block in _BLOCK.findall(src):
            for ret, name, params in _FUNC.findall(block):
                assert name not in out, f"{name} defined twice"
                params = params.strip()
                args = [] if params in ("", "void") else [
                    _width(p) for p in params.split(",")]
                out[name] = (_width(ret), args)
    return out


C_FUNCTIONS = _c_functions()


def _declared() -> dict:
    """C symbol -> its Entry, over every declared entry."""
    return {sym: e for e in _build.ENTRIES.values()
            for sym in e.symbols().values()}


def test_the_sources_have_entries_to_hold():
    assert len(C_FUNCTIONS) >= 30
    assert _SELF_BOUND <= C_FUNCTIONS.keys()


@pytest.mark.parametrize("name", sorted(C_FUNCTIONS.keys() - _SELF_BOUND))
def test_each_c_entry_is_declared_once_with_its_signature(name):
    declared = _declared()
    assert name in declared, f"{name} is declared by no wrapper"
    entry = declared[name]
    ret, args = C_FUNCTIONS[name]
    assert [_CTYPES_WIDTH[t] for t in entry.argtypes] == args, name
    assert _CTYPES_WIDTH[entry.restype] == ret, name
    if entry.is_launch:
        assert entry.restype == _build.STATUS and args[-1] == "ptr", name


def test_every_declared_symbol_is_in_the_sources():
    assert sorted(set(_declared()) - C_FUNCTIONS.keys()) == []


def test_an_entry_is_declared_once(monkeypatch):
    monkeypatch.setattr(_build, "ENTRIES", dict(_build.ENTRIES))
    with pytest.raises(ValueError, match="declared twice"):
        _build.Entry("cpkt_dia_spmv", (_build.P,))
    with pytest.raises(ValueError, match="unknown counters"):
        _build.Entry("cpkt_new", (_build.P,), counters=("no_such",))


class _FakeLibrary:
    """Stands in for the kernel library: records each call, returns the
    status it is told to."""

    def __init__(self, status=0):
        self.calls, self.status = [], status
        self.cpkt_error_string = lambda code: b"a stand-in error"

    def __getattr__(self, name):
        if not name.startswith("cpkt_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return self.status
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(_build, "ENTRIES", dict(_build.ENTRIES))
    monkeypatch.setitem(_build._LIBS, "kernels", _FakeLibrary())
    return _build._LIBS["kernels"]


def test_a_launch_takes_the_dtypes_symbol_the_stream_and_counts(fake):
    entry = _build.Entry("cpkt_probe", (_build.P, _build.I64),
                         dtypes=(torch.float32, torch.float64),
                         counters=("dia_spmv", "scan_grid_launches"))
    before = {**profiling.launch_counts(), **profiling.path_counts()}
    entry.launch(torch.zeros(2, dtype=torch.float64), 7, 8, stream=99)
    assert fake.calls == [("cpkt_probe_f64", (7, 8, 99))]
    fn = fake.cpkt_probe_f64
    assert fn.argtypes == [_build.P, _build.I64, _build.P]
    assert fn.restype is ctypes.c_int
    entry.launch(torch.zeros(2, dtype=torch.float32), 1, 2, stream=3,
                 counted=False)
    assert fake.calls[-1] == ("cpkt_probe_f32", (1, 2, 3))
    after = {**profiling.launch_counts(), **profiling.path_counts()}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"dia_spmv": 1, "scan_grid_launches": 1}
    with pytest.raises(TypeError, match="probe: unsupported dtype"):
        entry.launch(torch.zeros(2, dtype=torch.int32), 1, 2, stream=3)


def test_a_failed_launch_raises_the_wrappers_text_and_counts_nothing(fake):
    entry = _build.Entry("cpkt_probe", (_build.P,), counters=("block_tri",),
                         what="probe (c = inv b)")
    fake.status = 700
    before = profiling.launch_counts()
    with pytest.raises(RuntimeError, match=re.escape(
            "probe (c = inv b): CUDA error 700 (a stand-in error)")):
        entry.launch(torch.zeros(1), 5, stream=0)
    assert profiling.launch_counts() == before
    assert fake.calls == [("cpkt_probe", (5, 0))]


def test_a_query_takes_no_stream_and_returns_its_value(fake):
    query = _build.Entry("cpkt_probe_limit", (_build.I32,), launch=False,
                         restype=_build.I64)
    layout = _build.Entry("cpkt_probe_layout", (_build.I32,),
                          dtypes=(torch.float64,), launch=False)
    fake.status = 4096
    assert query(3) == 4096
    with pytest.raises(RuntimeError, match="probe_layout: CUDA error 4096"):
        layout(3, dtype=torch.float64)
    fake.status = 0
    assert layout(3, dtype=torch.float64) is None
    assert fake.calls[-1] == ("cpkt_probe_layout_f64", (3,))
    assert fake.cpkt_probe_limit.restype is ctypes.c_int64


KERNELS = {"dia_spmv", "bidiag_scan", "df_dia_spmv", "band_tri", "csr_spmv",
           "affine_scan", "interleave", "uninterleave", "block_tri",
           "df_tri_matvec"}
PATHS = {"mixed_device_loops", "mixed_fallbacks", "dia_card_packs",
         "dia_gate_refusals", "tri_reduced_scan_builds", "tri_block_builds",
         "tri_bidiag_builds", "scan_pack_us", "scan_grid_launches",
         "scan_cluster_launches", "block_card_packs", "gmres_restarts"}


def test_the_registry_holds_the_twenty_counters_and_resets_them():
    assert set(profiling.launch_counts()) == KERNELS
    assert set(profiling.path_counts()) == PATHS
    for key in KERNELS | PATHS:
        profiling.count(key, 3)
    assert set(profiling.launch_counts().values()) >= {3}
    profiling.reset_launches()
    assert not any(profiling.launch_counts().values())
    assert not any(profiling.path_counts().values())
    with pytest.raises(KeyError):
        profiling.count("no_such_counter")


def test_every_declared_counter_is_a_kernel_or_path_counter():
    for entry in _build.ENTRIES.values():
        assert set(entry.counters) <= KERNELS | PATHS, entry.stem
