"""Tiny sizes of the benchmark's configurations, for the CPU tests."""
from portbench import harness

SIZES = {"cvxqp": {"n": 1000}, "banded": {"n": 4000, "m": 1000}}


def tiny_config(cell: str) -> dict:
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfile = next(c["file"] for c in bench["configs"]
                 if c["name"] == entry["config"])
    cfg = harness.load_json(harness.ROOT, cfile)
    cfg["generator"].update(SIZES[cfg["family"]])
    return cfg


def cells() -> list:
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]


def run_tiny(cell: str, seed: int = 2**33 + 17, trace: bool = False,
             seconds: float = 0.3, program: dict | None = None):
    """A whole run of ``cell`` at its tiny size on the CPU, judged by the
    cell's own limits (``program``: as ``harness.run_cell``'s)."""
    return harness.run_cell(cell, seed, seconds, trace, t_start=0.0,
                            device="cpu", config=tiny_config(cell),
                            program=program)
