"""BENCHMARK.json keeps the contract, and the harness finds configurations,
mixes, kinds of request, limits, kernel maps and metric readers by name: a
new mix with a new kind of request, and a new metric, added as files are
listed and run without an edit."""
import copy
import json
import os
import re

import numpy as np
import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    budget = (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200
    assert budget <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert harness.load_json(harness.ROOT, c["file"])["name"] == c["name"]
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["traffic"] in harness.names("mixes", ".json")
        mix = harness.load_json(harness.HERE, "mixes", w["traffic"] + ".json")
        assert mix["request"] in harness.names("requests", ".py")
        assert w["name"] in harness.names("limits", ".json")
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == set(configs)
    cells = {w["name"] for w in b["workloads"]}
    readers = harness.names("metrics", ".py")
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] in readers
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in cells:
        e2e = [m["name"] for m in harness.cell_metrics(b, c, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(b, c, True)


DUMMY_KIND = """
def draw(family, streams, mix):
    base = family.base()
    return base, [(base, mix["params"]["scale"] * family.rhs(r))
                  for r in streams]


def call(solve, system, rhs, *, method, **kw):
    CALLS.append(rhs.shape[0])
    return solve(method, rhs, system.A, system.B, system.C, system.G,
                 spmv_format="csr", **kw)


CALLS = []
"""


def test_a_new_mix_and_metric_are_found_by_name():
    mix = os.path.join(harness.HERE, "mixes", "zz_dummy_mix.json")
    kind = os.path.join(harness.HERE, "requests", "zz_dummy_kind.py")
    met = os.path.join(harness.HERE, "metrics", "zz.dummy_metric.py")
    try:
        src = harness.load_json(harness.HERE, "mixes", "rhs_stream.json")
        with open(mix, "w") as f:
            json.dump(dict(src, name="zz_dummy_mix", request="zz_dummy_kind",
                           params={"scale": 0.5}, pool=2, checks=1, warm=1),
                      f)
        with open(kind, "w") as f:
            f.write(DUMMY_KIND)
        with open(met, "w") as f:
            f.write("def read(run):\n    return 42.0 + len(run.requests)"
                    " * 0\n")
        assert "zz_dummy_mix" in harness.names("mixes", ".json")
        assert "zz_dummy_kind" in harness.names("requests", ".py")
        assert "zz.dummy_metric" in harness.names("metrics", ".py")
        bench = copy.deepcopy(BENCH)
        bench["workloads"].append({"name": "banded_1m.zz_dummy_mix",
                                   "config": "banded_1m",
                                   "traffic": "zz_dummy_mix", "chips": 1,
                                   "why": "a test"})
        bench["end_to_end"].append({"name": "zz.dummy_metric", "unit": "x",
                                    "better": "lower", "bound": 0.05,
                                    "source": "host_clock"})
        cfg = harness.load_json(harness.HERE, "configs", "banded_1m.json")
        cfg["generator"].update(n=3000, m=800)
        cell = harness.Cell(bench, "banded_1m.zz_dummy_mix", 5, config=cfg)
        plain = harness.Cell(BENCH, "banded_1m.rhs_stream", 5, config=cfg)
        assert np.array_equal(cell.system(1)[1], 0.5 * plain.system(1)[1])
        res, _ = harness.run_cell(
            "banded_1m.zz_dummy_mix", 5, 0.2, False, t_start=0.0,
            device="cpu", bench=bench, config=cfg,
            limits={"resid_ratio": 3.0, "unsolved": 0})
        assert res["metrics"]["zz.dummy_metric"]["value"] == 42.0
        assert res["correct"]
        out = harness._program(cell, "cpu")[0](*cell.system(0))
        assert cell.kind.CALLS == [3800] and out.solved
    finally:
        for p in (mix, kind, met):
            if os.path.exists(p):
                os.remove(p)


@pytest.mark.parametrize("kind,ext", [("configs", ".json"),
                                      ("kernels", ".json"),
                                      ("limits", ".json")])
def test_every_file_of_a_kind_parses(kind, ext):
    for n in harness.names(kind, ext):
        assert isinstance(harness.load_json(harness.HERE, kind, n + ext),
                          dict)
