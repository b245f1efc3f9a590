"""The control, at a size a test run holds: a whole run of each cell with
the program's own float32 path (``harness.CONTROL``: ``solve(dtype=float32,
refine=False)``) in the cell's call comes out not correct by the harness's
own comparison, where the same run of the cell's own call comes out
correct: the control reads one of the compared numbers past its limit, the
program none."""
import math

import pytest

from portbench import control, harness

from ._tiny import cells, run_tiny

SEED = 2**33 + 3


@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_limit_and_the_program_passes(cell):
    prog, _ = run_tiny(cell, seed=SEED)
    ctrl, _ = run_tiny(cell, seed=SEED, program=harness.CONTROL)
    assert prog["correct"], prog["checks"]
    assert not ctrl["correct"], ctrl["checks"]
    assert all(c["value"] <= c["limit"] for c in prog["checks"].values())
    assert any(not c["value"] <= c["limit"]
               for c in ctrl["checks"].values())
    assert math.isfinite(prog["checks"]["resid_ratio_max"]["value"])


def test_control_script_reports_correct_of_whole_runs(monkeypatch, capsys):
    calls = []

    def fake(workload, seed, seconds, trace, *, t_start, program=None):
        calls.append(program)
        return ({"correct": program is None, "attempted": 3,
                 "checks": {"resid_ratio_max": {"value": 1.0, "limit": 2.0},
                            "unsolved": {"value": 0, "limit": 0}}}, [])

    monkeypatch.setattr(harness, "run_cell", fake)
    control.main(["--workload", cells()[0], "--seeds", "1",
                  "--control-seeds", "2"])
    rows = [l for l in capsys.readouterr().out.splitlines() if l]
    assert calls == [None, harness.CONTROL]
    assert '"correct": true' in rows[0] and '"correct": false' in rows[1]
