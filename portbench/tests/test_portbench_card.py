"""One short run of every cell on the card (``cuda``: skips without one)."""
import json
import subprocess
import sys

import pytest

from portbench import harness

from ._tiny import cells


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and "solve_ms" in res["metrics"]
