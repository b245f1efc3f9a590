"""No run of any cell imports JAX or the JAX package, the reference
imports nothing of the program, and no file of the benchmark reads the JAX
package's benchmarks."""
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

from ._tiny import cells

RUN_TINY = """
import json, sys, warnings
warnings.simplefilter("ignore")
sys.path.insert(0, {root!r})
from portbench.tests._tiny import run_tiny
for trace in (False, True):
    res, _ = run_tiny({cell!r}, trace=trace, seconds=0.2)
    assert res["correct"], res
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.residual, portbench.gen.cvxqp, portbench.gen.banded
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", cells())
def test_a_run_imports_no_jax(cell):
    mods = _modules(RUN_TINY.format(root=harness.ROOT, cell=cell))
    assert "cpkrylov_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules(REFERENCE.format(root=harness.ROOT))
    assert not mods & {"cpkrylov_tpu_torch", "cpkrylov_tpu", "jax", "torch"}


def test_no_source_names_jax_or_the_benchmarks_folder():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|cpkrylov_tpu)\b"
                     r"(?!_torch)", re.M)
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath.split(os.sep):
                src = open(os.path.join(dirpath, f)).read()
                assert not pat.search(src), f
                assert "benchmarks/" not in src, f
