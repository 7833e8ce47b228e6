"""The port's examples (``examples/torch_0*.py``) run as scripts on the CPU:
each with the ``cpu`` argument (the kernels' plain twins), the multichip
one on 8 gloo ranks of its own; each must exit 0 and report ok."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,says", [
    ("torch_01_basic.py", "ok: True"),
    ("torch_02_batched.py", "all ok: True"),
    ("torch_03_families.py", "done: True True True True"),
    ("torch_04_multichip.py", "dp x tp ok: True"),
    ("torch_05_solve_refine.py", "Inverter ok: True"),
])
def test_example_runs(script, says):
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples",
                                                     script), "cpu"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-800:]
    assert says in r.stdout
