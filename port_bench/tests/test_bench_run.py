"""A whole run on the CPU at a small size (the chip look skipped): the
result line's keys, the exits without a result, and the modules loaded."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from port_bench import run
from port_bench.core import spec

ROOT = spec.ROOT


def small_cell(name, n, batch, root=ROOT):
    """Cell ``name`` cut to ``n`` and ``batch`` and a pool of 2, for the
    CPU."""
    cell = spec.cell(name, root)
    cell.config = dict(cell.config, n=n, batch=batch)
    cell.traffic = dict(cell.traffic, pool=2, sample=3)
    return cell


@pytest.mark.parametrize("name,n,batch,metrics", [
    ("batched128.b4096", 128, 8, {"setup_s", "inversions_per_s"}),
    ("single4096.flat", 512, None, {"setup_s", "call_ms.flat",
                                    "call_ms_p95.flat"}),
])
def test_result_line_keys(name, n, batch, metrics):
    out = run.measure(small_cell(name, n, batch), 2**31 + 99, 0.5, False,
                      device="cpu", t_start=time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == metrics
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(out["checks"]) == ["ok_mismatch", "resid", "resid_col",
                                   "inv_err"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gpu_matrix_inversion_tpu_torchx",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("y"))
    assert set(run.forbidden_modules()) == base | {"jaxlib"}


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1])\n"
        "from port_bench import run\n"
        "from port_bench.tests.test_bench_run import small_cell\n"
        "out = run.measure(small_cell('single4096.device', 512, None), 5,"
        " 0.3, False, device='cpu', t_start=time.perf_counter())\n"
        "assert out['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    done = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "gpu_matrix_inversion_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "batched128.b4096",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _cli(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA" in done.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _cli(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from port_bench import run\n"
            "try:\n    run.import_port(sys.argv[1])\n"
            "except run.RunError as err:\n    print('refused', err)\n")
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert done.stdout.startswith("refused"), done.stderr[-2000:]
