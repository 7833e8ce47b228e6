"""Each configuration, generator, traffic mix, entry, limit file and metric
is found by its name in BENCHMARK.json, and new ones are new files only."""

import json
import shutil
import time

import pytest

from port_bench import run
from port_bench.core import check, spec, trace

BENCH = spec.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found(name):
    cell = spec.cell(name)
    assert cell.config["n"] > 0
    assert cell.entry().INPUTS in ("device", "host")
    assert callable(cell.entry().bind)
    assert callable(cell.generator().device)
    assert set(cell.limits) == set(check.NAMES)
    assert any(m.name == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in
                                  BENCH["end_to_end"] + BENCH["per_layer"]
                                  if m["name"] != "setup_s"])
def test_every_metric_has_a_reader(name):
    assert callable(spec.reader(name))


def test_a_suffixed_name_falls_back_to_its_quantity():
    folder = spec.ROOT / "port_bench" / "metrics"
    assert not (folder / "device.idle_pct.single.py").exists()
    assert spec.reader("device.idle_pct.single").__module__ == \
        spec.reader("device.idle_pct").__module__
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.x")


# A deployment of another kind, added as files only: float64 matrices of
# three orders from a generator of its own, a call of the program that no
# cell drives yet, its own limits, an end-to-end metric under a suffixed
# name and a per-layer metric.
NEW_FILES = {
    "port_bench/configs/fp64-lu-refined-small.json": json.dumps({
        "n": 24, "batch": None, "dtype": "float64",
        "generator": "diag_heavy", "reduced": []}),
    "port_bench/reference/generators/diag_heavy.py": (
        "import numpy as np\nimport torch\n\n\n"
        "def device(seed, shape, *, device, dtype):\n"
        "    gen = torch.Generator(device=device)\n"
        "    gen.manual_seed(int(seed))\n"
        "    a = torch.rand(shape, generator=gen, device=device, "
        "dtype=dtype)\n"
        "    a.diagonal(dim1=-2, dim2=-1).add_(shape[-1])\n"
        "    return a\n\n\n"
        "def host(seed, count, n, *, dtype):\n"
        "    rng = np.random.default_rng(int(seed))\n"
        "    return [(rng.random((n, n)) + n * np.eye(n)).astype(dtype)"
        ".reshape(-1) for _ in range(count)]\n"),
    "port_bench/entries/lu_inverse_refined.py": (
        "INPUTS = 'device'\n\n\n"
        "def bind(device):\n"
        "    from gpu_matrix_inversion_tpu_torch.ops import refine\n\n"
        "    def call(x, n):\n"
        "        inv, ok = refine.lu_inverse_refined(x)\n"
        "        return inv, ok, bool(ok.all())\n"
        "    return call\n"),
    "port_bench/traffic/sweep3.json": json.dumps({
        "entry": "lu_inverse_refined", "pool": 3, "sizes": [16, 24, 40],
        "sample": 3, "trace_calls": 3}),
    "port_bench/limits/fp64-lu-refined-small.json": json.dumps({
        "ok_mismatch": {"limit": 0}, "resid": {"limit": 1e-5},
        "resid_col": {"limit": 1e-5}, "inv_err": {"limit": 1e-5}}),
    "port_bench/metrics/dummy.calls.py": (
        "def read(segment):\n    return segment.calls\n"),
}


def _checkout_with_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in NEW_FILES.items():
        assert not (root / rel).exists(), rel
        (root / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "fp64-lu-refined-small", "source": "x",
        "file": "port_bench/configs/fp64-lu-refined-small.json",
        "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "lu.sweep3",
                               "config": "fp64-lu-refined-small",
                               "traffic": "sweep3", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "call_ms.lu", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["lu.sweep3"]})
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "Device (H100)", "moves": "call_ms.lu",
                               "workloads": ["lu.sweep3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_new_kind_of_cell_is_files_only(tmp_path, monkeypatch):
    root = _checkout_with_a_new_cell(tmp_path)
    cell = spec.cell("lu.sweep3", root)
    assert [m.name for m in cell.end_to_end] == ["setup_s", "call_ms.lu"]
    assert [m.name for m in cell.per_layer] == ["dummy.calls"]
    seg = trace.Segment(4, 1.0, 0.5, [], {}, {})
    assert spec.reader("dummy.calls", root)(seg) == 4
    # A whole run of it on the CPU, from the copy (the look for the port
    # in the checkout skipped: the copy holds the benchmark only).
    monkeypatch.setattr(run, "import_port", lambda root: None)
    out = run.measure(cell, 2**31 + 3, 0.3, False, device="cpu",
                      t_start=time.perf_counter(), root=root)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "call_ms.lu"}
    assert out["attempted"] >= 3
    # The cells already there read as before.
    for w in BENCH["workloads"]:
        old, new = spec.cell(w["name"]), spec.cell(w["name"], root)
        assert (old.config, old.traffic, old.limits) == \
            (new.config, new.traffic, new.limits)


def test_the_new_cells_pool_has_its_orders_and_dtype(tmp_path):
    import torch

    from port_bench.core import loop
    root = _checkout_with_a_new_cell(tmp_path)
    load = loop.Load(spec.cell("lu.sweep3", root), 5, "cpu")
    assert [tuple(x.shape) for x in load.pool] == [(16, 16), (24, 24),
                                                  (40, 40)]
    assert all(x.dtype == torch.float64 for x in load.pool)
    assert load.work(4)["flops"] == 2 * (2 * 16 ** 3 + 24 ** 3 + 40 ** 3)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
