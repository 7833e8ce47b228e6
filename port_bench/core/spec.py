"""Everything a cell needs, found by the names in ``BENCHMARK.json``.

- a configuration: the JSON file its ``configs`` entry names. Its
  ``generator`` names the input generator,
  ``port_bench/reference/generators/<generator>.py``;
- a traffic mix: ``port_bench/traffic/<traffic>.json``, parameters that
  the one load generator (``core/loop.py``) reads. Its ``entry`` names the
  call of the program it drives, ``port_bench/entries/<entry>.py``;
- the correctness limits of a configuration:
  ``port_bench/limits/<config>.json``;
- a metric: ``port_bench/metrics/<metric>.py``, whose ``read`` takes the
  window (an end-to-end metric) or the traced segment (a per-layer one)
  and returns the value or None. A metric named ``<quantity>.<suffix>``
  (the same quantity in cells that need a bound of their own, or that
  move another end-to-end metric) is read by ``<quantity>.py`` where no
  file of its whole name exists.

A new configuration, generator, mix, entry, cell or metric is new files
and new entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = "port_bench"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: dict


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def entry(self):
        """The module of the traffic's ``entry``."""
        return module(Path(self.root) / BENCH / "entries"
                      / f"{self.traffic['entry']}.py")

    def generator(self):
        """The module of the configuration's ``generator``."""
        return module(Path(self.root) / BENCH / "reference" / "generators"
                      / f"{self.config['generator']}.py")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files
    read; raises ``KeyError`` for an unknown name."""
    root = Path(root)
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / BENCH / "limits" / f"{w['config']}.json").read_text())
    metrics = [[Metric(m["name"], m["unit"], m) for m in bench[kind]
                if _applies(m, name)] for kind in ("end_to_end", "per_layer")]
    return Cell(name, w["chips"], config, traffic, limits, *metrics, root)


def module(path: Path):
    """The module of the Python file ``path``, loaded under a name of its
    own; raises ``FileNotFoundError`` where there is no such file."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "port_bench_" + "".join(
        ch if ch.isalnum() else "_"
        for ch in f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``port_bench/metrics/<metric>.py``, or of
    the file of ``metric`` less its last dotted suffixes, the longest
    name first."""
    folder = Path(root) / BENCH / "metrics"
    parts = metric.split(".")
    for k in range(len(parts), 0, -1):
        path = folder / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return module(path).read
    raise FileNotFoundError(folder / f"{metric}.py")
