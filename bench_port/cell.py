"""Finds a cell's pieces by name: its workload file
(bench_port/workloads/<cell>.json), the configuration file it names
(bench_port/configs/<config>.json), the driver of its traffic kind
(bench_port/traffic/<driver>.py), the metrics BENCHMARK.json gives it, and
the reader of each per-layer metric (bench_port/metrics/<metric>.py). A
later change adds a configuration, a cell, a traffic kind or a metric as
new files and BENCHMARK.json entries, and edits none of these."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def driver(self):
        return importlib.import_module(
            f"{__package__}.traffic.{self.workload['driver']}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def names(root: Path = HERE) -> list[str]:
    """The cells that have a workload file."""
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = HERE, benchmark: Path = BENCHMARK) -> Cell:
    """The cell `name`, with the metrics that BENCHMARK.json gives it
    (none where BENCHMARK.json does not list it)."""
    wl = _json(root / "workloads" / f"{name}.json")
    cfg = _json(root / "configs" / f"{wl['config']}.json")
    bench = _json(benchmark) if benchmark.exists() else {}
    entry = next((w for w in bench.get("workloads", []) if w["name"] == name),
                 None)
    if entry is None:
        return Cell(name, wl, cfg)
    return Cell(name, wl, cfg, chips=int(entry["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, root: Path = HERE):
    """The `read(run)` function of metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
