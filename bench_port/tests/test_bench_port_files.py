"""BENCHMARK.json, the configuration files and the workload files hold
together, name only what the contract allows, and a cell added as a new
file is found without an edit to any file there."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_port import cell as cell_m

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_metrics():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (cell_m.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", cells):
            mv = e2e[m["moves"]]
            assert w in cells and w in mv.get("workloads", cells)
    for w in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    f = ROOT / entry["file"]
    assert f.is_file() and f.parent == cell_m.HERE / "configs"
    cfg = json.loads(f.read_text())
    assert cfg["name"] == entry["name"] == f.stem
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for k in entry["reduced"]:
        assert NAME.match(k) and k in cfg["cut"]
    assert _line(entry["source"]) and _line(entry["why"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert "call" in cfg["preset"] and "kind" in cfg["scene"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and _line(entry["why"])
    assert NAME.match(entry["traffic"])
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    cell = cell_m.load(entry["name"])
    assert cell.workload["config"] == entry["config"]
    assert cell.config["name"] == entry["config"]
    assert (cell_m.HERE / "traffic" / f"{cell.workload['driver']}.py").exists()
    r = cell.workload["render"]
    for k in ("road", "res", "spp", "sppc", "filter", "max_depth", "mode"):
        assert k in r
    assert r["max_depth"] == cell.config["scene"]["max_depth"]
    assert r["res"] % 8 == 0 and r["spp"] % r["sppc"] == 0
    assert set(cell.workload["limits"]) == set(cell.driver().NUMBERS)
    assert cell.workload["limits"]["bad_values"] == 0
    assert all(v is None or v >= 0 for v in cell.workload["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


def test_a_new_cell_is_a_new_file(tmp_path):
    root = tmp_path / "bench_port"
    shutil.copytree(cell_m.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    wl = json.loads((root / "workloads" / "het_volume.render.json").read_text())
    wl.update(name="het_volume.dummy")
    (root / "workloads" / "het_volume.dummy.json").write_text(json.dumps(wl))
    assert "het_volume.dummy" in cell_m.names(root)
    cell = cell_m.load("het_volume.dummy", root=root,
                       benchmark=tmp_path / "BENCHMARK.json")
    assert cell.config["name"] == "het_volume" and cell.chips == 1
    assert all(p.read_bytes() == b for p, b in before.items())
