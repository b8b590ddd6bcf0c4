"""The harness end to end on the CPU at a size a test run holds: no JAX
in its imports, no result without a card, the last line's keys, the
reference against the port (a sound run comes out correct), the planted
faults and the bfloat16 control coming out not correct where this size
resolves them, and a traffic kind added as new files that the harness
runs with no edit to a file that is there. The test marked cuda runs each
cell for 24 seconds on the card (`python -m pytest bench_port/tests -m
cuda` there)."""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import cell as cell_m, run
from bench_port.traffic import render_loop

ROOT = Path(__file__).resolve().parents[2]
CELLS = cell_m.names()
SEED = 3_000_000_123


def _modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=300).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_harness_imports_no_jax():
    mods = _modules(
        "import bench_port.run, bench_port.calibrate\n"
        "import bench_port.traffic.render_loop, bench_port.reference.tracer\n"
        "from bench_port import cell\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[cell.reader(m['name']) for m in b['per_layer']]")
    assert not mods & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = _modules("import bench_port.reference.tracer")
    assert not mods & (set(run.FORBIDDEN) | {"mitsubaer_tpu_torch"})


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    code = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"])
    assert code != 0 and capsys.readouterr().out == ""


# The limits at the test's size, 16x16 with a tenth of the samples: the
# block number is free of the size, but the others read over 768 pixel-
# channels or 10 images of a heavy-tailed estimator. Sound runs read here
# (CPU, 3-6 seeds a cell) pixel_excess -0.22 to 0.24 and image_chi2 0.14
# to 4.31, the faults image_chi2 14 and more; noise_ratio is read but
# never fails here, and the half fault is held to a rise of it (the
# chip's readings at the cells' size set their own limits, PERF.md).
SMALL_LIMITS = {"image_chi2": 10.0, "pixel_excess": 0.8,
                "noise_ratio": math.inf}
IMAGES = 10


def small(name: str):
    """The cell at 16^2 and 64 samples a pixel, a reference of 16 replicas
    of 128 samples a pixel and channel; the beam scene at depth 3, where a
    test's images resolve a doubled pass."""
    cell = cell_m.load(name)
    r = cell.workload["render"]
    r.update(res=16, spp=64, sppc=64)
    if cell.config["scene"]["kind"] == "volume":
        r["max_depth"] = cell.config["scene"]["max_depth"] = 3
    cell.workload["reference"].update(replicas=16, spp=128,
                                      splat_samples=1 << 18)
    cell.workload["limits"].update(SMALL_LIMITS)
    return cell


def _run(name: str, trace: int = 0, fault=None):
    code, res = run.run(["--workload", name, "--seed", str(SEED),
                         "--seconds", "0", "--trace", str(trace)],
                        device="cpu", cell=small(name), fault=fault,
                        images=IMAGES)
    assert code == 0
    return res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["attempted"] == IMAGES and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in
                                   cell_m.load(name).end_to_end}
    assert res["correct"], res["check"]


def test_traced_run_reports_per_layer_metrics():
    res = _run("het_volume.render", trace=1)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "loop_pass_ms_per_msample" in res["metrics"]
    assert "msamples_per_s" not in res["metrics"]


@pytest.mark.parametrize("fault", render_loop.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    res = _run(name, fault=fault)
    assert not res["correct"], res["check"]
    if fault == "half":
        # the count of camera samples at the film fails it in every cell
        assert res["check"]["samples_off"]["value"] == IMAGES * 16 * 16 * 32


def test_half_the_samples_raise_the_noise():
    """Besides the count of samples, the half fault raises the Cornell
    box's noise_ratio: at this size sound and half runs overlap in it from
    seed to seed, and at the test's seed half reads higher. On the beam
    scene the noise of its heavy-tailed estimator does not show the fault
    (PERF.md): there only the count of samples catches it."""
    name = "cbox_medium.render"
    sound = _run(name)["check"]["noise_ratio"]["value"]
    half = _run(name, fault="half")["check"]["noise_ratio"]["value"]
    assert half > 1.15 * sound, (sound, half)


def test_control_is_not_correct():
    """The bfloat16 control on the Cornell box. On the beam scene what
    bfloat16 breaks (film coordinates past 256 rounded to even pixels)
    needs the cell's width: its control runs on the chip (PERF.md)."""
    cell = small("cbox_medium.render")
    values = render_loop.control(cell, SEED, IMAGES, torch.device("cpu"))
    assert not run.verdict(values, cell.workload["limits"]), values


TOY_DRIVER = '''
import contextlib

import torch

FAULTS = ("unchanged",)
NUMBERS = ("state_off",)


class Driver:
    span = "step"
    span_targets = []

    def __init__(self, cell, device):
        self.cell, self.steps, self.fault = cell, 0, None
        self.x = torch.zeros(4, device=device)

    def warm(self):
        self.x += 0

    @contextlib.contextmanager
    def timed_path(self, fault=None):
        self.fault = fault
        yield
        self.fault = None

    def step(self, seed, traced):
        if self.fault != "unchanged":
            self.x += 1
        self.steps += 1

    def end_to_end(self, window_s):
        return {"toy_steps_per_s": self.steps / window_s}

    def compare(self, seed):
        off = float((self.x - self.steps).abs().max())
        return {"state_off": off}, self.cell.workload["limits"]
'''


def test_a_new_traffic_kind_is_new_files(tmp_path):
    """A traffic kind, its configuration, its cell and a per-layer metric
    added as new files and BENCHMARK.json entries: the harness runs the
    cell, traced and not, and the planted fault, and no file that was
    there changes."""
    root = tmp_path / "bench_port"
    shutil.copytree(cell_m.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "none",
                             "file": "bench_port/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.steps", "config": "toy",
                               "traffic": "steps", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "toy_steps_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.steps"]})
    bench["per_layer"].append({"name": "toy_steps", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "toy", "moves": "toy_steps_per_s",
                               "workloads": ["toy.steps"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "configs" / "toy.json").write_text(json.dumps({"name": "toy"}))
    (root / "workloads" / "toy.steps.json").write_text(json.dumps(
        {"name": "toy.steps", "config": "toy", "driver": "toy_steps",
         "limits": {"state_off": 0}}))
    (root / "traffic" / "toy_steps.py").write_text(TOY_DRIVER)
    (root / "metrics" / "toy_steps.py").write_text(
        "def read(run):\n    return run.drv.steps\n")
    code = (
        "import json\n"
        "from bench_port import run\n"
        "out = {}\n"
        "for trace, fault in ((0, None), (1, None), (0, 'unchanged')):\n"
        "    c, res = run.run(['--workload', 'toy.steps', '--seed', '5',\n"
        "                      '--seconds', '0', '--trace', str(trace)],\n"
        "                     device='cpu', fault=fault, images=3)\n"
        "    out[f'{trace}{fault}'] = res\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    sound, traced, fault = out["0None"], out["1None"], out["0unchanged"]
    assert sound["correct"] and sound["attempted"] == 3
    assert set(sound["metrics"]) == {"toy_steps_per_s", "setup_s"}
    assert sound["check"] == {"state_off": {"value": 0.0, "limit": 0}}
    assert traced["correct"] and traced["metrics"] == {
        "toy_steps": {"value": 3, "unit": "1"}}
    assert not fault["correct"]
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", name,
         "--seed", str(SEED), "--seconds", "24", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["correct"]
