"""Build and load the package's CUDA kernels.

The sources in csrc/*.cu are compiled by `nvcc` at first use, one process
per source, all started together, and linked into one shared library with a
plain C interface, build/kernels/<hash>/libmitsubaer_kernels.so (keyed by a
hash of the sources and flags, so an edit rebuilds), and loaded with ctypes. Each C function takes device pointers and the CUDA stream, and
returns cudaGetLastError() after its launch; `check` raises on non-zero.

No --use_fast_math, and --fmad=false: the kernels round as the plain PyTorch
versions do, which the lane-by-lane comparisons rely on.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int


class ErParams(ctypes.Structure):
    """The RIF/SDF parameters kernels D and E take by value (16 floats)."""

    _fields_ = [("q", ctypes.c_float * 16)]


class TraceIO(ctypes.Structure):
    """Kernel D's tensors, by value: the inputs as ermarch.trace takes them,
    the arc length and step size (dist_lanes and h_lanes, or dist and h
    where they are null), the sphere's inside threshold on r2
    (ermarch.sphere_threshold) and the outputs as trace returns them, plus
    the per-lane trip counts (int64) before the step count."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "p", "v", "active", "dist_lanes", "h_lanes")] + [
        (f, ctypes.c_float) for f in ("dist", "h", "sphere_t")] + [
        (f, ctypes.c_void_p) for f in (
            "po", "vo", "opt", "marched", "exited", "trips", "steps")]


class SensIO(ctypes.Structure):
    """Kernel E's tensors, by value: the inputs as ermarch.sens_march takes
    them, the step size (h_lanes, or h where h_lanes is null) and the
    outputs as it returns them, plus the per-lane trip counts (int64) before
    the step count."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "p1", "v", "dp", "dv", "p2", "active", "h_lanes")] + [
        ("h", ctypes.c_float)] + [(f, ctypes.c_void_p) for f in (
            "p", "vo", "dpo", "dvo", "opt", "marched", "crossed", "trips",
            "steps")]


_SIGNATURES = {
    # (points, cells, aabb6, out, n, nx, ny, nz, bf16, stream)
    "mk_trilinear_lookup": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (points, grad_out, aabb6, grad_grid, acc (int64 scratch), n, nx, ny,
    #  nz, stream)
    "mk_trilinear_lookup_backward": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P],
    # (params, seed, table, beam_tab, out, npix, sppc, max_depth, rr_depth,
    #  width, height, stride, nx, ny, nz, nbx, nby, nbz, max_trips,
    #  next_lane (one int32 of scratch), stream)
    "mk_boxwalk": [_P, ctypes.c_uint32, _P, _P, _P] + [_I] * 14 + [_P, _P],
    # (resident blocks a multiprocessor, out)
    "mk_boxwalk_blocks_per_sm": [_P],
    # (params, tensors, n, max_steps, stream)
    "mk_er_trace": [ErParams, TraceIO, _I, _I, _P],
    # (params, tensors, n, max_steps, stream)
    "mk_er_sens": [ErParams, SensIO, _I, _I, _P],
    # (rows, ctr, table, out, ctr_out, n, seed, max_trips, nx, ny, nz, nbx,
    #  nby, nbz, stream)
    "mk_megatrack": [_P, _P, _P, _P, _P, _I, ctypes.c_uint32] + [_I] * 7
    + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmitsubaer_kernels.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing; returns (path, seconds spent).

    Each source compiles to an object in its own nvcc process, all at once;
    one more nvcc links them."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{text}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}"
                          f"{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mk_error_string.argtypes = [ctypes.c_int]
    lib.mk_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().mk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device. This is the
    binding torch's generated code launches with; torch.cuda.current_stream
    builds a Stream object and costs several microseconds of host time a
    call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(t: torch.Tensor):
    """A context that makes t's device current for a launch (a no-op where
    it already is)."""
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor (`is_cuda`:
    `device.type` builds a device object, a microsecond or more a call)."""
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous CUDA tensors, got "
                             f"{t.device} contiguous={t.is_contiguous()}")
