"""ctypes bindings for the native loader library (mernative.cpp, port of
mitsubaer_tpu/native): mmap-based OBJ parsing and VOL3 grid reading, the
fast paths of utils/io.py's `load_obj` and `read_vol`.

The library is compiled with g++ at first use into
build/native/<hash>/libmernative.so (keyed by a hash of the source and the
flags, so an edit rebuilds), as kernels.py builds the CUDA library. A failed
build raises with the compiler's log: nothing falls back to the Python
parsers quietly. A file the library cannot read raises too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "mernative.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile mernative.cpp (once per source and flags); returns the
    library's path. Raises RuntimeError with g++'s log on failure."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                         ).hexdigest()[:16]
    out = BUILD_ROOT / key / "libmernative.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: concurrent builds never load a
    # half-written library
    tmp = out.with_name(f"libmernative.{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader failed: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded native library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.obj_copy.argtypes = [ctypes.c_void_p] * 3
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.vol_header.restype = ctypes.c_int
        lib.vol_header.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 4
        lib.vol_read.restype = ctypes.c_int
        lib.vol_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def load_obj_native(path):
    """(verts (V, 3) f32, tris (T, 3) i32) of an OBJ file, fan-triangulated
    as utils/io.py's Python parser does."""
    lib = get_lib()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    h = lib.obj_parse(str(path).encode(), ctypes.byref(nv), ctypes.byref(nt))
    if not h or nv.value < 0:
        raise OSError(f"the native loader cannot read OBJ file {path}")
    verts = np.empty((nv.value, 3), np.float32)
    tris = np.empty((nt.value, 3), np.int32)
    lib.obj_copy(h, _ptr(verts), _ptr(tris))
    lib.obj_free(h)
    return verts, tris


def read_vol_native(path):
    """(data (nz, ny, nx, ch) f32, aabb_min, aabb_max) of a VOL3 file."""
    lib = get_lib()
    enc = np.zeros(1, np.int32)
    dims = np.zeros(3, np.int32)
    ch = np.zeros(1, np.int32)
    bbox = np.zeros(6, np.float32)
    rc = lib.vol_header(str(path).encode(), _ptr(enc), _ptr(dims), _ptr(ch),
                        _ptr(bbox))
    if rc != 0:
        raise OSError(f"the native loader cannot read VOL3 file {path} "
                      f"(header code {rc})")
    n = int(dims[0]) * int(dims[1]) * int(dims[2]) * int(ch[0])
    out = np.empty(n, np.float32)
    rc = lib.vol_read(str(path).encode(), _ptr(out), n)
    if rc != 0:
        raise OSError(f"the native loader cannot read VOL3 file {path} "
                      f"(payload code {rc})")
    data = out.reshape(int(dims[2]), int(dims[1]), int(dims[0]), int(ch[0]))
    return data, bbox[:3].copy(), bbox[3:].copy()
