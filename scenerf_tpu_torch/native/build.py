"""Build the port's host C++ (ICP registration, `icp.cpp`; marching cubes,
`meshing.cpp`) with g++ at first use and load it with ctypes.

The sources are the port's copies of the JAX package's, built with its
flags (`-O3 -shared -fPIC -std=c++17`), so both builds of the same source
register point clouds and extract meshes bit for bit alike on one
machine. The library goes under `build/native/` at the repository root,
named by a hash of the source and the flags: never into the source tree.
Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "native"
SOURCES = ("icp.cpp", "meshing.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    target = BUILD_DIR / f"libscenerf_native_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, *(str(HERE / s) for s in SOURCES), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCES} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, target)  # another process may have built the same file meanwhile
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.icp_register.restype = ctypes.c_double
            fp = ctypes.POINTER(ctypes.c_float)
            lib.icp_register.argtypes = [fp, ctypes.c_int, fp, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
            lib.mc_run2.restype = ctypes.c_void_p
            lib.mc_run2.argtypes = [fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_int]
            i64 = ctypes.POINTER(ctypes.c_int64)
            lib.mc_counts.argtypes = [ctypes.c_void_p, i64, i64]
            lib.mc_copy.argtypes = [ctypes.c_void_p, fp, ctypes.POINTER(ctypes.c_int32), fp]
            lib.mc_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib
