"""Build the package's CUDA kernels at first use and load them with ctypes.

The sources under `csrc/` have a plain C interface, so `nvcc` compiles them in
seconds into one shared library under `build/kernels/` at the repository
root, named by a hash of the sources and flags (an unchanged checkout reuses
it). Nothing is built or loaded at import time: the CPU path never needs the
library, and a failed build raises.

Every kernel wrapper counts its launches in `LAUNCHES`, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("gather.cu", "composite.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"gather_levels": 0, "sort_composite": 0}

_lib = None
_force_plain = False
build_seconds = None  # wall time of the build this process ran (None: reused)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch version of every kernel, also on CUDA tensors
    (for comparing a whole path against its plain twin on the card)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def use_kernel(t) -> bool:
    """The dispatch rule: the kernel for a CUDA tensor, the plain version for
    a CPU tensor (or inside `plain_versions`)."""
    return t.is_cuda and not _force_plain


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build() -> Path:
    global build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    target = BUILD_DIR / f"libscenerf_kernels_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    build_seconds = time.perf_counter() - t0
    target.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, target)
    return target


def build_log() -> str:
    """nvcc's output (ptxas registers, spills) for the current sources."""
    log = _build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.scenerf_gather_levels_f32.argtypes = [
            vp, vp, i32, vp, vp, i32, vp, i32, vp]
        lib.scenerf_gather_levels_f32.restype = i32
        lib.scenerf_sort_composite_f32.argtypes = [
            vp, vp, vp, vp, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.scenerf_sort_composite_f32.restype = i32
        lib.scenerf_error_string.argtypes = [i32]
        lib.scenerf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = library().scenerf_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
