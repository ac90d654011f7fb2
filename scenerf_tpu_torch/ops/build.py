"""Build the package's CUDA kernels at first use and load them with ctypes.

The sources under `csrc/` have a plain C interface, so `nvcc` compiles them in
seconds: one `nvcc -c` per source, all started together, then one link into
a shared library under `build/kernels/` at the repository root, named by a
hash of the sources and flags (an unchanged checkout reuses it). Nothing is
built or loaded at import time: the CPU path never needs the library, and a
failed build raises.

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
SOURCES = ("gather.cu", "gather_bwd.cu", "composite.cu", "composite_bwd.cu", "som.cu",
           "tsdf.cu", "norm.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = {"gather_levels": 0, "gather_levels_bwd": 0, "sort_composite": 0,
            "sort_composite_bwd": 0, "ray_som": 0, "tsdf_integrate": 0,
            # of the ray_som launches, those inside kernel C's (training) launch
            "ray_som_in_sort_composite": 0,
            # kernel K5 (batch norm + activation): N1-N4; of those, the one-launch
            # cluster path's (counted under both its stages' keys too)
            "bn_stats": 0, "bn_apply": 0, "bn_bwd_reduce": 0, "bn_bwd_apply": 0,
            "bn_forward_fused": 0, "bn_backward_fused": 0,
            # K5's synced path (a training site whose statistics are reduced
            # over the ranks): N1 and N3 without their finalize, and the two
            # finalize launches after the all-reduce (N2 and N4 count above)
            "bn_sync_sums": 0, "bn_sync_stats": 0, "bn_sync_bwd_sums": 0, "bn_sync_grads": 0}
BN_SYNC_KERNELS = ("bn_sync_sums", "bn_sync_stats", "bn_sync_bwd_sums", "bn_sync_grads")
# of those launches, the ones of a bf16 instantiation (counted under both keys;
# the synced path's at a bf16 site)
BF16_KERNELS = ("gather_levels", "gather_levels_bwd", "bn_stats", "bn_apply", "bn_bwd_reduce",
                "bn_bwd_apply", "bn_forward_fused", "bn_backward_fused", *BN_SYNC_KERNELS)
LAUNCHES.update({f"{k}_bf16": 0 for k in BF16_KERNELS})

_lib = None
_force_plain = False
_keep = frozenset()  # inside plain_versions: the kernels that still launch
build_seconds = None  # wall time of the build this process ran (None: reused)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str, dtype) -> None:
    """One launch of kernel `name`'s instantiation for `dtype`."""
    import torch

    LAUNCHES[name] += 1
    if dtype == torch.bfloat16:
        LAUNCHES[f"{name}_bf16"] += 1


@contextlib.contextmanager
def plain_versions(keep=()):
    """Run the plain PyTorch version of every kernel, also on CUDA tensors
    (for comparing a whole path against its plain twin on the card), but the
    kernels named in `keep` (the `name` their wrappers pass to
    `use_kernel`)."""
    global _force_plain, _keep
    prev = _force_plain, _keep
    _force_plain, _keep = True, frozenset(keep)
    try:
        yield
    finally:
        _force_plain, _keep = prev


def use_kernel(t, name: str = "") -> bool:
    """The dispatch rule: the kernel for a CUDA tensor, the plain version for
    a CPU tensor (or inside `plain_versions`, unless it keeps `name`)."""
    return t.is_cuda and (not _force_plain or name in _keep)


def resolve_device(device=None):
    """The entry points' device: `device`, or cuda:0 when None; raises when
    CUDA is asked for and absent (the port has no silent CPU fallback: pass
    device="cpu" for the CPU)."""
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    log = []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{out}")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    build_seconds = time.perf_counter() - t0
    target.with_suffix(".log").write_text("".join(log) + res.stdout + res.stderr)
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
        vp, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        signatures = {
            "scenerf_gather_levels_f32": [vp, vp, i32, vp, vp, i32, vp, i32, i32, i32, i32,
                                          vp],
            "scenerf_gather_levels_bwd_f32": [vp, vp, vp, i32, vp, vp, i32, vp, i32,
                                              vp, vp, i32, i32, vp],
            "scenerf_sort_composite_f32": [vp, vp, vp, vp, i32, i32, vp, vp, vp, vp,
                                           vp, vp, vp, vp, vp, vp, vp, vp, i32, f32, f32,
                                           f32, vp, vp, vp, vp],
            "scenerf_sort_composite_bwd_f32": [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                               vp, vp, vp, vp, vp],
            "scenerf_ray_som_f32": [vp, vp, vp, vp, i32, i32, i32, f32, f32, f32,
                                    vp, vp, vp, vp],
            "scenerf_tsdf_integrate_f32": [vp] * 7 + [i32] * 6 + [f32] * 6 + [i32, vp],
            "scenerf_tsdf_plan_constants": [vp],
            "scenerf_bn_forward_f32": [vp, vp, vp, i64, i32, i64] + [vp] * 6
                                      + [i64, f32, f32, f32, i32, i32, i32]
                                      + [i32, i32, i64, i64, vp],
            "scenerf_bn_backward_f32": [vp] * 5 + [i64, i32, i64] + [vp] * 4
                                       + [i64, f32, i32, i32, i32] + [i32, i32, i64, i64, vp],
            "scenerf_bn_sums_f32": [vp, i64, i32, i64, vp, vp, i64, vp],
            "scenerf_bn_bwd_sums_f32": [vp, vp, vp, i64, i32, i64, vp, vp, vp, i64, i32, vp],
            "scenerf_bn_stats_finalize": [vp, i64, i32] + [vp] * 5 + [f32, f32, f32, vp],
            "scenerf_bn_grads_finalize": [vp, vp, i64, i32, vp, vp, vp, f32, i32, vp],
            "scenerf_empty_launch": [i32, vp],
        }
        for name in ("gather_levels", "gather_levels_bwd", "bn_forward", "bn_backward",
                     "bn_sums", "bn_bwd_sums"):
            # the bf16 instantiations take the f32 entries' arguments
            signatures[f"scenerf_{name}_bf16"] = signatures[f"scenerf_{name}_f32"]
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        lib.scenerf_bn_work_floats.argtypes = [i64, i32, i64, i32, i32]
        lib.scenerf_bn_work_floats.restype = i64
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


def ptr(t) -> int | None:
    """A tensor's device pointer for ctypes (None for None: a null pointer)."""
    return None if t is None else t.data_ptr()
