"""The run's surroundings: the cache directories inside the checkout, the
look for the cards, the device record of the result line, and the check
that no JAX module was loaded."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scenerf_tpu")


def fix_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout
    (the program's own kernels build into `build/kernels/` there); no
    library loads JAX by itself."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> List[str]:
    """Modules in this process whose top-level name is one of FORBIDDEN,
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def has_cards(n: int) -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.device_count() >= n


def power_limit() -> str:
    """The first card's name and power limit as nvidia-smi reads them, or
    the reason it could not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi: {e}"


def record(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips))}
