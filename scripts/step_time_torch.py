"""Wall time of KITTI training steps of the PyTorch port on one NVIDIA GPU,
for comparing two checkouts in one call (run them in turns: A, B, B, A).

    python3 scripts/step_time_torch.py [--root DIR] [--steps 4] [--dtype bfloat16]

Imports `scenerf_tpu_torch` from --root (default: this checkout; its kernels
build under DIR/build/kernels), builds SceneRF(kitti(compute_dtype=--dtype))
with seeded random weights (f32 parameters; float32, the default, or the
bf16 compute path; TF32 off, as chip_smoke.py) and a Trainer, takes one
warm-up step on make_batch and then times --steps steps: host clock around
each step, ended by synchronize. Prints each step's ms, their median, the
peak device memory of the timed steps, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the config's compute_dtype")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = C.kitti(compute_dtype=args.dtype)
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg)
    trainer = Trainer(cfg, device=dev, model=model)
    batch = make_batch(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer.train_step(batch, gen)  # warm-up: kernel build, cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"{root} ({args.dtype}): {statistics.median(times):.1f} ms per step (median of "
          f"{args.steps}; "
          f"{['%.1f' % t for t in times]}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {card}")


if __name__ == "__main__":
    main()
