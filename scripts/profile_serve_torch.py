"""Where the time of the PyTorch port's serve path goes on one NVIDIA GPU.

    python3 scripts/profile_serve_torch.py [--poses 1] [--out build/profile/serve_trace.json]

Builds SceneRF(kitti()) with seeded random weights (f32, TF32 off, as
chip_smoke.py does), encodes one synthetic frame and renders one warm-up
pose, then profiles one encode and `--poses` poses of the stride-2 sweep
with torch.profiler. Prints the device time by kernel (top 25), the device
busy share of the profiled window, and the card's name and power limit;
writes a chrome trace to `--out`.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=1)
    ap.add_argument("--out", default="build/profile/serve_trace.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame
    from scenerf_tpu_torch.model import SceneRF

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = C.kitti()
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg).eval()
    K_np = default_intrinsics(cfg)
    K = torch.from_numpy(K_np).to(dev)
    img = torch.from_numpy(input_frame(cfg)).to(dev)
    maps = model.compute_sphere_maps(K_np)
    poses = torch.from_numpy(geo.rel_pose_stack(geo.sample_rel_poses(
        cfg.sweep_step, cfg.sweep_angle, cfg.sweep_max_distance))).to(dev)

    pyramid = model.pyramid_for_item(model.encode(img, K_np, sphere_maps=maps), 0)
    model.render_pose_sweep(pyramid, K, poses[:1], stride=2, ray_chunk=5000)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pyramid = model.pyramid_for_item(model.encode(img, K_np, sphere_maps=maps), 0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.render_pose_sweep(pyramid, K, poses[:args.poses], stride=2, ray_chunk=5000)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in events) / 1e3
    wall_ms = (t2 - t0) * 1e3
    print(f"card: {card}")
    print(f"profiled window: encode {1e3 * (t1 - t0):.1f} ms + {args.poses} pose(s) "
          f"{1e3 * (t2 - t1):.1f} ms = {wall_ms:.1f} ms wall (under the profiler); "
          f"device kernel time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.1%}")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.out)


if __name__ == "__main__":
    main()
