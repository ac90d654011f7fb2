"""Where the time of the PyTorch port's serve path, or of its training step,
goes on one NVIDIA GPU.

    python3 scripts/profile_serve_torch.py [--poses 1] [--out build/profile/serve_trace.json]
    python3 scripts/profile_serve_torch.py --train [--out build/profile/train_trace.json]
    python3 scripts/profile_serve_torch.py --train --root DIR   # another checkout's package
    python3 scripts/profile_serve_torch.py --train --dtype bfloat16   # the bf16 compute path

Builds SceneRF(kitti(compute_dtype=--dtype)) with seeded random weights (f32
parameters; the float32 path by default; TF32 off, as chip_smoke.py does). Serve: encodes one synthetic frame and renders one
warm-up pose, then profiles one encode and `--poses` poses of the stride-2
sweep. Train: takes one warm-up step of `Trainer` on `make_batch` (4 sources
x 1200 rays), then profiles one step. Prints the device time by kernel (top
25), by kind (GEMM, convolution, the port's kernels, the rest), the device
busy share of the profiled window, the kernels it ran and the peak device
memory, the device time of kernel G-bwd's
autograd nodes and of the pyramid node whose gradient buffers they share
(training), and the card's name and power limit; writes a chrome trace to
`--out`.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

KINDS = (  # first match wins, on the device kernel's name; cuDNN's convolutions
    # run as implicit GEMMs (fprop/dgrad/wgrad), so they are matched before GEMMs
    ("port kernels (G, G-bwd, C, C-bwd, S, K5)",
     r"gather_levels|sort_composite|ray_som|bn_(stats|apply|bwd)"),
    ("convolution (cuDNN)", r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|cudnn"),
    ("GEMM (cuBLAS)", r"gemm|cutlass|splitK|nvjet"),
    ("reduction", r"reduce|norm|softmax|cumprod|cumsum|scan|sort|radix"),
    ("index / gather / scatter", r"index|gather|scatter|embedding"),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "elementwise and other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=1)
    ap.add_argument("--train", action="store_true", help="profile one training step")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose scenerf_tpu_torch to profile (default: this one)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the config's compute_dtype")
    args = ap.parse_args()
    out = args.out or f"build/profile/{'train' if args.train else 'serve'}_trace.json"
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = C.kitti(compute_dtype=args.dtype)
    torch.manual_seed(0)
    with torch.device(dev):
        model = SceneRF(cfg).eval()

    if args.train:
        trainer = Trainer(cfg, device=dev, model=model)
        batch = make_batch(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        trainer.train_step(batch, gen)  # warm-up (also builds the sphere maps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        window = f"1 training step {1e3 * (t2 - t0):.1f} ms"
    else:
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
        window = (f"encode {1e3 * (t1 - t0):.1f} ms + {args.poses} pose(s) "
                  f"{1e3 * (t2 - t1):.1f} ms")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in events) / 1e3
    wall_ms = (t2 - t0) * 1e3
    print(f"card: {card}; compute dtype {args.dtype}")
    print(f"profiled window: {window} = {wall_ms:.1f} ms wall (under the profiler); "
          f"device kernel time {busy_ms:.1f} ms in {len(events)} kernels, busy share "
          f"{busy_ms / wall_ms:.1%}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    by_kind, count = defaultdict(float), defaultdict(int)
    for e in events:
        by_kind[kind_of(e.name)] += e.device_time / 1e3
        count[kind_of(e.name)] += 1
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:40s} {ms:10.1f} ms {ms / busy_ms:6.1%} ({count[kind]} kernels)")
    port_ms, port_n = defaultdict(float), defaultdict(int)
    for e in events:
        m = re.search(r"(gather_levels(?:_bwd)?|sort_composite(?:_bwd)?|ray_som|bn_stats"
                      r"|bn_apply|bn_bwd_reduce|bn_bwd_apply|bn_forward_cluster"
                      r"|bn_backward_cluster)(?:_runs)?_kernel", e.name)
        if m:
            port_ms[m.group(1)] += e.device_time / 1e3
            port_n[m.group(1)] += 1
    for name in sorted(port_ms):
        print(f"  port kernel {name:30s} {port_ms[name]:10.3f} ms in {port_n[name]} launches")
    # G-bwd's autograd nodes: the kernel, and where a gather is not on a
    # shared pyramid (the encoder's resamples, the reprojection gathers) its
    # wrapper's zeroing of the level gradient; on the pyramid the first
    # gather's backward zeroes the shared buffers once. The engine's
    # evaluation of a node adds the summing of its outputs into the gradients
    # already accumulated for the same tensors. The pyramid node hands the
    # shared buffers to autograd once per step. A tree whose gathers each
    # zero and return a full level gradient compares with the two
    # "evaluated" lines together.
    total_evaluated = 0.0
    for label, op in (("G-bwd nodes (kernel + zeroing)", "_GatherLevelsBackward"),
                      ("G-bwd nodes evaluated (+ gradient accumulation)",
                       "autograd::engine::evaluate_function: _GatherLevelsBackward"),
                      ("pyramid node", "_PyramidNodeBackward"),
                      ("pyramid node evaluated (+ gradient accumulation)",
                       "autograd::engine::evaluate_function: _PyramidNodeBackward")):
        node = [e for e in prof.events() if e.name == op]
        if node:
            total = sum(e.device_time_total for e in node) / 1e3
            total_evaluated += total if "evaluate_function" in op else 0.0
            print(f"  {label:48s} {total:10.3f} ms device time in {len(node)} calls")
    if args.train:
        print(f"  {'G-bwd + pyramid nodes evaluated, per step':48s} {total_evaluated:10.3f} ms")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(out)


if __name__ == "__main__":
    main()
