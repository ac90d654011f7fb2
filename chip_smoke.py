"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the novel-depth
serve path, the training step, the `train-kitti` entry point and the KITTI
evaluation commands at the full KITTI preset, through the hand-written
kernels.

    python3 chip_smoke.py

Phases (each prints one line and raises on failure):
  1. device: card name and power limit, versions, TF32 off, kernel build;
     the device time of an empty kernel on one block and on kernel C's grid
     at a training chunk (the floor a single-wave launch cannot beat)
  2. kernel G (multi-level bilinear gather) bit-equal to its plain PyTorch
     version at KITTI shapes: the five-level pyramid at the projected coords
     of 5000 rays x 64 samples, every sphere resample of the B7 encoder
     (s1 .. s32 at its tap widths) and the 1200-pixel reprojection gather,
     each beside F.grid_sample on the same tap and coords (events, alone)
  3. kernel C (per-ray sort + composite) against its plain version at P=64
     and the launch sizes of the paths: R=300 (a training chunk), 1024 (the
     GT-depth render), 5000 (a serve chunk)
  4. encode: SceneRF(kitti()) with seeded random weights (EfficientNet-B7
     spherical U-Net) on one synthetic 1220x370 frame: one K5 launch per
     batch norm (192), each site's shape and layout recorded
  5. serve: render_pose_sweep over the first 3 poses of the CLI's default
     sweep at stride 2, chunk 5000; pose 0 again on the plain versions
  6. numbers: encode ms, ms per pose, rays/s, peak device memory
  7. kernel G-bwd against autograd of the plain gather into the KITTI
     pyramid, at the cotangents the training path launches it with (a
     render chunk's [19200, 2480] samples and [1200, 2480] anchors) and at
     one source's [76800, 2480], timed alone (it adds into gradient buffers
     the caller zeroes once per step; the zeroing timed apart); each level
     alone; one step's 32 chunk gathers through the pyramid's shared
     buffers against the plain gathers summed, its backward timed beside
     the same gathers each zeroing its own gradient; the 3-channel
     reprojection gather with coordinate gradients; every sphere resample's
     backward beside grid_sample's
  8. kernel C-bwd, through the sort order of kernel C's training launch
     (RaySOM's EM inside), against autograd of the plain sort + composite,
     R=5000, P=64 with saturated alphas and clamped ties; the device time of
     C-bwd, and of kernel C alone and its training launch alone at R=300,
     1024, 5000 (CUDA-graph replay of 50 launches), with the inputs read from
     HBM and L2-resident
  9. RaySOM's EM inside kernel C's training launch, and kernel S (the EM
     launched alone), against its plain version at a training chunk (R=300,
     C=4, P=64); the fused launch timed beside C alone and C + S
 10. train: Trainer(kitti()) on the phase-4 weights takes 3 steps on
     make_batch (4 sources x 1200 rays, f32): finite loss and gradients,
     every parameter gets a nonzero gradient, the first AdamW step moves
     each weight by -lr g / (|g| + eps), BN running statistics move,
     every kernel launches, S only inside C's launches, K5 192 times forward
     and backward per step; step 0 again on the plain versions but K5's
     kernels, from the same weights and draws, loss and every gradient leaf
     held to the kernel path's; K5 on the train-mode encode (levels, and the
     encoder's gradients under a fixed cotangent) against the plain version,
     each held to the plain version in f64; ms per step, rays/s, peak device
     memory
 11. reconstruction: the phase-4 weights encode the synthetic frame with
     KITTI's calibration, render the CLI's full default sweep (63 poses) at
     stride 2, chunk 5000 (kernels G, C), upsample it to 1220x370, quantize
     the colors as the CLI's PNGs and fuse it into the 256x256x32 KITTI TSDF
     grid with kernel T; observed voxels, weight <= 63; T against its plain
     version in both modes (bit-equal but for pixel-rounding ties) and the
     kernel's occupancy scored against the plain version's (SSCMetrics);
     s per frame, fuse ms, T's time (events, fresh volume; alone) and bound
 12. kernel K5 (N1-N4: batch norm statistics, affine + activation +
     residual, and their backward) at every distinct batch norm configuration
     of the encoder and decoder (shape, activation, residual, layout; the
     sites recorded in phases 4 and 10): each stage against its plain
     version on the same inputs, each direction as the training step
     launches it (one launch on the cluster path: the path printed) against
     the plain stages, the fused op in train mode against autograd of the
     plain version (the cotangent zeroed at the leaky-ReLU's kink ties), eval
     mode within 2 f32 spacings; the time alone of each direction and of
     each stage, by events and plain, the bounds (3 and 5 passes, and the
     one-launch design's 2 and 3), F.batch_norm + activation; their sums over
     a training step's 192 sites and an encode's; the host time of one call
 13. bf16: the JAX package's flagship training configuration,
     kitti(n_sources=4, ray_chunk=1200, n_gt_depth=256,
     compute_dtype="bfloat16"), on the phase-4 weights: kernels G (phase 2's
     pyramid and every sphere resample) bit-equal to their plain bf16
     versions, G-bwd (phase 7's cotangents, bf16 into f32 buffers), each
     timed alone with its bf16 byte bound; a bf16 encode (192 bf16 K5
     launches) and the first 3 sweep poses at stride 2, chunk 5000, pose 0
     against the plain bf16 render (>= 99% of pixels); 3 bf16 training steps:
     finite loss and gradients, parameters, gradients and BN statistics f32,
     the statistics move, every parameter gets a gradient, the first AdamW
     move, K5 at 192 sites forward and backward in bf16, bf16 G and G-bwd,
     one C training launch (R = 1200, S's EM inside) per source, step 0's
     batch statistics at every BN site (recovered from the running
     statistics, set to 0 before the step) within BN_STATS_TOL of the f64
     statistics of the site's bf16 input, and step 0's loss beside the f32
     step's from the same weights and draws (printed); K5 and G in bf16 on the train-mode encode (levels, encoder
     gradients) against f64, at most ENCODE_F64_RATIO x the plain bf16
     version's error; N1-N4 and each direction as the step launches it in
     bf16 at every distinct batch norm configuration against their plain
     bf16 versions, timed alone beside their bf16 bounds and bf16
     F.batch_norm + activation, the path of each; ms per step, rays/s, peak
     memory, encode ms and ms per pose beside the f32 phases' numbers
 14. train-kitti: the training entry point on a KITTI odometry tree that two
     `scripts/make_fake_kitti.py` processes write while phases 1-13 run
     (train sequence 00, 16 frames; val sequence 08, 12 frames, voxel GT on
     every 5th frame written with the port's io_voxel), through its click
     command at the flagship flags on the full KITTI preset (B7, 1220x370,
     1500x452 sphere; --n_rays 1200 --n_sources 4 --n_gt_depth 256
     --compute_dtype bfloat16, the CLI's ray_chunk): one epoch of 3 steps,
     then a second run in the same logdir with --n_epochs 2 that resumes at
     step 3 with epoch 1's staircase lr; both validate on sequence 08 and
     save last / best. Checks: the resume and its lr, last and best saved,
     meta.json's best value the best epoch's mean val depth/abs_rel, losses
     and val metrics finite, every training kernel launched (K5 at 192 sites
     forward and backward a step, N2 also at each val encode, the one-launch
     counts phase 13's per step, S only inside C: one C training launch per
     ray chunk, source, step and val item), ICP's cached refinements rigid
     (R^T R = I and det 1 within RIGID_TOL), best through load_model
     rendering one stride-2 pose through G and C with finite depth. Prints
     ms per step through the loader (median after each run's first), host
     ms per item (the loader thread's read + collate), the loader-wait share,
     ICP ms per source cold, val ms per item, checkpoint save ms, peak
     memory and the make_batch step at the same flags beside phase 13's
 15. eval: the KITTI evaluation entry points through their click commands
     on cuda:0, on phase 14's tree (2 val items of sequence 08, every source
     of their scans) and its checkpoint directory (`best`, bf16), ICP cold
     in a preprocess tree of their own: save-depth-metrics (depth at every
     LiDAR pixel of every source), agg-depth-metrics, render-colors (stride
     3, 407x124) and eval-color with random LPIPS weights written in
     torchvision's and lpips' layouts (--lpips_vgg_path / --lpips_lin_path);
     then save-depth-metrics and render-colors again. Checks: one pickle per
     val item, its 7-vectors finite, n_frames summing to the sources with
     LiDAR pixels, agg's All row the pickles' mean, one 407x124 render PNG
     and one source copy per (item, source), eval-color scoring each pair,
     the second runs launching nothing, G, C and N2 (bf16) at their counted
     launches, one source's depth at its LiDAR pixels through the kernels
     against the plain versions (>= 99% of rays at rtol 1e-3, on the
     kernels' encode), LPIPS on the card within rtol 1e-4 of the CPU on one
     pair. Prints save-depth-metrics ms per val item (host read with ICP
     cold, encode, renders), LiDAR rays/s, render-colors ms per image,
     eval-color ms per pair (PSNR + SSIM on the host, LPIPS on the card) and
     peak memory
Then one JSON line of per-kernel results (each bf16 kernel's bf16 results
under "bf16"; "launches_by_path" gains "train_kitti" and "eval"), the card
line, and the last line
{"ok": true, "device": {...}}. It exits non-zero, printing no result, when no
CUDA device is present or any phase fails. Imports torch, numpy and the port
(`scenerf_tpu_torch`, which must sit beside this file), never JAX.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_RAYS, N_PTS = 5000, 64
C_RAYS = (300, 1024, N_RAYS)  # kernel C's launches: training chunk, GT-depth render, serve chunk
SWEEP_POSES = 3
STRIDE = 2
CHUNK = 5000
TIMING_RUNS = 20
COMPOSITE_RTOL = 1e-5
ARGMIN_MIN_SHARE = 0.999
SERVE_RTOL = 1e-3
SERVE_MIN_SHARE = 0.99
SERVE_KERNELS = ("gather_levels", "sort_composite", "bn_apply")  # no backward
TRAIN_KERNELS = ("gather_levels", "gather_levels_bwd", "sort_composite", "sort_composite_bwd",
                 "ray_som", "bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply")
RECON_KERNELS = ("gather_levels", "sort_composite", "tsdf_integrate", "bn_apply")
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply")
BN_FUSED = ("bn_forward_fused", "bn_backward_fused")  # K5's one-launch cluster path
BN_SITES = 192             # FusedBatchNorm modules of the B7 spherical U-Net
BN_RTOL = 1e-5             # y, running statistics, the statistics (sums in another order)
BN_REL_L2 = 1e-4           # dx, dweight, dbias, d_residual, dx's coefficients
BN_EVAL_SPACINGS = 2       # eval y: f32 spacings of the summands |x mul| + |add| + |r|
ENCODE_F64_RATIO = 2.0     # K5's encode error against f64, in units of the plain version's
GATHER_BWD_REL_TOL = 1e-5  # max abs error <= this x max|d_level| (f32 atomics)
COORD_GRAD_REL_TOL = 1e-4  # d_ix, d_iy: sums over channels in another order
COMPOSITE_BWD_RTOL = 1e-4  # the plain cumprod backward divides by 1 - alpha + 1e-10
SOM_RTOL = 1e-4            # EM sums over samples in another order
SOM_MIN_SHARE = 0.999
TRAIN_STEPS = 3
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL_L2 = 1e-2   # per gradient leaf, kernel path vs plain path
BN_STATS_TOL = 1e-4        # a step's batch statistics vs f64 ones of each site's input, in
                           # units of the channel's mean square: f32 sums ~1e-6; statistics
                           # rounded to bf16 up to 2^-9; the unbiased variance 1 / (M - 1),
                           # 2.1e-3 at the 12x39 sites
BF16_DX_REL_L2 = 4e-3      # bf16 dx, d_residual of N4: one rounding each (2^-8)
ADAM_EPS = 1e-8
ADAM_STEP_TOL = 0.05       # lr: a weight's first AdamW move against -lr g / (|g| + eps)
TSDF_MIN_EQUAL = 0.9999    # share of voxels where T and its plain version are bit-equal
TIE_PX = 1e-4              # a projection this close to a .5 boundary is a rounding tie
RECON_MIN_IOU = 0.9999     # kernel-vs-plain occupancy IoU
GRAPH_REPS = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
L2_BYTES = 50 * 2**20      # H100 SXM L2 cache
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
KITTI_TREE_FRAMES = {"00": 16, "08": 12}  # train and val sequences of phase 14's tree
TRAIN_KITTI_FLAGS = ("--n_rays", "1200", "--n_sources", "4", "--n_gt_depth", "256",
                     "--compute_dtype", "bfloat16", "--sequences", "00",
                     "--max_steps_per_epoch", "3")
KITTI_STEPS = 3            # steps per epoch (--max_steps_per_epoch)
KITTI_ICP_PAIRS = 4        # sources refined anew for ICP's cold time
RIGID_TOL = 1e-6           # ICP refinement: |R^T R - I|, |det R - 1|
LOADER_WAIT_S = 1e-3       # a get of the loader's queue this long waited for the thread
EVAL_KERNELS = ("gather_levels", "sort_composite", "bn_apply")  # G, C, N2 on the eval path
SPHERE_RESAMPLES = 6       # kernel G launches of an encode: s1 .. s32
LPIPS_RTOL = 1e-4          # LPIPS on the card against the CPU (f32 convs, TF32 off)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of `fn` in ms over `runs` CUDA-event timed calls
    (after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fns, reps: int = GRAPH_REPS) -> float:
    """Device time of one call in ms, without the host's launch overhead:
    `reps` calls captured in one CUDA graph, replayed 3 times (median). The
    calls cycle through `fns` (a callable, or one per copy of the inputs:
    copies that together exceed the L2 make every call read its inputs from
    HBM), and every call's outputs stay alive, so each writes fresh memory."""
    import torch

    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fns[i % len(fns)]() for i in range(reps)]
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph, outs
    return statistics.median(times)


def hbm_copies(tensors) -> list:
    """Copies of `tensors` (the first is the tensors themselves), enough
    that together they fill twice the L2."""
    n = min(GRAPH_REPS, -(-2 * L2_BYTES // nbytes(*tensors)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the f32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k5_path_hooks(model, paths: dict) -> list:
    """Hooks on every FusedBatchNorm of `model` that record the path
    (`NM.launch_path`) each training launch of K5 takes: paths["forward"] as
    the forward launches it, paths["backward"] from the cotangent autograd
    hands the backward (one of another layout is copied into x's, as
    `launch_backward` copies it)."""
    import torch

    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.ops import norm as NM

    def record(mod, args, kwargs, out):
        x_in = args[0]
        res_in = args[1] if len(args) > 1 else kwargs.get("residual")
        paths["forward"].append(NM.launch_path(x_in, "forward", mod.act, res_in).path)
        if out.requires_grad:
            def on_cotangent(dy):
                if NM.plane(dy) != NM.plane(x_in):
                    dy = torch.empty_like(x_in)
                paths["backward"].append(
                    NM.launch_path(x_in, "backward", mod.act, res_in, True, 3, dy).path)

            out.register_hook(on_cotangent)

    return [m.register_forward_hook(record, with_kwargs=True)
            for m in model.modules() if isinstance(m, FusedBatchNorm)]


def k5_fused_check(launches: dict, paths: dict, suffix: str = "") -> dict:
    """K5's one-launch counts per training step (`launches` over TRAIN_STEPS
    steps) held to the sites `k5_path_hooks` saw take the cluster path in
    one step, in each direction; the per-step counts."""
    fused = {k: launches[k + suffix] / TRAIN_STEPS for k in BN_FUSED}
    plan = {k: paths[d].count("cluster") for k, d in zip(BN_FUSED, ("forward", "backward"))}
    if [len(paths[d]) for d in ("forward", "backward")] != [BN_SITES] * 2 or fused != plan \
            or min(plan.values()) < 1:
        fail(f"train{suffix}: K5 one-launch (cluster) launches per step {fused}; the plan puts "
             f"{plan} of {[len(paths[d]) for d in ('forward', 'backward')]} sites there")
    return fused


def bn_stats_hooks(model, record: list) -> list:
    """Set every FusedBatchNorm's running statistics of `model` to 0 and hook
    its forward to append (module, f64 mean, f64 mean square) of its input
    over all axes but the last to `record`: after one training step each
    running statistic is (1 - momentum) x the batch's (`bn_stats_error`)."""
    import torch

    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm

    def hook(mod, args, out):
        x = args[0].detach().double()
        dims = tuple(range(x.dim() - 1))
        record.append((mod, x.mean(dims), torch.square(x).mean(dims)))

    mods = [m for m in model.modules() if isinstance(m, FusedBatchNorm)]
    with torch.no_grad():
        for m in mods:
            m.running_mean.zero_()
            m.running_var.zero_()
    return [m.register_forward_hook(hook) for m in mods]


def bn_stats_error(record: list) -> float:
    """The largest error of the batch statistics a training step used at the
    sites `bn_stats_hooks` recorded (each called once, its running statistics
    moved from 0), against the f64 statistics of the site's input: |mean -
    mean64| / sqrt(ms64) and |var - var64| / ms64 (ms64: the f64 mean
    square), over every channel of every site."""
    import numpy as np
    import torch

    if len({id(m) for m, *_ in record}) != len(record):
        raise ValueError("a batch norm ran twice: its running statistics moved twice")
    worst = 0.0
    for mod, mean64, ms64 in record:
        k = float(np.float32(1.0 - mod.momentum))  # the f32 factor of the update
        mean, var = mod.running_mean.double() / k, mod.running_var.double() / k
        var64 = torch.clamp(ms64 - torch.square(mean64), min=0.0)
        scale = torch.clamp(ms64, min=1e-30)
        worst = max(worst, float(torch.max(torch.maximum(
            (mean - mean64).abs() / scale.sqrt(), (var - var64).abs() / scale))))
    return worst


def adamw_first_move(params, start_state, grads, lr: float):
    """The first AdamW step (zero weight decay) moves each weight by -lr g /
    (|g| + eps): per parameter, the largest excess of the move's distance
    from that beyond one f32 spacing of the weight, and the largest move,
    both in units of lr."""
    import torch

    excess, moved_by = [], []
    for n, p in params.items():
        p0, g = start_state[n], grads[n]
        delta = p.detach() - p0
        spacing = torch.nextafter(p0.abs(), torch.full_like(p0, float("inf"))) - p0.abs()
        err = (delta + lr * g / (g.abs() + ADAM_EPS)).abs() - spacing
        excess.append(err.max())
        moved_by.append(delta.abs().max())
    return torch.stack(excess).cpu() / lr, torch.stack(moved_by).cpu() / lr


def touched_row_bytes(levels, ix, iy) -> int:
    """Bytes of the level rows that bilinear corners at (ix, iy) [L, N] land
    on, each row counted once: what a gather reads (or a scatter-add reads
    and writes) of the levels at these coords, at the least."""
    import torch

    total = 0
    for lv, x, y in zip(levels, ix, iy):
        H, W, C = lv.shape
        x0, y0 = torch.floor(x), torch.floor(y)
        rows = []
        for dx in (0, 1):
            for dy in (0, 1):
                cx, cy = x0 + dx, y0 + dy
                inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                rows.append((cy[inside] * W + cx[inside]).long())
        total += int(torch.unique(torch.cat(rows)).numel()) * C * lv.element_size()
    return total


def start_kitti_tree(root: Path) -> list:
    """Start writing a KITTI odometry tree under `root`: train sequence 00
    and val sequence 08 (1241x376 PNGs, KITTI's P2 / Tr, LiDAR .bins and
    exact poses), one `scripts/make_fake_kitti.py` process each."""
    script = ROOT / "scripts" / "make_fake_kitti.py"
    procs = [subprocess.Popen([sys.executable, str(script), "--root", str(root), "--frames",
                               str(n), "--sequence", seq], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for seq, n in KITTI_TREE_FRAMES.items()]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def finish_kitti_tree(root: Path, procs: list) -> None:
    """Wait for `start_kitti_tree`'s processes, then write the val
    sequence's voxel GT on every 5th frame with the port's io_voxel, as
    make_fake_kitti.py --val writes it (a road layer; nothing invalid)."""
    import numpy as np

    from scenerf_tpu_torch.data import io_voxel

    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            fail(f"make_fake_kitti.py failed ({p.returncode}):\n{out}")
    vox_dir = root / "dataset" / "sequences" / "08" / "voxels"
    vox_dir.mkdir(parents=True, exist_ok=True)
    labels = np.zeros(256 * 256 * 32, np.uint16)
    labels[: 256 * 256 * 2] = 40
    for i in range(0, KITTI_TREE_FRAMES["08"], 5):
        labels.tofile(vox_dir / f"{i:06d}.label")
        io_voxel.pack(np.zeros(labels.size, np.uint8)).tofile(vox_dir / f"{i:06d}.invalid")
        io_voxel.pack((labels > 0).astype(np.uint8)).tofile(vox_dir / f"{i:06d}.bin")


def train_kitti_phase(dev, card: str, tree: Path, tree_procs: list, ref: dict | None) -> dict:
    """Phase 14: `train-kitti` through its click entry point at the flagship
    flags on the tree: one epoch of KITTI_STEPS steps, then a second run in
    the same logdir that resumes and takes one more epoch; the checks and
    numbers of the module docstring. `ref` (phase 13's K5 one-launch counts
    per step and its step time) is compared where given. Returns the
    launches of both runs and the numbers."""
    import numpy as np
    import torch

    from scenerf_tpu_torch.cli import train as train_cli
    from scenerf_tpu_torch.data import icp
    from scenerf_tpu_torch.data.kitti import KittiDataset
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.native import build as native_build
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.utils.checkpoint import load_model

    t0 = time.perf_counter()
    finish_kitti_tree(tree, tree_procs)
    tree_s = time.perf_counter() - t0
    root, pre, logdir = str(tree), str(tree / "preprocess"), str(tree / "logs")
    train_scans = KittiDataset("train", root, pre, n_sources=0, sequences=["00"]).scans
    val_scans = KittiDataset("val", root, pre, n_sources=0).scans

    # ICP cold: the library's build, then each source of the first scan
    # refined anew (lidar reads, downsampling, two registrations)
    t0 = time.perf_counter()
    native_build.load()
    icp_build_s = time.perf_counter() - t0
    scan, icp_s = train_scans[0], []
    for sid in range(1, 1 + KITTI_ICP_PAIRS):
        t0 = time.perf_counter()
        icp.compute_transformation(scan["lidar_paths"][sid], scan["lidar_paths"][0],
                                   scan["lidar_paths"][sid - 1], scan["poses"][sid],
                                   scan["poses"][0], scan["poses"][sid - 1], scan["T_velo_2_cam"],
                                   scan["T_cam0_2_cam2"])
        icp_s.append(time.perf_counter() - t0)

    argv = ["train-kitti", "--root", root, "--preprocess_root", pre, "--logdir", logdir,
            *TRAIN_KITTI_FLAGS]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    run1 = train_cli.cli.main(argv + ["--n_epochs", "1"], standalone_mode=False)
    run1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run2 = train_cli.cli.main(argv + ["--n_epochs", "2"], standalone_mode=False)
    run2_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    trainer, mgr = run2["trainer"], run2["checkpoints"]
    cfg = trainer.cfg
    n_steps = len(run1["loss"]) + len(run2["loss"])
    if (run1["start_step"], run2["start_step"], trainer.step, n_steps) != (
            0, KITTI_STEPS, 2 * KITTI_STEPS, 2 * KITTI_STEPS):
        fail(f"train-kitti: runs started at steps {run1['start_step']}, {run2['start_step']} "
             f"and took {len(run1['loss'])} + {len(run2['loss'])} steps; expected 0 and "
             f"{KITTI_STEPS}, {KITTI_STEPS} each")
    lr1 = cfg.lr * cfg.lr_decay_gamma
    lrs = {g["lr"] for g in trainer.optimizer.param_groups}
    if trainer.steps_per_epoch != KITTI_STEPS or lrs != {lr1}:
        fail(f"train-kitti resume: steps per epoch {trainer.steps_per_epoch}, lr {lrs}; "
             f"expected {KITTI_STEPS} and epoch 1's {lr1}")
    val = run1["val_metrics"] + run2["val_metrics"]
    losses = run1["loss"] + run2["loss"]
    if not (all(math.isfinite(v) for v in losses) and all(
            v is not None and all(math.isfinite(x) for x in v.values()) for v in val)):
        fail(f"train-kitti: losses {losses} or val metrics {val} not finite")
    abs_rel = [v["depth/abs_rel"] for v in val]
    meta = mgr.read_meta()
    best_epoch = int(np.argmin(abs_rel))
    if not (mgr.latest() and mgr.best() and meta["last_step"] == 2 * KITTI_STEPS
            and meta["best_value"] == abs_rel[best_epoch]
            and meta["best_step"] == (best_epoch + 1) * KITTI_STEPS):
        fail(f"train-kitti checkpoints: last {mgr.latest()}, best {mgr.best()}, meta "
             f"{ {k: v for k, v in meta.items() if k != 'config'} }; val abs_rel per epoch "
             f"{abs_rel}")

    # every training kernel, K5 at its 192 sites a step in each direction (N2
    # also at each val encode), S only inside C: per source, one C training
    # launch per ray chunk, in every step and every val item
    n_val = sum(run1["val_items"]) + sum(run2["val_items"])
    chunks = -(-cfg.n_rays // cfg.ray_chunk)
    want = {"bn_stats_bf16": BN_SITES * n_steps, "bn_bwd_reduce_bf16": BN_SITES * n_steps,
            "bn_bwd_apply_bf16": BN_SITES * n_steps,
            "bn_apply_bf16": BN_SITES * (n_steps + n_val),
            "ray_som_in_sort_composite": cfg.n_sources * chunks * (n_steps + n_val),
            "ray_som": cfg.n_sources * chunks * (n_steps + n_val), "tsdf_integrate": 0}
    if ref is not None:
        want.update({f"{k}_bf16": ref["fused_per_step"][k] * n_steps for k in BN_FUSED})
    got = {k: launches[k] for k in want}
    if got != want or min(launches[k] for k in TRAIN_KERNELS + (
            "gather_levels_bf16", "gather_levels_bwd_bf16") + tuple(f"{k}_bf16" for k in BN_FUSED)) < 1:
        fail(f"train-kitti launches {launches}; expected {want} and every training kernel")

    # ICP's refinements (the cached transforms against their odometry) are
    # rigid; how far they move the odometry
    scans = {(s["sequence"], s["frame_id"]): s for s in train_scans + val_scans}
    moves, n_pairs = [], 0
    for path in sorted((tree / "preprocess" / "transform").glob("*/*.pkl")):
        seq = path.parent.name.split("_")[0]
        s_ = scans[(seq, path.stem)]
        with open(path, "rb") as f:
            cached = pickle.load(f)
        for sid, T in cached.items():
            sid = int(sid)
            for key, other in (("T_source2infer", 0), ("T_source2target", sid - 1)):
                odo = (s_["T_cam0_2_cam2"] @ np.linalg.inv(s_["poses"][other])
                       @ s_["poses"][sid] @ s_["T_cam2_2_cam0"])
                ref_T = np.linalg.inv(odo) @ T[key]
                R_ = ref_T[:3, :3]
                if not (np.abs(R_.T @ R_ - np.eye(3)).max() <= RIGID_TOL
                        and abs(np.linalg.det(R_) - 1) <= RIGID_TOL
                        and np.abs(ref_T[3] - [0, 0, 0, 1]).max() <= RIGID_TOL):
                    fail(f"ICP refinement {path.name} source {sid} {key} is not rigid:\n{ref_T}")
                angle = math.degrees(math.acos(min(1.0, max(-1.0, (np.trace(R_) - 1) / 2))))
                moves.append((float(np.linalg.norm(ref_T[:3, 3])), angle))
            n_pairs += 1
    if n_pairs == 0:
        fail("train-kitti: no ICP transforms cached")

    # the make_batch step at the same flags (the trained model, f32 draws)
    batch = make_batch(cfg, seed=SEED)
    mb_ms = []
    for _ in range(KITTI_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        mb_ms.append((time.perf_counter() - t0) * 1e3)
    del trainer, run1["trainer"], run2["trainer"], batch
    torch.cuda.empty_cache()

    # `best` through load_model: one stride-2 pose of the first val frame
    build.reset_launch_counts()
    model = load_model(str(mgr.directory), dev)
    if model.cfg != cfg:
        fail(f"load_model(best): config {model.cfg} differs from the run's {cfg}")
    item = KittiDataset("val", root, pre, n_sources=0)[0]
    K = torch.from_numpy(item["cam_K"]).to(dev)
    levels = model.encode(torch.from_numpy(item["img_input"][None]).to(dev), item["cam_K"])
    out = model.render_image(model.pyramid_for_item(levels, 0), K,
                             torch.eye(4, device=dev), torch.Generator(device=dev).manual_seed(SEED),
                             stride=2)
    depth = out["depth"]
    if depth.shape != (185, 610) or not bool(torch.isfinite(depth).all()) or not (
            build.LAUNCHES["gather_levels"] >= 1 and build.LAUNCHES["sort_composite"] >= 1):
        fail(f"best's render: depth {tuple(depth.shape)}, finite "
             f"{bool(torch.isfinite(depth).all())}, launches {dict(build.LAUNCHES)}")
    del model, levels, out
    torch.cuda.empty_cache()

    warm = [x * 1e3 for x in run1["step_s"][1:] + run2["step_s"][1:]]
    timings = {"cold": run1["train_timings"], "resumed": run2["train_timings"]}
    item_ms = {k: [(r + c) * 1e3 / cfg.batch_size for r, c in zip(t["read_s"], t["collate_s"])]
               for k, t in timings.items()}
    waits = [w for t in timings.values() for w in t["wait_s"]]
    waited = sum(w > LOADER_WAIT_S for w in waits) / max(len(waits), 1)
    val_ms = [s * 1e3 / n for s, n in zip(run1["val_s"] + run2["val_s"],
                                           run1["val_items"] + run2["val_items"])]
    save_ms = [s * 1e3 for s in run1["save_s"] + run2["save_s"]]
    numbers = dict(
        step_ms=statistics.median(warm), steps_ms=warm,
        first_step_ms=[run1["step_s"][0] * 1e3, run2["step_s"][0] * 1e3],
        host_item_ms={k: statistics.median(v) for k, v in item_ms.items()},
        loader_wait_share=waited, loader_wait_ms=[w * 1e3 for w in waits],
        icp_pair_ms=statistics.median(icp_s) * 1e3, icp_build_s=icp_build_s,
        val_item_ms=val_ms, save_ms=save_ms, peak_gib=peak / 2**30,
        make_batch_step_ms=statistics.median(mb_ms[1:]), run_s=[run1_s, run2_s], tree_s=tree_s)
    print(f"[14 train-kitti] {' '.join(TRAIN_KITTI_FLAGS)} on a KITTI tree of "
          f"{KITTI_TREE_FRAMES} frames: run 1 {len(run1['loss'])} steps from 0, run 2 resumed at "
          f"step {run2['start_step']} with epoch 1's lr {lr1:.4e}; losses "
          f"{['%.5f' % v for v in losses]}; val abs_rel per epoch {['%.5f' % v for v in abs_rel]}"
          f" ({n_val} val items), best {meta['best_value']:.5f} at step {meta['best_step']}; "
          f"launches {got}; best loaded and rendered a stride-2 pose, depth finite "
          f"({float(depth.min()):.2f} .. {float(depth.max()):.2f} m)")
    print(f"[14 train-kitti] ICP: {n_pairs} cached sources, every refinement rigid (R^T R = I "
          f"and det 1 within {RIGID_TOL}); they move the odometry by at most "
          f"{max(m[0] for m in moves):.2e} m and {max(m[1] for m in moves):.2e} deg")
    print(f"[14 numbers] on {card}: {numbers['step_ms']:.1f} ms per step through the loader "
          f"(median of the steps after each run's first: {['%.1f' % v for v in warm]}; first "
          f"steps {['%.1f' % v for v in numbers['first_step_ms']]}); host ms per item (read + "
          f"collate, the loader thread) cold {numbers['host_item_ms']['cold']:.1f}, resumed "
          f"{numbers['host_item_ms']['resumed']:.1f}; the consumer waited on the queue at "
          f"{waited:.0%} of its gets (> {LOADER_WAIT_S * 1e3:.0f} ms; waits "
          f"{['%.1f' % v for v in numbers['loader_wait_ms']]} ms); ICP {numbers['icp_pair_ms']:.1f}"
          f" ms per source cold (g++ build {icp_build_s:.2f} s); val "
          f"{['%.1f' % v for v in val_ms]} ms per item; checkpoint save "
          f"{['%.0f' % v for v in save_ms]} ms; peak device memory {numbers['peak_gib']:.2f} "
          f"GiB; runs {run1_s:.1f} + {run2_s:.1f} s; the make_batch step at the same flags "
          f"{numbers['make_batch_step_ms']:.1f} ms"
          + ("" if ref is None else f" (phase 13, ray_chunk 1200: {ref['step_ms']:.1f} ms)"))
    return {"launches": launches, "numbers": numbers, "model_path": str(mgr.directory)}


def eval_phase(dev, card: str, tree: Path, model_path: str) -> dict:
    """Phase 15: the four KITTI evaluation commands through their click
    entry points on cuda:0, on phase 14's tree and checkpoint directory (its
    `best`, bf16), ICP cold in a preprocess tree of their own; then
    save-depth-metrics and render-colors again, which must skip; the checks
    and numbers of the module docstring. Returns the eval path's launches
    and the numbers."""
    import numpy as np
    import torch
    from PIL import Image

    from scenerf_tpu_torch.cli import common
    from scenerf_tpu_torch.cli import evaluation as ev
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.utils.checkpoint import load_model
    from scenerf_tpu_torch.utils.lpips import LPIPS

    root, out = str(tree), tree / "eval"
    kitti = ["--root", root, "--preprocess_root", str(tree / "preprocess_eval"),
             "--model_path", model_path, "--eval_save_dir", str(out)]
    # random LPIPS weights in torchvision's and lpips' layouts
    sd = LPIPS.random_init(torch.Generator().manual_seed(SEED)).state_dicts()
    vgg_path, lin_path = str(tree / "vgg16.pth"), str(tree / "lpips_vgg.pth")
    torch.save(sd["vgg"], vgg_path)
    torch.save(sd["lpips"], lin_path)

    def run(*argv):
        t0 = time.perf_counter()
        res = ev.cli.main(list(argv), standalone_mode=False)
        return res, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    depth_run, depth_s = run("save-depth-metrics", *kitti)
    agg, _ = run("agg-depth-metrics", "--eval_save_dir", str(out))
    color_run, color_s = run("render-colors", *kitti)
    scores, score_s = run("eval-color", "--eval_save_dir", str(out), "--lpips_vgg_path",
                          vgg_path, "--lpips_lin_path", lin_path)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    build.reset_launch_counts()
    again = (run("save-depth-metrics", *kitti)[0], run("render-colors", *kitti)[0])
    again_launches = {k: build.LAUNCHES[k] for k in EVAL_KERNELS}

    # every val item and source, read again (ICP now cached)
    ds = common.eval_val_ds(root, str(tree / "preprocess_eval"), 10.0, 0.4)
    items = [ds[i] for i in range(len(ds))]
    with_lidar = sum(len(d) > 0 for it in items for d in it["lidar_depths"])
    pickles = sorted((out / "depth_metrics" / "08").glob("*.npy"))
    if [p.stem for p in pickles] != [it["frame_id"] for it in items] or not items:
        fail(f"save-depth-metrics: pickles {[p.name for p in pickles]} for val items "
             f"{[it['frame_id'] for it in items]}")
    total, n_total = np.zeros(7), 0
    for path in pickles:
        with open(path, "rb") as f:
            data = pickle.load(f)
        for k, e in data["depth_errors"].items():
            if not (e.shape == (7,) and np.isfinite(e).all()):
                fail(f"{path.name}: depth errors at {k} m {e}")
            total, n_total = total + e, n_total + data["n_frames"][k]
    agg_all = sum(agg[0].values()) / sum(agg[1].values())
    if n_total != with_lidar or not np.allclose(agg_all, total / n_total, rtol=1e-12, atol=0):
        fail(f"agg-depth-metrics: n_frames {n_total} for {with_lidar} sources with LiDAR "
             f"pixels; All row {agg_all} against the pickles' mean {total / n_total}")
    names = [f"{it['frame_id']}_{it['source_frame_ids'][s]}_{it['source_distances'][s]:.2f}.png"
             for it in items for s in range(len(it["source_frame_ids"]))]
    for sub in ("rgb", "render_rgb"):
        got = sorted(p.name for p in (out / sub / "08").glob("*.png"))
        if got != sorted(names):
            fail(f"render-colors: {sub}/08 holds {got}; expected {sorted(names)}")
    sizes = {Image.open(out / "render_rgb" / "08" / n).size for n in names}
    if sizes != {(407, 124)} or color_run["images"] != len(names):
        fail(f"render-colors: {color_run['images']} images of sizes {sizes} for {len(names)} "
             "sources; expected 407x124 each")
    if sum(scores["count"].values()) != len(names) or not all(
            math.isfinite(v) for d in ("psnr", "ssim", "lpips") for v in scores[d].values()):
        fail(f"eval-color: {dict(scores['count'])} pairs for {len(names)}; psnr "
             f"{dict(scores['psnr'])} ssim {dict(scores['ssim'])} lpips {dict(scores['lpips'])}")
    if again[0]["frames"] or again[1]["images"] or any(again_launches.values()):
        fail(f"second runs: save-depth-metrics did {again[0]['frames']}, render-colors "
             f"{again[1]['images']} images, launches {again_launches}; expected nothing")

    # launches: per encode 6 sphere resamples (G) and 192 eval applies (N2,
    # bf16); per render chunk of 4000 rays two pyramid gathers and one C
    encodes = len(depth_run["frames"]) + len(color_run["render_s"])
    pix_chunks = -(-len(common.strided_pixel_grid((1220, 370), 3)[0]) // ev.EVAL_CHUNK)
    chunks = (sum(-(-r // ev.EVAL_CHUNK) for rs in depth_run["rays"] for r in rs)
              + pix_chunks * color_run["images"])
    want = {"gather_levels": SPHERE_RESAMPLES * encodes + 2 * chunks,
            "sort_composite": chunks, "bn_apply": BN_SITES * encodes,
            "bn_apply_bf16": BN_SITES * encodes, "bn_stats": 0, "gather_levels_bwd": 0,
            "sort_composite_bwd": 0, "ray_som": 0, "tsdf_integrate": 0}
    got = {k: launches[k] for k in want}
    if got != want or launches["gather_levels_bf16"] < 2 * chunks:
        fail(f"eval launches {launches}; expected {want} and >= {2 * chunks} bf16 G")

    # one source's depth at its LiDAR pixels through the kernels against the
    # plain versions, on the kernels' encode
    model = load_model(model_path, dev)
    it = items[0]
    pyramid = ev.FrameEncoder(model)(it)
    args = (model, pyramid, it["cam_K"], it["T_source2infers"][0],
            it["loc2d_with_depths"][0], ev.EVAL_CHUNK)
    depth = ev.render_depth_at_pixels(*args, torch.Generator(device=dev).manual_seed(0))[0]
    with build.plain_versions():
        ref = ev.render_depth_at_pixels(*args, torch.Generator(device=dev).manual_seed(0))[0]
    share = float(np.isclose(depth, ref, rtol=SERVE_RTOL,
                             atol=SERVE_RTOL * float(np.abs(ref).max())).mean())
    if share < SERVE_MIN_SHARE:
        fail(f"eval render at {len(ref)} LiDAR pixels: the kernels agree with the plain "
             f"versions on {share:.4%} of rays")
    del model, pyramid
    torch.cuda.empty_cache()

    # LPIPS on the card against the CPU, one pair
    name = names[0]
    pair = [torch.from_numpy((np.array(Image.open(out / d / "08" / name).convert("RGB").resize(
        ev.KITTI_COLOR_SIZE), np.float32) / 255.0 - 0.5) * 2) for d in ("render_rgb", "rgb")]
    lp = {d: float(LPIPS.from_torch_checkpoint(vgg_path, lin_path, d)(*(t.to(d) for t in pair)))
          for d in (dev, "cpu")}
    if not math.isclose(lp[dev], lp["cpu"], rel_tol=LPIPS_RTOL):
        fail(f"LPIPS on the card {lp[dev]} against the CPU {lp['cpu']} (rtol {LPIPS_RTOL})")

    rays = sum(sum(rs) for rs in depth_run["rays"])
    numbers = dict(
        depth_item_ms=[(r + e + d) * 1e3 for r, e, d in zip(
            depth_run["read_s"], depth_run["encode_s"], depth_run["render_s"])],
        depth_read_ms=[s_ * 1e3 for s_ in depth_run["read_s"]],
        depth_encode_ms=[s_ * 1e3 for s_ in depth_run["encode_s"]],
        depth_render_ms=[s_ * 1e3 for s_ in depth_run["render_s"]],
        sources=[len(rs) for rs in depth_run["rays"]], lidar_rays=rays,
        lidar_rays_per_s=rays / sum(depth_run["render_s"]),
        color_image_ms=sum(color_run["render_s"]) * 1e3 / color_run["images"],
        color_read_ms=[s_ * 1e3 for s_ in color_run["read_s"]],
        pair_host_ms=statistics.median(scores["host_s"]) * 1e3,
        pair_lpips_ms=statistics.median(scores["lpips_s"]) * 1e3,
        peak_gib=peak / 2**30, command_s=[depth_s, color_s, score_s])
    print(f"[15 eval] save-depth-metrics, agg-depth-metrics, render-colors, eval-color on "
          f"{len(items)} val items, {len(names)} sources ({rays} LiDAR rays) from {model_path} "
          f"(best, bf16): pickles finite, n_frames {n_total}, the All row the pickles' mean; "
          f"{len(names)} render PNGs 407x124; second runs rendered nothing (launches "
          f"{again_launches}); launches {got}; kernels vs plain at {len(ref)} LiDAR pixels "
          f"{share:.4%} of rays within rtol {SERVE_RTOL}; LPIPS card {lp[dev]:.7f} vs CPU "
          f"{lp['cpu']:.7f}; Total: abs_rel {agg_all[0]:.4f}, a1 {agg_all[4]:.4f}")
    print(f"[15 numbers] on {card}: save-depth-metrics per val item "
          f"{['%.1f' % v for v in numbers['depth_item_ms']]} ms = host read (ICP cold) "
          f"{['%.1f' % v for v in numbers['depth_read_ms']]} + encode "
          f"{['%.1f' % v for v in numbers['depth_encode_ms']]} + renders and errors "
          f"{['%.1f' % v for v in numbers['depth_render_ms']]} ms (sources "
          f"{numbers['sources']}); {numbers['lidar_rays_per_s']:.0f} LiDAR rays/s in the "
          f"renders; render-colors {numbers['color_image_ms']:.1f} ms per image (encode, render, "
          f"PNG; item reads {['%.1f' % v for v in numbers['color_read_ms']]} ms); eval-color per "
          f"pair PSNR + SSIM {numbers['pair_host_ms']:.1f} ms host, LPIPS "
          f"{numbers['pair_lpips_ms']:.1f} ms; peak device memory {numbers['peak_gib']:.2f} GiB;"
          f" commands {['%.1f' % v for v in numbers['command_s']]} s")
    return {"launches": launches, "numbers": numbers}


def main() -> None:
    if not (ROOT / "scenerf_tpu_torch").is_dir():
        fail(f"the port package scenerf_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")

    import numpy as np
    import torch.nn.functional as F

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch import sampling as S
    from scenerf_tpu_torch.data.synthetic import default_intrinsics, input_frame, make_batch
    from scenerf_tpu_torch.encoder.sphere_decoder import sphere_map_coords
    from scenerf_tpu_torch.fields import gaussian_params_from_offsets
    from scenerf_tpu_torch.model import SceneRF, compute_sphere_maps
    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import gather as ops_gather
    from scenerf_tpu_torch.ops import norm as NM
    from scenerf_tpu_torch.ops.composite import (SOM_KEYS, SomInputs, sort_composite,
                                                 sort_composite_backward,
                                                 sort_composite_forward, sort_composite_plain)
    from scenerf_tpu_torch.ops.gather import (gather_levels, gather_levels_backward,
                                              gather_levels_plain, lanes_per_point,
                                              share_pyramid_grads)
    from scenerf_tpu_torch.rendering import (SCALES, inverse, pyramid_coords,
                                             pyramid_level_size)
    from scenerf_tpu_torch.som import som_em, som_em_plain
    from scenerf_tpu_torch.train import Trainer

    dev = torch.device("cuda", 0)
    # phase 14's KITTI tree, written by two host processes meanwhile
    tree_dir = tempfile.TemporaryDirectory(prefix="scenerf_kitti_")
    tree_procs = start_kitti_tree(Path(tree_dir.name))

    # ---- 1. device -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"[1 device] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | kernels built+loaded in {build_s:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'reused'})")
    for line in build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    def empty_launch(n_rays: int) -> None:
        # an empty kernel on the grid kernels C and S take for n_rays rays
        build.check(build.library().scenerf_empty_launch(n_rays, build.stream_handle(dev)),
                    "empty")

    chunk = C.kitti().ray_chunk
    floor = {"one_block_ms": graph_ms(lambda: empty_launch(1)),
             "train_chunk_grid_ms": graph_ms(lambda: empty_launch(chunk))}
    print(f"[1 device] an empty kernel alone (graph of {GRAPH_REPS}): one block "
          f"{floor['one_block_ms'] * 1e3:.2f} us, kernel C's grid at a training chunk "
          f"({chunk} rays) {floor['train_chunk_grid_ms'] * 1e3:.2f} us")

    cfg = C.kitti()
    K_np = default_intrinsics(cfg)
    K = torch.from_numpy(K_np).to(dev)
    inv_K = inverse(K)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # ---- 2. kernel G -----------------------------------------------------
    widths = [cfg.encoder_features // k for k in (32, 16, 8, 4, 2)]
    levels = [torch.randn(*pyramid_level_size(cfg.sphere, s), c, generator=gen, device=dev)
              for s, c in zip(SCALES, widths)]
    W, H = cfg.img_size
    grid = geo.pixel_grid(W, H, device=dev)
    grid = grid[(grid[:, 0] % STRIDE == 0) & (grid[:, 1] % STRIDE == 0)]
    pix = grid[torch.linspace(0, grid.shape[0] - 1, N_RAYS, device=dev).long()]
    pose = torch.from_numpy(geo.sample_rel_poses(0.5, 10.0, 1.0)[(0.5, 10.0)]).to(dev)
    pts, _, _, _ = S.sample_rays_uniform(gen, pix, inv_K, pose, N_PTS,
                                         cfg.min_sample_depth, cfg.max_sample_depth)
    ix, iy = pyramid_coords(pts.reshape(-1, 3), K, inv_K, cfg.sphere,
                            [lv.shape[:2] for lv in levels])
    got = gather_levels(levels, ix, iy)
    want = gather_levels_plain(levels, ix, iy)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"gather_levels: not bit-equal to the plain version (max abs error "
             f"{float((got - want).abs().max())})")
    ms = cuda_ms(lambda: gather_levels(levels, ix, iy))
    plain_ms = cuda_ms(lambda: gather_levels_plain(levels, ix, iy))
    touched = touched_row_bytes(levels, ix, iy)
    # per point and channel: 6 multiplies and 3 adds
    results["gather_levels"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                    **bound(touched + nbytes(ix, iy, got), 9 * got.numel()),
                                    library_ms=None,
                                    lanes=lanes_per_point([lv.shape[2] for lv in levels], ix.shape[1]))
    print(f"[2 kernel G] pyramid {[tuple(lv.shape) for lv in levels]} at "
          f"{ix.shape[1]} points -> {tuple(got.shape)}: bit-equal to the plain version; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{results['gather_levels']['bound_ms']:.3f} ms ({touched / 1e6:.0f} MB of level "
          f"rows touched; all levels {nbytes(*levels) / 1e6:.0f} MB)")

    def check_g(what: str, lvs, gx, gy) -> dict:
        """One-level kernel G bit-equal to its plain version, and its time
        beside F.grid_sample on the same tap and coords (NCHW, zeros,
        align_corners=False): events and alone (graph), and the bound."""
        lv = lvs[0]
        h, w, c = lv.shape
        g1 = gather_levels(lvs, gx, gy)
        g0 = gather_levels_plain(lvs, gx, gy)
        grid = torch.stack([(2 * gx[0] + 1) / w - 1, (2 * gy[0] + 1) / h - 1], -1)
        grid = grid.view(1, 1, -1, 2)
        nchw = lv.permute(2, 0, 1)[None].contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                    align_corners=False)
        lib_diff = float((lib()[0, :, 0].t() - g1).abs().max())
        torch.cuda.synchronize()
        if not torch.equal(g1, g0):
            fail(f"gather_levels at {what}: not bit-equal to the plain version (max abs "
                 f"error {float((g1 - g0).abs().max())})")
        run = lambda: gather_levels(lvs, gx, gy)  # noqa: E731
        return dict(shape=what, ms=cuda_ms(run), device_ms=graph_ms(run),
                    plain_ms=cuda_ms(lambda: gather_levels_plain(lvs, gx, gy)),
                    library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib),
                    library_max_abs_diff=lib_diff, lanes=lanes_per_point([c], gx.shape[1]),
                    **bound(touched_row_bytes(lvs, gx, gy) + nbytes(gx, gy, g1), 9 * g1.numel()))

    # every sphere resample of the B7 encoder (tap widths of the backbone; s32
    # resamples the decoder's conv2 output) and the reprojection gather
    with torch.device("meta"):
        tap_ch = SceneRF(cfg).net_rgb.encoder.original_model.tap_channels
    tap_widths = {s: (tap_ch[f"s{s}"] if s < 32 else cfg.encoder_features)
                  for s in (1, 2, 4, 8, 16, 32)}
    sphere_maps = compute_sphere_maps(cfg, K_np)
    one_level = []
    for s, c in tap_widths.items():
        tap = torch.randn(-(-H // s), -(-W // s), c, generator=gen, device=dev)
        m = torch.from_numpy(sphere_maps[s]).to(dev)
        rix, riy = sphere_map_coords(m, tap.shape[0], tap.shape[1])
        one_level.append(check_g(f"s{s} sphere resample {list(tap.shape)} -> "
                                 f"{list(m.shape[:2])}", [tap], rix[None], riy[None]))
    rimg = torch.rand(H, W, 3, generator=gen, device=dev)
    span = torch.tensor([W + 40.0, H + 40.0], device=dev)
    pix_img = torch.rand(cfg.n_rays, 2, generator=gen, device=dev) * span - 20.0  # some off
    pix_x, pix_y = geo.pix_feature_coords(pix_img, H, W)
    one_level.append(check_g(f"reprojection {list(rimg.shape)} at {cfg.n_rays} pixels", [rimg],
                             pix_x[None].contiguous(), pix_y[None].contiguous()))
    results["gather_levels"]["library_at"] = one_level
    for r in one_level:
        print(f"[2 kernel G] {r['shape']} ({r['lanes']} lanes per point): bit-equal; kernel "
              f"{r['ms']:.4f} ms, alone {r['device_ms']:.4f} ms; F.grid_sample {r['library_ms']:.4f}"
              f" ms, alone {r['library_device_ms']:.4f} ms (max |diff| {r['library_max_abs_diff']:.1e});"
              f" plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms")

    # ---- 3. kernel C -----------------------------------------------------
    def composite_inputs(R: int):
        """A KITTI-shaped ray block: uniform and Gaussian distances (clamped:
        ties), depths, densities, colors, and the Gaussians [R, 4] about
        which the Gaussian samples were drawn."""
        sd_u = S.uniform_sensor_distances(gen, R, cfg.n_pts_uni, cfg.min_sample_depth,
                                          cfg.max_sample_depth, device=dev)
        m = torch.rand(R, cfg.n_gaussians, generator=gen, device=dev) * 100.0
        sdev = torch.rand(R, cfg.n_gaussians, generator=gen, device=dev) * 5.0 + 1.5
        sd_gs = torch.clamp(torch.repeat_interleave(m, cfg.n_pts_per_gaussian, 1)
                            + torch.randn(R, cfg.n_pts_gauss, generator=gen, device=dev)
                            * torch.repeat_interleave(sdev, cfg.n_pts_per_gaussian, 1),
                            min=cfg.min_clamp_depth)  # clamped ties included
        sd_r = torch.cat([sd_u, sd_gs], 1)
        dv_r = sd_r * (0.8 + 0.2 * torch.rand(R, 1, generator=gen, device=dev))
        dens_r = torch.nn.functional.softplus(
            torch.randn(R, N_PTS, generator=gen, device=dev) - 1.0)
        rgb_r = torch.rand(R, N_PTS, 3, generator=gen, device=dev)
        return [sd_r, dv_r, dens_r, rgb_r], m, sdev

    def composite_bound(ins, outs, n_protos: int = 0) -> dict:
        """Kernel C's bound on these inputs and outputs: per sample the
        21-stage bitonic network's compares and ~20 arithmetic ops; with
        RaySOM's EM, C^2 products and sums for p(z|c2) and ~12 C for p(z|c1)
        and the weights."""
        return bound(nbytes(*ins, *outs),
                     ins[0].numel() * (41 + 2 * n_protos ** 2 + 12 * n_protos))

    c_in, c_rows = {}, []
    for R in C_RAYS:
        ins, m, sdev = composite_inputs(R)
        c_in[R] = (ins, m, sdev)
        ck = sort_composite(*ins)
        cp = sort_composite_plain(*ins)
        torch.cuda.synchronize()
        cerr = 0.0
        for k in ("depth", "color"):
            ok = torch.isclose(ck[k], cp[k], rtol=COMPOSITE_RTOL, atol=1e-6)
            if not bool(ok.all()):
                fail(f"sort_composite R={R} {k}: {int((~ok).sum())} values beyond rtol "
                     f"{COMPOSITE_RTOL}")
            cerr = max(cerr, float((ck[k] - cp[k]).abs().max()))
        for k in ("sensor_distance", "depth_volume"):
            if not torch.equal(ck[k], cp[k]):
                fail(f"sort_composite R={R} {k}: sorted order differs from the stable sort")
        same_argmin = float((ck["closest_idx"] == cp["closest_idx"]).float().mean())
        if same_argmin < ARGMIN_MIN_SHARE:
            fail(f"sort_composite R={R} argmin agrees on {same_argmin:.4%} of rays")
        c_rows.append(dict(rays=R, max_abs_err=cerr,
                           argmin_equal=same_argmin,
                           ms=cuda_ms(lambda: sort_composite(*ins)),
                           plain_ms=cuda_ms(lambda: sort_composite_plain(*ins)),
                           **composite_bound(ins, ck.values())))
        print(f"[3 kernel C] R={R} P={N_PTS}: depth/color max abs err {cerr:.3e} (rtol {COMPOSITE_RTOL}), sorted "
              f"outputs bit-equal, argmin equal on {same_argmin:.4%} of rays; kernel "
              f"{c_rows[-1]['ms']:.3f} ms, plain {c_rows[-1]['plain_ms']:.3f} ms, bound "
              f"{c_rows[-1]['bound_ms'] * 1e3:.2f} us")
        del ck, cp
    (sd, dv, dens, rgb), means, stds = c_in[N_RAYS]
    main_row = c_rows[C_RAYS.index(N_RAYS)]
    results["sort_composite"] = dict(
        {k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, at_shapes=c_rows)
    del levels, ix, iy, got, want
    torch.cuda.empty_cache()

    # ---- 4. encode -------------------------------------------------------
    torch.manual_seed(SEED)
    with torch.device(dev):
        model = SceneRF(cfg).eval()
    img = torch.from_numpy(input_frame(cfg, seed=SEED)).to(dev)
    # every batch norm site of the encode: its input's shape and layout
    # (NM.plane: 0 channel-last, > 0 channel-first, None neither) and its
    # activation and residual (kernel K5's launch configurations)
    bn_sites = {"eval": [], "train": []}
    k5_paths = {"forward": [], "backward": []}  # each training site's K5 paths (step 0)

    def site_hooks(path: str) -> list:
        def record_site(mod, args, kwargs):
            x_in = args[0]
            res_in = args[1] if len(args) > 1 else kwargs.get("residual")
            bn_sites[path].append((tuple(x_in.shape), mod.act, res_in is not None, mod.eps,
                                   mod.momentum, NM.plane(x_in)))

        return [m.register_forward_pre_hook(record_site, with_kwargs=True)
                for m in model.modules() if isinstance(m, FusedBatchNorm)]

    bn_hooks = site_hooks("eval")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv = model.encode(img, K_np, sphere_maps=sphere_maps)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    encode_launches = dict(build.LAUNCHES)
    for h in bn_hooks:
        h.remove()
    bn_eval = (encode_launches["bn_stats"], encode_launches["bn_apply"])
    if len(bn_sites["eval"]) != BN_SITES or bn_eval != (0, BN_SITES):
        fail(f"encode: {len(bn_sites['eval'])} batch norm sites, K5 launches (stats, apply) "
             f"{bn_eval}; expected {BN_SITES} eval applies and no statistics")

    def layouts(path: str) -> str:
        planes = [site[-1] for site in bn_sites[path]]
        return (f"{sum(p == 0 for p in planes)} channel-last, "
                f"{sum(bool(p) for p in planes)} channel-first of {len(planes)} sites")
    want_shapes = [(1, *pyramid_level_size(cfg.sphere, s), c) for s, c in zip(SCALES, widths)]
    got_shapes = [tuple(lv[k].shape) for k in ("1_1", "1_2", "1_4", "1_8", "1_16")]
    if got_shapes != want_shapes:
        fail(f"encode level shapes {got_shapes} != {want_shapes}")
    for k, v in lv.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"encode level {k} is not finite")
    print(f"[4 encode] B7 spherical U-Net on {W}x{H}: levels {got_shapes}, finite, "
          f"max|level| {['%.3e' % float(v.abs().max()) for v in lv.values()]}; "
          f"first call {encode_ms:.1f} ms; kernel K5: {bn_eval[1]} eval launches (one per "
          f"batch norm), inputs {layouts('eval')} (views, no copies)")

    # ---- 5. serve --------------------------------------------------------
    pyramid = model.pyramid_for_item(lv, 0)
    poses_np = geo.rel_pose_stack(geo.sample_rel_poses(
        cfg.sweep_step, cfg.sweep_angle, cfg.sweep_max_distance))[:SWEEP_POSES]
    poses = torch.from_numpy(poses_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = model.render_pose_sweep(pyramid, K, poses, seed=SEED, stride=STRIDE,
                                    ray_chunk=CHUNK)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    depth, color = sweep["depth"], sweep["color"]
    if not (bool(torch.isfinite(depth).all()) and bool(torch.isfinite(color).all())):
        fail("sweep depth/color not finite")
    dmin, dmax = float(depth.min()), float(depth.max())
    if not (0.0 <= dmin and dmax <= cfg.max_sample_depth):
        fail(f"sweep depth range [{dmin}, {dmax}] outside [0, {cfg.max_sample_depth}]")
    for name in SERVE_KERNELS:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the serve path")
    if (launches["bn_stats"], launches["bn_apply"]) != (0, BN_SITES):
        fail(f"serve: K5 launches {launches}; expected {BN_SITES} eval applies (the encode)")
    n_rays = depth[0].numel()
    g0 = torch.Generator(device=dev).manual_seed(SEED)
    with build.plain_versions():
        ref = model.render_image(pyramid, K, poses[0], g0, stride=STRIDE, ray_chunk=CHUNK)
    shares = {}
    for k in ("depth", "color"):
        ok = torch.isclose(sweep[k][0], ref[k], rtol=SERVE_RTOL,
                           atol=SERVE_RTOL * float(ref[k].abs().max()))
        if k == "color":
            ok = ok.all(dim=-1)
        shares[k] = float(ok.float().mean())
        if shares[k] < SERVE_MIN_SHARE:
            fail(f"pose 0 {k}: kernel path agrees with the plain path on {shares[k]:.4%} of pixels")
    print(f"[5 serve] {SWEEP_POSES} poses x {tuple(depth.shape[1:])} = {n_rays} rays/pose, "
          f"chunk {CHUNK}: finite, depth in [{dmin:.3f}, {dmax:.3f}]; main-path launches "
          f"{ {k: launches[k] for k in SERVE_KERNELS} }; pose 0 vs plain path within rtol {SERVE_RTOL}: depth "
          f"{shares['depth']:.4%}, color {shares['color']:.4%} of pixels")

    # ---- 6. numbers ------------------------------------------------------
    enc_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(img, K_np, sphere_maps=sphere_maps)
        torch.cuda.synchronize()
        enc_times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.render_pose_sweep(pyramid, K, poses, seed=SEED, stride=STRIDE, ray_chunk=CHUNK)
    torch.cuda.synchronize()
    warm_pose_ms = (time.perf_counter() - t0) * 1e3 / SWEEP_POSES
    print(f"[6 numbers] on {card}: encode {statistics.median(enc_times):.1f} ms "
          f"(median of 3 warm; first {encode_ms:.1f} ms); {warm_pose_ms:.1f} ms/pose warm "
          f"({sweep_ms / SWEEP_POSES:.1f} ms/pose in the first sweep); "
          f"{n_rays / warm_pose_ms * 1e3:.0f} rays/s; peak device memory "
          f"{peak / 2**30:.2f} GiB (encode + sweep)")

    serve_launches, peak_serve = launches, peak
    del lv, pyramid, sweep, depth, color, ref
    torch.cuda.empty_cache()

    # ---- 7. kernel G-bwd -------------------------------------------------
    n_train = cfg.n_rays
    levels = [torch.randn(*pyramid_level_size(cfg.sphere, s), c, generator=gen, device=dev)
              for s, c in zip(SCALES, widths)]
    pts_t, _, _, _ = S.sample_rays_uniform(gen, pix[:n_train], inv_K, pose, N_PTS,
                                           cfg.min_sample_depth, cfg.max_sample_depth)
    ix, iy = pyramid_coords(pts_t.reshape(-1, 3), K, inv_K, cfg.sphere,
                            [lv.shape[:2] for lv in levels])
    # the pyramid's gradient buffers: G-bwd adds into them; a step zeroes them once
    bufs = [torch.zeros_like(lv) for lv in levels]

    def check_gather_bwd(idx: torch.Tensor) -> dict:
        """G-bwd at the points `idx` against autograd of the plain gather;
        its time is the kernel's: it adds into the buffers (no zeroing)."""
        ix_n, iy_n = ix[:, idx].contiguous(), iy[:, idx].contiguous()
        n = idx.numel()
        d_n = torch.randn(n, sum(widths), generator=gen, device=dev)
        for b in bufs:
            b.zero_()
        gather_levels_backward(levels, ix_n, iy_n, d_n, bufs, False)
        leaves = [lv.clone().requires_grad_(True) for lv in levels]
        plain_out = gather_levels_plain(leaves, ix_n, iy_n)
        want_lv = torch.autograd.grad(plain_out, leaves, d_n, retain_graph=True)
        torch.cuda.synchronize()
        limit = GATHER_BWD_REL_TOL * max(float(b.abs().max()) for b in want_lv)
        err = max(float((a - b).abs().max()) for a, b in zip(bufs, want_lv))
        if not err <= limit:
            fail(f"gather_levels_bwd at {n} points: max abs error {err} > {limit}")
        del want_lv
        run = lambda: gather_levels_backward(levels, ix_n, iy_n, d_n, bufs, False)  # noqa: E731
        ms, dev_ms = cuda_ms(run), graph_ms(run)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, leaves, d_n, retain_graph=True))
        # per point and channel: 2 multiplies for the row pair, 4 weighted adds;
        # bytes: the cotangent, the coords, the touched gradient rows read and written
        return dict(shape=list(d_n.shape), max_abs_err=err, limit=limit, ms=ms,
                    device_ms=dev_ms, plain_ms=plain_ms,
                    **bound(nbytes(d_n, ix_n, iy_n) + 2 * touched_row_bytes(levels, ix_n, iy_n),
                            10 * d_n.numel()))

    # the training path launches G-bwd per render chunk: the chunk's samples
    # and its Gaussian anchors (here 4 spread samples of each of its rays);
    # one source's samples at once for comparison
    chunk_pts = torch.arange(cfg.ray_chunk * N_PTS, device=dev)
    anchor_pts = chunk_pts.view(cfg.ray_chunk, N_PTS)[:, ::N_PTS // cfg.n_gaussians].reshape(-1)
    bwd_runs = [check_gather_bwd(idx) for idx in (
        chunk_pts, anchor_pts, torch.arange(n_train * N_PTS, device=dev))]
    zero_all = lambda: [b.zero_() for b in bufs]  # noqa: E731
    zero_ms, zero_dev_ms = cuda_ms(zero_all), graph_ms(zero_all)
    zero_bound = bound(nbytes(*bufs), 0)["bound_ms"]
    torch.cuda.empty_cache()
    d_out = torch.randn(ix.shape[1], sum(widths), generator=gen, device=dev)
    cols = [0]
    for c in widths:
        cols.append(cols[-1] + c)
    level_ms = []
    for i in range(len(levels)):
        d_i = d_out[:, cols[i]:cols[i + 1]].contiguous()
        level_ms.append(graph_ms(lambda: gather_levels_backward(
            [levels[i]], ix[i:i + 1], iy[i:i + 1], d_i, [bufs[i]], False)))
        del d_i
    del d_out
    runs_text = "; ".join(
        f"{tuple(r['shape'])}: max abs err {r['max_abs_err']:.3e} (limit {r['limit']:.3e}), "
        f"kernel {r['ms']:.3f} ms, alone {r['device_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms" for r in bwd_runs)
    print(f"[7 kernel G-bwd] cotangents added into the pyramid's gradient buffers at a "
          f"training chunk's samples, its anchors, and one source's samples: {runs_text}; "
          f"each level alone at [{ix.shape[1]}, C] (1_1 .. 1_16) "
          f"{['%.3f' % t for t in level_ms]} ms; zeroing the buffers once "
          f"({nbytes(*bufs) / 1e6:.0f} MB) {zero_ms:.3f} ms, alone {zero_dev_ms:.3f} ms "
          f"(bound {zero_bound:.3f} ms)")

    # a training step's sequence on one pyramid: every source's chunks, each
    # gathering its anchors and samples, then one backward; through the shared
    # buffers (the training path), and with every gather zeroing its own full
    # level gradients that autograd then sums; held to autograd of the plain
    # gathers, summed
    n_chunks = n_train // cfg.ray_chunk
    seq_idx = []
    for c in range(n_chunks):
        samples = chunk_pts + c * cfg.ray_chunk * N_PTS
        seq_idx += [anchor_pts + c * cfg.ray_chunk * N_PTS, samples]
    seq_idx = seq_idx * cfg.n_sources
    seq_xy = [(ix[:, i].contiguous(), iy[:, i].contiguous()) for i in seq_idx]
    seq_cot = [torch.randn(i.numel(), sum(widths), generator=gen, device=dev) for i in seq_idx]

    def step_backward(shared: bool):
        """(level gradients, ms of the backward alone, launches)."""
        leaves = [lv.detach().requires_grad_(True) for lv in levels]
        pyramid, pgrads = share_pyramid_grads(leaves) if shared else (leaves, None)
        outs = [gather_levels(pyramid, x, y, grads=pgrads) for x, y in seq_xy]
        build.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.backward(outs, seq_cot)
        end.record()
        end.synchronize()
        return [lv.grad for lv in leaves], start.elapsed_time(end), build.LAUNCHES["gather_levels_bwd"]

    want_seq = [torch.zeros_like(lv) for lv in levels]
    for (x, y), cot in zip(seq_xy, seq_cot):
        leaves = [lv.detach().requires_grad_(True) for lv in levels]
        for acc, g in zip(want_seq, torch.autograd.grad(gather_levels_plain(leaves, x, y),
                                                        leaves, cot)):
            acc.add_(g)
    got_seq, _, seq_launches = step_backward(shared=True)
    torch.cuda.synchronize()
    seq_limit = GATHER_BWD_REL_TOL * max(float(b.abs().max()) for b in want_seq)
    seq_err = max(float((a - b).abs().max()) for a, b in zip(got_seq, want_seq))
    if not seq_err <= seq_limit or seq_launches != len(seq_idx):
        fail(f"gather_levels_bwd step sequence: max abs error {seq_err} > {seq_limit} "
             f"({seq_launches} launches)")
    del got_seq, want_seq
    seq_ms = {True: [], False: []}
    for shared in (True, False, False, True, True, False):
        seq_ms[shared].append(step_backward(shared)[1])
    step_seq = dict(gathers=len(seq_idx), max_abs_err=seq_err, limit=seq_limit,
                    shared_backward_ms=statistics.median(seq_ms[True]),
                    per_gather_zeroing_backward_ms=statistics.median(seq_ms[False]))
    print(f"[7 kernel G-bwd] one step's {len(seq_idx)} gathers on one pyramid ({cfg.n_sources} "
          f"sources x {n_chunks} chunks x anchors + samples): level gradients within "
          f"{seq_err:.3e} of the plain gathers' summed (limit {seq_limit:.3e}); backward "
          f"{step_seq['shared_backward_ms']:.2f} ms through the shared buffers, "
          f"{step_seq['per_gather_zeroing_backward_ms']:.2f} ms with a zeroed gradient per "
          f"gather and autograd's sums (median of 3 each)")
    del seq_xy, seq_cot, bufs
    torch.cuda.empty_cache()

    d_col = torch.randn(n_train, 3, generator=gen, device=dev)
    img_x, img_y = pix_x[None].contiguous(), pix_y[None].contiguous()
    gx, gy = gather_levels_backward([rimg], img_x, img_y, d_col, [None], True)
    cx, cy = img_x.clone().requires_grad_(True), img_y.clone().requires_grad_(True)
    wx, wy = torch.autograd.grad(gather_levels_plain([rimg], cx, cy), (cx, cy), d_col)
    torch.cuda.synchronize()
    xy_scale = max(float(wx.abs().max()), float(wy.abs().max()))
    xy_err = max(float((gx - wx).abs().max()), float((gy - wy).abs().max()))
    if not xy_err <= COORD_GRAD_REL_TOL * xy_scale:
        fail(f"gather_levels_bwd coords: max abs error {xy_err} > {COORD_GRAD_REL_TOL} x {xy_scale}")
    xy_run = lambda: gather_levels_backward([rimg], img_x, img_y, d_col, [None], True)  # noqa: E731
    xy_ms, xy_dev_ms = cuda_ms(xy_run), graph_ms(xy_run)
    print(f"[7 kernel G-bwd] reprojection gather {tuple(rimg.shape)} at {n_train} pixels with "
          f"d_ix/d_iy: max abs err {xy_err:.3e} (limit {COORD_GRAD_REL_TOL * xy_scale:.3e}); "
          f"kernel {xy_ms:.4f} ms, alone {xy_dev_ms:.4f} ms")

    # every sphere resample's backward into its tap beside grid_sample's
    # backward (one aten call: it allocates and zeroes the tap gradient);
    # the encoder's resamples are not shared, so each zeroes its tap gradient
    resample_bwd = []
    for s, c in tap_widths.items():
        h, w = -(-H // s), -(-W // s)
        tap = torch.randn(h, w, c, generator=gen, device=dev)
        rix, riy = sphere_map_coords(torch.from_numpy(sphere_maps[s]).to(dev), h, w)
        rix, riy = rix[None].contiguous(), riy[None].contiguous()
        g_res = torch.randn(rix.shape[1], c, generator=gen, device=dev)
        d_tap = torch.zeros_like(tap)
        gather_levels_backward([tap], rix, riy, g_res, [d_tap], False)
        leaf = tap.clone().requires_grad_(True)
        want_tap, = torch.autograd.grad(gather_levels_plain([leaf], rix, riy), leaf, g_res)
        torch.cuda.synchronize()
        r_err = float((d_tap - want_tap).abs().max())
        if not r_err <= GATHER_BWD_REL_TOL * float(want_tap.abs().max()):
            fail(f"gather_levels_bwd s{s} resample: max abs error {r_err}")
        grid = torch.stack([(2 * rix[0] + 1) / w - 1, (2 * riy[0] + 1) / h - 1], -1)
        grid = grid.view(1, 1, -1, 2)
        nchw = tap.permute(2, 0, 1)[None].contiguous()
        g_nchw = g_res.t().reshape(1, c, 1, -1).contiguous()
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            g_nchw, nchw, grid, 0, 0, False, [True, False])
        run = lambda: gather_levels_backward([tap], rix, riy, g_res, [d_tap], False)  # noqa: E731
        zeroed = lambda: gather_levels_backward(  # noqa: E731
            [tap], rix, riy, g_res, [torch.zeros_like(tap)], False)
        resample_bwd.append(dict(
            shape=f"s{s} sphere resample {[h, w, c]} -> {list(sphere_maps[s].shape[:2])}",
            max_abs_err=r_err, device_ms=graph_ms(run), zeroed_device_ms=graph_ms(zeroed),
            library_ms=cuda_ms(lib), library_device_ms=graph_ms(lib),
            **bound(nbytes(g_res, rix, riy) + 2 * touched_row_bytes([tap], rix, riy),
                    10 * g_res.numel())))
        del tap, d_tap, want_tap, leaf, nchw, g_nchw, g_res
    for r in resample_bwd:
        print(f"[7 library] {r['shape']}: G-bwd alone {r['device_ms']:.4f} ms "
              f"({r['zeroed_device_ms']:.4f} ms with its zeroed tap gradient), grid_sample "
              f"backward {r['library_ms']:.4f} ms, alone {r['library_device_ms']:.4f} ms; "
              f"bound {r['bound_ms']:.4f} ms; max abs err {r['max_abs_err']:.2e}")
    main_run = {k: v for k, v in bwd_runs[0].items() if k != "limit"}
    results["gather_levels_bwd"] = dict(
        **main_run, library_ms=None,
        other_shapes=[{k: r[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms")}
                      for r in bwd_runs[1:]],
        zeroing_ms=zero_ms, zeroing_device_ms=zero_dev_ms, step_sequence=step_seq,
        reprojection_coords=dict(ms=xy_ms, device_ms=xy_dev_ms, max_abs_err=xy_err),
        library_at=resample_bwd)
    del levels, ix, iy
    torch.cuda.empty_cache()

    # ---- 8. kernel C-bwd -------------------------------------------------
    hot = torch.rand(N_RAYS, N_PTS, generator=gen, device=dev) < 0.2
    dens_sat = torch.where(hot, dens * 100 + 50, dens)  # saturated alphas
    ins = [sd, dv, dens_sat, rgb]

    def som_of(m, sdev):
        return SomInputs(m, sdev, cfg.som_sigma, cfg.som_mask_threshold)

    # the order of kernel C's training launch, the one with RaySOM's EM inside
    fwd_outs, order, _ = sort_composite_forward(*ins, with_order=True, som=som_of(means, stds))
    n_saturated = int((fwd_outs[2] == 1.0).sum())
    g_depth = torch.randn(N_RAYS, generator=gen, device=dev)
    g_color = torch.randn(N_RAYS, 3, generator=gen, device=dev)
    bwd = lambda: sort_composite_backward(fwd_outs[0], fwd_outs[1], order, dens_sat, rgb,
                                          g_depth, g_color)
    got_c = bwd()
    leaves = [t.clone().requires_grad_(True) for t in ins]
    pc = sort_composite_plain(*leaves)
    plain_bwd = lambda: torch.autograd.grad([pc["depth"], pc["color"]], leaves,
                                            [g_depth, g_color], retain_graph=True)
    want_c = plain_bwd()
    torch.cuda.synchronize()
    cb_err = 0.0
    for name, a, b in zip(("d_sd", "d_dv", "d_density", "d_rgb"), got_c, want_c):
        if not bool(torch.isfinite(a).all()):
            fail(f"sort_composite_bwd {name} is not finite")
        lim = 1e-5 * float(b.abs().max())
        ok = (a - b).abs() <= COMPOSITE_BWD_RTOL * b.abs() + lim
        if not bool(ok.all()):
            fail(f"sort_composite_bwd {name}: {int((~ok).sum())} values beyond rtol "
                 f"{COMPOSITE_BWD_RTOL}")
        cb_err = max(cb_err, float((a - b).abs().max()))
    ms = cuda_ms(bwd)
    plain_ms = cuda_ms(plain_bwd)
    # device time alone: inputs read from HBM (copies cycled past the L2),
    # and with one copy, whose inputs stay in the L2 between launches
    bwd_copies = hbm_copies((fwd_outs[0], fwd_outs[1], order, dens_sat, rgb, g_depth, g_color))
    dev_ms = graph_ms([lambda c=c: sort_composite_backward(*c) for c in bwd_copies])
    dev_ms_l2 = graph_ms(bwd)
    n_copies = len(bwd_copies)
    del bwd_copies
    # kernel C alone (as the serve and GT-depth renders launch it) and its
    # training launch (sort order written, RaySOM's EM inside) at each launch
    # size, from HBM and L2-resident
    for row in c_rows:
        ins_r, m_r, s_r = c_in[row["rays"]]
        copies = hbm_copies((*ins_r, m_r, s_r))
        row.update(
            hbm_copies=len(copies), copies_mb=len(copies) * nbytes(*copies[0]) / 1e6,
            device_ms=graph_ms([lambda c=c: sort_composite_forward(*c[:4]) for c in copies]),
            device_ms_l2=graph_ms(lambda: sort_composite_forward(*ins_r)),
            fused_device_ms=graph_ms([lambda c=c: sort_composite_forward(
                *c[:4], with_order=True, som=som_of(*c[4:])) for c in copies]),
            fused_device_ms_l2=graph_ms(lambda: sort_composite_forward(
                *ins_r, with_order=True, som=som_of(m_r, s_r))))
        del copies
    results["sort_composite"].update(device_ms=main_row["device_ms"],
                                     device_ms_l2=main_row["device_ms_l2"])
    results["sort_composite_bwd"] = dict(
        max_abs_err=cb_err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, device_ms_l2=dev_ms_l2,
        **bound(nbytes(fwd_outs[0], fwd_outs[1], order, dens_sat, rgb, g_depth, g_color,
                       *got_c), 60 * sd.numel()), library_ms=None)
    print(f"[8 kernel C-bwd] R={N_RAYS} P={N_PTS}, {n_saturated} saturated alphas, through "
          f"the order of C's training launch: max abs err {cb_err:.3e} (rtol "
          f"{COMPOSITE_BWD_RTOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; device time "
          f"alone (graph of {GRAPH_REPS}), inputs from HBM ({n_copies} copies cycled) / "
          f"L2-resident: {dev_ms * 1e3:.1f} / {dev_ms_l2 * 1e3:.1f} us")
    for row in c_rows:
        print(f"[8 kernel C] R={row['rays']} alone, "
              f"inputs cycled over {row['hbm_copies']} copies ({row['copies_mb']:.0f} MB; the "
              f"L2 holds {L2_BYTES / 1e6:.0f} MB) / L2-resident: C {row['device_ms'] * 1e3:.2f} / "
              f"{row['device_ms_l2'] * 1e3:.2f} us, its training launch (order + RaySOM's EM) "
              f"{row['fused_device_ms'] * 1e3:.2f} / {row['fused_device_ms_l2'] * 1e3:.2f} us; "
              f"bound of C {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    del leaves, pc, want_c

    # ---- 9. RaySOM's EM: inside kernel C's training launch, and kernel S --
    R_s = cfg.ray_chunk
    anchors = S.gaussian_anchor_distances(cfg.n_gaussians, cfg.max_sample_depth, device=dev)
    offs = torch.randn(R_s, cfg.n_gaussians, 2, generator=gen, device=dev) * 5.0
    g_means, g_stds = gaussian_params_from_offsets(offs, anchors, cfg.std, cfg.mean_std_floor)
    ins_s = c_in[R_s][0]
    som_in = som_of(g_means, g_stds)
    build.reset_launch_counts()
    fused = sort_composite(*ins_s, som=som_in)
    s_sd, s_alpha = fused["sensor_distance"], fused["alphas"]
    som_args = (g_means, g_stds, s_sd, s_alpha, cfg.som_sigma, cfg.som_mask_threshold)
    got_s = som_em(*som_args)
    counts = dict(build.LAUNCHES)
    want_s = som_em_plain(*som_args)
    torch.cuda.synchronize()
    if (counts["sort_composite"], counts["ray_som"], counts["ray_som_in_sort_composite"]) != (1, 2, 1):
        fail(f"ray_som: launch counts {counts} after one fused launch and one of S")

    def agreement(got) -> float:
        agree = torch.ones(R_s, dtype=torch.bool, device=dev)
        for a, b in zip(got[:2], want_s[:2]):
            agree &= torch.isclose(a, b, rtol=SOM_RTOL, atol=SOM_RTOL).all(dim=1)
        agree &= (got[2] == want_s[2]).all(dim=1)
        return float(agree.float().mean())

    got_f = [fused[k] for k in SOM_KEYS]
    share_f, share_s = agreement(got_f), agreement(got_s)
    if min(share_f, share_s) < SOM_MIN_SHARE:
        fail(f"ray_som: the EM inside C agrees with the plain version on {share_f:.4%} of "
             f"rays, kernel S on {share_s:.4%}")
    f_err = max(float((a - b).abs().max()) for a, b in zip(got_f, want_s))
    s_err = max(float((a - b).abs().max()) for a, b in zip(got_s, want_s))

    def c_then_s():
        outs, _, _ = sort_composite_forward(*ins_s, with_order=True)
        return som_em(g_means, g_stds, outs[0], outs[2], cfg.som_sigma, cfg.som_mask_threshold)

    def fused_plain():
        out = sort_composite_plain(*ins_s)
        return som_em_plain(g_means, g_stds, out["sensor_distance"], out["alphas"],
                            cfg.som_sigma, cfg.som_mask_threshold)

    ms = cuda_ms(lambda: som_em(*som_args))
    plain_ms = cuda_ms(lambda: som_em_plain(*som_args))
    fused_ms = cuda_ms(lambda: sort_composite(*ins_s, som=som_in))
    fused_plain_ms = cuda_ms(fused_plain)
    c_ms = cuda_ms(lambda: sort_composite(*ins_s))
    # alone, L2-resident as on the training path (C reads what the field has
    # just written, S what C has just written), C writing the sort order
    dev_ms = graph_ms(lambda: som_em(*som_args))
    fused_dev = graph_ms(lambda: sort_composite_forward(*ins_s, with_order=True, som=som_in))
    c_dev = graph_ms(lambda: sort_composite_forward(*ins_s, with_order=True))
    c_s_dev = graph_ms(c_then_s)
    C_ = cfg.n_gaussians
    fused_bound = composite_bound(ins_s, [*(fused[k] for k in fused), g_means, g_stds], C_)
    # the numbers of the launch the training path makes: kernel C's training
    # launch with the EM inside, against the plain sort-composite then EM
    results["ray_som"] = dict(
        max_abs_err=f_err, agree_share=share_f, ms=fused_ms, plain_ms=fused_plain_ms,
        device_ms_l2=fused_dev, **fused_bound, library_ms=None,
        launched_in="scenerf_tpu_torch/ops/csrc/composite.cu (kernel C's training launch, "
                    "order written)",
        sort_composite_alone=dict(ms=c_ms, device_ms_l2=c_dev,
                                  then_standalone_s_device_ms_l2=c_s_dev),
        # the entry for sorted samples without a composite, off the training path
        standalone=dict(
            source="scenerf_tpu_torch/ops/csrc/som.cu", max_abs_err=s_err, agree_share=share_s,
            ms=ms, plain_ms=plain_ms, device_ms_l2=dev_ms,
            # per sample: C^2 products and sums for p(z|c2), ~12 C for p(z|c1) and the weights
            **bound(nbytes(g_means, g_stds, s_sd, s_alpha, *got_s),
                    s_sd.numel() * (2 * C_ * C_ + 12 * C_))))
    print(f"[9 RaySOM] R={R_s} C={C_} P={N_PTS}: the EM inside C's training launch agrees with "
          f"the plain version within rtol {SOM_RTOL} (mask equal) on {share_f:.4%} of rays (max "
          f"abs err {f_err:.3e}), kernel S alone on {share_s:.4%} ({s_err:.3e}); events: C with "
          f"the EM {fused_ms:.3f} ms (plain sort-composite then EM {fused_plain_ms:.3f} ms), C "
          f"alone {c_ms:.3f} ms, S alone {ms:.3f} ms (plain EM {plain_ms:.3f} ms); device time alone (L2-resident, order written): C with the EM "
          f"{fused_dev * 1e3:.2f} us, C alone {c_dev * 1e3:.2f} us, S alone {dev_ms * 1e3:.2f} us, "
          f"C then S {c_s_dev * 1e3:.2f} us; bound of C with the EM "
          f"{fused_bound['bound_ms'] * 1e3:.2f} us, of S "
          f"{results['ray_som']['standalone']['bound_ms'] * 1e3:.3f} us")
    del fwd_outs, order, got_c, fused, got_s, want_s
    torch.cuda.empty_cache()

    # ---- 10. train -------------------------------------------------------
    batch = make_batch(cfg, seed=SEED)
    trainer = Trainer(cfg, device=dev, model=model)
    params = dict(model.named_parameters())
    noises = [model.draw_noise(1, cfg.n_sources, gen, dev) for _ in range(TRAIN_STEPS)]
    start_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    seen_nonzero = {n: False for n in params}
    step_ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    NM.cotangent_copies = 0
    for i in range(TRAIN_STEPS):
        # step 0's layouts and K5 paths; not timed warm
        hooks = site_hooks("train") + k5_path_hooks(model, k5_paths) if i == 0 else []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, noise=noises[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for h in hooks:
            h.remove()
        gmax = torch.stack([p.grad.abs().max() for p in params.values()]).cpu()
        if not (bool(torch.isfinite(gmax).all()) and bool(torch.isfinite(metrics["total_loss"]))):
            fail(f"train step {i}: loss or gradients not finite")
        for n, m in zip(params, gmax.tolist()):
            seen_nonzero[n] |= m > 0
        losses.append(float(metrics["total_loss"]))
        if i == 0:
            metrics0 = {k: float(v) for k, v in metrics.items()}
            grads0 = {n: p.grad.detach().clone() for n, p in params.items()}
            # the first AdamW step moves each weight by -lr g / (|g| + eps)
            # (zero weight decay): held per element within 0.05 lr plus one
            # f32 spacing of the weight (the rounding of the update)
            excess, moved_by = adamw_first_move(params, start_state, grads0, cfg.lr)
            if not float(excess.max()) <= ADAM_STEP_TOL:
                fail(f"train step 0: AdamW moved a weight {float(excess.max()):.3f} lr away "
                     f"from -lr g / (|g| + eps)")
            has_grad = gmax > 0
            if not bool((moved_by[has_grad] > 0).all()):
                fail("train step 0: a parameter with a nonzero gradient did not move")
            adam_text = (f"AdamW step 0 moved all {int(has_grad.sum())} parameters with a nonzero "
                         f"gradient, each element by -lr g / (|g| + eps) within "
                         f"{max(float(excess.max()), 0.0):.2e} lr + one f32 spacing (limit "
                         f"{ADAM_STEP_TOL} lr); largest move per parameter "
                         f"{float(moved_by[has_grad].min()):.3f} .. "
                         f"{float(moved_by.max()):.3f} lr")
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in TRAIN_KERNELS:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the training path")
    if launches["ray_som"] != launches["ray_som_in_sort_composite"]:
        fail(f"the training path launched kernel S alone: {launches}")
    bn_train = [launches[k] for k in BN_KERNELS]
    if bn_train != [BN_SITES * TRAIN_STEPS] * 4:
        fail(f"train: K5 launches {dict(zip(BN_KERNELS, bn_train))} in {TRAIN_STEPS} steps; "
             f"expected {BN_SITES} of each per step")
    # one launch (N1 + N2, N3 + N4) at each site the plan puts on the cluster path
    bn_fused = k5_fused_check(launches, k5_paths)
    k5_per_step = sum(2 * BN_SITES - bn_fused[k] for k in BN_FUSED)
    bn_copies = NM.cotangent_copies
    # a conv bias that feeds a train-mode batch norm is subtracted again: zero gradient
    zero = [n for n, seen in seen_nonzero.items()
            if not seen and not re.search(r"conv_block[12]\.0\.bias$", n)]
    if zero:
        fail(f"{len(zero)} parameters never got a nonzero gradient, e.g. {zero[:3]}")
    state = model.state_dict()
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    moved = sum(not torch.equal(state[k], start_state[k]) for k in stats)
    if moved != len(stats):
        fail(f"{len(stats) - moved} of {len(stats)} BN running statistics did not move")
    warm = statistics.median(step_ms[1:])
    print(f"[10 train] {TRAIN_STEPS} steps, {cfg.n_sources} sources x {cfg.n_rays} rays x "
          f"{cfg.n_pts_per_ray} samples, f32: loss {['%.5f' % v for v in losses]}; finite; "
          f"{len(params)} parameter tensors, all with nonzero gradients; {moved} BN running "
          f"statistics moved; main-path launches {launches} (K5: {BN_SITES} forward and "
          f"{BN_SITES} backward per step, of which {bn_fused} per step in one launch, "
          f"{k5_per_step:.0f} K5 kernels a step; inputs {layouts('train')}; {bn_copies} "
          f"cotangents copied to their input's layout)")
    print(f"[10 train] {adam_text}")

    # step 0 again on the plain versions but K5's kernels: the step's loss
    # and gradients move by far more than rounding when the encode moves by
    # rounding (RaySOM's assignments, the closest-sample argmins: on this
    # card a 1e-6 change of the input frame on the plain path moved some
    # gradient leaves by over 100%), so both sides share K5's encode, and K5
    # is held to its plain version on the encode below
    model.load_state_dict(start_state)
    plain_trainer = Trainer(cfg, device=dev, model=model)
    with build.plain_versions(keep=("bn",)):
        metrics_p = plain_trainer.train_step(batch, noise=noises[0])
    torch.cuda.synchronize()
    loss_k, loss_p = metrics0["total_loss"], float(metrics_p["total_loss"])
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p):
        fail(f"train step 0: kernel-path loss {loss_k} vs plain {loss_p}")
    norms = {n: float(g.norm()) for n, g in grads0.items()}
    gscale = max(norms.values())
    worst, worst_name = 0.0, ""
    for n, p in params.items():
        diff = float((grads0[n] - p.grad).norm())
        if norms[n] <= 1e-6 * gscale:  # zero up to rounding on both paths
            if diff > 1e-5 * gscale:
                fail(f"train step 0: gradient {n} differs by {diff} (scale {gscale})")
            continue
        rel = diff / norms[n]
        if rel > worst:
            worst, worst_name = rel, n
    if worst > TRAIN_GRAD_REL_L2:
        fail(f"train step 0: gradient {worst_name} relative L2 {worst:.3e} > {TRAIN_GRAD_REL_L2}")
    metric_err = max(abs(metrics0[k] - float(v)) / max(abs(float(v)), 1e-12)
                     for k, v in metrics_p.items())
    print(f"[10 train] step 0 on the plain versions (K5's kernels kept) from the same weights "
          f"and draws: loss "
          f"{loss_p:.6f} vs kernel path {loss_k:.6f}; worst metric relative difference "
          f"{metric_err:.2e}; worst gradient leaf relative L2 {worst:.3e} ({worst_name}; "
          f"limit {TRAIN_GRAD_REL_L2})")

    # K5 on the train-mode encode: the levels, and every encoder gradient
    # under one fixed cotangent of the levels, through K5's kernels and
    # through the plain version, each held to the plain version in f64 (the
    # same f32 frame and sphere-map coords): the kernels' error at most
    # ENCODE_F64_RATIO times the plain version's
    tensors, maps_t = plain_trainer.device_batch(batch)
    enc = {}
    for name in ("kernels", "plain", "f64"):
        model.load_state_dict(start_state)
        net = copy.deepcopy(model.net_rgb).double() if name == "f64" else model.net_rgb
        net.train()
        net.zero_grad(set_to_none=True)
        cot = torch.Generator(device=dev).manual_seed(SEED + 1)
        with build.plain_versions() if name != "kernels" else contextlib.nullcontext():
            lv_e = net(tensors["img_input"].double() if name == "f64" else tensors["img_input"],
                       maps_t)
            sum((lv_e[k].double() * torch.randn(lv_e[k].shape, generator=cot, device=dev,
                                                dtype=torch.float64)).sum()
                for k in sorted(lv_e)).backward()
        enc[name] = ({k: v.detach().double() for k, v in lv_e.items()},
                     torch.cat([p.grad.double().flatten() for p in net.parameters()
                                if p.grad is not None]))
        del lv_e, net
    model.zero_grad(set_to_none=True)
    enc_err = {}
    for name in ("kernels", "plain"):
        lv_n, g_n = enc[name]
        lv_r, g_r = enc["f64"]
        enc_err[name] = dict(
            levels={k: float((lv_n[k] - lv_r[k]).norm() / lv_r[k].norm()) for k in lv_r},
            grads=float((g_n - g_r).norm() / g_r.norm()))
    ek, ep = enc_err["kernels"], enc_err["plain"]
    for k in ep["levels"]:
        if not ek["levels"][k] <= ENCODE_F64_RATIO * ep["levels"][k] + 1e-7:
            fail(f"train-mode encode, level {k}: K5's relative L2 error against f64 "
                 f"{ek['levels'][k]:.3e} > {ENCODE_F64_RATIO} x the plain version's "
                 f"{ep['levels'][k]:.3e}")
    if not ek["grads"] <= ENCODE_F64_RATIO * ep["grads"] + 1e-7:
        fail(f"train-mode encode gradients: K5's relative L2 error against f64 "
             f"{ek['grads']:.3e} > {ENCODE_F64_RATIO} x the plain version's {ep['grads']:.3e}")
    del enc, lv_n, g_n, lv_r, g_r, tensors, maps_t
    torch.cuda.empty_cache()
    print(f"[10 train] K5 on the train-mode encode against the plain version in f64: levels "
          f"relative L2 { {k: float('%.2e' % v) for k, v in ek['levels'].items()} } (plain "
          f"f32: { {k: float('%.2e' % v) for k, v in ep['levels'].items()} }); all encoder "
          f"gradients under a fixed cotangent {ek['grads']:.2e} (plain f32 {ep['grads']:.2e}; "
          f"limit {ENCODE_F64_RATIO}x)")
    n_step_rays = cfg.n_sources * cfg.n_rays
    print(f"[10 numbers] on {card}: {warm:.1f} ms per step (median of steps "
          f"{list(range(1, TRAIN_STEPS))}; step 0 {step_ms[0]:.1f} ms), "
          f"{n_step_rays / warm * 1e3:.0f} rays/s, peak device memory {peak / 2**30:.2f} GiB "
          f"(the {TRAIN_STEPS} kernel-path steps)")

    # ---- 11. reconstruction ----------------------------------------------
    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.data.synthetic import kitti_calibration
    from scenerf_tpu_torch.fusion.tsdf import pack_colors, tsdf2occ
    from scenerf_tpu_torch.ops.tsdf import integrate, integrate_plain, pixel_ties
    from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

    del trainer, plain_trainer, batch, noises, grads0
    model.load_state_dict(start_state)
    model.eval()
    torch.cuda.empty_cache()
    K_kitti, T_velo_2_cam = kitti_calibration()
    K11 = torch.from_numpy(K_kitti).to(dev)
    maps11 = compute_sphere_maps(cfg, K_kitti)
    rel_poses = geo.rel_pose_stack(geo.sample_rel_poses(
        cfg.sweep_step, cfg.sweep_angle, cfg.sweep_max_distance))
    n_poses = rel_poses.shape[0]
    frame = torch.from_numpy(input_frame(cfg, seed=SEED)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv = model.encode(frame, K_kitti, sphere_maps=maps11)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sweep = recon.render_sweep_full_res(model, model.pyramid_for_item(lv, 0), K11,
                                        torch.from_numpy(rel_poses).to(dev), stride=STRIDE,
                                        chunk=CHUNK, seed=SEED)
    depths, colors = sweep["depth"], recon.quantize_colors(sweep["color"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    vol = recon.fuse_kitti_sweep(depths, colors, K_kitti, T_velo_2_cam, rel_poses)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    recon_launches = dict(build.LAUNCHES)
    recon_peak = torch.cuda.max_memory_allocated()
    encode11_ms, sweep_s, fuse_ms = (t1 - t0) * 1e3, t2 - t1, (t3 - t2) * 1e3
    for name in RECON_KERNELS:
        if recon_launches[name] < 1:
            fail(f"kernel {name} was not launched on the reconstruction path")
    if (recon_launches["bn_stats"], recon_launches["bn_apply"]) != (0, BN_SITES):
        fail(f"reconstruction encode: K5 launches {recon_launches}; expected {BN_SITES} eval "
             f"applies")
    if tuple(depths.shape) != (n_poses, H, W) or tuple(colors.shape) != (n_poses, H, W, 3):
        fail(f"full-res sweep {tuple(depths.shape)}, {tuple(colors.shape)}")
    if not bool(torch.isfinite(depths).all()):
        fail("full-res sweep depth is not finite")
    observed = int((vol.weight > 0).sum())
    max_weight = float(vol.weight.max())
    if vol.shape != (256, 256, 32) or observed == 0 or max_weight > n_poses:
        fail(f"TSDF {vol.shape}: {observed} observed voxels, max weight {max_weight}")
    if not bool(torch.isfinite(vol.tsdf).all()):
        fail("TSDF not finite")
    print(f"[11 reconstruction] encode {encode11_ms:.1f} ms + {n_poses}-pose sweep at stride "
          f"{STRIDE} upsampled to {W}x{H} {sweep_s:.2f} s + fuse {fuse_ms:.2f} ms per frame; "
          f"TSDF {vol.shape}: {observed} voxels observed ({observed / vol.tsdf.numel():.2%}), "
          f"max weight {max_weight:.0f}; main-path launches "
          f"{ {k: recon_launches[k] for k in RECON_KERNELS} }; peak device memory "
          f"{recon_peak / 2**30:.2f} GiB")

    # kernel T against its plain version on the same arrays, both modes
    cam_poses = np.stack([np.linalg.inv(T_velo_2_cam) @ p for p in rel_poses])
    w2cs = torch.from_numpy(np.stack([np.linalg.inv(p) for p in cam_poses])
                            .astype(np.float32)).to(dev)
    intrs = torch.from_numpy(np.tile(K_kitti[None], (n_poses, 1, 1))).to(dev)
    packed = pack_colors(colors)
    t_args = (depths, packed, intrs, w2cs, vol._vol_origin, vol._voxel_size,
              vol._trunc_margin, 1.0)
    ties = pixel_ties(vol.shape, vol._vol_origin, vol._voxel_size, intrs, w2cs, tol=TIE_PX)

    def fresh():
        return [torch.full(vol.shape, 255.0, device=dev), torch.zeros(vol.shape, device=dev),
                torch.zeros(vol.shape, device=dev)]

    t_text = []
    t_err = 0.0
    for mode in ("closest", "average"):
        if mode == "closest":
            got_v = [vol.tsdf, vol.weight, vol.color]  # the main path's volume
        else:
            got_v = fresh()
            integrate(*got_v, *t_args, mode=mode)
        want_v = fresh()
        integrate_plain(*want_v, *t_args, mode=mode)
        torch.cuda.synchronize()
        differs = torch.zeros(vol.shape, dtype=torch.bool, device=dev)
        for a, b in zip(got_v, want_v):
            differs |= a != b
        equal = 1.0 - float(differs.float().mean())
        untied = int((differs & ~ties).sum())
        if equal < TSDF_MIN_EQUAL or untied:
            fail(f"tsdf_integrate {mode}: bit-equal on {equal:.6%} of voxels, {untied} "
                 f"differing voxels with no pixel-rounding tie")
        err = max(float((a - b).abs().max()) for a, b in zip(got_v, want_v))
        t_err = max(t_err, err)
        t_text.append(f"{mode}: bit-equal on {equal:.6%} of voxels ({int(differs.sum())} differ, "
                      f"each at a pixel-rounding tie; {int(ties.sum())} voxels have one), max "
                      f"abs err {err:.3e}")
        if mode == "closest":
            occ_k = tsdf2occ(got_v[0].cpu().numpy(), 0.25, 6.0)
            occ_p = tsdf2occ(want_v[0].cpu().numpy(), 0.25, 6.0)
            occ_metric = SSCMetrics(2)
            occ_metric.add_batch(occ_k[None], occ_p[None])
            occ_stats = occ_metric.get_stats()
            if occ_p.sum() == 0 or occ_stats["iou"] < RECON_MIN_IOU:
                fail(f"occupancy: {int(occ_p.sum())} plain voxels occupied, kernel-vs-plain "
                     f"IoU {occ_stats['iou']}")
            n_valid = float(want_v[1].sum())  # valid voxel-frames: the weights, obs 1
        del got_v, want_v

    work = fresh()

    def timed_on_fresh(fn, runs=TIMING_RUNS):
        """Median CUDA-event time of fn on a volume reset before each run."""
        times = []
        for i in range(runs + 1):
            work[0].fill_(255.0)
            work[1].zero_()
            work[2].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i:  # the first run warms up
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    t_ms = timed_on_fresh(lambda: integrate(*work, *t_args))
    t_plain_ms = timed_on_fresh(lambda: integrate_plain(*work, *t_args))
    # alone: 50 launches in one CUDA graph on the same (no longer fresh)
    # volume; each reads the volume and its frames' pixels from HBM (278 MB)
    t_dev_ms = graph_ms(lambda: integrate(*work, *t_args))
    del work
    # each voxel and frame: the camera point (9 mul + 9 add), the pixel
    # (2 x mul, div, add, rint), z select and 5 range tests = 32; each valid
    # voxel-frame: sub, 2 tests, 2 abs, compare, add = 7
    n_vox = vol.tsdf.numel()
    t_bound = bound(2 * nbytes(vol.tsdf, vol.weight, vol.color) + nbytes(depths, packed, intrs, w2cs),
                    32 * n_vox * n_poses + 7 * n_valid)
    results["tsdf_integrate"] = dict(
        max_abs_err=t_err, ms=t_ms, plain_ms=t_plain_ms, device_ms=t_dev_ms, **t_bound,
        library_ms=None, shape=[*vol.shape, n_poses, H, W])
    print(f"[11 kernel T] {n_poses} frames of {W}x{H} into {vol.shape}: " + "; ".join(t_text)
          + f"; kernel-vs-plain occupancy IoU {occ_stats['iou']:.6f} "
          f"({int(occ_p.sum())} plain voxels occupied)")
    print(f"[11 numbers] on {card}: {sweep_s / n_poses * 1e3:.1f} ms/pose, {sweep_s:.2f} s "
          f"sweep + {encode11_ms:.1f} ms encode + {fuse_ms:.2f} ms fuse per frame; kernel T "
          f"{t_ms:.3f} ms (events, fresh volume, median of {TIMING_RUNS}), alone "
          f"{t_dev_ms:.3f} ms (graph of {GRAPH_REPS}), bound {t_bound['bound_ms']:.3f} ms "
          f"({t_bound['bound_by']}); plain {t_plain_ms:.3f} ms")
    # ---- 12. kernel K5 ---------------------------------------------------
    # every distinct batch norm configuration of the B7 encoder and decoder
    # (the sites recorded in phase 4; the training step runs the same): the
    # kernels N1-N4 one by one against their plain versions, the fused op in
    # train mode against autograd of the plain version, eval mode, and the
    # times: each kernel alone (CUDA graph), the fused op by events, its
    # plain version, and F.batch_norm(training=True) + the activation
    del lv, sweep, depths, colors, packed, vol, ties
    torch.cuda.empty_cache()
    site_count = {"train": {}, "eval": {}}
    for path, counts in site_count.items():
        for key in bn_sites[path]:
            counts[key] = counts.get(key, 0) + 1
    configs = sorted(set(site_count["train"]) | set(site_count["eval"]),
                     key=lambda k: (-math.prod(k[0]), k[1], k[2], k[5]))
    act_ops = {"identity": 0, "silu": 4, "leaky": 2}        # per element, forward
    act_grad_ops = {"identity": 0, "silu": 7, "leaky": 2}   # per element, act'(z)
    lib_act = {"identity": lambda z: z, "silu": F.silu,
               "leaky": lambda z: F.leaky_relu(z, NM.LEAKY_SLOPE)}

    def rel_l2(a, b) -> float:
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    def check_close(what, a, b, rtol=BN_RTOL):
        atol = 1e-6 * float(b.abs().max())
        ok = (a - b).abs() <= rtol * b.abs() + atol
        if not bool(ok.all()):
            fail(f"K5 {what}: {int((~ok).sum())} values beyond rtol {rtol} (max abs error "
                 f"{float((a - b).abs().max()):.3e})")
        return float((a - b).abs().max())

    def check_l2(what, a, b):
        """Relative L2 within BN_REL_L2; returns the max abs error."""
        err = rel_l2(a, b)
        if not (bool(torch.isfinite(a).all()) and err <= BN_REL_L2):
            fail(f"K5 {what}: relative L2 {err:.3e} > {BN_REL_L2}")
        return float((a - b).abs().max())

    bn_rows = []
    for key in configs:
        shape, act, has_res, eps, mom, layout = key
        count = {path: site_count[path].get(key, 0) for path in site_count}
        Cn = shape[-1]
        Mn = math.prod(shape[:-1])
        what = (f"{list(shape)} {act}{' + residual' if has_res else ''}"
                f"{' channel-first' if layout else ''}")

        def draw():
            """A seeded tensor of the site's shape and layout."""
            if not layout:
                return torch.randn(shape, generator=gen, device=dev)
            return torch.randn(shape[0], Cn, *shape[1:-1], generator=gen,
                               device=dev).movedim(1, -1)

        def lib_in(t):
            """The library's layout: NCHW for a channel-first site, [M, C] else."""
            return t.movedim(-1, 1) if layout else t.reshape(Mn, Cn)

        x = draw() * 2 + 0.5
        x[..., 0] = 0.5  # a constant channel: mean2 - mean^2 ties at 0
        w = torch.rand(Cn, generator=gen, device=dev) + 0.5
        b = torch.rand(Cn, generator=gen, device=dev) - 0.5
        rm = torch.rand(Cn, generator=gen, device=dev) * 0.4 - 0.2
        rv = torch.rand(Cn, generator=gen, device=dev) + 0.5
        r = draw() if has_res else None
        dy = draw()
        run = lambda: [rm.clone(), rv.clone()]  # noqa: E731
        err = {}
        # N1: the statistics and the running update
        rk, rp = run(), run()
        _, st_k = NM.launch_forward(x, w, b, *rk, True, mom, eps, act, r, stages=1)
        st_p = NM.stats_plain(x, w, b, *rp, mom, eps)
        err["bn_stats"] = max(*(check_close(f"N1 {what} statistics row {i}", st_k[i], st_p[i])
                                for i in range(5)),
                              check_close(f"N1 {what} running mean", rk[0], rp[0]),
                              check_close(f"N1 {what} running var", rk[1], rp[1]))
        # N2 on the plain statistics; in eval mode folding the running ones
        y_k, _ = NM.launch_forward(x, w, b, *run(), True, mom, eps, act, r, stages=2,
                                   stats=st_p)
        err["bn_apply"] = check_close(f"N2 {what}", y_k, NM.apply_plain(x, st_p, act, r))
        ye_k, _ = NM.launch_forward(x, w, b, rm, rv, False, mom, eps, act, r, want_stats=False)
        fold = NM.fold_plain(w, b, rm, rv, eps)
        ye_p = NM.batch_norm_act_plain(x, w, b, rm, rv, False, mom, eps, act, r)
        summands = (x * fold[NM.MUL]).abs() + fold[NM.ADD].abs() + (0 if r is None else r.abs())
        spacing = torch.nextafter(summands, torch.full_like(summands, float("inf"))) - summands
        eval_spacings = float(((ye_k - ye_p).abs() / spacing).max())
        if not eval_spacings <= BN_EVAL_SPACINGS:
            fail(f"K5 N2 eval {what}: {eval_spacings:.2f} f32 spacings from the plain version")
        err["bn_apply"] = max(err["bn_apply"], float((ye_k - ye_p).abs().max()))
        # N3, N4 on the plain statistics (and N4 on the plain coefficients)
        _, gr_k, _ = NM.launch_backward(x, dy, w, st_p, True, eps, act, r, stages=1)
        gr_p = NM.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)
        err["bn_bwd_reduce"] = max(check_l2(f"N3 {what} row {i}", gr_k[i], gr_p[i])
                                   for i in range(4))
        dx_k, _, dr_k = NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                           residual_grad=has_res, stages=2, grads=gr_p)
        dx_p, dr_p = NM.bwd_apply_plain(x, dy, st_p, gr_p, act, r)
        err["bn_bwd_apply"] = check_l2(f"N4 {what} dx", dx_k, dx_p)
        if has_res:
            err["bn_bwd_apply"] = max(err["bn_bwd_apply"], check_l2(f"N4 {what} d_r", dr_k, dr_p))
        # each direction as the training step launches it (one launch on the
        # cluster path): the statistics, y on its own statistics, the
        # gradients and dx on its own gradients
        paths = {d: NM.launch_path(x, d, act, r).path for d in ("forward", "backward")}
        rf = run()
        y_f, st_f = NM.launch_forward(x, w, b, *rf, True, mom, eps, act, r)
        err["bn_forward_fused"] = max(
            *(check_close(f"{paths['forward']} forward {what} statistics row {i}", st_f[i],
                          st_p[i]) for i in range(5)),
            check_close(f"{paths['forward']} forward {what} running mean", rf[0], rp[0]),
            check_close(f"{paths['forward']} forward {what} running var", rf[1], rp[1]),
            check_close(f"{paths['forward']} forward {what} y", y_f,
                        NM.apply_plain(x, st_f, act, r)))
        dx_f, gr_f, dr_f = NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                              residual_grad=has_res)
        dx_fp, dr_fp = NM.bwd_apply_plain(x, dy, st_p, gr_f, act, r)
        err["bn_backward_fused"] = max(
            *(check_l2(f"{paths['backward']} backward {what} row {i}", gr_f[i], gr_p[i])
              for i in range(4)),
            check_l2(f"{paths['backward']} backward {what} dx", dx_f, dx_fp),
            *((check_l2(f"{paths['backward']} backward {what} d_r", dr_f, dr_fp),)
              if has_res else ()))
        del y_f, dx_f, dr_f, dx_fp, dr_fp
        # the fused op, train mode: the kernels' Function against autograd of
        # the plain version (the gradient through mean and var included); the
        # cotangent zeroed at the leaky-ReLU's kink ties (z within rounding of
        # 0, where each side's statistics may pick the other slope)
        ties = NM.kink_ties(x, st_p, act, r)
        dy_op = torch.where(ties, torch.zeros_like(dy), dy)
        sides = []
        for plain in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            rr = None if r is None else r.clone().requires_grad_(True)
            stats = run()
            with build.plain_versions() if plain else contextlib.nullcontext():
                y = NM.batch_norm_act(*leaves, *stats, True, mom, eps, act, rr)
            y.backward(dy_op)
            sides.append([y.detach(), *stats, *(t.grad for t in leaves),
                          *([] if rr is None else [rr.grad])])
            del y, leaves, rr
        for i, name in enumerate(("y", "running mean", "running var")):
            check_close(f"{what} train {name}", sides[0][i], sides[1][i])
        op_l2 = max(rel_l2(sides[0][i], sides[1][i]) for i in range(3, len(sides[0])))
        for i, name in zip(range(3, len(sides[0])), ("x", "weight", "bias", "residual")):
            check_l2(f"{what} train d{name}", sides[0][i], sides[1][i])
        del sides
        # times
        nb = lambda *ts: nbytes(*(t for t in ts if t is not None))  # noqa: E731
        r_act = r if act != "identity" else None  # the backward reads r for z only
        y_buf, st_buf, gr_buf = torch.empty_like(x), st_p.clone(), gr_p.clone()
        dx_buf = torch.empty_like(x)
        dr_buf = torch.empty_like(x) if has_res and act != "identity" else None
        scratch = run()
        stage_calls = {
            "bn_stats": (lambda: NM.launch_forward(x, w, b, *scratch, True, mom, eps, act, r,
                                                   stages=1, y=y_buf, stats=st_buf),
                         lambda: NM.stats_plain(x, w, b, *scratch, mom, eps)),
            "bn_apply": (lambda: NM.launch_forward(x, w, b, *scratch, True, mom, eps, act, r,
                                                   stages=2, y=y_buf, stats=st_p),
                         lambda: NM.apply_plain(x, st_p, act, r)),
            "bn_bwd_reduce": (lambda: NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                                         stages=1, grads=gr_buf, dx=dx_buf),
                              lambda: NM.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)),
            "bn_bwd_apply": (lambda: NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                                        residual_grad=has_res, stages=2,
                                                        grads=gr_p, dx=dx_buf, d_res=dr_buf),
                             lambda: NM.bwd_apply_plain(x, dy, st_p, gr_p, act, r)),
        }
        stage_ms = {k: cuda_ms(kern) for k, (kern, _) in stage_calls.items()}
        stage_plain_ms = {k: cuda_ms(plain) for k, (_, plain) in stage_calls.items()}
        alone = {k: graph_ms(kern) for k, (kern, _) in stage_calls.items()}
        alone["bn_apply_eval"] = graph_ms(lambda: NM.launch_forward(
            x, w, b, rm, rv, False, mom, eps, act, r, want_stats=False, y=y_buf))
        # each direction as the training step launches it
        alone["train_fwd"] = graph_ms(lambda: NM.launch_forward(
            x, w, b, *scratch, True, mom, eps, act, r, y=y_buf, stats=st_buf))
        alone["train_bwd"] = graph_ms(lambda: NM.launch_backward(
            x, dy, w, st_p, True, eps, act, r, residual_grad=has_res, grads=gr_buf, dx=dx_buf,
            d_res=dr_buf))
        n = x.numel()
        bounds = {
            "bn_stats": bound(nb(x), 3 * n),
            "bn_apply": bound(nb(x, r, y_buf), (4 + act_ops[act]) * n),
            "bn_apply_eval": bound(nb(x, r, y_buf), (4 + act_ops[act]) * n),
            "bn_bwd_reduce": bound(nb(x, dy, r_act), (5 + act_grad_ops[act]) * n),
            "bn_bwd_apply": bound(nb(x, dy, r_act, x, r_act if has_res else None),
                                  (6 + act_grad_ops[act]) * n),
            # the one-launch design's least: x (and r) read once, y written
            "train_fwd": bound(nb(x, r, y_buf), (7 + act_ops[act]) * n),
            "train_bwd": bound(nb(x, dy, r_act, x, r_act if has_res else None),
                               (11 + 2 * act_grad_ops[act]) * n),
        }
        leaf_x = x.clone().requires_grad_(True)
        leaf_w, leaf_b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        leaf_r = None if r is None else r.clone().requires_grad_(True)

        def fused_fwd():
            return NM.batch_norm_act(leaf_x, leaf_w, leaf_b, *scratch, True, mom, eps, act,
                                     leaf_r)

        def fused_step(fwd):
            fwd().backward(dy)

        def plain_fwd():
            with build.plain_versions():
                return fused_fwd()

        def lib_fwd():
            z = F.batch_norm(lib_in(leaf_x), scratch[0], scratch[1], leaf_w, leaf_b,
                             training=True, momentum=1.0 - mom, eps=eps)
            return lib_act[act](z if leaf_r is None else z + lib_in(leaf_r))

        ms_fwd, ms_step = cuda_ms(fused_fwd), cuda_ms(lambda: fused_step(fused_fwd))
        plain_fwd_ms, plain_step = cuda_ms(plain_fwd), cuda_ms(lambda: fused_step(plain_fwd))
        lib_fwd_ms = cuda_ms(lib_fwd)
        lib_step = cuda_ms(lambda: lib_fwd().backward(lib_in(dy)))
        with torch.no_grad():
            eval_ms = cuda_ms(lambda: NM.batch_norm_act(x, w, b, rm, rv, False, mom, eps, act, r))
            eval_plain_ms = cuda_ms(lambda: NM.batch_norm_act_plain(x, w, b, rm, rv, False, mom,
                                                                    eps, act, r))
        reduce_dims = (0, *range(2, len(shape))) if layout else 0
        lib_stats_ms = cuda_ms(lambda: torch.var_mean(lib_in(x), reduce_dims, correction=0))
        bn_rows.append(dict(
            shape=list(shape), act=act, residual=has_res, eps=eps, momentum=mom,
            channel_first=bool(layout), sites=count, kink_ties=int(ties.sum()), paths=paths,
            max_abs_err=err, eval_spacings=eval_spacings, op_rel_l2=op_l2,
            device_ms=alone, bound_ms={k: v["bound_ms"] for k, v in bounds.items()},
            stage_ms=stage_ms, stage_plain_ms=stage_plain_ms,
            events_ms=dict(train_fwd=ms_fwd, train_bwd=ms_step - ms_fwd, eval=eval_ms),
            plain_ms=dict(train_fwd=plain_fwd_ms, train_bwd=plain_step - plain_fwd_ms,
                          eval=eval_plain_ms),
            library_ms=dict(train_fwd=lib_fwd_ms, train_bwd=lib_step - lib_fwd_ms,
                            var_mean=lib_stats_ms)))
        row = bn_rows[-1]
        print(f"[12 kernel K5] {what} x{count['train']} train, x{count['eval']} eval: paths "
              f"{paths['forward']} / {paths['backward']}; train forward "
              f"{alone['train_fwd'] * 1e3:.1f} backward {alone['train_bwd'] * 1e3:.1f} us alone "
              f"(one-launch bounds {bounds['train_fwd']['bound_ms'] * 1e3:.1f} / "
              f"{bounds['train_bwd']['bound_ms'] * 1e3:.1f}); stages alone N1 "
              f"{alone['bn_stats'] * 1e3:.1f} N2 "
              f"{alone['bn_apply'] * 1e3:.1f} (eval {alone['bn_apply_eval'] * 1e3:.1f}) N3 "
              f"{alone['bn_bwd_reduce'] * 1e3:.1f} N4 {alone['bn_bwd_apply'] * 1e3:.1f} us; "
              f"bounds {bounds['bn_stats']['bound_ms'] * 1e3:.1f} / "
              f"{bounds['bn_apply']['bound_ms'] * 1e3:.1f} / "
              f"{bounds['bn_bwd_reduce']['bound_ms'] * 1e3:.1f} / "
              f"{bounds['bn_bwd_apply']['bound_ms'] * 1e3:.1f} us; events fwd / bwd / eval "
              f"{ms_fwd:.3f} / {ms_step - ms_fwd:.3f} / {eval_ms:.3f} ms, plain "
              f"{plain_fwd_ms:.3f} / {plain_step - plain_fwd_ms:.3f} / {eval_plain_ms:.3f}, "
              f"F.batch_norm + act {lib_fwd_ms:.3f} / {lib_step - lib_fwd_ms:.3f}; errors "
              f"{ {k: float('%.2e' % v) for k, v in err.items()} }, eval "
              f"{eval_spacings:.2f} spacings, op rel L2 {op_l2:.2e} ({int(ties.sum())} kink "
              f"ties)")
        del x, r, dy, y_buf, dx_buf, dr_buf, leaf_x, leaf_r, y_k, ye_k, ye_p, dx_k, dx_p, dr_k
        del dr_p, summands, spacing, stage_calls, ties, dy_op
        torch.cuda.empty_cache()

    def per_step(get, path: str = "train") -> float:
        return sum(row["sites"][path] * get(row) for row in bn_rows)

    # the host's time to issue one call (no synchronize: the enqueue), at the
    # smallest configuration, kernels against the plain chain, in turns
    shape, act, has_res, eps, mom = bn_rows[-1]["shape"], *(
        bn_rows[-1][k] for k in ("act", "residual", "eps", "momentum"))
    xs = torch.randn(shape, device=dev).requires_grad_(True)
    rs = torch.randn(shape, device=dev) if has_res else None
    mod = FusedBatchNorm(shape[-1], eps, mom, act=act).to(dev)

    def host_us(fn, plain: bool, reps: int = 200) -> float:
        times = []
        with build.plain_versions() if plain else contextlib.nullcontext():
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e6)
                torch.cuda.synchronize()
        return statistics.median(times)

    host = {"train_fwd": {}, "eval": {}}
    for plain in (False, True, True, False):
        side = "plain" if plain else "kernel"
        mod.train()
        host["train_fwd"].setdefault(side, []).append(host_us(lambda: mod(xs, rs), plain))
        mod.eval()
        with torch.no_grad():
            host["eval"].setdefault(side, []).append(host_us(lambda: mod(xs, rs), plain))
    host = {k: {side: statistics.mean(v) for side, v in d.items()} for k, d in host.items()}
    print(f"[12 kernel K5] host time to issue one call at {shape} {act}: train forward kernel "
          f"{host['train_fwd']['kernel']:.1f} us vs plain chain {host['train_fwd']['plain']:.1f} "
          f"us; eval {host['eval']['kernel']:.1f} vs {host['eval']['plain']:.1f} us (median of "
          f"200, mean of 2 turns)")
    del xs, rs, mod

    bn_step = dict(
        forward_ms=per_step(lambda r_: r_["device_ms"]["train_fwd"]),
        backward_ms=per_step(lambda r_: r_["device_ms"]["train_bwd"]),
        stages_forward_ms=per_step(lambda r_: r_["device_ms"]["bn_stats"]
                                   + r_["device_ms"]["bn_apply"]),
        stages_backward_ms=per_step(lambda r_: r_["device_ms"]["bn_bwd_reduce"]
                                    + r_["device_ms"]["bn_bwd_apply"]),
        eval_ms=per_step(lambda r_: r_["device_ms"]["bn_apply_eval"], "eval"),
        forward_bound_ms=per_step(lambda r_: r_["bound_ms"]["bn_stats"] + r_["bound_ms"]["bn_apply"]),
        backward_bound_ms=per_step(lambda r_: r_["bound_ms"]["bn_bwd_reduce"]
                                   + r_["bound_ms"]["bn_bwd_apply"]),
        forward_min_bound_ms=per_step(lambda r_: r_["bound_ms"]["train_fwd"]),
        backward_min_bound_ms=per_step(lambda r_: r_["bound_ms"]["train_bwd"]),
        cluster_sites={d: sum(row["sites"]["train"] for row in bn_rows
                              if row["paths"][d] == "cluster") for d in ("forward", "backward")},
        eval_bound_ms=per_step(lambda r_: r_["bound_ms"]["bn_apply_eval"], "eval"),
        forward_events_ms=per_step(lambda r_: r_["events_ms"]["train_fwd"]),
        backward_events_ms=per_step(lambda r_: r_["events_ms"]["train_bwd"]),
        plain_forward_ms=per_step(lambda r_: r_["plain_ms"]["train_fwd"]),
        plain_backward_ms=per_step(lambda r_: r_["plain_ms"]["train_bwd"]),
        library_forward_ms=per_step(lambda r_: r_["library_ms"]["train_fwd"]),
        library_backward_ms=per_step(lambda r_: r_["library_ms"]["train_bwd"]),
        sites=sum(row["sites"]["train"] for row in bn_rows), configurations=len(bn_rows),
        layouts={path: layouts(path) for path in bn_sites},
        cotangent_copies_in_train=bn_copies, host_us_per_call=host)
    print(f"[12 kernel K5] per training step over the {bn_step['sites']} sites "
          f"({bn_step['configurations']} configurations; inputs: train {layouts('train')}, eval "
          f"{layouts('eval')}; {bn_step['cotangent_copies_in_train']} cotangents copied "
          f"in {TRAIN_STEPS} steps; the cluster path at {bn_step['cluster_sites']} sites): "
          f"kernels alone forward {bn_step['forward_ms']:.3f} ms (bound "
          f"{bn_step['forward_bound_ms']:.3f}, one-launch {bn_step['forward_min_bound_ms']:.3f}; "
          f"stages one by one {bn_step['stages_forward_ms']:.3f}), backward "
          f"{bn_step['backward_ms']:.3f} ms (bound {bn_step['backward_bound_ms']:.3f}, one-launch "
          f"{bn_step['backward_min_bound_ms']:.3f}; stages {bn_step['stages_backward_ms']:.3f}); "
          f"eval encode {bn_step['eval_ms']:.3f} ms "
          f"(bound {bn_step['eval_bound_ms']:.3f}); events forward / backward "
          f"{bn_step['forward_events_ms']:.2f} / {bn_step['backward_events_ms']:.2f} ms, plain "
          f"{bn_step['plain_forward_ms']:.2f} / {bn_step['plain_backward_ms']:.2f}, "
          f"F.batch_norm + act {bn_step['library_forward_ms']:.2f} / "
          f"{bn_step['library_backward_ms']:.2f}")
    main_bn = bn_rows[0]  # the largest configuration
    for name in BN_KERNELS:
        results[name] = dict(
            shape=main_bn["shape"], act=main_bn["act"], residual=main_bn["residual"],
            max_abs_err=max(row["max_abs_err"][name] for row in bn_rows),
            ms=main_bn["stage_ms"][name], plain_ms=main_bn["stage_plain_ms"][name],
            device_ms=main_bn["device_ms"][name], bound_ms=main_bn["bound_ms"][name],
            bound_by="bytes",
            library_ms=main_bn["library_ms"]["var_mean"] if name == "bn_stats" else None,
            per_step=bn_step, at_shapes=[{k: row[k] for k in (
                "shape", "act", "residual", "channel_first", "sites", "paths", "device_ms",
                "bound_ms", "events_ms", "plain_ms", "library_ms")} for row in bn_rows]
            if name == "bn_stats" else None)
    # the one-launch cluster path, at the largest configuration that takes it
    for name, d, key in (("bn_forward_fused", "forward", "train_fwd"),
                         ("bn_backward_fused", "backward", "train_bwd")):
        row = next(r_ for r_ in bn_rows if r_["paths"][d] == "cluster" and r_["sites"]["train"])
        results[name] = dict(
            shape=row["shape"], act=row["act"], residual=row["residual"],
            max_abs_err=max(r_["max_abs_err"][name] for r_ in bn_rows),
            ms=row["events_ms"][key], plain_ms=row["plain_ms"][key],
            device_ms=row["device_ms"][key], bound_ms=row["bound_ms"][key], bound_by="bytes",
            library_ms=row["library_ms"][key])

    # ---- 13. bf16 --------------------------------------------------------
    # the JAX package's flagship training configuration (bench.py's, minus its
    # TPU knobs) in the port's bf16 compute path: kernels G, G-bwd and K5 in
    # their bf16 instantiations (C, C-bwd, S and T stay f32), cuDNN and cuBLAS
    # in bf16 over the f32 parameters
    torch.cuda.empty_cache()
    cfg16 = C.kitti(n_sources=4, ray_chunk=1200, n_gt_depth=256, compute_dtype="bfloat16")
    cfg32 = cfg16.replace(compute_dtype="float32")
    bf16 = torch.bfloat16
    b16 = {}  # per kernel: its bf16 results

    # kernel G: phase 2's pyramid at the serve chunk's points, each sphere
    # resample at its tap width; bit-equal to the plain bf16 version
    levels16 = [torch.randn(*pyramid_level_size(cfg.sphere, s), c, generator=gen,
                            device=dev).to(bf16) for s, c in zip(SCALES, widths)]
    ix, iy = pyramid_coords(pts.reshape(-1, 3), K, inv_K, cfg.sphere,
                            [lv.shape[:2] for lv in levels16])

    def check_g16(what, lvs, gx, gy, reps: int = GRAPH_REPS) -> dict:
        """Kernel G in bf16 bit-equal to its plain version; its times ("alone":
        a graph of `reps` launches, whose outputs all stay alive)."""
        g1 = gather_levels(lvs, gx, gy)
        g0 = gather_levels_plain(lvs, gx, gy)
        torch.cuda.synchronize()
        if g1.dtype != bf16 or not torch.equal(g1, g0):
            fail(f"bf16 gather_levels at {what}: not bit-equal to the plain bf16 version")
        run = lambda: gather_levels(lvs, gx, gy)  # noqa: E731
        return dict(shape=what, max_abs_err=0.0, ms=cuda_ms(run), device_ms=graph_ms(run, reps),
                    plain_ms=cuda_ms(lambda: gather_levels_plain(lvs, gx, gy)),
                    lanes=lanes_per_point([lv.shape[2] for lv in lvs], gx.shape[1], bf16),
                    **bound(touched_row_bytes(lvs, gx, gy) + nbytes(gx, gy, g1), 9 * g1.numel()))

    # the pyramid's 1.59 GB output: a graph of 8 (50 would not fit the card)
    g16 = [check_g16(f"pyramid at {ix.shape[1]} points", levels16, ix, iy, reps=8)]
    for s, c in tap_widths.items():
        tap = torch.randn(-(-H // s), -(-W // s), c, generator=gen, device=dev).to(bf16)
        m = torch.from_numpy(sphere_maps[s]).to(dev)
        rix, riy = sphere_map_coords(m, tap.shape[0], tap.shape[1])
        g16.append(check_g16(f"s{s} sphere resample {list(tap.shape)}", [tap], rix[None],
                             riy[None]))
    for r in g16:
        print(f"[13 kernel G bf16] {r['shape']} ({r['lanes']} lanes per point): bit-equal; "
              f"kernel {r['ms']:.4f} ms, alone {r['device_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms; bf16 bound {r['bound_ms']:.4f} ms")
    b16["gather_levels"] = dict(g16[0], at_shapes=g16[1:])

    # kernel G-bwd: phase 7's cotangents (a training chunk's samples and
    # anchors, one source's samples), bf16, into f32 buffers
    ix, iy = pyramid_coords(pts_t.reshape(-1, 3), K, inv_K, cfg.sphere,
                            [lv.shape[:2] for lv in levels16])
    bufs = [torch.zeros(lv.shape, device=dev) for lv in levels16]
    gb16 = []
    for idx in (chunk_pts, anchor_pts, torch.arange(ix.shape[1], device=dev)):
        ix_n, iy_n = ix[:, idx].contiguous(), iy[:, idx].contiguous()
        d_n = torch.randn(idx.numel(), sum(widths), generator=gen, device=dev).to(bf16)
        for b_ in bufs:
            b_.zero_()
        gather_levels_backward(levels16, ix_n, iy_n, d_n, bufs, False)
        want_lv = [torch.zeros_like(b_) for b_ in bufs]
        gb_plain = lambda: ops_gather._plain_backward(  # noqa: E731
            levels16, ix_n, iy_n, d_n, want_lv, False)
        gb_plain()
        torch.cuda.synchronize()
        limit = GATHER_BWD_REL_TOL * max(float(b_.abs().max()) for b_ in want_lv)
        err = max(float((a - b_).abs().max()) for a, b_ in zip(bufs, want_lv))
        if not err <= limit:
            fail(f"bf16 gather_levels_bwd at {idx.numel()} points: max abs error {err} > {limit}")
        run = lambda: gather_levels_backward(levels16, ix_n, iy_n, d_n, bufs, False)  # noqa: E731
        gb16.append(dict(shape=list(d_n.shape), max_abs_err=err, ms=cuda_ms(run),
                         device_ms=graph_ms(run), plain_ms=cuda_ms(gb_plain),
                         **bound(nbytes(d_n, ix_n, iy_n)
                                 + 2 * touched_row_bytes(bufs, ix_n, iy_n), 10 * d_n.numel())))
        del want_lv, d_n
    for r in gb16:
        print(f"[13 kernel G-bwd bf16] cotangent {r['shape']} bf16 into f32 buffers: max abs "
              f"err {r['max_abs_err']:.3e}; kernel {r['ms']:.3f} ms, alone "
              f"{r['device_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; bound "
              f"{r['bound_ms']:.3f} ms")
    b16["gather_levels_bwd"] = dict(gb16[0], at_shapes=gb16[1:])
    del levels16, ix, iy, bufs
    torch.cuda.empty_cache()

    # encode and serve in bf16 from phase 4's weights
    with torch.device(dev):
        model16 = SceneRF(cfg16).eval()
    model16.load_state_dict(start_state)
    sites16 = {"eval": [], "train": []}

    def site_hooks16(path: str) -> list:
        def record_site(mod, args, kwargs):
            x_in = args[0]
            res_in = args[1] if len(args) > 1 else kwargs.get("residual")
            sites16[path].append((tuple(x_in.shape), mod.act, res_in is not None, mod.eps,
                                  mod.momentum, NM.plane(x_in), x_in.dtype))

        return [m.register_forward_pre_hook(record_site, with_kwargs=True)
                for m in model16.modules() if isinstance(m, FusedBatchNorm)]

    hooks16 = site_hooks16("eval")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv16 = model16.encode(img, K_np, sphere_maps=sphere_maps)
    torch.cuda.synchronize()
    encode16_first = (time.perf_counter() - t0) * 1e3
    for h in hooks16:
        h.remove()
    if ({v.dtype for v in lv16.values()} != {bf16}
            or [tuple(lv16[k].shape) for k in ("1_1", "1_2", "1_4", "1_8", "1_16")]
            != want_shapes or not all(bool(torch.isfinite(v).all()) for v in lv16.values())):
        fail("bf16 encode: levels not bf16, of the f32 shapes, finite")
    if (build.LAUNCHES["bn_apply_bf16"], build.LAUNCHES["bn_stats"]) != (BN_SITES, 0) or \
            build.LAUNCHES["gather_levels_bf16"] != build.LAUNCHES["gather_levels"] or \
            {s[-1] for s in sites16["eval"]} != {bf16}:
        fail(f"bf16 encode launches {build.LAUNCHES}")
    pyramid16 = model16.pyramid_for_item(lv16, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep16 = model16.render_pose_sweep(pyramid16, K, poses, seed=SEED, stride=STRIDE,
                                        ray_chunk=CHUNK)
    torch.cuda.synchronize()
    sweep16_ms = (time.perf_counter() - t0) * 1e3
    serve16_launches = dict(build.LAUNCHES)
    serve16_peak = torch.cuda.max_memory_allocated()
    depth16 = sweep16["depth"]
    if not (bool(torch.isfinite(depth16).all()) and bool(torch.isfinite(sweep16["color"]).all())
            and 0.0 <= float(depth16.min()) and float(depth16.max()) <= cfg.max_sample_depth):
        fail("bf16 sweep depth/color not finite or out of range")
    with build.plain_versions():
        ref16 = model16.render_image(pyramid16, K, poses[0],
                                     torch.Generator(device=dev).manual_seed(SEED),
                                     stride=STRIDE, ray_chunk=CHUNK)
    shares16 = {}
    for k in ("depth", "color"):
        ok = torch.isclose(sweep16[k][0], ref16[k], rtol=SERVE_RTOL,
                           atol=SERVE_RTOL * float(ref16[k].abs().max()))
        shares16[k] = float((ok.all(dim=-1) if k == "color" else ok).float().mean())
        if shares16[k] < SERVE_MIN_SHARE:
            fail(f"bf16 pose 0 {k}: kernel path agrees with the plain bf16 path on "
                 f"{shares16[k]:.4%} of pixels")
    enc16 = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model16.encode(img, K_np, sphere_maps=sphere_maps)
        torch.cuda.synchronize()
        enc16.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    model16.render_pose_sweep(pyramid16, K, poses, seed=SEED, stride=STRIDE, ray_chunk=CHUNK)
    torch.cuda.synchronize()
    pose16_ms = (time.perf_counter() - t0) * 1e3 / SWEEP_POSES
    print(f"[13 serve bf16] encode: {BN_SITES} bf16 K5 launches, levels bf16 and finite; "
          f"{SWEEP_POSES} poses at stride {STRIDE}, chunk {CHUNK}: finite, launches "
          f"{ {k: serve16_launches[k] for k in SERVE_KERNELS + ('gather_levels_bf16', 'bn_apply_bf16')} }; "
          f"pose 0 vs the plain bf16 path within rtol {SERVE_RTOL}: depth {shares16['depth']:.4%}, "
          f"color {shares16['color']:.4%} of pixels")
    print(f"[13 numbers] on {card}: bf16 encode {statistics.median(enc16):.1f} ms (f32 "
          f"{statistics.median(enc_times):.1f}), {pose16_ms:.1f} ms/pose warm (f32 "
          f"{warm_pose_ms:.1f}; first sweep {sweep16_ms / SWEEP_POSES:.1f}), "
          f"{n_rays / pose16_ms * 1e3:.0f} rays/s (f32 {n_rays / warm_pose_ms * 1e3:.0f}); peak "
          f"device memory {serve16_peak / 2**30:.2f} GiB (f32 {peak_serve / 2**30:.2f})")
    del lv16, pyramid16, sweep16, depth16, ref16
    torch.cuda.empty_cache()

    # train: 3 bf16 steps at the flagship shapes from phase 4's weights, and
    # step 0 in f32 from the same weights and draws
    model16.train()
    batch16 = make_batch(cfg16, seed=SEED)
    noises16 = [model16.draw_noise(1, cfg16.n_sources, gen, dev) for _ in range(TRAIN_STEPS)]
    with torch.device(dev):
        model32 = SceneRF(cfg32)
    model32.load_state_dict(start_state)
    metrics32 = Trainer(cfg32, device=dev, model=model32).train_step(batch16, noise=noises16[0])
    loss32 = float(metrics32["total_loss"])
    del model32, metrics32
    torch.cuda.empty_cache()
    trainer16 = Trainer(cfg16, device=dev, model=model16)
    params16 = dict(model16.named_parameters())
    seen16 = {n: False for n in params16}
    step16_ms, losses16 = [], []
    k5_paths16 = {"forward": [], "backward": []}  # each site's K5 paths (step 0)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        stats16_rec = []  # step 0's BN inputs' f64 statistics (running statistics set to 0)
        hooks16 = (site_hooks16("train") + k5_path_hooks(model16, k5_paths16)
                   + bn_stats_hooks(model16, stats16_rec)) if i == 0 else []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics16 = trainer16.train_step(batch16, noise=noises16[i])
        torch.cuda.synchronize()
        step16_ms.append((time.perf_counter() - t0) * 1e3)
        for h in hooks16:
            h.remove()
        gmax = torch.stack([p.grad.abs().max() for p in params16.values()]).cpu()
        if not (bool(torch.isfinite(gmax).all())
                and bool(torch.isfinite(metrics16["total_loss"]))):
            fail(f"bf16 train step {i}: loss or gradients not finite")
        if {p.dtype for p in params16.values()} | {p.grad.dtype for p in params16.values()} \
                != {torch.float32}:
            fail(f"bf16 train step {i}: a parameter or gradient is not f32")
        for n, m_ in zip(params16, gmax.tolist()):
            seen16[n] |= m_ > 0
        losses16.append(float(metrics16["total_loss"]))
        if i == 0:
            stats16_err = bn_stats_error(stats16_rec)
            del stats16_rec
            if not (stats16_err <= BN_STATS_TOL and len(hooks16) == 3 * BN_SITES):
                fail(f"bf16 train step 0: the batch statistics of a BN site are "
                     f"{stats16_err:.3e} (of the channel's mean square) from the f64 statistics "
                     f"of its input (limit {BN_STATS_TOL})")
            grads16 = {n: p.grad.detach().clone() for n, p in params16.items()}
            excess16, moved16 = adamw_first_move(params16, start_state, grads16, cfg16.lr)
            has16 = gmax > 0
            if not float(excess16.max()) <= ADAM_STEP_TOL or not bool((moved16[has16] > 0).all()):
                fail(f"bf16 train step 0: AdamW moved a weight {float(excess16.max()):.3f} lr "
                     f"away from -lr g / (|g| + eps), or a parameter with a gradient stayed")
    train16_launches = dict(build.LAUNCHES)
    train16_peak = torch.cuda.max_memory_allocated()
    launches16_per_step = {k: train16_launches[k] / TRAIN_STEPS for k in train16_launches}
    bn16 = [train16_launches[f"{k}_bf16"] for k in BN_KERNELS]
    bn16_fused = k5_fused_check(train16_launches, k5_paths16, "_bf16")
    if bn16 != [BN_SITES * TRAIN_STEPS] * 4 or [train16_launches[k] for k in BN_KERNELS] != bn16:
        fail(f"bf16 train: K5 launches {train16_launches}; expected {BN_SITES} bf16 launches "
             f"of each of N1-N4 per step")
    if not (train16_launches["gather_levels_bf16"] >= 1
            and train16_launches["gather_levels_bwd_bf16"] >= 1
            and train16_launches["ray_som_in_sort_composite"] == cfg16.n_sources * TRAIN_STEPS
            and train16_launches["ray_som"] == train16_launches["ray_som_in_sort_composite"]
            and train16_launches["sort_composite_bwd"] >= 1):
        fail(f"bf16 train launches {train16_launches}: expected bf16 G and G-bwd, and one "
             f"C training launch (R = {cfg16.n_rays}, S's EM inside) per source and step")
    if {s[-1] for s in sites16["train"]} != {bf16} or len(sites16["train"]) != BN_SITES:
        fail(f"bf16 train: {len(sites16['train'])} BN sites, dtypes "
             f"{ {s[-1] for s in sites16['train']} }")
    zero16 = [n for n, seen in seen16.items()
              if not seen and not re.search(r"conv_block[12]\.0\.bias$", n)]
    if zero16:
        fail(f"bf16 train: {len(zero16)} parameters never got a nonzero gradient, e.g. "
             f"{zero16[:3]}")
    state16 = model16.state_dict()
    stats16 = [k for k in state16 if k.endswith(("running_mean", "running_var"))]
    if any(state16[k].dtype != torch.float32 or torch.equal(state16[k], start_state[k])
           for k in stats16):
        fail("bf16 train: a BN running statistic is not f32 or did not move")
    warm16 = statistics.median(step16_ms[1:])
    rays16 = cfg16.n_sources * cfg16.n_rays
    print(f"[13 train bf16] {TRAIN_STEPS} steps of kitti(n_sources=4, ray_chunk=1200, "
          f"n_gt_depth=256, compute_dtype=bfloat16): loss {['%.5f' % v for v in losses16]}, "
          f"step 0's batch statistics {stats16_err:.2e} from f64 (limit {BN_STATS_TOL}); step 0 "
          f"vs f32 from the same weights and draws {loss32:.5f} (rel "
          f"{abs(losses16[0] - loss32) / abs(loss32):.2e}); finite; "
          f"params, gradients and {len(stats16)} BN statistics f32, the statistics moved; "
          f"AdamW step 0 within {max(float(excess16.max()), 0.0):.2e} lr; launches per step "
          f"{ {k: launches16_per_step[k] for k in TRAIN_KERNELS + tuple(f'{k}_bf16' for k in build.BF16_KERNELS)} }")
    print(f"[13 numbers] on {card}: bf16 {warm16:.1f} ms per step (median of steps "
          f"{list(range(1, TRAIN_STEPS))}; step 0 {step16_ms[0]:.1f} ms), "
          f"{rays16 / warm16 * 1e3:.0f} rays/s, peak device memory "
          f"{train16_peak / 2**30:.2f} GiB; f32 phase 10 (ray_chunk {cfg.ray_chunk}): "
          f"{warm:.1f} ms per step, {n_step_rays / warm * 1e3:.0f} rays/s, {peak / 2**30:.2f} GiB")

    # K5 and G in bf16 on the train-mode encode: levels and encoder gradients
    # under a fixed cotangent, through the kernels and through the plain bf16
    # versions, each held to the f32 weights' encode in f64
    tensors16, maps16 = trainer16.device_batch(batch16)
    enc = {}
    for name in ("kernels", "plain", "f64"):
        model16.load_state_dict(start_state)
        model.load_state_dict(start_state)
        net = copy.deepcopy(model.net_rgb).double() if name == "f64" else model16.net_rgb
        net.train()
        net.zero_grad(set_to_none=True)
        cot = torch.Generator(device=dev).manual_seed(SEED + 1)
        x_in = tensors16["img_input"].to(torch.float64 if name == "f64" else bf16)
        with build.plain_versions() if name != "kernels" else contextlib.nullcontext():
            lv_e = net(x_in, maps16)
            sum((lv_e[k].double() * torch.randn(lv_e[k].shape, generator=cot, device=dev,
                                                dtype=torch.float64)).sum()
                for k in sorted(lv_e)).backward()
        enc[name] = ({k: v.detach().double() for k, v in lv_e.items()},
                     torch.cat([p.grad.double().flatten() for p in net.parameters()
                                if p.grad is not None]))
        del lv_e, net
    model16.zero_grad(set_to_none=True)
    e16 = {}
    for name in ("kernels", "plain"):
        lv_n, g_n = enc[name]
        lv_r, g_r = enc["f64"]
        e16[name] = dict(levels={k: float((lv_n[k] - lv_r[k]).norm() / lv_r[k].norm())
                                 for k in lv_r},
                         grads=float((g_n - g_r).norm() / g_r.norm()))
    for k in e16["plain"]["levels"]:
        if not e16["kernels"]["levels"][k] <= ENCODE_F64_RATIO * e16["plain"]["levels"][k]:
            fail(f"bf16 train-mode encode level {k}: kernels' relative L2 error against f64 "
                 f"{e16['kernels']['levels'][k]:.3e} > {ENCODE_F64_RATIO} x the plain bf16 "
                 f"version's {e16['plain']['levels'][k]:.3e}")
    if not e16["kernels"]["grads"] <= ENCODE_F64_RATIO * e16["plain"]["grads"]:
        fail(f"bf16 train-mode encode gradients: kernels {e16['kernels']['grads']:.3e} > "
             f"{ENCODE_F64_RATIO} x plain bf16 {e16['plain']['grads']:.3e} against f64")
    print(f"[13 train bf16] K5 and G (bf16) on the train-mode encode against f64: levels "
          f"relative L2 { {k: float('%.2e' % v) for k, v in e16['kernels']['levels'].items()} } "
          f"(plain bf16: { {k: float('%.2e' % v) for k, v in e16['plain']['levels'].items()} }); "
          f"encoder gradients {e16['kernels']['grads']:.2e} (plain bf16 "
          f"{e16['plain']['grads']:.2e}; limit {ENCODE_F64_RATIO}x)")
    del enc, tensors16, maps16, trainer16, model16, batch16, noises16, grads16, lv_n, g_n
    del lv_r, g_r
    torch.cuda.empty_cache()

    # N1-N4 in bf16 at every distinct batch norm configuration of the bf16
    # encode and step: each against its plain bf16 version, timed alone, and
    # the bf16 byte bound
    count16 = {"train": {}, "eval": {}}
    for path, counts in count16.items():
        for key in sites16[path]:
            counts[key[:-1]] = counts.get(key[:-1], 0) + 1
    configs16 = sorted(set(count16["train"]) | set(count16["eval"]),
                       key=lambda k: (-math.prod(k[0]), k[1], k[2], k[5]))
    rows16 = []
    for key in configs16:
        shape, act, has_res, eps, mom, layout = key
        Cn = shape[-1]

        def draw16():
            if not layout:
                return torch.randn(shape, generator=gen, device=dev).to(bf16)
            return torch.randn(shape[0], Cn, *shape[1:-1], generator=gen,
                               device=dev).to(bf16).movedim(1, -1)

        x = draw16()
        w = torch.rand(Cn, generator=gen, device=dev) + 0.5
        b = torch.rand(Cn, generator=gen, device=dev) - 0.5
        rm = torch.rand(Cn, generator=gen, device=dev) * 0.4 - 0.2
        rv = torch.rand(Cn, generator=gen, device=dev) + 0.5
        r = draw16() if has_res else None
        dy = draw16()
        what = f"bf16 {list(shape)} {act}{' + residual' if has_res else ''}" \
               f"{' channel-first' if layout else ''}"
        err = {}
        rk, rp = [rm.clone(), rv.clone()], [rm.clone(), rv.clone()]
        _, st_k = NM.launch_forward(x, w, b, *rk, True, mom, eps, act, r, stages=1)
        st_p = NM.stats_plain(x, w, b, *rp, mom, eps)
        err["bn_stats"] = max(check_close(f"N1 {what} statistics row {i}", st_k[i], st_p[i])
                              for i in range(5))
        y_k, _ = NM.launch_forward(x, w, b, rm.clone(), rv.clone(), True, mom, eps, act, r,
                                   stages=2, stats=st_p)
        y_p = NM.apply_plain(x, st_p, act, r)
        spac = (y_k.float() - y_p.float()).abs() / torch.exp2(
            torch.floor(torch.log2(y_p.float().abs().clamp(min=1e-30))) - 7)
        if float(spac.max()) > 1.0:
            fail(f"K5 N2 {what}: {float(spac.max()):.2f} bf16 spacings from the plain version")
        err["bn_apply"] = float((y_k.float() - y_p.float()).abs().max())
        _, gr_k, _ = NM.launch_backward(x, dy, w, st_p, True, eps, act, r, stages=1)
        gr_p = NM.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)
        err["bn_bwd_reduce"] = max(check_l2(f"N3 {what} row {i}", gr_k[i], gr_p[i])
                                   for i in range(4))
        dx_k, _, dr_k = NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                           residual_grad=has_res, stages=2, grads=gr_p)
        dx_p, dr_p = NM.bwd_apply_plain(x, dy, st_p, gr_p, act, r)
        for name_, a_, b_ in (("dx", dx_k, dx_p), ("d_r", dr_k, dr_p)):
            if b_ is None or (name_ == "d_r" and not has_res):
                continue
            e_ = float((a_.float() - b_.float()).norm() / max(float(b_.float().norm()), 1e-30))
            if e_ > BF16_DX_REL_L2:
                fail(f"K5 N4 {what} {name_}: relative L2 {e_:.3e} > {BF16_DX_REL_L2}")
        err["bn_bwd_apply"] = float((dx_k.float() - dx_p.float()).abs().max())
        # each direction as the training step launches it (one launch on the
        # cluster path), against the plain stages on its own statistics and
        # gradients
        paths = {d: NM.launch_path(x, d, act, r).path for d in ("forward", "backward")}
        rf, rfp = [rm.clone(), rv.clone()], [rm.clone(), rv.clone()]
        y_f, st_f = NM.launch_forward(x, w, b, *rf, True, mom, eps, act, r)
        NM.stats_plain(x, w, b, *rfp, mom, eps)
        err["bn_forward_fused"] = max(
            *(check_close(f"{paths['forward']} forward {what} statistics row {i}", st_f[i],
                          st_p[i]) for i in range(5)),
            check_close(f"{paths['forward']} forward {what} running mean", rf[0], rfp[0]),
            check_close(f"{paths['forward']} forward {what} running var", rf[1], rfp[1]))
        y_fp = NM.apply_plain(x, st_f, act, r)
        spac_f = (y_f.float() - y_fp.float()).abs() / torch.exp2(
            torch.floor(torch.log2(y_fp.float().abs().clamp(min=1e-30))) - 7)
        if float(spac_f.max()) > 1.0:
            fail(f"K5 {paths['forward']} forward {what}: y {float(spac_f.max()):.2f} bf16 "
                 f"spacings from the plain version")
        dx_f, gr_f, dr_f = NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                              residual_grad=has_res)
        err["bn_backward_fused"] = max(check_l2(f"{paths['backward']} backward {what} row {i}",
                                                gr_f[i], gr_p[i]) for i in range(4))
        dx_fp, dr_fp = NM.bwd_apply_plain(x, dy, st_p, gr_f, act, r)
        for name_, a_, b_ in (("dx", dx_f, dx_fp), ("d_r", dr_f, dr_fp)):
            if b_ is None or (name_ == "d_r" and not has_res):
                continue
            e_ = float((a_.float() - b_.float()).norm() / max(float(b_.float().norm()), 1e-30))
            if e_ > BF16_DX_REL_L2:
                fail(f"K5 {paths['backward']} backward {what} {name_}: relative L2 {e_:.3e} > "
                     f"{BF16_DX_REL_L2}")
        del y_f, y_fp, spac_f, dx_f, dr_f, dx_fp, dr_fp
        scratch = [rm.clone(), rv.clone()]
        y_buf, st_buf, gr_buf, dx_buf = torch.empty_like(x), st_p.clone(), gr_p.clone(), \
            torch.empty_like(x)
        dr_buf = torch.empty_like(x) if has_res and act != "identity" else None
        calls = {
            "bn_stats": (lambda: NM.launch_forward(x, w, b, *scratch, True, mom, eps, act, r,
                                                   stages=1, y=y_buf, stats=st_buf),
                         lambda: NM.stats_plain(x, w, b, *scratch, mom, eps)),
            "bn_apply": (lambda: NM.launch_forward(x, w, b, *scratch, True, mom, eps, act, r,
                                                   stages=2, y=y_buf, stats=st_p),
                         lambda: NM.apply_plain(x, st_p, act, r)),
            "bn_bwd_reduce": (lambda: NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                                         stages=1, grads=gr_buf, dx=dx_buf),
                              lambda: NM.bwd_reduce_plain(x, dy, st_p, w, eps, act, True, r)),
            "bn_bwd_apply": (lambda: NM.launch_backward(x, dy, w, st_p, True, eps, act, r,
                                                        residual_grad=has_res, stages=2,
                                                        grads=gr_p, dx=dx_buf, d_res=dr_buf),
                             lambda: NM.bwd_apply_plain(x, dy, st_p, gr_p, act, r)),
        }
        alone = {k: graph_ms(kern) for k, (kern, _) in calls.items()}
        alone["bn_apply_eval"] = graph_ms(lambda: NM.launch_forward(
            x, w, b, rm, rv, False, mom, eps, act, r, want_stats=False, y=y_buf))
        alone["train_fwd"] = graph_ms(lambda: NM.launch_forward(
            x, w, b, *scratch, True, mom, eps, act, r, y=y_buf, stats=st_buf))
        alone["train_bwd"] = graph_ms(lambda: NM.launch_backward(
            x, dy, w, st_p, True, eps, act, r, residual_grad=has_res, grads=gr_buf, dx=dx_buf,
            d_res=dr_buf))
        nb = lambda *ts: nbytes(*(t for t in ts if t is not None))  # noqa: E731
        r_act = r if act != "identity" else None
        n = x.numel()
        bounds16 = {
            "bn_stats": bound(nb(x), 3 * n)["bound_ms"],
            "bn_apply": bound(nb(x, r, y_buf), (4 + act_ops[act]) * n)["bound_ms"],
            "bn_apply_eval": bound(nb(x, r, y_buf), (4 + act_ops[act]) * n)["bound_ms"],
            "bn_bwd_reduce": bound(nb(x, dy, r_act), (5 + act_grad_ops[act]) * n)["bound_ms"],
            "bn_bwd_apply": bound(nb(x, dy, r_act, x, r_act if has_res else None),
                                  (6 + act_grad_ops[act]) * n)["bound_ms"],
            "train_fwd": bound(nb(x, r, y_buf), (7 + act_ops[act]) * n)["bound_ms"],
            "train_bwd": bound(nb(x, dy, r_act, x, r_act if has_res else None),
                               (11 + 2 * act_grad_ops[act]) * n)["bound_ms"],
        }
        # the library's yardstick: F.batch_norm(training=True) on the bf16
        # tensor with the f32 parameters, then the activation (and the
        # residual), forward and forward + backward by events
        lx = (x.movedim(-1, 1) if layout else x.reshape(-1, Cn)).detach().requires_grad_(True)
        lr_ = None if r is None else (r.movedim(-1, 1) if layout else r.reshape(-1, Cn))
        lw, lb = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ldy = dy.movedim(-1, 1) if layout else dy.reshape(-1, Cn)

        def lib16():
            z = F.batch_norm(lx, scratch[0], scratch[1], lw, lb, training=True,
                             momentum=1.0 - mom, eps=eps)
            return lib_act[act](z if lr_ is None else z + lr_)

        lib16_fwd = cuda_ms(lib16)
        lib16_step = cuda_ms(lambda: lib16().backward(ldy))
        row = dict(shape=list(shape), act=act, residual=has_res, channel_first=bool(layout),
                   sites={p: count16[p].get(key, 0) for p in count16}, max_abs_err=err,
                   device_ms=alone, bound_ms=bounds16, paths=paths,
                   library_ms=dict(train_fwd=lib16_fwd, train_bwd=lib16_step - lib16_fwd))
        del lx, lr_, ldy
        if not rows16:  # the largest configuration: events and the plain versions
            row["stage_ms"] = {k: cuda_ms(kern) for k, (kern, _) in calls.items()}
            row["stage_plain_ms"] = {k: cuda_ms(plain) for k, (_, plain) in calls.items()}
        rows16.append(row)
        del x, r, dy, y_buf, dx_buf, dr_buf, y_k, y_p, dx_k, dx_p, dr_k, dr_p, calls, spac
        torch.cuda.empty_cache()

    def per_step16(get, path: str = "train") -> float:
        return sum(row["sites"][path] * get(row) for row in rows16)

    bn16_step = dict(
        forward_ms=per_step16(lambda r_: r_["device_ms"]["train_fwd"]),
        backward_ms=per_step16(lambda r_: r_["device_ms"]["train_bwd"]),
        stages_forward_ms=per_step16(lambda r_: r_["device_ms"]["bn_stats"]
                                     + r_["device_ms"]["bn_apply"]),
        stages_backward_ms=per_step16(lambda r_: r_["device_ms"]["bn_bwd_reduce"]
                                      + r_["device_ms"]["bn_bwd_apply"]),
        eval_ms=per_step16(lambda r_: r_["device_ms"]["bn_apply_eval"], "eval"),
        forward_bound_ms=per_step16(lambda r_: r_["bound_ms"]["bn_stats"]
                                    + r_["bound_ms"]["bn_apply"]),
        backward_bound_ms=per_step16(lambda r_: r_["bound_ms"]["bn_bwd_reduce"]
                                     + r_["bound_ms"]["bn_bwd_apply"]),
        forward_min_bound_ms=per_step16(lambda r_: r_["bound_ms"]["train_fwd"]),
        backward_min_bound_ms=per_step16(lambda r_: r_["bound_ms"]["train_bwd"]),
        eval_bound_ms=per_step16(lambda r_: r_["bound_ms"]["bn_apply_eval"], "eval"),
        library_forward_ms=per_step16(lambda r_: r_["library_ms"]["train_fwd"]),
        library_backward_ms=per_step16(lambda r_: r_["library_ms"]["train_bwd"]),
        cluster_sites={d: sum(r_["sites"]["train"] for r_ in rows16
                              if r_["paths"][d] == "cluster") for d in ("forward", "backward")},
        launches_per_step=bn16_fused, configurations=len(rows16))
    for r_ in rows16:
        print(f"[13 kernel K5 bf16] {r_['shape']} {r_['act']}{' + residual' if r_['residual'] else ''}"
              f"{' channel-first' if r_['channel_first'] else ''} x{r_['sites']['train']} train: "
              f"paths {r_['paths']['forward']} / {r_['paths']['backward']}; alone forward "
              f"{r_['device_ms']['train_fwd'] * 1e3:.2f} backward "
              f"{r_['device_ms']['train_bwd'] * 1e3:.2f} us (stages N1-N4 "
              f"{', '.join('%.2f' % (r_['device_ms'][k] * 1e3) for k in BN_KERNELS)}); bounds "
              f"{(r_['bound_ms']['bn_stats'] + r_['bound_ms']['bn_apply']) * 1e3:.2f} / "
              f"{(r_['bound_ms']['bn_bwd_reduce'] + r_['bound_ms']['bn_bwd_apply']) * 1e3:.2f}, "
              f"one-launch {r_['bound_ms']['train_fwd'] * 1e3:.2f} / "
              f"{r_['bound_ms']['train_bwd'] * 1e3:.2f} us; F.batch_norm + act "
              f"{r_['library_ms']['train_fwd']:.3f} / {r_['library_ms']['train_bwd']:.3f} ms")
    print(f"[13 kernel K5 bf16] {len(rows16)} configurations (train sites "
          f"{sum(r_['sites']['train'] for r_ in rows16)}, eval "
          f"{sum(r_['sites']['eval'] for r_ in rows16)}; the cluster path at "
          f"{bn16_step['cluster_sites']} train sites, {bn16_fused} launches per step): N1-N4 "
          f"and each direction as the step launches it against the plain bf16 versions (y "
          f"within 1 bf16 spacing, dx and d_r relative L2 <= {BF16_DX_REL_L2}); per training "
          f"step alone forward {bn16_step['forward_ms']:.3f} ms (bf16 bound "
          f"{bn16_step['forward_bound_ms']:.3f}, one-launch {bn16_step['forward_min_bound_ms']:.3f}"
          f"; stages one by one {bn16_step['stages_forward_ms']:.3f}; f32 "
          f"{bn_step['forward_ms']:.3f}), backward {bn16_step['backward_ms']:.3f} ms (bound "
          f"{bn16_step['backward_bound_ms']:.3f}, one-launch "
          f"{bn16_step['backward_min_bound_ms']:.3f}; stages "
          f"{bn16_step['stages_backward_ms']:.3f}; f32 {bn_step['backward_ms']:.3f}); eval "
          f"encode {bn16_step['eval_ms']:.3f} ms (bound {bn16_step['eval_bound_ms']:.3f}; f32 "
          f"{bn_step['eval_ms']:.3f}); F.batch_norm + act (bf16, events) "
          f"{bn16_step['library_forward_ms']:.2f} / {bn16_step['library_backward_ms']:.2f} ms")
    main16 = rows16[0]
    for name in BN_KERNELS:
        b16[name] = dict(shape=main16["shape"], act=main16["act"], residual=main16["residual"],
                         max_abs_err=max(r_["max_abs_err"][name] for r_ in rows16),
                         ms=main16["stage_ms"][name], plain_ms=main16["stage_plain_ms"][name],
                         device_ms=main16["device_ms"][name], bound_ms=main16["bound_ms"][name],
                         bound_by="bytes", per_step=bn16_step if name == "bn_stats" else None,
                         library_ms=None, at_shapes=rows16 if name == "bn_stats" else None)
    for name, d, key in (("bn_forward_fused", "forward", "train_fwd"),
                         ("bn_backward_fused", "backward", "train_bwd")):
        row = next(r_ for r_ in rows16 if r_["paths"][d] == "cluster" and r_["sites"]["train"])
        b16[name] = dict(shape=row["shape"], act=row["act"], residual=row["residual"],
                         max_abs_err=max(r_["max_abs_err"][name] for r_ in rows16),
                         device_ms=row["device_ms"][key], bound_ms=row["bound_ms"][key],
                         bound_by="bytes", library_ms=row["library_ms"][key])
    for name in b16:
        b16[name]["launches"] = train16_launches[f"{name}_bf16"]
        b16[name]["launches_by_path"] = {"serve": serve16_launches[f"{name}_bf16"],
                                         "train": train16_launches[f"{name}_bf16"]}
        results[name]["bf16"] = b16[name]

    # ---- 14. train-kitti ---------------------------------------------------
    p14 = train_kitti_phase(dev, card, Path(tree_dir.name), tree_procs,
                            {"fused_per_step": bn16_fused, "step_ms": warm16})
    # ---- 15. eval ----------------------------------------------------------
    p15 = eval_phase(dev, card, Path(tree_dir.name), p14["model_path"])
    tree_dir.cleanup()
    for name in b16:
        results[name]["bf16"]["launches_by_path"]["train_kitti"] = \
            p14["launches"][f"{name}_bf16"]
        results[name]["bf16"]["launches_by_path"]["eval"] = p15["launches"][f"{name}_bf16"]

    sources = {
        "gather_levels": ("scenerf_tpu_torch/ops/csrc/gather.cu", "scenerf_tpu/geometry.py:106"),
        "gather_levels_bwd": ("scenerf_tpu_torch/ops/csrc/gather_bwd.cu",
                              "scenerf_tpu/ops/gather_scatter.py:141"),
        "sort_composite": ("scenerf_tpu_torch/ops/csrc/composite.cu",
                           "scenerf_tpu/rendering.py:102"),
        "sort_composite_bwd": ("scenerf_tpu_torch/ops/csrc/composite_bwd.cu",
                               "scenerf_tpu/rendering.py:102"),
        "ray_som": ("scenerf_tpu_torch/ops/csrc/som_em.cuh", "scenerf_tpu/som.py:37"),
        "tsdf_integrate": ("scenerf_tpu_torch/ops/csrc/tsdf.cu",
                           "scenerf_tpu/fusion/tsdf.py:44"),
        **{k: ("scenerf_tpu_torch/ops/csrc/norm.cu", "scenerf_tpu/encoder/norm.py:31")
           for k in BN_KERNELS + BN_FUSED},
    }
    # launches: on the training path, or for T the reconstruction path's
    main_launches = {**launches, "tsdf_integrate": recon_launches["tsdf_integrate"]}
    results["ray_som"]["empty_kernel_floor"] = floor
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "launches_by_path": {"serve": serve_launches.get(name, 0), "train": launches[name],
                              "reconstruction": recon_launches[name],
                              "train_kitti": p14["launches"][name],
                              "eval": p15["launches"][name]},
         **results[name]}
        for name, (src, rep) in sources.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
