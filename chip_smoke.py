"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the novel-depth
serve path, the training step, the `train-kitti` entry point and the KITTI
evaluation commands at the full KITTI preset, and the BundleFusion entry
points at the BF preset, through the hand-written kernels.

    python3 chip_smoke.py [--bf-som-chunk OUT.npz]

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
     and backward per step (counted over step 0, eager, and step 1, which
     captures the step's CUDA graphs; step 2 replays them); step 2 against
     an eager twin from the same state (loss and metrics within
     GRAPH_METRIC_RTOL, the gradients as one vector within the compute
     dtype's GRAPH_GRAD_REL_L2); step 0 and step 2 again on the plain
     versions but K5's kernels, from the same state and draws, loss and
     every gradient leaf held to the kernel path's; K5 on the train-mode
     encode (levels, and the encoder's gradients under a fixed cotangent)
     against the plain version, each held to the plain version in f64; ms
     per replayed step, rays/s, peak device memory
 11. reconstruction: the phase-4 weights encode the synthetic frame with
     KITTI's calibration, render the CLI's full default sweep (63 poses) at
     stride 2, chunk 5000 (kernels G, C), upsample it to 1220x370, quantize
     the colors as the CLI's PNGs and fuse it into the 256x256x32 KITTI TSDF
     grid with kernel T; observed voxels, weight <= 63; T against its plain
     version in both modes (bit-equal but for pixel-rounding ties) and the
     kernel's occupancy scored against the plain version's (SSCMetrics);
     s per frame, fuse ms and its parts (the volume, pack_colors, the host's
     pose inversion and upload, T), T's time (events, fresh volume; alone),
     its work (voxel-frames in view and valid, distinct depth pixels and
     taken colors, 32-B sectors per warp depth load with lanes along z and
     along the image rows, the share its cull keeps) and its bounds (the pixels it
     touches and the instructions in view; every pixel read once)
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
     one C training launch (R = 1200, S's EM inside) per source (counted
     over the eager and the capturing step), the replayed step 2 against an
     eager twin as in phase 10, step 0's
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
     and val metrics finite, each run's first step eager, its second
     capturing the step graphs and its third replaying them, every training
     kernel launched (K5 at 192 sites forward and backward in each eager and
     capturing step, N2 also at each val encode, the one-launch counts phase
     13's per step, S only inside C: one C training launch per ray chunk,
     source, such step and val item), ICP's cached refinements rigid
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
 16. BundleFusion: the entry points through their click commands on cuda:0
     on a fake 640x480 tree that eight `scripts/make_fake_bf.py` processes
     write while phases 1-15 run (the 7 train scenes with 37 frames, 3
     train items each; copyroom with 33, one val item: frame 16 with 16
     sources), at the BF preset (B7 at 640x480, 960x720 sphere, 32 + 4x8
     samples, f32): train-bundlefusion at the CLI's defaults (2048 rays in
     one chunk, som_sigma 0.02) with --max_steps_per_epoch 3, then resumed
     with --n_epochs 2 (each run's steps eager, capturing, replaying); one
     more step of the run's trainer, which replays, against an eager twin
     as in phase 10; the first step of a new trainer from the same state
     (eager) hooked to record each BN site's configuration and K5 path and
     kernel C's launches; K5 at every
     distinct BF configuration (train and eval) held to its plain version
     by phase 12's checks; RaySOM's EM inside C against its plain version
     on the step's chunk (saved with --bf-som-chunk for the CPU test against
     JAX); save-depth-metrics-bf (every GT pixel of the 16 sources,
     4,915,200 rays), agg-depth-metrics-bf, render-colors-bf (stride 2,
     upsampled to 640x480) and eval-color-bf (random LPIPS weights), again
     (nothing launched); one source's depth at its 307,200 GT pixels,
     kernels against the plain versions (>= 99% at rtol 1e-3);
     generate-novel-depths-bf (33 poses), depth2tsdf-bf (120x120x96 at 0.04
     m, marching cubes), generate-sc-gt-bf, eval-sc-bf, determine-angles,
     the first three again (nothing launched); kernel T against its plain
     version on the sweep's and the GT's frames at the BF grid (bit-equal
     but at pixel-rounding ties, >= 99.99%). Checks: the resume and its lr,
     last and best, finite losses and metrics, every kernel at its counted
     launches on each path (K5's one-launch counts from the plan's cluster
     sites; C at R = 2048 with the EM), the files and sizes of every
     command. Prints ms per step through the loader, host ms per item, val
     ms per item, save ms and peak memory; save-depth-metrics-bf ms per item
     (host read, encode, renders) and GT-pixel rays/s; render-colors-bf ms
     per image; eval-color-bf ms per pair; s per sweep frame, fuse, mesh and
     GT-fuse ms, the mesh's vertex count; kernel T's time at the BF grid
     (events, alone), its work and bounds as in phase 11
 17. several ranks: K5's synced stages (N1 and N3 without their finalize,
     the two finalize launches) at every distinct bf16 training
     configuration of phase 13 against their plain versions (the finalizes
     on a rank's and the world's sums of two halves), each direction
     of the synced path timed alone and summed over a step's 192 sites
     beside the cluster path's, the stages beside torch.batch_norm_stats,
     batch_norm_gather_stats_with_counts and batch_norm_backward_reduce;
     then PAR_RANKS ranks on cuda:0 over gloo, child processes of this
     script with torchrun's environment (`--parallel-rank DIR`), reaped by
     it: (0) the synced op across the ranks at three B7 sites, f32 and
     bf16, against the plain version on all the ranks' rows; (1)
     train-kitti --parallel_mode data --bs 2 at phase 14's flags on
     its tree, one item a rank: parameters and gradients bit-equal across
     the ranks after every step, each site's synced batch statistics within
     BN_STATS_TOL of f64 over both items, the first AdamW move, no cluster
     launch and the synced launches and all-reduces as counted; (2)
     ray_shard at --bs 1 on make_batch at lr 0, in bf16 and in f32, against
     the one-rank step on the same item, seed and weights, run twice, and
     against the split played on one rank (loss rtol 1e-3; in f32 phase
     10's leaves, relative L2 1e-2 each but those zero up to rounding; in
     bf16, whose step does not repeat on the card, the whole gradient
     within SHARD_FLOOR_RATIO times the one-rank step's run-to-run
     difference), the ranks bit-equal;
     (3) save-depth-metrics
     --n_devices 2 on phase 15's tree and best: phase 15's files, metrics
     within rtol 1e-3, one source's rays >= 99% equal to the one-rank render
     at rtol 1e-3; a frame's encode beside broadcasting its levels; (4) a
     one-rank NCCL group in this process all-reduces one step's gradient
     buffer. Prints ms per step, peak memory per rank, the synced-BN and
     gradient all-reduces' ms per step, the synced K5 ms per step, all
     labelled as two ranks sharing one card through the host
 18. the last workflows, on phase 14's tree: (a) import: phase 14's `best`
     written in the layout of a published checkpoint (`state_dict` under the
     reference's names plus the keys it carries and the forward never reads:
     the encoder's bn2 and classifier, the decoder's resize convs, every BN's
     batch counter; `hyper_parameters` at phase 14's KITTI values under the
     reference's flag names), imported by
     `scripts/import_reference_ckpt_torch.py` in a subprocess; load_model
     gives every tensor bit-equal and every hparam on the config (f32). (b)
     the KITTI reconstruction CLIs through click on cuda:0 with the imported
     checkpoint on one val frame (08/000005, a root linking phase 14's files
     with that frame's voxel GT alone) and a cut sweep (--max_distance 2.1:
     15 of the 63 poses, stride 2): generate-novel-depths -> depth2tsdf ->
     eval-sr. Checks: the depths finite at 370x1220; depth2tsdf's volume
     bit-equal to the plain version of T on the written depths and PNGs on
     at least TSDF_MIN_EQUAL of the voxels; eval-sr's IoU, precision and
     recall equal to a host recompute from the written volume; G, C, N2 and
     T at their counted launches. (c) `scripts/quality_runs_torch.py
     --configs bf16x4,f32x4 --steps 4 --val_every 2` at full width (B7,
     1220x370, 1500x452, ray_chunk 1200): its JSON read by
     `scripts/quality_table.py`, every value finite, both arms on the same
     frames, every training kernel launched in both dtypes. (d)
     `scripts/overfit_probe_torch.py --steps 25` on the card: a finite
     abs_rel. Prints each stage's seconds, both trajectories, the table, the
     arms' wall time and peak memory
Then one JSON line of per-kernel results (each bf16 kernel's bf16 results
under "bf16"; "launches_by_path" gains "train_kitti", "eval", "bf_train",
"bf_eval", "bf_recon", "parallel", "chain", "quality" and "overfit"; T,
RaySOM and K5 gain their BF rows; K5's
synced stages count their launches in phase 17's data-mode run), the card
line, and the last line
{"ok": true, "device": {...}}. It exits non-zero, printing no result, when no
CUDA device is present or any phase fails. Imports torch, numpy and the port
(`scenerf_tpu_torch`, which must sit beside this file), never JAX.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import json
import math
import os
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
# of a trainer's steps on one shape the first runs eagerly and the second
# captures the step's CUDA graphs (scenerf_tpu_torch/step_graphs.py): both
# call the kernels' wrappers, which count launches, and run module hooks;
# every later step replays the graphs and calls neither
LAUNCHING_STEPS = 2
GRAPH_METRIC_RTOL = 1e-6   # a replayed step's loss and metrics vs an eager twin's: the
                           # same kernels in the same order on the same inputs
# its gradients as one vector: G-bwd's float atomics add in another order.
# In f32 that moves them by ~4e-6 at KITTI. In bf16, where such a sum tips a
# bf16 rounding, the encoder backward's later roundings part one after
# another, and two eager steps from one state differ as much as a replayed
# and an eager step (tiny config: up to 1.1e-2 and 1.2e-2; KITTI, graphed
# against eager: 3.3e-2); the eager twin's own spread is printed beside
GRAPH_GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 0.1}
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
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9  # H100 SXM lane-instructions/s: 132 SMs x 4 schedulers
                                     # x 32 lanes at the 1.98 GHz boost clock
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
    """K5's one-launch counts per training step (`launches` over the
    LAUNCHING_STEPS of TRAIN_STEPS steps) held to the sites `k5_path_hooks`
    saw take the cluster path in one step, in each direction; the per-step
    counts."""
    fused = {k: launches[k + suffix] / LAUNCHING_STEPS for k in BN_FUSED}
    plan = {k: paths[d].count("cluster") for k, d in zip(BN_FUSED, ("forward", "backward"))}
    if [len(paths[d]) for d in ("forward", "backward")] != [BN_SITES] * 2 or fused != plan \
            or min(plan.values()) < 1:
        fail(f"train{suffix}: K5 one-launch (cluster) launches per step {fused}; the plan puts "
             f"{plan} of {[len(paths[d]) for d in ('forward', 'backward')]} sites there")
    return fused


def step_kinds() -> list:
    """The kind of each training step `tracing` recorded, oldest first:
    "eager", "capture" (captured the step graphs, then replayed them) or
    "replay"."""
    from scenerf_tpu_torch.utils import tracing

    return ["capture" if s.counts.get("graph_capture") else
            "replay" if s.counts.get("graph_replay") else "eager"
            for s in tracing.snapshot() if s.name == "train_step"]


def replay_against_eager(trainer, before: dict, batch, noise, metrics: dict,
                         grads: dict) -> dict:
    """A step of `trainer` that replayed its step graphs (its `metrics` and
    gradients `grads`, taken from `before`, a copy of its `state_dict()`)
    against the same step of an eager twin from that state: a trainer on
    the same model that runs every step eagerly. The loss and metrics are
    held within GRAPH_METRIC_RTOL, the gradients as one vector within the
    compute dtype's GRAPH_GRAD_REL_L2; the twin takes the step twice, and
    the gap of its two steps' gradients is returned beside ("floor"), and
    the fields' gradients' gap ("fields", upstream of G-bwd); `trainer`'s
    state after its step is put back. Returns the gaps."""
    import torch

    from scenerf_tpu_torch.train import Trainer

    def rel(a: dict, b: dict, names) -> float:
        num = sum(float((a[n].double() - b[n].double()).square().sum()) for n in names)
        return (num / max(sum(float(b[n].double().square().sum()) for n in names), 1e-60)) ** 0.5

    after = copy.deepcopy(trainer.state_dict())
    twin = Trainer(trainer.cfg, device=trainer.device, model=trainer.model,
                   steps_per_epoch=trainer.steps_per_epoch)
    twin._eager = True
    runs = []
    for _ in range(2):
        twin.load_state_dict(copy.deepcopy(before))
        want = {k: float(v) for k, v in twin.train_step(batch, noise=noise).items()}
        runs.append({n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
                     if p.grad is not None})
    got = {k: float(v) for k, v in metrics.items()}
    want_g = runs[0]
    if set(got) != set(want) or set(grads) != set(want_g):
        fail(f"a replayed step's metrics {sorted(got)} or gradient leaves ({len(grads)}) "
             f"differ from its eager twin's ({sorted(want)}, {len(want_g)})")
    fields = [n for n in want_g if not n.startswith("net_rgb.")]
    gaps = {"metric": max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want),
            "grad": rel(grads, want_g, want_g), "floor": rel(runs[1], want_g, want_g),
            "fields": rel(grads, want_g, fields),
            "grad_limit": GRAPH_GRAD_REL_L2[trainer.cfg.compute_dtype]}
    del runs, want_g
    trainer.load_state_dict(after)
    trainer.model.zero_grad(set_to_none=True)
    del twin
    torch.cuda.empty_cache()
    if not (gaps["metric"] <= GRAPH_METRIC_RTOL and gaps["grad"] <= gaps["grad_limit"]):
        fail(f"a replayed step against its eager twin from the same state: metrics "
             f"{gaps['metric']:.3e} (limit {GRAPH_METRIC_RTOL}), gradients {gaps['grad']:.3e} "
             f"(limit {gaps['grad_limit']})")
    return gaps


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


def k5_what(key) -> str:
    shape, act, has_res, _, _, layout = key
    return (f"{list(shape)} {act}{' + residual' if has_res else ''}"
            f"{' channel-first' if layout else ''}")


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
    import torch

    err = rel_l2(a, b)
    if not (bool(torch.isfinite(a).all()) and err <= BN_REL_L2):
        fail(f"K5 {what}: relative L2 {err:.3e} > {BN_REL_L2}")
    return float((a - b).abs().max())


def k5_site_check(key, gen, dev) -> dict:
    """Kernel K5 at one batch norm configuration `key` (shape, activation,
    residual, eps, momentum, layout) on seeded f32 inputs: N1-N4 one by one
    against their plain versions, each direction as the training step
    launches it (one launch on the cluster path), the fused op in train mode
    against autograd of the plain version (the cotangent zeroed at the
    leaky-ReLU's kink ties), eval mode within BN_EVAL_SPACINGS. Fails on a
    disagreement; returns the inputs (x, w, b, rm, rv, r, dy), the plain
    statistics and gradients (st_p, gr_p), the largest error per kernel,
    the path of each direction, the eval spacings, the fused op's relative
    L2, the kink ties and how many of them only the two sides' statistics
    make (z on either side of 0, beyond rounding of the summands)."""
    import torch

    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import norm as NM

    shape, act, has_res, eps, mom, layout = key
    Cn = shape[-1]
    what = k5_what(key)

    def draw():
        """A seeded tensor of the site's shape and layout."""
        if not layout:
            return torch.randn(shape, generator=gen, device=dev)
        return torch.randn(shape[0], Cn, *shape[1:-1], generator=gen,
                           device=dev).movedim(1, -1)

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
    # cotangent zeroed at the leaky-ReLU's kink ties: z within rounding of
    # 0, and z on the two sides of 0 from the kernels' statistics and the
    # plain version's (held to each other at BN_RTOL above), where each side
    # takes another slope
    ties = NM.kink_ties(x, st_p, act, r)
    straddle = 0
    if act == "leaky":
        sides_of_0 = ((NM._pre_activation(x, st_f, r) >= 0)
                      != (NM._pre_activation(x, st_p, r) >= 0))
        straddle = int((sides_of_0 & ~ties).sum())
        ties |= sides_of_0
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
    return dict(x=x, w=w, b=b, rm=rm, rv=rv, r=r, dy=dy, st_p=st_p, gr_p=gr_p, err=err,
                paths=paths, eval_spacings=eval_spacings, op_l2=op_l2, ties=ties,
                straddle=straddle)


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


def wait_procs(procs: list, what: str) -> None:
    """Wait for the tree writers `procs`; fail with the output of one that failed."""
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            fail(f"{what} failed ({p.returncode}):\n{out}")


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

    wait_procs(procs, "make_fake_kitti.py")
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
    from scenerf_tpu_torch.utils import tracing
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
    with tracing.recording():
        run1 = train_cli.cli.main(argv + ["--n_epochs", "1"], standalone_mode=False)
    kinds = step_kinds()
    run1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tracing.recording():
        run2 = train_cli.cli.main(argv + ["--n_epochs", "2"], standalone_mode=False)
    kinds += step_kinds()
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

    # each run's first step eager, its second capturing the step graphs, the
    # others replaying them
    run_kinds = ["eager", "capture"] + ["replay"] * (KITTI_STEPS - LAUNCHING_STEPS)
    if kinds != run_kinds * 2:
        fail(f"train-kitti: the steps of its two runs ran {kinds}; expected {run_kinds} each")

    # every training kernel, K5 at its 192 sites a step in each direction (N2
    # also at each val encode), S only inside C: per source, one C training
    # launch per ray chunk, in every step that ran the wrappers (eager,
    # capturing) and every val item
    n_val = sum(run1["val_items"]) + sum(run2["val_items"])
    n_launch = 2 * LAUNCHING_STEPS
    chunks = -(-cfg.n_rays // cfg.ray_chunk)
    want = {"bn_stats_bf16": BN_SITES * n_launch, "bn_bwd_reduce_bf16": BN_SITES * n_launch,
            "bn_bwd_apply_bf16": BN_SITES * n_launch,
            "bn_apply_bf16": BN_SITES * (n_launch + n_val),
            "ray_som_in_sort_composite": cfg.n_sources * chunks * (n_launch + n_val),
            "ray_som": cfg.n_sources * chunks * (n_launch + n_val), "tsdf_integrate": 0}
    if ref is not None:
        want.update({f"{k}_bf16": ref["fused_per_step"][k] * n_launch for k in BN_FUSED})
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
          f"each run's steps {run_kinds}; launches in the eager and the capturing steps and "
          f"the val items {got}; best loaded and rendered a stride-2 pose, depth finite "
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


BF_TRAIN_SCENES = ("apt0", "apt1", "apt2", "office0", "office1", "office2", "office3")
# phase 16's BundleFusion tree at 640x480: copyroom's 33 frames leave one val item
# (frame 16, 16 sources at frame interval 2); 37 frames leave each train scene 3
BF_TREE_FRAMES = {**{s: 37 for s in BF_TRAIN_SCENES}, "copyroom": 33}
BF_TREE_SIZE = (640, 480)  # (W, H) of its frames: the dataset's
BF_STEPS = 3               # steps per epoch (--max_steps_per_epoch)
BF_TRAIN_FLAGS = ("--max_steps_per_epoch", str(BF_STEPS))  # else the CLI's defaults
# the BF preset at the CLI's defaults: image, sphere, rays (one chunk), sources,
# som_sigma, compute dtype
BF_PRESET = ((640, 480), (960, 720), 2048, 2048, 1, 0.02, "float32")
BF_VAL_FRAME, BF_VAL_SOURCES = "000016", 16
BF_SWEEP_POSES = 33        # the CLI's sweep: 11 steps of 0.2 m x yaw 0, -30, +30
BF_GRID = (120, 120, 96)


def start_bf_tree(root: Path) -> list:
    """Start writing phase 16's BundleFusion tree under `root` (640x480
    frames; a room of depth 1-4 m, every pixel valid; poses along z): one
    `scripts/make_fake_bf.py` process per scene."""
    script = ROOT / "scripts" / "make_fake_bf.py"
    W, H = BF_TREE_SIZE
    procs = [subprocess.Popen([sys.executable, str(script), "--root", str(root), "--frames",
                               str(n), "--scenes", scene, "--width", str(W), "--height",
                               str(H)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for scene, n in BF_TREE_FRAMES.items()]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def tsdf_footprint(shape, vol_origin, voxel_size, trunc, depths, packed, intrs, w2cs,
                   warp_groups=None) -> dict:
    """What fusing these frames into a fresh volume in closest mode (the
    CLI's) needs, from the plain version's pixel indices (its projection,
    repeated here): voxel-frames in view and valid; the distinct depth pixels
    the in-view voxel-frames touch and the distinct pixels whose color is
    taken, summed over frames; and for each [X, Y, Z] map of warp-load
    groups in `warp_groups` (name -> int64 group of each voxel), the
    distinct 32-B sectors of its groups' depth loads and the loads (groups
    with a lane in view), summed over frames."""
    import torch

    from scenerf_tpu_torch.ops.tsdf import _origin_values, world_coords

    dev = depths.device
    F_, H, W = depths.shape
    f32 = dict(dtype=torch.float32, device=dev)
    wx, wy, wz = world_coords(shape, torch.tensor(_origin_values(vol_origin), **f32),
                              torch.tensor(float(voxel_size), **f32))
    tsdf = torch.full(tuple(shape), 255.0, **f32)
    trunc = torch.tensor(float(trunc), **f32)
    groups = {k: v.to(dev) for k, v in (warp_groups or {}).items()}
    out = dict(n_voxels=tsdf.numel(), n_frames=F_, in_view=0, valid=0, depth_px=0,
               color_px=0, sectors={k: 0 for k in groups}, loads={k: 0 for k in groups})
    n_sectors = -(-H * W // 8)
    for f in range(F_):
        K, M = intrs[f], w2cs[f]
        cx, cy, cz = (M[r, 0] * wx + M[r, 1] * wy + M[r, 2] * wz + M[r, 3] for r in range(3))
        sz = torch.where(cz > 0, cz, torch.ones((), **f32))
        px = torch.round(K[0, 0] * cx / sz + K[0, 2])
        py = torch.round(K[1, 1] * cy / sz + K[1, 2])
        seen = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (cz > 0)
        flat = (torch.clamp(py, 0, H - 1).to(torch.int64) * W
                + torch.clamp(px, 0, W - 1).to(torch.int64))
        d = torch.where(seen, torch.take(depths[f], flat), torch.zeros((), **f32))
        dd = d - cz
        valid = (d > 0) & (dd >= -trunc)
        take = valid & (tsdf.abs() >= dd.abs())
        tsdf = torch.where(take, dd, tsdf)
        out["in_view"] += int(seen.sum())
        out["valid"] += int(valid.sum())
        out["depth_px"] += int(torch.unique(flat[seen]).numel())
        out["color_px"] += int(torch.unique(flat[take]).numel())
        for k, g in groups.items():
            out["sectors"][k] += int(torch.unique(g[seen] * n_sectors + flat[seen] // 8).numel())
            out["loads"][k] += int(torch.unique(g[seen]).numel())
    return out


def tsdf_warp_groups(shape, axis: int) -> dict:
    """The warp loads of kernel T's depth gathers, as maps of the voxels
    ([X, Y, Z] int64 group): a warp per 32 consecutive voxels of the flat
    grid (lanes along z) and kernel T's (lanes along `axis`, one load per
    voxel of each thread's run)."""
    import torch

    from scenerf_tpu_torch.ops import tsdf as T

    (A, B, L), (_, nB, nL) = T.tile_layout(axis)
    idx = [torch.arange(n).view([n if b == a else 1 for b in range(3)])
           for a, n in enumerate(shape)]
    rows = (T.voxel_tiles(shape, axis) * nB + idx[B] % nB) * nL + idx[L] % nL
    return {"lanes_along_z": torch.arange(math.prod(shape)).view(tuple(shape)) // 32,
            "lanes_along_rows": rows}


def tsdf_bounds(fp: dict, vol_bytes: int, frame_bytes: int, cam_bytes: int) -> dict:
    """Kernel T's bounds on footprint `fp`. `bound_ms`: the volume in and
    out, the distinct depth pixels touched and colors taken, the cameras, at
    the HBM rate; 32 instructions per voxel-frame in view and 7 per valid
    one at the issue rate (a voxel-frame out of view needs none where whole
    tiles of them are culled). `all_pixels_bound_ms`: every pixel of every
    frame read once and 32 operations per voxel-frame and 7 per valid one at
    the f32 peak."""
    old = bound(2 * vol_bytes + frame_bytes + cam_bytes,
                32 * fp["n_voxels"] * fp["n_frames"] + 7 * fp["valid"])
    t_bytes = (2 * vol_bytes + 4 * (fp["depth_px"] + fp["color_px"]) + cam_bytes) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = (32 * fp["in_view"] + 7 * fp["valid"]) / ISSUE_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes_ms": t_bytes, "issue_ms": t_ops,
            "all_pixels_bound_ms": old["bound_ms"], "all_pixels_bound_by": old["bound_by"]}


def tsdf_work_text(fp: dict, b: dict, cull: dict) -> str:
    """One line of kernel T's work and bounds at a shape."""
    n = fp["n_voxels"] * fp["n_frames"]
    return (f"in view {fp['in_view'] / n:.4f}, valid {fp['valid'] / n:.4f} of {n} "
            f"voxel-frames; live tiles {cull['live_share']:.4f} (lanes along axis "
            f"{cull['lane_axis']}); distinct depth px/frame {fp['depth_px'] / fp['n_frames']:.0f}, "
            f"colors taken/frame {fp['color_px'] / fp['n_frames']:.0f}; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: bytes {b['bytes_ms']:.4f}, issue "
            f"{b['issue_ms']:.4f}), all-pixels bound {b['all_pixels_bound_ms']:.4f} ms")


def tsdf_cull(shape, vol_origin, voxel_size, intrs, w2cs, H: int, W: int) -> dict:
    """Kernel T's plan for these poses (its plain twin, ops.tsdf): the lanes'
    axis, the share of tile-frames culled and the share of voxel-frames in
    tiles that keep their frame."""
    from scenerf_tpu_torch.ops import tsdf as T

    axis = T.lane_axis(w2cs)
    unseen = T.tiles_unseen(shape, vol_origin, voxel_size, intrs, w2cs, H, W)
    _, count = T.tile_boxes(shape, axis)
    live = float((count.prod(1)[:, None] * ~unseen).sum())
    return {"lane_axis": axis, "culled_tile_frames": float(unseen.float().mean()),
            "live_share": live / (math.prod(shape) * len(w2cs))}


def tsdf_against_plain(dev, depths, colors, intrs, w2cs) -> dict:
    """Kernel T against its plain version on a fresh BundleFusion grid
    (closest mode, the CLI's): bit-equal but at pixel-rounding ties (at least
    TSDF_MIN_EQUAL of the voxels); T's time on a fresh volume (events) and
    alone (a CUDA graph), the plain version's, its work (`tsdf_footprint`,
    `tsdf_cull`) and bounds (`tsdf_bounds`). `colors` 0..255."""
    import torch

    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.fusion.tsdf import pack_colors
    from scenerf_tpu_torch.ops.tsdf import integrate, integrate_plain, pixel_ties

    vol = recon.bf_volume(dev)
    packed = pack_colors(colors)
    args = (depths, packed, intrs, w2cs, vol._vol_origin, vol._voxel_size, vol._trunc_margin,
            1.0)

    def fresh():
        return [torch.full(vol.shape, 255.0, device=dev), torch.zeros(vol.shape, device=dev),
                torch.zeros(vol.shape, device=dev)]

    got, want = fresh(), fresh()
    integrate(*got, *args)
    integrate_plain(*want, *args)
    ties = pixel_ties(vol.shape, vol._vol_origin, vol._voxel_size, intrs, w2cs, tol=TIE_PX)
    differs = torch.zeros(vol.shape, dtype=torch.bool, device=dev)
    for a, b in zip(got, want):
        differs |= a != b
    equal = 1.0 - float(differs.float().mean())
    untied = int((differs & ~ties).sum())
    if equal < TSDF_MIN_EQUAL or untied:
        fail(f"tsdf_integrate at {vol.shape}: bit-equal on {equal:.6%} of voxels, {untied} "
             f"differing voxels with no pixel-rounding tie")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    H, W = depths.shape[1:]
    fp = tsdf_footprint(vol.shape, vol._vol_origin, vol._voxel_size, vol._trunc_margin, depths,
                        packed, intrs, w2cs)
    n_valid = int(want[1].double().sum())  # obs 1: the weights count the valid voxel-frames
    if fp["valid"] != n_valid:
        fail(f"tsdf_footprint at {vol.shape}: {fp['valid']} valid voxel-frames, the plain "
             f"version's weights {n_valid}")
    cull = tsdf_cull(vol.shape, vol._vol_origin, vol._voxel_size, intrs, w2cs, H, W)
    ms = cuda_ms(lambda: integrate(*fresh(), *args))
    plain_ms = cuda_ms(lambda: integrate_plain(*fresh(), *args))
    work = fresh()
    dev_ms = graph_ms(lambda: integrate(*work, *args))
    del work
    b = tsdf_bounds(fp, nbytes(*got), nbytes(depths, packed), nbytes(intrs, w2cs))
    return dict(shape=[*vol.shape, *depths.shape], equal_share=equal,
                differ=int(differs.sum()), tie_voxels=int(ties.sum()), max_abs_err=err,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, footprint=fp, cull=cull,
                work=tsdf_work_text(fp, b, cull), **b)


def bf_phase(dev, card: str, tree: Path, tree_procs: list, som_chunk: str | None) -> dict:
    """Phase 16: BundleFusion at the BF preset through the normal entry
    points on the tree: train-bundlefusion (resumed), the five evaluation
    commands, the four reconstruction commands; the checks and numbers of
    the module docstring. `som_chunk`: where to save the RaySOM inputs of the
    first 512 rays of one training chunk and the EM's outputs on them
    (npz), or None. Returns each path's launches, the numbers, K5's rows
    and kernel T's at the BundleFusion grid."""
    import numpy as np
    import torch
    from PIL import Image

    from scenerf_tpu_torch import rendering
    from scenerf_tpu_torch.cli import evaluation as ev
    from scenerf_tpu_torch.cli import reconstruction as rc
    from scenerf_tpu_torch.cli import train as train_cli
    from scenerf_tpu_torch.data import bundlefusion as bfd
    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import norm as NM
    from scenerf_tpu_torch.som import som_em_plain
    from scenerf_tpu_torch.train import Trainer
    from scenerf_tpu_torch.utils import tracing
    from scenerf_tpu_torch.utils.checkpoint import load_model
    from scenerf_tpu_torch.utils.lpips import LPIPS

    t0 = time.perf_counter()
    wait_procs(tree_procs, "make_fake_bf.py")
    tree_s = time.perf_counter() - t0
    root, logdir = str(tree), str(tree / "logs")
    val_ds = ev.bf_val_ds(root)
    if [s["frame_id"] for s in val_ds.scans] != [BF_VAL_FRAME] or len(bfd.BundlefusionDataset(
            "train", root, frame_interval=2, n_frames=16).scans) != 3 * len(BF_TRAIN_SCENES):
        fail(f"BundleFusion tree: val frames {[s['frame_id'] for s in val_ds.scans]}")

    # ---- train-bundlefusion at the CLI's defaults, then resumed
    argv = ["train-bundlefusion", "--root", root, "--logdir", logdir, *BF_TRAIN_FLAGS]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with tracing.recording():
        run1 = train_cli.cli.main(argv + ["--n_epochs", "1"], standalone_mode=False)
    kinds = step_kinds()
    with tracing.recording():
        run2 = train_cli.cli.main(argv + ["--n_epochs", "2"], standalone_mode=False)
    kinds += step_kinds()
    train_s = time.perf_counter() - t0
    launches_train = dict(build.LAUNCHES)
    train_peak = torch.cuda.max_memory_allocated()
    trainer, mgr = run2["trainer"], run2["checkpoints"]
    cfg = trainer.cfg
    n_steps = len(run1["loss"]) + len(run2["loss"])
    if (cfg.name, cfg.img_size, (cfg.sphere.width, cfg.sphere.height), cfg.n_rays, cfg.ray_chunk,
            cfg.n_sources, cfg.som_sigma, cfg.compute_dtype) != ("bundlefusion", *BF_PRESET):
        fail(f"train-bundlefusion's config at the CLI defaults: {cfg}")
    if (run1["start_step"], run2["start_step"], trainer.step, n_steps) != (
            0, BF_STEPS, 2 * BF_STEPS, 2 * BF_STEPS):
        fail(f"train-bundlefusion: runs started at steps {run1['start_step']}, "
             f"{run2['start_step']} and took {len(run1['loss'])} + {len(run2['loss'])} steps")
    lr1 = cfg.lr * cfg.lr_decay_gamma
    if trainer.steps_per_epoch != BF_STEPS or {g["lr"] for g in
                                               trainer.optimizer.param_groups} != {lr1}:
        fail(f"train-bundlefusion resume: {trainer.steps_per_epoch} steps per epoch, lr "
             f"{[g['lr'] for g in trainer.optimizer.param_groups]}; expected epoch 1's {lr1}")
    val = run1["val_metrics"] + run2["val_metrics"]
    losses = run1["loss"] + run2["loss"]
    if not (all(math.isfinite(v) for v in losses) and all(
            v is not None and all(math.isfinite(x) for x in v.values()) for v in val)):
        fail(f"train-bundlefusion: losses {losses} or val metrics {val} not finite")
    abs_rel = [v["depth/abs_rel"] for v in val]
    meta = mgr.read_meta()
    if not (mgr.latest() and mgr.best() and meta["last_step"] == 2 * BF_STEPS
            and meta["best_value"] == min(abs_rel)
            and meta["best_step"] == (int(np.argmin(abs_rel)) + 1) * BF_STEPS):
        fail(f"train-bundlefusion checkpoints: meta "
             f"{ {k: v for k, v in meta.items() if k != 'config'} }; val abs_rel {abs_rel}")

    # each run's first step eager, its second capturing the step graphs, the
    # others replaying them
    run_kinds = ["eager", "capture"] + ["replay"] * (BF_STEPS - LAUNCHING_STEPS)
    if kinds != run_kinds * 2:
        fail(f"train-bundlefusion: the steps of its two runs ran {kinds}; expected "
             f"{run_kinds} each")
    n_launch = 2 * LAUNCHING_STEPS  # the steps that ran the wrappers

    # one more step of the run's trainer on a train item, which replays its
    # graphs, against an eager twin from the same state
    batch = bfd.to_model_batch([bfd.BundlefusionDataset(
        "train", root, n_sources=1, frame_interval=2, n_frames=16, seed=SEED)[0]], cfg)
    before = copy.deepcopy(trainer.state_dict())
    with tracing.recording():
        metrics = trainer.train_step(batch)
    if step_kinds() != ["replay"]:
        fail(f"train-bundlefusion: a step after the runs ran {step_kinds()}; expected a replay")
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    twin_gaps = replay_against_eager(trainer, before, batch, None, metrics, grads)
    del before, metrics, grads

    # and one on a new trainer from the same state, whose first step runs
    # eagerly, hooked: each BN site's configuration and K5 path, kernel C's
    # launches (rays, with the EM) and the RaySOM inputs
    hooked = Trainer(cfg, device=dev, model=trainer.model,
                     steps_per_epoch=trainer.steps_per_epoch)
    hooked.load_state_dict(copy.deepcopy(trainer.state_dict()))
    paths, sites = {"forward": [], "backward": []}, {"train": [], "eval": []}

    def site_hooks(path):
        def record(mod, args, kwargs):
            res_in = args[1] if len(args) > 1 else kwargs.get("residual")
            sites[path].append((tuple(args[0].shape), mod.act, res_in is not None, mod.eps,
                                mod.momentum, NM.plane(args[0])))
        return [m.register_forward_pre_hook(record, with_kwargs=True)
                for m in trainer.model.modules() if isinstance(m, FusedBatchNorm)]

    c_launches, chunks = [], []
    sort_composite, ray_som = rendering.sort_composite, rendering.ray_som

    def recording_composite(sd, *a, som=None):
        c_launches.append((sd.shape[0], som is not None))
        return sort_composite(sd, *a, som=som)

    def recording_som(m, s, sd, alphas, **kw):
        chunks.append([t.detach() for t in (m, s, sd, alphas, *kw["em"])])
        return ray_som(m, s, sd, alphas, **kw)

    hooks = k5_path_hooks(trainer.model, paths) + site_hooks("train")
    rendering.sort_composite, rendering.ray_som = recording_composite, recording_som
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.recording():
            hooked.train_step(batch)
        torch.cuda.synchronize()
        hooked_step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rendering.sort_composite, rendering.ray_som = sort_composite, ray_som
        for h in hooks:
            h.remove()
    if step_kinds() != ["eager"]:
        fail(f"train-bundlefusion: a new trainer's first step ran {step_kinds()}")
    del hooked
    trainer.model.eval()
    hooks = site_hooks("eval")
    with torch.no_grad():
        ev.FrameEncoder(trainer.model)(ev.bf_val_ds(root, n_sources=0)[0])
    for h in hooks:
        h.remove()
    if [len(paths[d]) for d in paths] != [BN_SITES] * 2 or len(sites["eval"]) != BN_SITES:
        fail(f"BundleFusion K5 sites: paths {[len(v) for v in paths.values()]}, eval sites "
             f"{len(sites['eval'])}; expected {BN_SITES} each")
    cluster = {d: paths[d].count("cluster") for d in paths}
    n_val = sum(run1["val_items"]) + sum(run2["val_items"])
    want = {"bn_stats": BN_SITES * n_launch, "bn_bwd_reduce": BN_SITES * n_launch,
            "bn_bwd_apply": BN_SITES * n_launch, "bn_apply": BN_SITES * (n_launch + n_val),
            "bn_forward_fused": cluster["forward"] * n_launch,
            "bn_backward_fused": cluster["backward"] * n_launch,
            "ray_som_in_sort_composite": n_launch + n_val, "ray_som": n_launch + n_val,
            "tsdf_integrate": 0, **{f"{k}_bf16": 0 for k in build.BF16_KERNELS}}
    train_got = {k: launches_train[k] for k in want}
    if train_got != want or min(launches_train[k] for k in TRAIN_KERNELS) < 1:
        fail(f"train-bundlefusion launches {launches_train}; expected {want} and every "
             "training kernel")
    c_train = [r for r, with_som in c_launches if with_som]
    if c_train != [cfg.n_rays] or [r for r, s in c_launches if not s] != [cfg.n_gt_depth]:
        fail(f"kernel C's launches in a BundleFusion step (rays, with the EM): {c_launches}; "
             f"expected one training launch at R = {cfg.n_rays} and the GT-depth render's")
    print(f"[16 train-bundlefusion] {' '.join(BF_TRAIN_FLAGS)}, else the CLI's defaults ("
          f"{cfg.encoder} at {cfg.img_size}, sphere {cfg.sphere.width}x{cfg.sphere.height}, "
          f"{cfg.n_rays} rays in chunks of {cfg.ray_chunk}, {cfg.n_pts_uni} + {cfg.n_gaussians}x"
          f"{cfg.n_pts_per_gaussian} samples, som_sigma {cfg.som_sigma}, {cfg.compute_dtype}) on "
          f"the BundleFusion tree {BF_TREE_FRAMES} at {BF_TREE_SIZE}: run 1 "
          f"{len(run1['loss'])} steps, run 2 resumed at step "
          f"{run2['start_step']} with epoch 1's lr {lr1:.3e}; losses "
          f"{['%.5f' % v for v in losses]}; val abs_rel {['%.5f' % v for v in abs_rel]} "
          f"({n_val} val items); each run's steps {run_kinds}; launches in the eager and the "
          f"capturing steps and the val items {train_got}; a replayed step against an eager "
          f"twin from the same state: metrics {twin_gaps['metric']:.2e} (limit "
          f"{GRAPH_METRIC_RTOL}), gradients as one vector {twin_gaps['grad']:.2e} (limit "
          f"{twin_gaps['grad_limit']}; the twin's two steps {twin_gaps['floor']:.2e}; the "
          f"fields' {twin_gaps['fields']:.2e})")

    # K5 at every distinct BundleFusion site configuration against its plain
    # version (phase 12's checks, f32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k5_rows = []
    configs = sorted(set(sites["train"]) | set(sites["eval"]),
                     key=lambda k: (-math.prod(k[0]), k[1], k[2], k[5]))
    for key in configs:
        chk = k5_site_check(key, gen, dev)
        k5_rows.append(dict(shape=list(key[0]), act=key[1], residual=key[2],
                            channel_first=bool(key[5]), paths=chk["paths"],
                            sites={p: sites[p].count(key) for p in sites},
                            max_abs_err=chk["err"], eval_spacings=chk["eval_spacings"],
                            op_rel_l2=chk["op_l2"], kink_ties=int(chk["ties"].sum()),
                            straddle=chk["straddle"]))
        del chk
    torch.cuda.empty_cache()
    other = {d: sorted({p_ for p_ in paths[d] if p_ != "cluster"}) for d in paths}
    print(f"[16 K5] plan: every BundleFusion site has a path, forward {cluster['forward']} "
          f"cluster / {len(paths['forward']) - cluster['forward']} {other['forward']}, backward "
          f"{cluster['backward']} cluster / {len(paths['backward']) - cluster['backward']} "
          f"{other['backward']}; {len(k5_rows)} configurations "
          f"(train and eval) hold phase 12's checks against the plain versions (the fused op's "
          f"relative L2 at most {max(r_['op_rel_l2'] for r_ in k5_rows):.2e}; "
          f"{sum(r_['straddle'] for r_ in k5_rows)} elements where the two sides' statistics "
          f"put z on either side of the kink, beyond rounding); kernel C's "
          f"launches in a step (rays, with the EM): {c_launches}")

    # RaySOM at som_sigma 0.02: the EM inside kernel C's training launch
    # against its plain version on the chunk's inputs
    m, s, sd, alphas, *em = chunks[0]
    em_plain = som_em_plain(m, s, sd, alphas, cfg.som_sigma, cfg.som_mask_threshold)
    agree = torch.ones(m.shape[0], dtype=torch.bool, device=dev)
    for a, b in zip(em[:2], em_plain[:2]):
        agree &= torch.isclose(a, b, rtol=SOM_RTOL, atol=SOM_RTOL).all(dim=1)
    agree &= (em[2] == em_plain[2]).all(dim=1)
    kl = [ray_som(m, s, sd, alphas, som_sigma=cfg.som_sigma,
                  mask_threshold=cfg.som_mask_threshold, std_floor=cfg.kl_std_floor,
                  em=e).loss_kl.mean() for e in (em, list(em_plain))]
    som_row = dict(rays=m.shape[0], agree_share=float(agree.float().mean()),
                   kl_rel=float(abs(kl[0] - kl[1]) / abs(kl[1])))
    if som_row["agree_share"] < SOM_MIN_SHARE:
        fail(f"BundleFusion RaySOM: the EM inside C agrees with the plain version on "
             f"{som_row['agree_share']:.4%} of {m.shape[0]} rays")
    if som_chunk:
        keep = slice(0, 512)
        np.savez_compressed(som_chunk, **{k: t[keep].cpu().numpy() for k, t in zip(
            ("gauss_means", "gauss_stds", "sensor_distances", "alphas", "kernel_new_means",
             "kernel_new_vars", "kernel_mask"), chunks[0])}, som_sigma=cfg.som_sigma, card=card)
    print(f"[16 RaySOM] som_sigma {cfg.som_sigma}: the EM inside C agrees with the plain "
          f"version on {som_row['agree_share']:.4%} of {som_row['rays']} rays of a training "
          f"chunk; mean KL relative difference {som_row['kl_rel']:.3e}"
          + (f"; chunk saved to {som_chunk}" if som_chunk else ""))
    del chunks, trainer, run1["trainer"], run2["trainer"], batch
    torch.cuda.empty_cache()

    # ---- the evaluation commands on `best`
    model_path, out = str(mgr.directory), tree / "eval"
    bf = ["--root", root, "--model_path", model_path, "--eval_save_dir", str(out)]
    sd_ = LPIPS.random_init(torch.Generator().manual_seed(SEED)).state_dicts()
    vgg_path, lin_path = str(tree / "vgg16.pth"), str(tree / "lpips_vgg.pth")
    torch.save(sd_["vgg"], vgg_path)
    torch.save(sd_["lpips"], lin_path)

    def run(group, *a):
        t0 = time.perf_counter()
        res = group.main(list(a), standalone_mode=False)
        return res, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    depth_run, depth_s = run(ev.cli, "save-depth-metrics-bf", *bf)
    agg, _ = run(ev.cli, "agg-depth-metrics-bf", "--eval_save_dir", str(out))
    color_run, color_s = run(ev.cli, "render-colors-bf", *bf)
    scores, score_s = run(ev.cli, "eval-color-bf", "--eval_save_dir", str(out),
                          "--lpips_vgg_path", vgg_path, "--lpips_lin_path", lin_path)
    launches_eval = dict(build.LAUNCHES)
    eval_peak = torch.cuda.max_memory_allocated()
    build.reset_launch_counts()
    again = (run(ev.cli, "save-depth-metrics-bf", *bf)[0],
             run(ev.cli, "render-colors-bf", *bf)[0])
    if again[0]["frames"] or again[1]["images"] or any(build.LAUNCHES.values()):
        fail(f"second eval runs: {again[0]['frames']}, {again[1]['images']} images, launches "
             f"{dict(build.LAUNCHES)}")
    item = val_ds[0]
    names = [f"{BF_VAL_FRAME}_{item['source_frame_ids'][s_]}_"
             f"{ev.bf_source_distance(item, s_):.2f}.png" for s_ in range(BF_VAL_SOURCES)]
    with open(out / "depth_metrics" / "copyroom" / f"{BF_VAL_FRAME}.npy", "rb") as f:
        data = pickle.load(f)
    total = sum(data["depth_errors"].values())
    n_total = sum(data["n_frames"].values())
    agg_all = sum(agg[0].values()) / sum(agg[1].values())
    W, H = BF_TREE_SIZE
    gt_rays = BF_VAL_SOURCES * W * H
    if (depth_run["frames"] != [BF_VAL_FRAME] or depth_run["rays"] != [[W * H] * 16]
            or n_total != BF_VAL_SOURCES or not np.isfinite(total).all()
            or not np.allclose(agg_all, total / n_total, rtol=1e-12, atol=0)):
        fail(f"save-depth-metrics-bf: frames {depth_run['frames']}, rays {depth_run['rays']}, "
             f"n_frames {n_total}, errors {data['depth_errors']}; agg All {agg_all}")
    for sub in ("rgb", "render_rgb"):
        got_names = sorted(p.name for p in (out / sub / "copyroom").glob("*.png"))
        if got_names != sorted(names):
            fail(f"render-colors-bf: {sub}/copyroom holds {got_names}; expected {sorted(names)}")
    sizes = {Image.open(out / "render_rgb" / "copyroom" / n).size for n in names}
    if sizes != {(640, 480)} or color_run["images"] != BF_VAL_SOURCES:
        fail(f"render-colors-bf: {color_run['images']} images of sizes {sizes}")
    if sum(scores["count"].values()) != BF_VAL_SOURCES or not all(
            math.isfinite(v) for d in ("psnr", "ssim", "lpips") for v in scores[d].values()):
        fail(f"eval-color-bf: {dict(scores['count'])} pairs; psnr {dict(scores['psnr'])}")
    strided = -(-W // 2) * -(-H // 2)  # the stride-2 grid of render-colors-bf and the sweep
    c_chunks = BF_VAL_SOURCES * (-(-(W * H) // ev.EVAL_CHUNK) + -(-strided // ev.EVAL_CHUNK))
    want = {"gather_levels": SPHERE_RESAMPLES * 2 + 2 * c_chunks, "sort_composite": c_chunks,
            "bn_apply": BN_SITES * 2, "bn_stats": 0, "gather_levels_bwd": 0,
            "sort_composite_bwd": 0, "ray_som": 0, "tsdf_integrate": 0}
    got = {k: launches_eval[k] for k in want}
    if got != want:
        fail(f"BundleFusion eval launches {launches_eval}; expected {want}")

    # one source's depth at its GT pixels, kernels against the plain versions
    model = load_model(model_path, dev)
    pyramid = ev.FrameEncoder(model)(item)
    pixels, _, _ = ev.bf_depth_png(item, 0)
    args = (model, pyramid, item["cam_K"], item["T_source2infers"][0], pixels, ev.EVAL_CHUNK)
    depth = ev.render_depth_at_pixels(*args, torch.Generator(device=dev).manual_seed(0))[0]
    with build.plain_versions():
        ref = ev.render_depth_at_pixels(*args, torch.Generator(device=dev).manual_seed(0))[0]
    share = float(np.isclose(depth, ref, rtol=SERVE_RTOL, atol=0).mean())
    if share < SERVE_MIN_SHARE:
        fail(f"BundleFusion eval render at {len(ref)} GT pixels: the kernels agree with the "
             f"plain versions on {share:.4%} of rays")
    print(f"[16 eval] save-depth-metrics-bf on {BF_VAL_SOURCES} sources ({gt_rays} GT pixels), "
          f"agg All abs_rel {agg_all[0]:.4f} a1 {agg_all[4]:.4f}; render-colors-bf "
          f"{color_run['images']} PNGs 640x480 (stride 2, upsampled); eval-color-bf PSNR "
          f"{sum(scores['psnr'].values()) / BF_VAL_SOURCES:.3f}; second runs launched nothing; "
          f"kernels vs plain at {len(ref)} GT pixels of source 0: {share:.4%} of rays within "
          f"rtol {SERVE_RTOL}")
    del model, pyramid
    torch.cuda.empty_cache()

    # ---- the reconstruction commands
    recon = str(tree / "recon")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    sweep, sweep_s = run(rc.cli, "generate-novel-depths-bf", "--root", root, "--model_path",
                         model_path, "--recon_save_dir", recon)
    fused, fuse_s = run(rc.cli, "depth2tsdf-bf", "--root", root, "--recon_save_dir", recon)
    gt, gt_s = run(rc.cli, "generate-sc-gt-bf", "--root", root, "--recon_save_dir", recon)
    sc, _ = run(ev.cli, "eval-sc-bf", "--root", root, "--recon_save_dir", recon)
    angles, _ = run(rc.cli, "determine-angles", "--img_w", str(W), "--img_h", str(H), "--fx",
                    str(item["cam_K"][0, 0]), "--fy", str(item["cam_K"][1, 1]), "--cx",
                    str(item["cam_K"][0, 2]), "--cy", str(item["cam_K"][1, 2]))
    launches_recon = dict(build.LAUNCHES)
    recon_peak = torch.cuda.max_memory_allocated()
    build.reset_launch_counts()
    again = [run(rc.cli, c_, "--root", root, "--recon_save_dir", recon, *extra)[0]["frames"]
             for c_, extra in (("generate-novel-depths-bf", ["--model_path", model_path]),
                               ("depth2tsdf-bf", []), ("generate-sc-gt-bf", []))]
    if any(again) or any(build.LAUNCHES.values()):
        fail(f"second reconstruction runs did {again}, launches {dict(build.LAUNCHES)}")
    rel_poses = rc.bf_rel_poses(30.0, 0.2, 2.1)
    n_poses = len(rel_poses)
    sweep_chunks = n_poses * -(-strided // rc.SWEEP_CHUNK)
    want = {"gather_levels": SPHERE_RESAMPLES + 2 * sweep_chunks,
            "sort_composite": sweep_chunks, "bn_apply": BN_SITES, "tsdf_integrate": 2,
            "bn_stats": 0, "gather_levels_bwd": 0, "sort_composite_bwd": 0, "ray_som": 0}
    got = {k: launches_recon[k] for k in want}
    with open(Path(recon) / "tsdf" / "copyroom" / f"{BF_VAL_FRAME}.pkl", "rb") as f:
        pred = pickle.load(f)
    with open(Path(recon) / "sc_gt" / "copyroom" / f"{BF_VAL_FRAME}.pkl", "rb") as f:
        gt_pkl = pickle.load(f)
    if (n_poses != BF_SWEEP_POSES or got != want or sweep["frames"] != [BF_VAL_FRAME]
            or fused["frames"] != [BF_VAL_FRAME] or gt["frames"] != [BF_VAL_FRAME]
            or pred["tsdf_grid"].shape != BF_GRID or gt_pkl["occ"].shape != BF_GRID
            or not fused["verts"][0] or not all(math.isfinite(sc[k]) for k in ("iou", "precision",
                                                                             "recall"))
            or not (gt_pkl["occ"] == 1).any()):
        fail(f"BundleFusion reconstruction: {n_poses} poses, launches {launches_recon} "
             f"(expected {want}), frames {sweep['frames']} {fused['frames']} {gt['frames']}, "
             f"grid {pred['tsdf_grid'].shape}, mesh {fused['verts']} vertices, eval-sc {sc}")
    depth0 = np.load(Path(recon) / "depth" / "copyroom" / f"{BF_VAL_FRAME}_0.00_0.00.npy")
    if depth0.shape != (H, W) or not np.isfinite(depth0).all():
        fail(f"generate-novel-depths-bf: depth {depth0.shape}, finite "
             f"{np.isfinite(depth0).all()}")

    # kernel T against its plain version: the sweep's fuse and the GT fuse
    depths, colors, poses = rc._load_sweep_frames(recon, "copyroom", BF_VAL_FRAME, rel_poses)
    K_d = item["cam_K_depth"]
    t_rows = {}
    for name, (d_, c_, p_) in {
            "sweep": (depths, colors, poses),
            "gt": (item["source_depths"], [im * np.float32(255.0) for im in item["img_sources"]],
                   item["T_source2infers"])}.items():
        f32 = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(dev)  # noqa: E731
        w2cs = f32([np.linalg.inv(np.asarray(p)) for p in p_])
        t_rows[name] = tsdf_against_plain(dev, f32(d_), f32(c_), f32([K_d] * len(d_)), w2cs)
    torch.cuda.empty_cache()
    print(f"[16 recon] {n_poses}-pose sweep, depth2tsdf-bf mesh {fused['verts'][0]} vertices, "
          f"generate-sc-gt-bf {int((gt_pkl['occ'] == 1).sum())} surface voxels, eval-sc-bf "
          f"IoU {sc['iou']:.4f} P {sc['precision']:.4f} R {sc['recall']:.4f}; "
          f"determine-angles {angles}; second runs launched nothing; kernel T vs plain: "
          + "; ".join(f"{k} {r['shape']}: bit-equal on {r['equal_share']:.6%} ({r['differ']} "
                      f"differ, each at a pixel tie; {r['tie_voxels']} tie voxels)"
                      for k, r in t_rows.items()))
    for k, r in t_rows.items():
        print(f"[16 kernel T] {k} {r['shape']} on {card}: {r['ms']:.4f} ms (events, fresh "
              f"volume), alone {r['device_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms; "
              f"{r['work']}")

    numbers = dict(
        tree_s=tree_s, train_s=train_s,
        step_ms=statistics.median([x * 1e3 for x in run1["step_s"][1:] + run2["step_s"][1:]]),
        steps_ms=[x * 1e3 for x in run1["step_s"] + run2["step_s"]],
        host_item_ms={k: statistics.median([(r + c) * 1e3 for r, c in zip(
            t["read_s"], t["collate_s"])]) for k, t in (("cold", run1["train_timings"]),
                                                         ("resumed", run2["train_timings"]))},
        val_item_ms=[s_ * 1e3 / n for s_, n in zip(run1["val_s"] + run2["val_s"],
                                                    run1["val_items"] + run2["val_items"])],
        save_ms=[s_ * 1e3 for s_ in run1["save_s"] + run2["save_s"]],
        hooked_step_ms=hooked_step_ms, train_peak_gib=train_peak / 2**30,
        depth_item_ms=(depth_run["read_s"][0] + depth_run["encode_s"][0]
                       + depth_run["render_s"][0]) * 1e3,
        depth_read_ms=depth_run["read_s"][0] * 1e3,
        depth_encode_ms=depth_run["encode_s"][0] * 1e3,
        depth_render_ms=depth_run["render_s"][0] * 1e3,
        gt_rays=gt_rays, gt_rays_per_s=gt_rays / depth_run["render_s"][0],
        color_image_ms=sum(color_run["render_s"]) * 1e3 / color_run["images"],
        pair_host_ms=statistics.median(scores["host_s"]) * 1e3,
        pair_lpips_ms=statistics.median(scores["lpips_s"]) * 1e3, eval_peak_gib=eval_peak / 2**30,
        sweep_frame_s=sweep["encode_s"][0] + sweep["render_s"][0],
        sweep_render_s=sweep["render_s"][0], sweep_write_s=sweep["write_s"][0],
        fuse_ms=fused["fuse_s"][0] * 1e3, mesh_ms=fused["mesh_s"][0] * 1e3,
        mesh_verts=fused["verts"][0], gt_fuse_ms=gt["fuse_s"][0] * 1e3,
        recon_peak_gib=recon_peak / 2**30,
        command_s=dict(eval_depth=depth_s, eval_color=color_s, eval_score=score_s,
                       sweep=sweep_s, depth2tsdf=fuse_s, sc_gt=gt_s))
    print(f"[16 numbers] on {card}: train-bundlefusion {numbers['step_ms']:.1f} ms per step "
          f"through the loader (steps {['%.1f' % v for v in numbers['steps_ms']]}), host ms per "
          f"item (read + collate, the loader thread) "
          f"{ {k: round(v, 1) for k, v in numbers['host_item_ms'].items()} }, val "
          f"{['%.1f' % v for v in numbers['val_item_ms']]} ms per item, save "
          f"{['%.0f' % v for v in numbers['save_ms']]} ms, peak "
          f"{numbers['train_peak_gib']:.2f} GiB; save-depth-metrics-bf "
          f"{numbers['depth_item_ms']:.1f} ms per item = read {numbers['depth_read_ms']:.1f} + "
          f"encode {numbers['depth_encode_ms']:.1f} + renders {numbers['depth_render_ms']:.1f} "
          f"({numbers['gt_rays_per_s']:.0f} GT-pixel rays/s); render-colors-bf "
          f"{numbers['color_image_ms']:.1f} ms per image; eval-color-bf per pair host "
          f"{numbers['pair_host_ms']:.1f} + LPIPS {numbers['pair_lpips_ms']:.1f} ms; eval peak "
          f"{numbers['eval_peak_gib']:.2f} GiB; sweep {numbers['sweep_frame_s']:.2f} s per frame "
          f"(renders {numbers['sweep_render_s']:.2f} s, file writes "
          f"{numbers['sweep_write_s']:.2f} s), fuse {numbers['fuse_ms']:.1f} ms, mesh "
          f"{numbers['mesh_ms']:.1f} ms ({numbers['mesh_verts']} vertices), GT fuse "
          f"{numbers['gt_fuse_ms']:.1f} ms; recon peak {numbers['recon_peak_gib']:.2f} GiB; "
          f"kernel T at {t_rows['sweep']['shape']} {t_rows['sweep']['ms']:.3f} ms (events, "
          f"fresh volume; plain {t_rows['sweep']['plain_ms']:.3f}, bound "
          f"{t_rows['sweep']['bound_ms']:.3f} by {t_rows['sweep']['bound_by']}); commands "
          f"{ {k: round(v, 1) for k, v in numbers['command_s'].items()} } s")
    return {"launches": {"bf_train": launches_train, "bf_eval": launches_eval,
                         "bf_recon": launches_recon},
            "numbers": numbers, "k5_rows": k5_rows, "tsdf": t_rows, "som": som_row}


# ---- phase 17: several ranks -------------------------------------------------

PAR_RANKS = 2              # phase 17's ranks, sharing cuda:0 over gloo
PAR_BS = 2                 # data mode's global batch: one item a rank
PAR_TIMEOUT_S = 420        # the ranks' wall time at most
SHARD_LOSS_RTOL = TRAIN_LOSS_RTOL     # ray_shard vs one rank: phase 10's bars (the step is
SHARD_GRAD_REL_L2 = TRAIN_GRAD_REL_L2  # chaotic in its encode: ROADMAP Queue 3)
# ray_shard's gradient, in f32: every leaf within SHARD_GRAD_REL_L2 of one
# rank's and of the split played on one rank, but the leaves zero up to
# rounding (norm <= 1e-6 of the largest: within 1e-5 of it), phase 10's
# rule. In bf16 the step does not repeat on the card (H100 80GB HBM3, 700
# W): the one-rank step run twice differs by ~3% (relative L2 of the whole
# gradient; single leaves by up to ~150%), the backward's bf16 roundings
# walking apart from the last bits of nondeterministic f32 atomics. So the
# bf16 gradient is held as a whole, against one rank's and against the
# split's, each within SHARD_FLOOR_RATIO times that run-to-run floor
# measured in the same run (sound readings there 0.83-1.07 of it, a psum
# whose backward skips the sum 12.5), the floor itself within
# SHARD_BF16_FLOOR
SHARD_ZERO_LEAF = (1e-6, 1e-5)  # f32: (norm floor, bound), in units of the largest leaf's norm
SHARD_FLOOR_RATIO = 2.0
SHARD_BF16_FLOOR = 1e-1
SHARD_DTYPES = ("bfloat16", "float32")
SHARD_EVAL_RTOL = 1e-3     # sharded save-depth-metrics vs one rank: the pickles, and rays
SHARD_MIN_SHARE = 0.99     # equal at rtol SHARD_EVAL_RTOL
SYNC_KERNELS = ("bn_sync_sums", "bn_sync_stats", "bn_sync_bwd_sums", "bn_sync_grads")
# three B7 training sites [rows a rank, C], activation, residual: the synced op
# across the ranks against the plain version on all their rows
SYNC_SITES = ((169500, 160, "silu", True), (28365, 288, "silu", False),
              (10528, 640, "leaky", True))
SYNC_REPLACES = "scenerf_tpu/encoder/norm.py:62"  # FusedBatchNorm's pmean of mean, mean(x^2)


def fingerprint(tensors) -> "torch.Tensor":
    """[n, 2] int64 on the host: per tensor, the sum of its 32-bit words and
    their sum weighted by position (a one-bit difference anywhere changes
    them)."""
    import torch

    rows = []
    for t in tensors:
        w = t.detach().reshape(-1).contiguous()
        w = (w.view(torch.int32) if w.element_size() == 4 else w.float().view(torch.int32)).long()
        pos = torch.arange(1, w.numel() + 1, device=w.device, dtype=torch.int64)
        rows.append(torch.stack([w.sum(), (w * pos).sum()]))
    return torch.stack(rows).cpu()


def k5_synced_stages(dev, card: str, rows16: list, gen) -> dict:
    """Phase 17's kernels on the card: K5's synced stages (N1 and N3 without
    their finalize, the two finalize launches) at every distinct bf16
    training configuration of the B7 step (phase 13's rows), each against
    its plain version on the same inputs (the sums f64 of f32 partial sums:
    rtol BN_RTOL; the finalizes on the plain sums of this rank's half and a
    second rank's, as two ranks hand them over: the statistics rtol BN_RTOL,
    the gradients relative L2 BN_REL_L2, beside a witness that the local and
    world sums swapped miss that bar tenfold); each direction of the
    synced path at a world of one rank (sums, finalize, N2; sums, finalize,
    N4) timed alone by graph replay, summed over a step's 192 sites beside
    the cluster path's; the stages timed by events, plain, and beside the
    PyTorch call that computes each (torch.batch_norm_stats,
    batch_norm_gather_stats_with_counts, batch_norm_backward_reduce; none
    computes the gradient finalize) at the largest configuration."""
    import torch

    from scenerf_tpu_torch.ops import norm as NM

    bf16 = torch.bfloat16
    out = {k: {"max_abs_err": 0.0} for k in SYNC_KERNELS}
    per_step = {"forward_ms": 0.0, "backward_ms": 0.0, "cluster_forward_ms": 0.0,
                "cluster_backward_ms": 0.0, "sites": 0}
    train_rows = [r_ for r_ in rows16 if r_["sites"]["train"] and not r_["channel_first"]]
    swap_gap = math.inf  # the least relative L2 between the right gradients and swapped sums'
    for i, row in enumerate(train_rows):
        shape, act, has_res = tuple(row["shape"]), row["act"], row["residual"]
        Cn, Mn = shape[-1], math.prod(shape[:-1])
        mom, eps = (0.9, 1e-5) if act == "leaky" else (0.99, 1e-3)
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        r = torch.randn(shape, generator=gen, device=dev).to(bf16) if has_res else None
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
        w = torch.rand(Cn, generator=gen, device=dev) + 0.5
        b = torch.rand(Cn, generator=gen, device=dev) - 0.5
        rm = torch.rand(Cn, generator=gen, device=dev) * 0.4 - 0.2
        rv = torch.rand(Cn, generator=gen, device=dev) + 0.5
        what = f"synced bf16 {list(shape)} {act}{' + residual' if has_res else ''}"
        # a second rank's half (xo, ro, dyo): the world's sums are both halves'
        # over 2 Mn rows, so that a finalize reading this rank's sums where it
        # needs the world's, or the other way round, shows
        xo = torch.randn(shape, generator=gen, device=dev).to(bf16)
        ro = torch.randn(shape, generator=gen, device=dev).to(bf16) if has_res else None
        dyo = torch.randn(shape, generator=gen, device=dev).to(bf16)
        s_k, s_p = NM.launch_sums(x), NM.sums_plain(x)
        err = {"bn_sync_sums": max(check_close(f"{what} sums row {j}", s_k[j], s_p[j])
                                   for j in range(2))}
        s_w = s_p + NM.sums_plain(xo)
        rk, rp = [rm.clone(), rv.clone()], [rm.clone(), rv.clone()]
        st_k = NM.launch_stats_finalize(s_w, 2 * Mn, x, w, b, *rk, mom, eps)
        st_p = NM.stats_finalize_plain(s_w, 2 * Mn, w, b, *rp, mom, eps)
        err["bn_sync_stats"] = max(
            *(check_close(f"{what} statistics row {j}", st_k[j], st_p[j]) for j in range(5)),
            check_close(f"{what} running mean", rk[0], rp[0]),
            check_close(f"{what} running var", rk[1], rp[1]))
        g_k, g_p = NM.launch_bwd_sums(x, dy, st_p, act, r), NM.bwd_sums_plain(x, dy, st_p, act, r)
        err["bn_sync_bwd_sums"] = max(check_l2(f"{what} backward sums row {j}", g_k[j], g_p[j])
                                      for j in range(2))
        g_w = g_p + NM.bwd_sums_plain(xo, dyo, st_p, act, ro)
        gr_k = NM.launch_grads_finalize(g_p, g_w, 2 * Mn, x, st_p, w, eps)
        gr_p = NM.grads_finalize_plain(g_p, g_w, 2 * Mn, st_p, w, eps)
        err["bn_sync_grads"] = max(check_l2(f"{what} gradients row {j}", gr_k[j], gr_p[j])
                                   for j in range(4))
        # the bar tells the sums apart: dweight, dbias from the world's, or
        # alpha, beta from the rank's, miss it
        swapped = (NM.grads_finalize_plain(g_w, g_w, 2 * Mn, st_p, w, eps)[:2],
                   NM.grads_finalize_plain(g_p, g_p, 2 * Mn, st_p, w, eps)[2:])
        witness = min(rel_l2(swapped[0], gr_p[:2]), rel_l2(swapped[1], gr_p[2:]))
        if not witness > 10 * BN_REL_L2:
            fail(f"K5 {what}: the finalize's local and world sums give gradients only "
                 f"{witness:.3e} apart (relative L2): the check cannot tell them apart")
        swap_gap = min(swap_gap, witness)
        for k in SYNC_KERNELS:
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err[k])
        scratch = [rm.clone(), rv.clone()]

        def fwd():
            s_ = NM.launch_sums(x)
            st_ = NM.launch_stats_finalize(s_, Mn, x, w, b, *scratch, mom, eps)
            return NM.launch_forward(x, w, b, *scratch, True, mom, eps, act, r, stages=2,
                                     stats=st_)

        def bwd():
            s_ = NM.launch_bwd_sums(x, dy, st_p, act, r)
            gr_ = NM.launch_grads_finalize(s_, s_, Mn, x, st_p, w, eps)
            return NM.launch_backward(x, dy, w, st_p, True, eps, act, r, residual_grad=has_res,
                                      stages=2, grads=gr_)

        n = row["sites"]["train"]
        per_step["forward_ms"] += n * graph_ms(fwd)
        per_step["backward_ms"] += n * graph_ms(bwd)
        per_step["cluster_forward_ms"] += n * row["device_ms"]["train_fwd"]
        per_step["cluster_backward_ms"] += n * row["device_ms"]["train_bwd"]
        per_step["sites"] += n
        if i == 0:  # the largest configuration: each stage alone, plain, library
            nbx = nbytes(x)
            r_act = r if act != "identity" else None
            s_ = NM.launch_sums(x)
            g_ = NM.launch_bwd_sums(x, dy, st_p, act, r)
            x2, dy2 = x.reshape(Mn, Cn), dy.reshape(Mn, Cn)
            mean_all = st_p[NM.MEAN][None].repeat(PAR_RANKS, 1)
            inv_all = st_p[NM.INV][None].repeat(PAR_RANKS, 1)
            counts = torch.full((PAR_RANKS,), float(Mn) / PAR_RANKS, device=dev)
            stages = {
                "bn_sync_sums": (lambda: NM.launch_sums(x), lambda: NM.sums_plain(x),
                                 lambda: torch.batch_norm_stats(x2, eps),
                                 bound(nbx + 16 * Cn, 3 * x.numel())),
                "bn_sync_stats": (
                    lambda: NM.launch_stats_finalize(s_, Mn, x, w, b, *scratch, mom, eps),
                    lambda: NM.stats_finalize_plain(s_, Mn, w, b, *scratch, mom, eps),
                    lambda: torch.batch_norm_gather_stats_with_counts(
                        x2, mean_all, inv_all, scratch[0], scratch[1], 1.0 - mom, eps, counts),
                    bound(16 * Cn + 4 * 4 * Cn + 5 * 4 * Cn + 2 * 4 * Cn, 12 * Cn)),
                "bn_sync_bwd_sums": (
                    lambda: NM.launch_bwd_sums(x, dy, st_p, act, r),
                    lambda: NM.bwd_sums_plain(x, dy, st_p, act, r),
                    lambda: torch.batch_norm_backward_reduce(
                        dy2, x2, st_p[NM.MEAN], st_p[NM.INV], w, True, True, True),
                    bound(nbytes(*(t for t in (x, dy, r_act) if t is not None)) + 16 * Cn,
                          (5 + (7 if act == "silu" else 2)) * x.numel())),
                "bn_sync_grads": (
                    lambda: NM.launch_grads_finalize(g_, g_, Mn, x, st_p, w, eps),
                    lambda: NM.grads_finalize_plain(g_, g_, Mn, st_p, w, eps),
                    None, bound(2 * 16 * Cn + 4 * Cn + 5 * 4 * Cn + 4 * 4 * Cn, 20 * Cn)),
            }
            for k, (kern, plain, lib, bnd) in stages.items():
                out[k].update(shape=list(shape), act=act, residual=has_res, ms=cuda_ms(kern),
                              plain_ms=cuda_ms(plain), device_ms=graph_ms(kern),
                              library_ms=None if lib is None else cuda_ms(lib), **bnd)
        del x, r, dy, xo, ro, dyo, s_k, s_p, g_k, g_p
        torch.cuda.empty_cache()
    print(f"[17 kernel K5 synced] on {card}: {len(train_rows)} bf16 training configurations "
          f"({per_step['sites']} sites): sums, finalizes against their plain versions on two "
          f"halves' sums (largest errors "
          f"{', '.join('%s %.2e' % (k, v['max_abs_err']) for k, v in out.items())}; the local and "
          f"world sums swapped at least {swap_gap:.2e} off); per "
          f"step alone {per_step['forward_ms']:.3f} + {per_step['backward_ms']:.3f} ms (one "
          f"rank's plan at those sites {per_step['cluster_forward_ms']:.3f} + "
          f"{per_step['cluster_backward_ms']:.3f}); at {out['bn_sync_sums'].get('shape')}: "
          + "; ".join(f"{k} {v['ms']:.4f} ms (alone {v['device_ms']:.4f}, plain "
                      f"{v['plain_ms']:.4f}, "
                      f"bound {v['bound_ms']:.4f}, library "
                      f"{'-' if v['library_ms'] is None else '%.4f' % v['library_ms']})"
                      for k, v in out.items()))
    return {"kernels": out, "per_step": per_step, "swap_gap": swap_gap}


def synced_op_ranks(dev, group) -> dict:
    """K5's synced op (`batch_norm_act_synced`, the kernels on the card)
    across the ranks of `group` at SYNC_SITES, in f32 and bf16: every rank
    draws every rank's rows from one seed, runs the op and its backward on
    its own rows, and holds against autograd of the plain version on all the
    ranks' rows together (the cotangent zeroed at the leaky-ReLU's kink
    ties): its y, its dx and d_residual (its rows of the plain version's;
    rtol BN_RTOL and relative L2 BN_REL_L2 in f32, relative L2
    BF16_DX_REL_L2 in bf16: one rounding each), the running statistics (rtol
    BN_RTOL), and dweight, dbias summed over the ranks (the numerator of the
    gradient mean; relative L2 BN_REL_L2). dx needs the world's sums, dweight
    and dbias the rank's own: a finalize that swapped them misses. Fails on
    a miss; returns the largest relative L2 of each output."""
    import torch

    from scenerf_tpu_torch.ops import norm as NM
    from scenerf_tpu_torch.parallel import dist as D

    W, r = D.size(group), D.rank(group)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, C, act, has_res in SYNC_SITES:
            mom, eps = (0.9, 1e-5) if act == "leaky" else (0.99, 1e-3)
            gen = torch.Generator(device=dev).manual_seed(SEED + M)
            x = torch.randn(W * M, C, generator=gen, device=dev).to(dtype)
            res = torch.randn(W * M, C, generator=gen, device=dev).to(dtype) if has_res else None
            dy = torch.randn(W * M, C, generator=gen, device=dev).to(dtype)
            w = torch.rand(C, generator=gen, device=dev) + 0.5
            b = torch.rand(C, generator=gen, device=dev) - 0.5
            rm = torch.rand(C, generator=gen, device=dev) * 0.4 - 0.2
            rv = torch.rand(C, generator=gen, device=dev) + 0.5
            st = NM.stats_plain(x, w, b, rm.clone(), rv.clone(), mom, eps)
            dy = torch.where(NM.kink_ties(x, st, act, res), torch.zeros_like(dy), dy)
            sides = []
            for mine in (True, False):  # the synced op on this rank's rows; the plain on all
                rows = slice(r * M, (r + 1) * M) if mine else slice(None)
                leaves = [x[rows].clone().requires_grad_(True), w.clone().requires_grad_(True),
                          b.clone().requires_grad_(True)]
                rr = None if res is None else res[rows].clone().requires_grad_(True)
                run = [rm.clone(), rv.clone()]
                if mine:
                    y = NM.batch_norm_act_synced(*leaves, *run, mom, eps, act, rr, group=group)
                else:
                    y = NM.batch_norm_act_plain(*leaves, *run, True, mom, eps, act, rr)
                y.backward(dy[rows])
                dw, db = leaves[1].grad, leaves[2].grad
                if mine:
                    D.all_reduce_sum(dw, group)
                    D.all_reduce_sum(db, group)
                outs = [y.detach(), leaves[0].grad, dw, db, *run,
                        *([] if rr is None else [rr.grad])]
                sides.append([t[r * M:(r + 1) * M] if not mine and t.dim() == 2 else t
                              for t in outs])
            what = f"synced across {W} ranks, rank {r}, {dtype} [{M}, {C}] {act}"
            names = ["y", "dx", "dweight", "dbias", "running mean", "running var", "d_residual"]
            for name, got, want in zip(names, *sides):
                got, want = got.float(), want.float()
                if name.startswith("running") or (name == "y" and dtype == torch.float32):
                    check_close(f"{what} {name}", got, want)
                err = rel_l2(got, want)
                bar = (BF16_DX_REL_L2 if dtype == torch.bfloat16 and name in ("y", "dx",
                                                                              "d_residual")
                       else BN_REL_L2)
                if not (bool(torch.isfinite(got).all()) and err <= bar):
                    fail(f"K5 {what} {name}: relative L2 {err:.3e} > {bar}")
                key = f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
                worst[key] = max(worst.get(key, 0.0), err)
            del x, res, dy, sides, leaves, rr, y
    return worst


class _Slice:
    """Rank r of a world of `size` ranks, played in one process by
    `split_grads_one_rank` (no process group)."""

    def __init__(self, r: int, size: int, sums: list, record: bool):
        self.r, self.size, self.sums, self.record, self.calls = r, size, sums, record, 0


def split_grads_one_rank(model, cfg, batch, dev, W: int) -> dict:
    """ray_shard's step over W ranks played in one process on `model`: each
    rank's slice of the rays (`SceneRF.forward`'s `ray_group`), with the
    noise of a one-rank Trainer seeded SEED, has its forward and backward run
    in turn; the masked means' psum takes the other slices' sums from a
    first pass without gradient, and its backward sums the W equal
    cotangents as the ranks' does; the gradients are averaged as the ranks
    average them. Every rank's arithmetic but the all-reduces, so this is
    the split step without the collectives. Returns the gradients by
    name."""
    import torch

    from scenerf_tpu_torch import losses as L
    from scenerf_tpu_torch.parallel import dist as D
    from scenerf_tpu_torch.train import Trainer

    class SliceSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, others):
            return t + others

        @staticmethod
        def backward(ctx, g):
            return g * W, None

    def psum(t, group=None):
        if not isinstance(group, _Slice):
            return orig[2](t, group)
        k = group.calls
        group.calls += 1
        if group.record:
            group.sums[group.r].append(t.detach().clone())
            return t
        others = sum(group.sums[q][k] for q in range(W) if q != group.r)
        return SliceSum.apply(t, others)

    trainer = Trainer(cfg, device=dev, model=model, seed=SEED)
    tensors, maps = trainer.device_batch(batch)
    noise = trainer._noise(tensors, trainer.generator, None)
    orig = (D.size, D.rank, L.sum_over_ranks)
    D.size = lambda g=None: g.size if isinstance(g, _Slice) else orig[0](g)
    D.rank = lambda g=None: g.r if isinstance(g, _Slice) else orig[1](g)
    L.sum_over_ranks = psum
    sums = [[] for _ in range(W)]
    try:
        with torch.no_grad():
            for q in range(W):
                model(tensors, noise, train=True, sphere_maps=maps,
                      ray_group=_Slice(q, W, sums, True))
        model.zero_grad(set_to_none=True)
        for q in range(W):
            loss, _ = model(tensors, noise, train=True, sphere_maps=maps,
                            ray_group=_Slice(q, W, sums, False))
            loss.backward()
    finally:
        D.size, D.rank, L.sum_over_ranks = orig
    grads = {n: p.grad.detach() / W for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def grad_gap(got: dict, want: dict) -> dict:
    """`got` against `want` (gradients by name): the relative L2 of the whole
    and the worst leaf's (leaves zero up to rounding, norm <= SHARD_ZERO_LEAF[0]
    of the largest, held instead to a difference within SHARD_ZERO_LEAF[1]
    of it), and the five worst leaves (relative L2, name, norm and
    difference over the largest leaf's)."""
    norms = {n: float(want[n].norm()) for n in want}
    diffs = {n: float((got[n] - want[n]).norm()) for n in want}
    scale = max(norms.values())
    floor, bound = SHARD_ZERO_LEAF
    worst, worst_name, tiny_bad, zero_worst, n_floor = 0.0, "", [], 0.0, 0
    for n in want:
        if norms[n] <= floor * scale:
            n_floor += 1
            zero_worst = max(zero_worst, diffs[n] / scale)
            if diffs[n] > bound * scale:
                tiny_bad.append(n)
        elif diffs[n] / norms[n] > worst:
            worst, worst_name = diffs[n] / norms[n], n
    leaves = sorted(((diffs[n] / max(norms[n], 1e-30), n, norms[n] / scale, diffs[n] / scale)
                     for n in want), reverse=True)
    return dict(worst_leaf=worst, worst_name=worst_name, tiny_bad=tiny_bad,
                zero_leaf_worst=zero_worst, n_zero_leaves=n_floor, n_leaves=len(want),
                leaves=leaves[:5], rel_l2=math.sqrt(sum(v * v for v in diffs.values())
                                                    / sum(v * v for v in norms.values())))


def parallel_rank(d: Path) -> None:
    """One rank of phase 17 on cuda:0 over gloo, started by `parallel_phase`
    with torchrun's environment: reads d/job.json (the paths and argv), runs
    the synced op across the ranks, data-mode train-kitti, ray_shard against
    one rank and the split played on one rank, and the sharded eval (the
    NCCL part runs in the parent), and writes d/rank{r}.json. Each check's
    outcome goes into the record; the parent fails on it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch.cli import evaluation as ev
    from scenerf_tpu_torch.cli import train as train_cli
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops import norm as NM
    from scenerf_tpu_torch.parallel import dist as D
    from scenerf_tpu_torch.train import Trainer
    from scenerf_tpu_torch.utils.checkpoint import load_model

    job = json.loads((d / "job.json").read_text())
    world = D.init("cuda:0", "gloo")
    rank, group, dev = world.rank, world.group, world.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        torch.cuda.synchronize(dev)

    def gathered(t) -> list:
        parts = [torch.empty_like(t) for _ in range(world.size)]
        dist.all_gather(parts, t, group=group)
        return parts

    rec = {"rank": rank, "world": [world.size, world.backend]}
    # ---- 0. K5's synced op across the ranks, against the plain version on all rows
    t0 = time.perf_counter()
    rec["synced_op"] = dict(rel_l2=synced_op_ranks(dev, group), s=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # ---- 1. data mode through train-kitti, hooked at each step
    checks = {"params_equal": [], "grads_equal": []}
    orig = Trainer.train_step

    def hooked(self, batch, generator=None, noise=None):
        first = self.step == 0
        if first:
            record = []
            hooks = bn_stats_hooks(self.model, record)
            params = dict(self.model.named_parameters())
            start = {k: v.detach().clone() for k, v in params.items()}
        metrics = orig(self, batch, generator, noise)
        if first:
            for h in hooks:
                h.remove()
            # the f64 statistics of the world's batch: the ranks' means (equal rows)
            flat = torch.cat([torch.cat([m, ms]) for _, m, ms in record])
            D.all_reduce_mean(flat, group)
            at, world_record = 0, []
            for mod, m, _ in record:
                c = m.numel()
                world_record.append((mod, flat[at:at + c], flat[at + c:at + 2 * c]))
                at += 2 * c
            checks["stats_err"] = bn_stats_error(world_record)
            checks["stats_sites"] = len(record)
            grads = {n: p.grad.detach().clone() for n, p in params.items()}
            excess, moved = adamw_first_move(params, start, grads, self.lr_at(0))
            checks["adam_excess"] = float(excess.max())
            checks["adam_all_moved"] = bool((moved[torch.stack(
                [g.abs().max() for g in grads.values()]).cpu() > 0] > 0).all())
        for what, ts in (("params_equal", list(self.model.parameters())),
                         ("grads_equal", [p.grad for p in self.model.parameters()])):
            parts = gathered(fingerprint(ts))
            checks[what].append(all(torch.equal(p_, parts[0]) for p_ in parts))
        return metrics

    Trainer.train_step = hooked
    NM.sync_all_reduces = 0
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        run = train_cli.cli.main(job["train_argv"], standalone_mode=False)
    finally:
        Trainer.train_step = orig
    sync()
    rec["train"] = dict(
        launches=dict(build.LAUNCHES), sync_all_reduces=NM.sync_all_reduces, checks=checks,
        steps=len(run["loss"]), loss=run["loss"], step_ms=[s * 1e3 for s in run["step_s"]],
        val_items=run["val_items"], val_metrics=run["val_metrics"],
        save_ms=[s * 1e3 for s in run["save_s"]], run_s=time.perf_counter() - t0,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    # one step's collectives again, timed: the synced sites' 2 all-reduces of
    # [2, C] f64 each, and the gradient mean
    trainer = run["trainer"]
    widths = [m.weight.numel() for m in trainer.model.modules()
              if isinstance(m, FusedBatchNorm)]
    bufs = [torch.zeros(2, c, dtype=torch.float64, device=dev) for c in widths for _ in (0, 1)]
    D.barrier(group)
    sync()
    t0 = time.perf_counter()
    for buf in bufs:
        D.all_reduce_sum(buf, group)
    sync()
    t1 = time.perf_counter()
    D.average_gradients(list(trainer.model.parameters()), group)
    sync()
    rec["train"].update(bn_all_reduces=len(bufs), bn_all_reduce_ms=(t1 - t0) * 1e3,
                        grad_all_reduce_ms=(time.perf_counter() - t1) * 1e3,
                        grad_floats=sum(p.numel() for p in trainer.model.parameters()))
    del run, trainer, bufs
    torch.cuda.empty_cache()

    # ---- 2. ray_shard against one rank, on the same item, seed and weights,
    # at lr 0, in each compute dtype; on rank 0 the split played on one rank
    rec["ray_shard"] = {}
    for dtype in SHARD_DTYPES:
        cfg = C.kitti(n_rays=1200, n_sources=4, n_gt_depth=256, lr=0.0, compute_dtype=dtype)
        batch = make_batch(cfg, seed=SEED)
        torch.manual_seed(SEED)
        model = SceneRF(cfg)
        build.reset_launch_counts()
        sharded = Trainer(cfg, device=dev, model=model, seed=SEED, group=group, mode="ray_shard")
        sync()
        t0 = time.perf_counter()
        m_sh = {k: float(v) for k, v in sharded.train_step(batch).items()}
        sync()
        shard = dict(step_ms=(time.perf_counter() - t0) * 1e3, metrics=m_sh,
                     launches=dict(build.LAUNCHES))
        params = dict(model.named_parameters())
        for what, ts in (("params_equal", list(params.values())),
                         ("grads_equal", [p.grad for p in params.values()])):
            parts = gathered(fingerprint(ts))
            shard[what] = all(torch.equal(p_, parts[0]) for p_ in parts)
        if rank == 0:
            g_sh = {n: p.grad.detach().clone() for n, p in params.items()}
            ones = []  # the one-rank step, twice: the second reads the card's run-to-run floor
            for _ in range(2):
                one = Trainer(cfg, device=dev, model=model, seed=SEED)
                sync()
                t0 = time.perf_counter()
                m_one = {k: float(v) for k, v in one.train_step(batch).items()}
                sync()
                shard.setdefault("one_step_ms", (time.perf_counter() - t0) * 1e3)
                shard.setdefault("one_metrics", m_one)
                ones.append({n: p.grad.detach().clone() for n, p in params.items()})
                del one
            g_split = split_grads_one_rank(model, cfg, batch, dev, world.size)
            shard.update(**grad_gap(g_sh, ones[0]), one_vs_one=grad_gap(ones[1], ones[0]),
                         split_vs_one=grad_gap(g_split, ones[0]),
                         shard_vs_split=grad_gap(g_sh, g_split))
            del g_sh, ones, g_split
        rec["ray_shard"][dtype] = shard
        del sharded, model, params
        torch.cuda.empty_cache()
        D.barrier(group)

    # ---- 3. save-depth-metrics over the ranks; one source's rays against one rank
    t0 = time.perf_counter()
    done = ev.cli.main(job["eval_argv"], standalone_mode=False)
    sync()
    rec["eval"] = dict(command_s=time.perf_counter() - t0, done=done)
    model = load_model(job["model_path"], dev)
    ds = ev.common.eval_val_ds(job["eval_root"], job["eval_pre"], 10.0, 0.4)
    item = ds[0]
    encode = ev.FrameEncoder(model)
    sync()
    t0 = time.perf_counter()
    pyramid = encode(item)
    sync()
    t1 = time.perf_counter()
    # the pyramid's bytes (bf16 levels seen as bytes: gloo's types) from rank 0
    levels = [lv.detach().reshape(-1).view(torch.uint8).clone() for lv in pyramid]
    D.broadcast_tensors(levels, group)
    sync()
    t2 = time.perf_counter()
    args = (pyramid, item["cam_K"], item["T_source2infers"][0], item["loc2d_with_depths"][0], 0)
    got = ev._source_renderer(model, group, ev.EVAL_CHUNK)(*args)
    sync()
    t3 = time.perf_counter()
    rays = dict(encode_ms=(t1 - t0) * 1e3, broadcast_levels_ms=(t2 - t1) * 1e3,
                level_bytes=sum(lv.numel() * lv.element_size() for lv in levels),
                sharded_render_ms=(t3 - t2) * 1e3, n=len(item["loc2d_with_depths"][0]))
    if rank == 0:
        t0 = time.perf_counter()
        want = ev._source_renderer(model, None, ev.EVAL_CHUNK)(*args)
        sync()
        rays["one_rank_render_ms"] = (time.perf_counter() - t0) * 1e3
        rays["share_equal"] = float(np.isclose(
            got[0], want[0], rtol=SHARD_EVAL_RTOL,
            atol=SHARD_EVAL_RTOL * float(np.abs(want[0]).max())).mean())
    rec["eval"]["rays"] = rays
    del model, pyramid, levels
    (d / f"rank{rank}.json").write_text(json.dumps(rec, default=float))
    D.barrier(group)
    D.shutdown()


def parallel_phase(dev, card: str, tree: Path, model_path: str, p15: dict,
                   synced: dict, timeout_s: float = PAR_TIMEOUT_S) -> dict:
    """Phase 17 (see the module docstring): PAR_RANKS ranks on cuda:0 over
    gloo, started as child processes of this script with torchrun's
    environment; then a one-rank NCCL group in this process. Fails on a
    rank's failure or any check; returns the launches of the data-mode run
    (rank 0's) and the numbers."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    d = tree / "parallel"
    d.mkdir(exist_ok=True)
    root, pre = str(tree), str(tree / "preprocess")
    job = dict(
        model_path=model_path, eval_root=root, eval_pre=str(tree / "preprocess_eval"),
        train_argv=["train-kitti", "--root", root, "--preprocess_root", pre, "--logdir",
                    str(tree / "logs_parallel"), *TRAIN_KITTI_FLAGS, "--n_epochs", "1",
                    "--bs", str(PAR_BS), "--parallel_mode", "data", "--device", "cuda:0",
                    "--dist_backend", "gloo"],
        eval_argv=["save-depth-metrics", "--root", root, "--preprocess_root",
                   str(tree / "preprocess_eval"), "--model_path", model_path,
                   "--eval_save_dir", str(tree / "eval_parallel"), "--n_devices",
                   str(PAR_RANKS), "--device", "cuda:0", "--dist_backend", "gloo"])
    (d / "job.json").write_text(json.dumps(job))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs, logs = [], []
    for k in range(PAR_RANKS):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(PAR_RANKS), RANK=str(k), LOCAL_RANK=str(k))
        log = open(d / f"rank{k}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--parallel-rank", str(d)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    deadline = time.monotonic() + timeout_s
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        time.sleep(0.5)
        bad = [k for k, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        elif time.monotonic() > deadline:
            failed = f"the ranks ran past {timeout_s} s"
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for log in logs:
        log.close()
    ranks_s = time.perf_counter() - t0
    if failed is not None or any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"--- rank {k}:\n" + (d / f"rank{k}.log").read_text()[-3000:]
                          for k in range(PAR_RANKS))
        fail(f"phase 17: {failed or [p.returncode for p in procs]}\n{tails}")
    recs = [json.loads((d / f"rank{k}.json").read_text()) for k in range(PAR_RANKS)]

    # 1. data mode
    tr = [r_["train"] for r_ in recs]
    n_steps, n_val = tr[0]["steps"], sum(tr[0]["val_items"])
    for k, t in enumerate(tr):
        c = t["checks"]
        if not (all(c["params_equal"]) and all(c["grads_equal"])
                and len(c["params_equal"]) == n_steps == KITTI_STEPS):
            fail(f"phase 17 data mode, rank {k}: parameters equal across the ranks after each "
                 f"step {c['params_equal']}, gradients {c['grads_equal']} ({n_steps} steps)")
        if not (c["stats_sites"] == BN_SITES and c["stats_err"] <= BN_STATS_TOL):
            fail(f"phase 17 data mode, rank {k}: synced batch statistics at {c['stats_sites']} "
                 f"sites {c['stats_err']:.3e} from f64 over the two items (limit {BN_STATS_TOL})")
        if not (c["adam_excess"] <= ADAM_STEP_TOL and c["adam_all_moved"]):
            fail(f"phase 17 data mode, rank {k}: AdamW's first move {c['adam_excess']:.3f} lr "
                 f"from -lr g / (|g| + eps), every weight with a gradient moved "
                 f"{c['adam_all_moved']}")
        la = t["launches"]
        want = {**{f"{s}_bf16": BN_SITES * n_steps for s in SYNC_KERNELS},
                "bn_bwd_apply_bf16": BN_SITES * n_steps,
                "bn_apply_bf16": BN_SITES * (n_steps + n_val // PAR_BS),
                "bn_stats": 0, "bn_bwd_reduce": 0, "bn_forward_fused": 0,
                "bn_backward_fused": 0}
        got = {k_: la[k_] for k_ in want}
        if got != want or t["sync_all_reduces"] != 2 * BN_SITES * n_steps or not all(
                math.isfinite(v) for v in t["loss"]):
            fail(f"phase 17 data mode, rank {k}: launches {got}, expected {want}; synced "
                 f"all-reduces {t['sync_all_reduces']} (expected {2 * BN_SITES * n_steps}); "
                 f"losses {t['loss']}")
    # 0. the synced op across the ranks (each rank failed on a miss)
    op_err = {k: max(r_["synced_op"]["rel_l2"][k] for r_ in recs)
              for k in recs[0]["synced_op"]["rel_l2"]}
    # 2. ray_shard, per compute dtype, against one rank and the split played
    # on one rank: leaf by leaf in f32, as a whole against the run-to-run
    # floor in bf16
    def held(g, floor, dtype):
        if dtype == "float32":
            return g["worst_leaf"] <= SHARD_GRAD_REL_L2 and not g["tiny_bad"]
        return g["rel_l2"] <= SHARD_FLOOR_RATIO * floor

    for dtype, sh in recs[0]["ray_shard"].items():
        if not all(r_["ray_shard"][dtype]["params_equal"] and r_["ray_shard"][dtype]["grads_equal"]
                   for r_ in recs):
            fail(f"phase 17 ray_shard {dtype}: parameters or gradients differ across the ranks")
        loss_sh, loss_one = sh["metrics"]["total_loss"], sh["one_metrics"]["total_loss"]
        floor = sh["one_vs_one"]["rel_l2"]
        if not (abs(loss_sh - loss_one) <= SHARD_LOSS_RTOL * abs(loss_one)
                and held(sh, floor, dtype) and held(sh["shard_vs_split"], floor, dtype)
                and floor <= SHARD_BF16_FLOOR):
            fail(f"phase 17 ray_shard {dtype}: loss {loss_sh} vs one rank's {loss_one} (rtol "
                 f"{SHARD_LOSS_RTOL}); the gradient's relative L2 {sh['rel_l2']:.3e} from one "
                 f"rank's, {sh['shard_vs_split']['rel_l2']:.3e} from the split played on one "
                 f"rank; the one-rank step run twice {floor:.3e} (bf16: each within "
                 f"{SHARD_FLOOR_RATIO}x that, it within {SHARD_BF16_FLOOR}); worst leaf "
                 f"{sh['worst_name']} {sh['worst_leaf']:.3e}, against the split "
                 f"{sh['shard_vs_split']['worst_name']} {sh['shard_vs_split']['worst_leaf']:.3e} "
                 f"(f32: limit {SHARD_GRAD_REL_L2}; leaves zero up to rounding beyond 1e-5: "
                 f"{sh['tiny_bad']}, {sh['shard_vs_split']['tiny_bad']}); the worst leaves "
                 f"(relative L2, name, norm and difference over the largest leaf's) "
                 f"{sh['leaves']}")
    shards = recs[0]["ray_shard"]
    # 3. the sharded eval: the same files as phase 15's one-rank run
    ev0 = recs[0]["eval"]
    one_dir, par_dir = tree / "eval" / "depth_metrics" / "08", \
        tree / "eval_parallel" / "depth_metrics" / "08"
    names = sorted(p.name for p in one_dir.glob("*.npy"))
    if sorted(p.name for p in par_dir.glob("*.npy")) != names or not names:
        fail(f"phase 17 sharded save-depth-metrics wrote "
             f"{sorted(p.name for p in par_dir.glob('*.npy'))}; the one-rank run {names}")
    worst_metric = 0.0
    for name in names:
        with open(one_dir / name, "rb") as f:
            want_p = pickle.load(f)
        with open(par_dir / name, "rb") as f:
            got_p = pickle.load(f)
        if got_p["n_frames"] != want_p["n_frames"]:
            fail(f"phase 17 sharded {name}: n_frames {got_p['n_frames']} vs {want_p['n_frames']}")
        for k_, w_ in want_p["depth_errors"].items():
            g_ = got_p["depth_errors"][k_]
            if not np.allclose(g_, w_, rtol=SHARD_EVAL_RTOL, atol=0):
                fail(f"phase 17 sharded {name} at {k_} m: {g_} vs one rank {w_}")
            worst_metric = max(worst_metric, float(np.max(
                np.abs(g_ - w_) / np.maximum(np.abs(w_), 1e-30))))
    rays = ev0["rays"]
    if rays["share_equal"] < SHARD_MIN_SHARE or recs[1]["eval"]["done"]["frames"]:
        fail(f"phase 17 sharded render: {rays['share_equal']:.4%} of {rays['n']} rays equal the "
             f"one-rank render (rtol {SHARD_EVAL_RTOL}); rank 1 recorded frames "
             f"{recs[1]['eval']['done']['frames']}")

    # 4. NCCL: a one-rank group all-reduces one step's gradient buffer
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        nport = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{nport}", rank=0,
                            world_size=1)
    try:
        g = torch.randn(tr[0]["grad_floats"], generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        want_g = g.clone()
        dist.all_reduce(g)  # warm-up: builds the communicator
        torch.cuda.synchronize()
        nccl_ms = cuda_ms(lambda: dist.all_reduce(g), runs=5)
        nccl_ok = torch.equal(g, want_g) and dist.get_backend() == "nccl"
    finally:
        dist.destroy_process_group()
    if not nccl_ok:
        fail("phase 17 NCCL: a one-rank all-reduce changed the buffer")

    warm = [statistics.median(t["step_ms"][1:]) if len(t["step_ms"]) > 1 else t["step_ms"][0]
            for t in tr]
    ps = synced["per_step"]
    numbers = dict(
        step_ms=warm, peak_gib=[t["peak_gib"] for t in tr], loss=tr[0]["loss"],
        bn_all_reduces=tr[0]["bn_all_reduces"],
        bn_all_reduce_ms=[t["bn_all_reduce_ms"] for t in tr],
        grad_all_reduce_ms=[t["grad_all_reduce_ms"] for t in tr],
        grad_floats=tr[0]["grad_floats"], synced_k5=ps, save_ms=tr[0]["save_ms"],
        train_run_s=[t["run_s"] for t in tr],
        shard={dt: {**{k: sh_[k] for k in ("step_ms", "one_step_ms", "worst_leaf",
                                             "worst_name", "zero_leaf_worst", "n_zero_leaves",
                                             "rel_l2")},
                    **{f"{w}_{k}": sh_[w][k]
                       for w in ("one_vs_one", "split_vs_one", "shard_vs_split")
                       for k in ("rel_l2", "worst_leaf", "worst_name")}}
               for dt, sh_ in shards.items()},
        synced_op_rel_l2=op_err, synced_op_s=[r_["synced_op"]["s"] for r_ in recs],
        eval_command_s=[r_["eval"]["command_s"] for r_ in recs],
        eval_one_rank_s=p15["numbers"]["command_s"][0], eval_worst_metric=worst_metric,
        rays=rays, nccl_all_reduce_ms=nccl_ms, ranks_s=ranks_s)
    label = f"2 ranks sharing one card through the host (gloo), no multi-GPU speed; {card}"
    print(f"[17 parallel] data mode: train-kitti --parallel_mode data --bs {PAR_BS} "
          f"{' '.join(TRAIN_KITTI_FLAGS)} on {PAR_RANKS} ranks, one item each: {n_steps} steps, "
          f"losses {['%.5f' % v for v in tr[0]['loss']]}; parameters and gradients bit-equal "
          f"across the ranks after every step; synced batch statistics at {BN_SITES} sites "
          f"{max(t['checks']['stats_err'] for t in tr):.2e} from f64 over the two items (limit "
          f"{BN_STATS_TOL}); AdamW's first move within "
          f"{max(t['checks']['adam_excess'] for t in tr):.2e} lr; no cluster launch, "
          f"{BN_SITES} synced launches of each stage a step, {2 * BN_SITES} all-reduces a step")
    print(f"[17 parallel] ray_shard at lr 0 against one rank: " + "; ".join(
              f"{dt} loss {sh_['metrics']['total_loss']:.6f} vs "
              f"{sh_['one_metrics']['total_loss']:.6f},"
              f" the gradient's relative L2 {sh_['rel_l2']:.2e}, the worst leaf's "
              f"{sh_['worst_leaf']:.3e} ({sh_['worst_name']}; the {sh_['n_zero_leaves']} of "
              f"{sh_['n_leaves']} leaves zero up to rounding at most "
              f"{sh_['zero_leaf_worst']:.2e} of the largest apart); the one-rank step run "
              f"twice {sh_['one_vs_one']['rel_l2']:.2e} (worst leaf "
              f"{sh_['one_vs_one']['worst_leaf']:.3e}); the split played on one "
              f"rank vs one rank {sh_['split_vs_one']['rel_l2']:.2e} (worst leaf "
              f"{sh_['split_vs_one']['worst_leaf']:.3e}), the two ranks vs that split "
              f"{sh_['shard_vs_split']['rel_l2']:.2e} (worst leaf "
              f"{sh_['shard_vs_split']['worst_leaf']:.3e}, {sh_['shard_vs_split']['worst_name']})"
              for dt, sh_ in shards.items())
          + f"; ranks bit-equal. The synced op across the ranks vs the plain version on all "
          f"rows at {len(SYNC_SITES)} sites, f32 and bf16: relative L2 "
          f"{', '.join('%s %.1e' % kv for kv in op_err.items())}. "
          f"save-depth-metrics --n_devices {PAR_RANKS}: the one-rank files ({len(names)} pickles), "
          f"metrics within {worst_metric:.2e} relative; one source's {rays['n']} rays "
          f"{rays['share_equal']:.4%} equal at rtol {SHARD_EVAL_RTOL}. NCCL: a one-rank group "
          f"all-reduced {tr[0]['grad_floats']} floats")
    print(f"[17 numbers] {label}: ms per data-mode step {['%.1f' % v for v in warm]} (ranks); "
          f"peak {['%.2f' % v for v in numbers['peak_gib']]} GiB per rank; the "
          f"{tr[0]['bn_all_reduces']} synced-BN all-reduces of a step "
          f"{['%.1f' % v for v in numbers['bn_all_reduce_ms']]} ms, the gradient mean "
          f"{['%.1f' % v for v in numbers['grad_all_reduce_ms']]} ms; synced K5 per bf16 step "
          f"alone {ps['forward_ms']:.3f} + {ps['backward_ms']:.3f} ms (one rank's plan, cluster or "
          f"streaming, at the same sites {ps['cluster_forward_ms']:.3f} + "
          f"{ps['cluster_backward_ms']:.3f}); ray_shard "
          f"first step (both ranks' first, cold) " + ", ".join(
              f"{dt} {sh_['step_ms']:.1f} ms vs one rank {sh_['one_step_ms']:.1f}"
              for dt, sh_ in shards.items()) + "; sharded "
          f"save-depth-metrics {['%.1f' % v for v in numbers['eval_command_s']]} s vs one rank "
          f"{numbers['eval_one_rank_s']:.1f} s (phase 15, ICP cold there); a frame's encode "
          f"{rays['encode_ms']:.1f} ms vs broadcasting its levels "
          f"({rays['level_bytes'] / 2**20:.1f} "
          f"MiB) {rays['broadcast_levels_ms']:.1f} ms; NCCL one-rank all-reduce "
          f"{nccl_ms:.3f} ms; ranks' wall {ranks_s:.1f} s")
    return {"launches": recs[0]["train"]["launches"], "numbers": numbers}


# ---- phase 18: import, the KITTI reconstruction CLIs, quality, overfit -------

CHAIN_FRAME = "000005"     # phase 14's first val anchor (000000 is a corrupt-GT frame)
CHAIN_MAX_DISTANCE = 2.1   # the sweep's reach: 15 of the CLI's 63 poses
QUALITY_ARMS = ("bf16x4", "f32x4")
QUALITY_STEPS = 4
QUALITY_VAL_EVERY = 2
OVERFIT_STEPS = 25
IMPORT_PRESET = "kitti"    # the preset of phase 14's checkpoint


def load_script(name: str):
    """A module of scripts/ by file name (scripts/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_hparams(cfg) -> dict:
    """`cfg`'s values under the reference's Lightning hparam names (the keys
    of tests/test_port_reference.py's checkpoint)."""
    hp = {k: getattr(cfg, k) for k in (
        "som_sigma", "lr", "weight_decay", "n_rays", "max_infer_depth", "max_sample_depth",
        "eval_depth", "std", "n_gaussians", "n_pts_uni", "n_pts_per_gaussian",
        "sampling_method", "batch_size", "use_color", "use_reprojection")}
    return {**hp, "img_size": list(cfg.img_size), "add_fov_hor": cfg.sphere.add_fov_hor,
            "add_fov_ver": cfg.sphere.add_fov_ver, "sphere_H": cfg.sphere.height,
            "sphere_W": cfg.sphere.width}


def chain_root(tree: Path) -> Path:
    """A KITTI root showing one val frame of phase 14's tree: sequence 08's
    poses, calibration, images and scans linked, and the voxel GT of
    CHAIN_FRAME alone (the val split anchors on voxels/*.bin)."""
    root = tree / "chain_root"
    src = tree / "dataset"
    seq = root / "dataset" / "sequences" / "08"
    (seq / "voxels").mkdir(parents=True)
    (root / "dataset" / "poses").mkdir(parents=True)
    (root / "dataset" / "poses" / "08.txt").symlink_to(src / "poses" / "08.txt")
    for name in ("calib.txt", "image_2", "velodyne"):
        (seq / name).symlink_to(src / "sequences" / "08" / name)
    for ext in ("bin", "label", "invalid"):
        (seq / "voxels" / f"{CHAIN_FRAME}.{ext}").symlink_to(
            src / "sequences" / "08" / "voxels" / f"{CHAIN_FRAME}.{ext}")
    return root


def import_chain_phase(dev, card: str, tree: Path, model_path: str) -> dict:
    """Phase 18 (a) and (b): phase 14's `best` written as a checkpoint in
    the reference's layout, imported by scripts/import_reference_ckpt_torch.py
    in a subprocess, then generate-novel-depths -> depth2tsdf -> eval-sr
    through click on cuda:0 with the imported checkpoint; the checks and
    numbers of the module docstring. Returns the chain's launches and the
    numbers."""
    import numpy as np
    import torch

    from scenerf_tpu_torch import geometry as geo
    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.cli import common
    from scenerf_tpu_torch.cli import evaluation as ev
    from scenerf_tpu_torch.cli import reconstruction as rc
    from scenerf_tpu_torch.fusion.tsdf import pack_colors, tsdf2occ
    from scenerf_tpu_torch.ops import build
    from scenerf_tpu_torch.ops.tsdf import integrate_plain
    from scenerf_tpu_torch.utils.checkpoint import load_model
    from scenerf_tpu_torch.utils.port_reference import save_reference_layout
    from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

    # (a) the import
    src = load_model(model_path, "cpu")
    want = {k: v.clone() for k, v in src.state_dict().items()}
    hp = reference_hparams(src.cfg)
    ckpt = tree / "scenerf_kitti_layout.ckpt"
    save_reference_layout(str(ckpt), want, hp)
    del src
    out = tree / "imported"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "import_reference_ckpt_torch.py"),
                          "--ckpt", str(ckpt), "--preset", IMPORT_PRESET, "--out", str(out)],
                         capture_output=True, text=True, timeout=600)
    import_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"import_reference_ckpt_torch.py ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    model = load_model(str(out), "cpu")
    got = model.state_dict()
    unequal = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    wrong_hp = {k: (v, getattr(model.cfg, k)) for k, v in hp.items()
                if k in model.cfg.__dataclass_fields__ and k != "img_size"
                and getattr(model.cfg, k) != v}
    cfg = model.cfg
    sphere = (cfg.sphere.width, cfg.sphere.height, cfg.sphere.add_fov_hor, cfg.sphere.add_fov_ver)
    if (unequal or got.keys() != want.keys() or wrong_hp or list(cfg.img_size) != hp["img_size"]
            or sphere != (hp["sphere_W"], hp["sphere_H"], hp["add_fov_hor"], hp["add_fov_ver"])
            or cfg.compute_dtype != "float32"):
        fail(f"imported checkpoint: {len(unequal)} tensors differ from the source ({unequal[:5]}),"
             f" keys equal {got.keys() == want.keys()}; hparams off the config {wrong_hp}, "
             f"img_size {cfg.img_size}, sphere {sphere}, dtype {cfg.compute_dtype}")
    del model, got
    ckpt_mib = ckpt.stat().st_size / 2**20
    ckpt.unlink()

    # (b) generate-novel-depths -> depth2tsdf -> eval-sr through click
    root = chain_root(tree)
    recon_dir = tree / "chain_recon"
    kitti = ["--root", str(root), "--preprocess_root", str(tree / "preprocess_chain"),
             "--model_path", str(out), "--recon_save_dir", str(recon_dir), "--max_distance",
             str(CHAIN_MAX_DISTANCE)]
    stage_s = {}

    def run(cli, *argv):
        t0_ = time.perf_counter()
        res_ = cli.main(list(argv), standalone_mode=False)
        stage_s[argv[0]] = time.perf_counter() - t0_
        return res_

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    sweep = run(rc.cli, "generate-novel-depths", *kitti)
    run(rc.cli, "depth2tsdf", *kitti)
    sr = run(ev.cli, "eval-sr", *kitti[:6], "--recon_save_dir", str(recon_dir))
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rel_poses = geo.sample_rel_poses(step=0.5, angle=10.0, max_distance=CHAIN_MAX_DISTANCE)
    n_poses = len(rel_poses)
    ds = common.kitti_val_ds(str(root), str(tree / "preprocess_chain"), 10.0, 0.4,
                             load_voxels=True)
    if len(ds) != 1 or sweep["frames"] != [CHAIN_FRAME]:
        fail(f"chain: {len(ds)} val frames, the sweep did {sweep['frames']}; expected "
             f"[{CHAIN_FRAME}]")
    item = ds[0]
    depths, colors, poses = rc._load_sweep_frames(str(recon_dir), "08", CHAIN_FRAME, rel_poses)
    W, H = cfg.img_size
    if len(depths) != n_poses or any(d.shape != (H, W) or not np.isfinite(d).all()
                                     for d in depths):
        fail(f"generate-novel-depths wrote {len(depths)} of {n_poses} depths, shapes "
             f"{sorted({d.shape for d in depths})}, finite "
             f"{all(np.isfinite(d).all() for d in depths)}")
    # kernel T's volume (depth2tsdf's file) against the plain version on the
    # written depths and PNG colors, posed as fuse_kitti_sweep poses them
    vol = recon.kitti_volume(dev)
    cam_poses = np.stack([np.linalg.inv(item["T_velo_2_cam"]) @ p for p in poses])
    w2cs = np.stack([np.linalg.inv(p) for p in cam_poses]).astype(np.float32)
    integrate_plain(vol.tsdf, vol.weight, vol.color,
                    torch.from_numpy(np.stack(depths)).to(dev),
                    pack_colors(torch.from_numpy(np.stack(colors)).to(dev)),
                    torch.from_numpy(np.tile(item["cam_K"][None], (n_poses, 1, 1))).to(dev),
                    torch.from_numpy(w2cs).to(dev), vol._vol_origin, vol._voxel_size,
                    vol._trunc_margin, 1.0)
    written = np.load(recon_dir / "tsdf" / "08" / f"{CHAIN_FRAME}.npy")
    plain = vol.tsdf.cpu().numpy()
    equal = float((written == plain).mean())
    if written.shape != (256, 256, 32) or equal < TSDF_MIN_EQUAL:
        fail(f"depth2tsdf's volume {written.shape}: bit-equal to the plain version on "
             f"{equal:.6%} of voxels (at least {TSDF_MIN_EQUAL:.2%})")
    # eval-sr against a recompute from the written volume on the host
    target = item["target_1_1"]
    occ = tsdf2occ(written, cfg.occ_threshold, cfg.occ_max_threshold)
    occ[:, :, np.nonzero(np.where(target == 255, 0, target))[2].max():] = 0
    whole, fov = SSCMetrics(2), SSCMetrics(2)
    whole.add_batch(occ[None], target[None])
    fov.add_batch(occ[None], target[None], item["fov_mask_1"].reshape(target.shape)[None])
    scores = {}
    for name, got_s, want_s in (("whole", sr[0], whole.get_stats()),
                                ("fov", sr[1], fov.get_stats())):
        scores[name] = {k: float(got_s[k]) for k in ("iou", "precision", "recall")}
        if any(float(got_s[k]) != float(want_s[k]) for k in scores[name]):
            fail(f"eval-sr {name}: {scores[name]} against the recompute "
                 f"{ {k: float(want_s[k]) for k in scores[name]} }")
    # launches: one encode (6 sphere resamples, 192 eval applies); per pose,
    # per render chunk two pyramid gathers and one C; one T
    n_rays = len(common.strided_pixel_grid(tuple(cfg.img_size), 2)[0])
    chunks = n_poses * -(-n_rays // rc.SWEEP_CHUNK)
    want_l = {"gather_levels": SPHERE_RESAMPLES + 2 * chunks, "sort_composite": chunks,
              "bn_apply": BN_SITES, "tsdf_integrate": 1, "bn_stats": 0, "gather_levels_bwd": 0,
              "sort_composite_bwd": 0, "ray_som": 0, "gather_levels_bf16": 0}
    got_l = {k: launches[k] for k in want_l}
    if got_l != want_l:
        fail(f"chain launches {launches}; expected {want_l}")
    numbers = dict(import_s=import_s, ckpt_mib=ckpt_mib, stage_s=stage_s,
                   encode_s=sweep["encode_s"][0], render_s=sweep["render_s"][0],
                   write_s=sweep["write_s"][0], peak_gib=peak / 2**30, n_poses=n_poses)
    print(f"[18 import] phase 14's best ({len(want)} tensors) in the reference's layout "
          f"({ckpt_mib:.0f} MiB with the unread keys, hparams under the reference's names) -> "
          f"scripts/import_reference_ckpt_torch.py {import_s:.1f} s -> load_model: every tensor "
          f"bit-equal, every hparam on the config (f32)")
    print(f"[18 chain] generate-novel-depths -> depth2tsdf -> eval-sr through click on {dev} "
          f"with the imported checkpoint, frame 08/{CHAIN_FRAME}, {n_poses} poses "
          f"(--max_distance {CHAIN_MAX_DISTANCE}) at stride 2: depths finite {H}x{W}; T's volume "
          f"bit-equal to the plain version on {equal:.6%} of voxels; eval-sr = the host "
          f"recompute: {scores}; launches {got_l}")
    print(f"[18 numbers] on {card}: stages "
          f"{ {k: round(v, 2) for k, v in stage_s.items()} } s; the sweep's frame: encode "
          f"{numbers['encode_s'] * 1e3:.1f} ms, {n_poses} poses {numbers['render_s']:.2f} s "
          f"({numbers['render_s'] / n_poses:.3f} s a pose, f32), files {numbers['write_s']:.2f} "
          f"s; peak device memory {numbers['peak_gib']:.2f} GiB")
    return {"launches": launches, "numbers": numbers}


def quality_phase(dev, card: str, tree: Path) -> dict:
    """Phase 18 (c) and (d): scripts/quality_runs_torch.py's bf16x4 and
    f32x4 arms for QUALITY_STEPS steps on phase 14's tree at full width, its
    JSON through scripts/quality_table.py; scripts/overfit_probe_torch.py for
    OVERFIT_STEPS steps. Returns the launches of each and the numbers."""
    import io

    import torch

    from scenerf_tpu_torch.ops import build

    out = tree / "quality.json"
    argv = ["--root", str(tree), "--prep", str(tree / "preprocess"), "--steps",
            str(QUALITY_STEPS), "--val_every", str(QUALITY_VAL_EVERY), "--configs",
            ",".join(QUALITY_ARMS), "--out", str(out), "--device", str(dev)]
    torch.cuda.empty_cache()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    load_script("quality_runs_torch").main(argv)
    quality_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    with open(out) as f:
        hist = json.load(f)
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        load_script("quality_table").main(str(out))
    rows = [line for line in table.getvalue().splitlines()
            if any(line.startswith(f"| {a} | 1 |") for a in QUALITY_ARMS)]
    values = [v for h in hist.values() for v in (
        h["val_abs_rel"] + h["val_rmse"] + h["train_loss"][1:] + [h["wall_s"], h["peak_gib"]])]
    values = [math.nan if v is None else v for v in values]
    ids = [hist[a]["frame_ids"] for a in QUALITY_ARMS]
    steps = list(range(0, QUALITY_STEPS + 1, QUALITY_VAL_EVERY))
    if (set(hist) != set(QUALITY_ARMS) or len(rows) != len(QUALITY_ARMS)
            or any("nan" in r for r in rows) or not all(math.isfinite(v) for v in values)
            or any(h["steps"] != steps for h in hist.values())):
        fail(f"quality_runs_torch.py: arms {sorted(hist)}, table rows {rows}, steps "
             f"{[h['steps'] for h in hist.values()]}, values {values}")
    if ids[0] != ids[1] or len(ids[0]) != QUALITY_STEPS:
        fail(f"quality arms read different frames: {ids}")
    kernels = TRAIN_KERNELS + tuple(f"{k}_bf16" for k in (
        "gather_levels", "gather_levels_bwd", "bn_stats", "bn_apply", "bn_bwd_reduce",
        "bn_bwd_apply"))
    if min(launches[k] for k in kernels) < 1:
        fail(f"quality arms launches {launches}; expected every training kernel in both dtypes")

    build.reset_launch_counts()
    t0 = time.perf_counter()
    best = load_script("overfit_probe_torch").main(["--steps", str(OVERFIT_STEPS), "--device",
                                                    str(dev)])
    overfit_s = time.perf_counter() - t0
    overfit_launches = dict(build.LAUNCHES)
    if not math.isfinite(best) or min(overfit_launches[k] for k in (
            "gather_levels", "gather_levels_bwd", "sort_composite", "sort_composite_bwd")) < 1:
        fail(f"overfit probe: best abs_rel {best}, launches {overfit_launches}")
    numbers = dict(quality_s=quality_s, overfit_s=overfit_s, overfit_best=best,
                   arms={a: {k: hist[a][k] for k in ("val_abs_rel", "val_rmse", "train_loss",
                                                      "wall_s", "peak_gib")}
                         for a in QUALITY_ARMS})
    for a in QUALITY_ARMS:
        h = hist[a]
        print(f"[18 quality] {a}: steps {h['steps']} val abs_rel "
              f"{['%.5f' % v for v in h['val_abs_rel']]} rmse {['%.4f' % v for v in h['val_rmse']]}"
              f" loss {['%.5f' % v for v in h['train_loss'][1:]]}; frames {h['frame_ids']}")
    print("[18 quality] quality_table.py:\n    " + "\n    ".join(rows))
    print(f"[18 numbers] on {card}: quality arms {quality_s:.1f} s ("
          + ", ".join(f"{a} wall {hist[a]['wall_s']} s, peak {hist[a]['peak_gib']:.2f} GiB"
                      for a in QUALITY_ARMS)
          + f"); overfit probe {OVERFIT_STEPS} steps {overfit_s:.1f} s, best abs_rel {best:.4f}")
    return {"launches": launches, "overfit_launches": overfit_launches, "numbers": numbers}


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--bf-som-chunk", default=None,
                    help="save phase 16's RaySOM chunk (512 rays) to this .npz")
    ap.add_argument("--parallel-rank", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if not (ROOT / "scenerf_tpu_torch").is_dir():
        fail(f"the port package scenerf_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    if opts.parallel_rank is not None:  # a rank of phase 17, started by parallel_phase
        parallel_rank(Path(opts.parallel_rank))
        return

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
    from scenerf_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    # phase 14's KITTI tree, written by two host processes meanwhile
    tree_dir = tempfile.TemporaryDirectory(prefix="scenerf_kitti_")
    tree_procs = start_kitti_tree(Path(tree_dir.name))
    # phase 16's BundleFusion tree, likewise
    bf_dir = tempfile.TemporaryDirectory(prefix="scenerf_bf_")
    bf_procs = start_bf_tree(Path(bf_dir.name))

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
    step_ms, losses, kinds = [], [], []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    NM.cotangent_copies = 0
    for i in range(TRAIN_STEPS):
        # step 0 (eager): the layouts and K5 paths
        hooks = site_hooks("train") + k5_path_hooks(model, k5_paths) if i == 0 else []
        if i == TRAIN_STEPS - 1:
            before_last = copy.deepcopy(trainer.state_dict())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.recording():
            metrics = trainer.train_step(batch, noise=noises[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        kinds += step_kinds()
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
    metrics_last = metrics
    grads_last = {n: p.grad.detach().clone() for n, p in params.items()}
    if kinds != ["eager", "capture"] + ["replay"] * (TRAIN_STEPS - LAUNCHING_STEPS):
        fail(f"train: the steps ran {kinds}; expected the first eager, the second capturing "
             f"the step graphs, the others replaying them")
    for name in TRAIN_KERNELS:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the training path")
    if launches["ray_som"] != launches["ray_som_in_sort_composite"]:
        fail(f"the training path launched kernel S alone: {launches}")
    bn_train = [launches[k] for k in BN_KERNELS]
    if bn_train != [BN_SITES * LAUNCHING_STEPS] * 4:
        fail(f"train: K5 launches {dict(zip(BN_KERNELS, bn_train))} in the eager and the "
             f"capturing step; expected {BN_SITES} of each per step")
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
    last = TRAIN_STEPS - 1
    print(f"[10 train] {TRAIN_STEPS} steps, {cfg.n_sources} sources x {cfg.n_rays} rays x "
          f"{cfg.n_pts_per_ray} samples, f32, {kinds}: loss {['%.5f' % v for v in losses]}; "
          f"finite; {len(params)} parameter tensors, all with nonzero gradients; {moved} BN "
          f"running statistics moved; main-path launches in the eager and the capturing step "
          f"{launches} (K5: {BN_SITES} forward and {BN_SITES} backward per step, of which "
          f"{bn_fused} per step in one launch, {k5_per_step:.0f} K5 kernels a step; inputs "
          f"{layouts('train')}; {bn_copies} cotangents copied to their input's layout)")
    print(f"[10 train] {adam_text}")
    twin_gaps = replay_against_eager(trainer, before_last, batch, noises[last], metrics_last,
                                     grads_last)
    print(f"[10 train] step {last} (replayed) against an eager twin from the same state: "
          f"metrics {twin_gaps['metric']:.2e} (limit {GRAPH_METRIC_RTOL}), gradients as one "
          f"vector {twin_gaps['grad']:.2e} (limit {twin_gaps['grad_limit']}; the twin's two "
          f"steps {twin_gaps['floor']:.2e}; the fields' {twin_gaps['fields']:.2e})")

    # step 0 (eager) and the last step (replayed) again on the plain versions
    # but K5's kernels, each from the state it was taken from: the step's
    # loss and gradients move by far more than rounding when the encode moves
    # by rounding (RaySOM's assignments, the closest-sample argmins: on this
    # card a 1e-6 change of the input frame on the plain path moved some
    # gradient leaves by over 100%), so both sides share K5's encode, and K5
    # is held to its plain version on the encode below
    for i, state, got_m, got_g in ((0, None, metrics0, grads0),
                                   (last, before_last, metrics_last, grads_last)):
        plain_trainer = Trainer(cfg, device=dev, model=model)  # its first step: eager
        if state is None:
            model.load_state_dict(start_state)
        else:
            plain_trainer.load_state_dict(copy.deepcopy(state))
        with build.plain_versions(keep=("bn",)):
            metrics_p = plain_trainer.train_step(batch, noise=noises[i])
        torch.cuda.synchronize()
        loss_k, loss_p = float(got_m["total_loss"]), float(metrics_p["total_loss"])
        if not abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p):
            fail(f"train step {i}: kernel-path loss {loss_k} vs plain {loss_p}")
        norms = {n: float(g.norm()) for n, g in got_g.items()}
        gscale = max(norms.values())
        worst, worst_name = 0.0, ""
        for n, p in params.items():
            diff = float((got_g[n] - p.grad).norm())
            if norms[n] <= 1e-6 * gscale:  # zero up to rounding on both paths
                if diff > 1e-5 * gscale:
                    fail(f"train step {i}: gradient {n} differs by {diff} (scale {gscale})")
                continue
            rel = diff / norms[n]
            if rel > worst:
                worst, worst_name = rel, n
        if worst > TRAIN_GRAD_REL_L2:
            fail(f"train step {i}: gradient {worst_name} relative L2 {worst:.3e} > "
                 f"{TRAIN_GRAD_REL_L2}")
        metric_err = max(abs(float(got_m[k]) - float(v)) / max(abs(float(v)), 1e-12)
                         for k, v in metrics_p.items())
        print(f"[10 train] step {i} ({kinds[i]}) on the plain versions (K5's kernels kept) "
              f"from the same state and draws: loss {loss_p:.6f} vs kernel path "
              f"{loss_k:.6f}; worst metric relative difference {metric_err:.2e}; worst "
              f"gradient leaf relative L2 {worst:.3e} ({worst_name}; limit "
              f"{TRAIN_GRAD_REL_L2})")

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
    warm = statistics.median(step_ms[LAUNCHING_STEPS:])
    print(f"[10 numbers] on {card}: {warm:.1f} ms per replayed step (median of steps "
          f"{list(range(LAUNCHING_STEPS, TRAIN_STEPS))}; step 0, eager, {step_ms[0]:.1f} ms; "
          f"step 1, capturing, {step_ms[1]:.1f} ms), {n_step_rays / warm * 1e3:.0f} rays/s, "
          f"peak device memory {peak / 2**30:.2f} GiB allocated (the {TRAIN_STEPS} kernel-path "
          f"steps; a replay allocates through the graphs' own pool)")

    # ---- 11. reconstruction ----------------------------------------------
    from scenerf_tpu_torch import reconstruction as recon
    from scenerf_tpu_torch.data.synthetic import kitti_calibration
    from scenerf_tpu_torch.fusion.tsdf import pack_colors, tsdf2occ
    from scenerf_tpu_torch.ops import tsdf as T
    from scenerf_tpu_torch.ops.tsdf import integrate, integrate_plain, pixel_ties
    from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

    del trainer, plain_trainer, batch, noises, grads0, before_last, metrics_last, grads_last
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
            n_valid = int(want_v[1].double().sum())  # valid voxel-frames: the weights, obs 1
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
    # volume
    t_dev_ms = graph_ms(lambda: integrate(*work, *t_args))
    del work
    # the work: voxel-frames in view and valid, the distinct pixels touched,
    # the sectors a warp's depth loads touch with lanes along z and along
    # the rows; the tiles the kernel culls (its plain twin)
    plan_constants = (T.TILE_LANES, T.TILE_WARPS, T.TILE_RUN, T.CULL_MARGIN, T.CULL_MAX_PIXEL)
    if T.kernel_plan_constants() != plan_constants:
        fail(f"kernel T's tile and cull constants {T.kernel_plan_constants()} are not its plain "
             f"twin's {plan_constants}")
    t_cull = tsdf_cull(vol.shape, vol._vol_origin, vol._voxel_size, intrs, w2cs, H, W)
    t_fp = tsdf_footprint(vol.shape, vol._vol_origin, vol._voxel_size, vol._trunc_margin,
                          depths, packed, intrs, w2cs,
                          tsdf_warp_groups(vol.shape, t_cull["lane_axis"]))
    if t_fp["valid"] != n_valid:
        fail(f"tsdf_footprint: {t_fp['valid']} valid voxel-frames, the plain version's "
             f"weights {n_valid}")
    t_bound = tsdf_bounds(t_fp, nbytes(vol.tsdf, vol.weight, vol.color), nbytes(depths, packed),
                          nbytes(intrs, w2cs))
    sectors = {k: t_fp["sectors"][k] / max(t_fp["loads"][k], 1) for k in t_fp["sectors"]}

    # the fuse's parts, as fuse_kitti_sweep and TSDFVolume.integrate_frames
    # run them on the same arrays (each ended by a synchronize): the volume,
    # pack_colors, the host's pose inversion and the upload of K and the
    # poses, kernel T; then the whole fuse again (the parts' synchronizes
    # keep the host's work from overlapping the card's, so they sum to more).
    # The split's poses and volume are the main path's, bit for bit.
    parts = {k: [] for k in ("volume", "pack_colors", "poses", "T", "fuse_again")}
    for _ in range(5):
        marks = [time.perf_counter()]
        part_vol = recon.kitti_volume(dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        part_packed = pack_colors(part_vol._f32(colors))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        part_cams = np.stack([np.linalg.inv(T_velo_2_cam) @ np.asarray(p) for p in rel_poses])
        part_w2cs = part_vol._f32(np.stack([np.linalg.inv(np.asarray(p)) for p in part_cams])
                                  .astype(np.float32))
        part_intrs = part_vol._f32(np.tile(np.asarray(K_kitti)[None], (n_poses, 1, 1)))
        part_depths = part_vol._f32(depths)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        integrate(part_vol.tsdf, part_vol.weight, part_vol.color, part_depths, part_packed,
                  part_intrs, part_w2cs, part_vol._vol_origin, part_vol._voxel_size,
                  part_vol._trunc_margin, 1.0, mode=part_vol.mode)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        recon.fuse_kitti_sweep(depths, colors, K_kitti, T_velo_2_cam, rel_poses)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for k, t0_, t1_ in zip(parts, marks, marks[1:]):
            parts[k].append((t1_ - t0_) * 1e3)
    if not (torch.equal(part_w2cs, w2cs) and torch.equal(part_intrs, intrs)
            and all(torch.equal(a, b) for a, b in zip(
                (part_vol.tsdf, part_vol.weight, part_vol.color),
                (vol.tsdf, vol.weight, vol.color)))):
        fail("fuse split: its poses or its volume differ from the main path's")
    parts = {k: statistics.median(v) for k, v in parts.items()}
    parts["sum"] = sum(parts[k] for k in ("volume", "pack_colors", "poses", "T"))
    if parts["T"] < t_dev_ms:
        fail(f"fuse split: kernel T {parts['T']:.3f} ms by the host's clock, launch included, "
             f"is below its graph replay's {t_dev_ms:.3f} ms")
    del part_vol, part_packed, part_w2cs, part_intrs, part_depths
    results["tsdf_integrate"] = dict(
        max_abs_err=t_err, ms=t_ms, plain_ms=t_plain_ms, device_ms=t_dev_ms, **t_bound,
        library_ms=None, shape=[*vol.shape, n_poses, H, W], footprint=t_fp, cull=t_cull,
        sectors_per_load=sectors, fuse_parts_ms=parts)
    print(f"[11 kernel T] {n_poses} frames of {W}x{H} into {vol.shape}: " + "; ".join(t_text)
          + f"; kernel-vs-plain occupancy IoU {occ_stats['iou']:.6f} "
          f"({int(occ_p.sum())} plain voxels occupied)")
    print(f"[11 kernel T work] {tsdf_work_text(t_fp, t_bound, t_cull)}; 32-B sectors per warp "
          "depth load " + ", ".join(f"{k} {v:.2f}" for k, v in sectors.items()))
    print(f"[11 numbers] on {card}: {sweep_s / n_poses * 1e3:.1f} ms/pose, {sweep_s:.2f} s "
          f"sweep + {encode11_ms:.1f} ms encode + {fuse_ms:.2f} ms fuse per frame (again, "
          f"median of 5: volume {parts['volume']:.3f} + pack_colors {parts['pack_colors']:.3f} "
          f"+ host pose inversion and upload {parts['poses']:.3f} + T {parts['T']:.3f} = "
          f"{parts['sum']:.3f} ms; the whole fuse again {parts['fuse_again']:.3f} ms); "
          f"kernel T {t_ms:.3f} ms (events, fresh volume, median of {TIMING_RUNS}), alone "
          f"{t_dev_ms:.3f} ms (graph of {GRAPH_REPS}), bound {t_bound['bound_ms']:.3f} ms "
          f"({t_bound['bound_by']}; all-pixels bound {t_bound['all_pixels_bound_ms']:.3f}); "
          f"plain {t_plain_ms:.3f} ms")
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

    bn_rows = []
    for key in configs:
        shape, act, has_res, eps, mom, layout = key
        count = {path: site_count[path].get(key, 0) for path in site_count}
        Cn = shape[-1]
        Mn = math.prod(shape[:-1])
        what = k5_what(key)

        def lib_in(t):
            """The library's layout: NCHW for a channel-first site, [M, C] else."""
            return t.movedim(-1, 1) if layout else t.reshape(Mn, Cn)

        chk = k5_site_check(key, gen, dev)
        x, w, b, rm, rv, r, dy, st_p, gr_p = (chk[k] for k in (
            "x", "w", "b", "rm", "rv", "r", "dy", "st_p", "gr_p"))
        err, paths, eval_spacings, op_l2, ties = (chk[k] for k in (
            "err", "paths", "eval_spacings", "op_l2", "ties"))
        run = lambda: [rm.clone(), rv.clone()]  # noqa: E731
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
        del x, r, dy, y_buf, dx_buf, dr_buf, leaf_x, leaf_r, stage_calls, ties, chk
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
          f"in the eager and the capturing step; the cluster path at "
          f"{bn_step['cluster_sites']} sites): "
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
    step16_ms, losses16, kinds16 = [], [], []
    k5_paths16 = {"forward": [], "backward": []}  # each site's K5 paths (step 0)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        stats16_rec = []  # step 0's BN inputs' f64 statistics (running statistics set to 0)
        hooks16 = (site_hooks16("train") + k5_path_hooks(model16, k5_paths16)
                   + bn_stats_hooks(model16, stats16_rec)) if i == 0 else []
        if i == TRAIN_STEPS - 1:
            before16 = copy.deepcopy(trainer16.state_dict())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.recording():
            metrics16 = trainer16.train_step(batch16, noise=noises16[i])
        torch.cuda.synchronize()
        step16_ms.append((time.perf_counter() - t0) * 1e3)
        kinds16 += step_kinds()
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
    grads16_last = {n: p.grad.detach().clone() for n, p in params16.items()}
    if kinds16 != ["eager", "capture"] + ["replay"] * (TRAIN_STEPS - LAUNCHING_STEPS):
        fail(f"bf16 train: the steps ran {kinds16}; expected the first eager, the second "
             f"capturing the step graphs, the others replaying them")
    # per step that ran the wrappers (the eager and the capturing step)
    launches16_per_step = {k: train16_launches[k] / LAUNCHING_STEPS for k in train16_launches}
    bn16 = [train16_launches[f"{k}_bf16"] for k in BN_KERNELS]
    bn16_fused = k5_fused_check(train16_launches, k5_paths16, "_bf16")
    if (bn16 != [BN_SITES * LAUNCHING_STEPS] * 4
            or [train16_launches[k] for k in BN_KERNELS] != bn16):
        fail(f"bf16 train: K5 launches {train16_launches}; expected {BN_SITES} bf16 launches "
             f"of each of N1-N4 per step")
    if not (train16_launches["gather_levels_bf16"] >= 1
            and train16_launches["gather_levels_bwd_bf16"] >= 1
            and train16_launches["ray_som_in_sort_composite"] == cfg16.n_sources * LAUNCHING_STEPS
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
    twin16 = replay_against_eager(trainer16, before16, batch16, noises16[-1], metrics16,
                                  grads16_last)
    del before16, grads16_last
    warm16 = statistics.median(step16_ms[LAUNCHING_STEPS:])
    rays16 = cfg16.n_sources * cfg16.n_rays
    print(f"[13 train bf16] {TRAIN_STEPS} steps of kitti(n_sources=4, ray_chunk=1200, "
          f"n_gt_depth=256, compute_dtype=bfloat16), {kinds16}: loss "
          f"{['%.5f' % v for v in losses16]}; step {TRAIN_STEPS - 1} (replayed) against an "
          f"eager twin from the same state: metrics {twin16['metric']:.2e} (limit "
          f"{GRAPH_METRIC_RTOL}), gradients as one vector {twin16['grad']:.2e} (limit "
          f"{twin16['grad_limit']}; the twin's two steps {twin16['floor']:.2e}; the fields' "
          f"{twin16['fields']:.2e}); "
          f"step 0's batch statistics {stats16_err:.2e} from f64 (limit {BN_STATS_TOL}); step 0 "
          f"vs f32 from the same weights and draws {loss32:.5f} (rel "
          f"{abs(losses16[0] - loss32) / abs(loss32):.2e}); finite; "
          f"params, gradients and {len(stats16)} BN statistics f32, the statistics moved; "
          f"AdamW step 0 within {max(float(excess16.max()), 0.0):.2e} lr; launches per step "
          f"that ran the wrappers (eager, capturing) "
          f"{ {k: launches16_per_step[k] for k in TRAIN_KERNELS + tuple(f'{k}_bf16' for k in build.BF16_KERNELS)} }")
    print(f"[13 numbers] on {card}: bf16 {warm16:.1f} ms per replayed step (median of steps "
          f"{list(range(LAUNCHING_STEPS, TRAIN_STEPS))}; step 0, eager, {step16_ms[0]:.1f} ms; "
          f"step 1, capturing, {step16_ms[1]:.1f} ms), {rays16 / warm16 * 1e3:.0f} rays/s, peak "
          f"device memory {train16_peak / 2**30:.2f} GiB allocated; f32 phase 10 (ray_chunk "
          f"{cfg.ray_chunk}): {warm:.1f} ms per replayed step, {n_step_rays / warm * 1e3:.0f} "
          f"rays/s, {peak / 2**30:.2f} GiB")

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
    # ---- 16. BundleFusion --------------------------------------------------
    p16 = bf_phase(dev, card, Path(bf_dir.name), bf_procs, opts.bf_som_chunk)
    bf_dir.cleanup()
    # ---- 17. several ranks ---------------------------------------------------
    synced = k5_synced_stages(dev, card, rows16, gen)
    p17 = parallel_phase(dev, card, Path(tree_dir.name), p14["model_path"], p15, synced)
    # ---- 18. import, the KITTI reconstruction CLIs, quality arm, overfit ---
    p18 = import_chain_phase(dev, card, Path(tree_dir.name), p14["model_path"])
    q18 = quality_phase(dev, card, Path(tree_dir.name))
    tree_dir.cleanup()
    for name, row in synced["kernels"].items():
        results[name] = {**row, "bf16": {"launches": p17["launches"][f"{name}_bf16"]},
                         "per_step": synced["per_step"]}
    results["tsdf_integrate"]["bf"] = p16["tsdf"]
    results["ray_som"]["bf"] = p16["som"]
    results["bn_stats"]["bf_at_shapes"] = p16["k5_rows"]
    for name in b16:
        results[name]["bf16"]["launches_by_path"]["train_kitti"] = \
            p14["launches"][f"{name}_bf16"]
        results[name]["bf16"]["launches_by_path"]["eval"] = p15["launches"][f"{name}_bf16"]
        results[name]["bf16"]["launches_by_path"]["quality"] = q18["launches"][f"{name}_bf16"]

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
        **{k: ("scenerf_tpu_torch/ops/csrc/norm.cu", SYNC_REPLACES) for k in SYNC_KERNELS},
    }
    # launches: on the training path, for T the reconstruction path's, for
    # K5's synced stages phase 17's data-mode training (rank 0)
    main_launches = {**launches, "tsdf_integrate": recon_launches["tsdf_integrate"],
                     **{k: p17["launches"][k] for k in SYNC_KERNELS}}
    results["ray_som"]["empty_kernel_floor"] = floor
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "launches_by_path": {"serve": serve_launches.get(name, 0), "train": launches[name],
                              "reconstruction": recon_launches[name],
                              "train_kitti": p14["launches"][name],
                              "eval": p15["launches"][name],
                              **{k: v[name] for k, v in p16["launches"].items()},
                              "parallel": p17["launches"][name],
                              "chain": p18["launches"][name], "quality": q18["launches"][name],
                              "overfit": q18["overfit_launches"][name]},
         **results[name]}
        for name, (src, rep) in sources.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
