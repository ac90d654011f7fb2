#!/usr/bin/env python
"""Training quality of the PyTorch port: f32 against bf16 at 1, 2, 4 or 8
sources, the protocol of scripts/quality_runs.py.

Trains the full B7 KITTI model (`config.kitti(n_sources=n, ray_chunk=1200,
n_gt_depth=256, compute_dtype=...)`) on a synthetic KITTI tree
(scripts/make_fake_kitti.py; voxel stubs are written for the val split
where sequence 08 has none) for --steps steps per arm through
`train.Trainer.train_step`, and evaluates the val depth abs_rel and rmse
(`Trainer.depth_eval_step`, averaged over min(4, len(val)) val items) at
step 0, every --val_every steps and at the end. Writes the trajectories as
JSON after each arm (keys `steps`, `val_abs_rel`, `val_rmse`, `train_loss`,
`wall_s`, which scripts/quality_table.py reads; also `frame_ids`, the batch's
frame per step, and `peak_gib`, the arm's peak device memory).

The arms of one seed are matched: each starts from the same f32 weights
(`torch.manual_seed(seed)`), reads the same batches in the same order (the
datasets and the loader seeded with `seed`), draws the same training noise
(the trainer's generator seeded with seed + 1) and the same val noise (val
item i from a generator seeded 1000 + i). Only the compute dtype and the
number of sources differ. The seeds run in turn, every arm of a seed before
the next seed. TF32 is off, so the f32 arm computes in f32. An arm that
does not fit on the device raises its out-of-memory error after the arms
before it are written.

Usage (one H100; the tree ~2 GB):
    python scripts/make_fake_kitti.py --root T --frames 120 --sequence 00
    python scripts/make_fake_kitti.py --root T --frames 40 --sequence 08
    python scripts/quality_runs_torch.py --root T --steps 300 --out q.json \\
        --configs bf16x4,f32x4 --seeds 42
    python scripts/quality_table.py q.json
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VAL_ITEMS = 4  # val items averaged at each evaluation
VAL_SEED = 1000  # val item i draws from a generator seeded VAL_SEED + i


def write_val_voxel_anchors(root: str, sequence: str = "08", n: int = 40) -> bool:
    """The val split anchors on voxels/*.bin; where the sequence has no
    voxel files, emit packed occupancy stubs (a road layer) on every 5th
    frame below `n`. A voxels directory that holds any file (a real
    SemanticKITTI tree, or one made with make_fake_kitti.py --val) is left
    as it is. Returns whether the stubs were written."""
    from scenerf_tpu_torch.data import io_voxel

    vox_dir = os.path.join(root, "dataset/sequences", sequence, "voxels")
    if os.path.isdir(vox_dir) and os.listdir(vox_dir):
        return False
    os.makedirs(vox_dir, exist_ok=True)
    labels = np.zeros((256 * 256 * 32,), np.uint16)
    labels[: 256 * 256 * 2] = 40
    invalid = np.zeros(256 * 256 * 32, np.uint8)
    for i in range(0, n, 5):
        labels.tofile(f"{vox_dir}/{i:06d}.label")
        io_voxel.pack(invalid).tofile(f"{vox_dir}/{i:06d}.invalid")
        io_voxel.pack((labels > 0).astype(np.uint8)).tofile(f"{vox_dir}/{i:06d}.bin")
    return True


def make_cfg(dtype: str, n_sources: int):
    from scenerf_tpu_torch import config as C

    return C.kitti(n_sources=n_sources, ray_chunk=1200, n_gt_depth=256, compute_dtype=dtype)


def arm_grid() -> dict:
    """The arms by tag: f32 and bf16 at 1, 2, 4 and 8 sources."""
    return {f"{d}x{n}": make_cfg(dtype, n)
            for n in (1, 2, 4, 8) for d, dtype in (("bf16", "bfloat16"), ("f32", "float32"))}


def run_one(tag, cfg, root, prep, steps, val_every, seed=42, device="cuda:0", log=print):
    """Train one arm; its trajectory."""
    import torch

    from scenerf_tpu_torch.data.kitti import KittiDataset, to_model_batch
    from scenerf_tpu_torch.data.loader import DataLoader
    from scenerf_tpu_torch.model import SceneRF
    from scenerf_tpu_torch.train import Trainer

    device = torch.device(device)
    torch.manual_seed(seed)
    trainer = Trainer(cfg, device=device, steps_per_epoch=1000, model=SceneRF(cfg),
                      seed=seed + 1)
    kw = dict(sequence_distance=10.0, frames_interval=0.4, n_sources=cfg.n_sources,
              n_rays=cfg.n_gt_depth, seed=seed)
    train_ds = KittiDataset("train", root, prep, sequences=["00"], **kw)
    val_ds = KittiDataset("val", root, prep, **kw)

    def collate(items):
        return to_model_batch(items, cfg), [f"{it['sequence']}/{it['frame_id']}" for it in items]

    loader = DataLoader(train_ds, collate, batch_size=1, shuffle=True, seed=seed)
    val_batches = [collate([val_ds[i]])[0] for i in range(min(VAL_ITEMS, len(val_ds)))]
    log(f"[{tag}] train scans={len(train_ds)} val scans={len(val_ds)}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def run_val():
        sums = None
        for bi, vb in enumerate(val_batches):
            m = trainer.depth_eval_step(vb, torch.Generator().manual_seed(VAL_SEED + bi))
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return {k: float(v) / len(val_batches) for k, v in sums.items()}

    hist = {"steps": [], "val_abs_rel": [], "val_rmse": [], "train_loss": [], "frame_ids": []}

    def record(step, v, loss):
        hist["steps"].append(step)
        hist["val_abs_rel"].append(v["depth/abs_rel"])
        hist["val_rmse"].append(v["depth/rmse"])
        hist["train_loss"].append(loss)

    t0 = time.time()
    v0 = run_val()
    record(0, v0, float("nan"))
    log(f"[{tag}] step 0 val abs_rel {v0['depth/abs_rel']:.4f}")
    step = 0
    it = iter(loader)
    while step < steps:
        try:
            batch, ids = next(it)
        except StopIteration:
            it = iter(loader)
            continue
        metrics = trainer.train_step(batch)
        hist["frame_ids"].append(ids)
        step += 1
        if step % val_every == 0 or step == steps:
            v = run_val()
            loss = float(metrics["total_loss"])
            record(step, v, loss)
            log(f"[{tag}] step {step} loss {loss:.4f} val abs_rel {v['depth/abs_rel']:.4f} "
                f"({time.time() - t0:.0f}s)")
    it.close()  # stops the loader's thread
    hist["wall_s"] = round(time.time() - t0, 1)
    hist["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else None)
    return hist


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="KITTI tree (make_fake_kitti.py)")
    ap.add_argument("--prep", default=None, help="preprocess root (ICP); default ROOT/preprocess")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--val_every", type=int, default=50)
    ap.add_argument("--out", required=True, help="JSON output")
    ap.add_argument("--configs", default="bf16x1,f32x1,bf16x2,f32x2")
    ap.add_argument("--seeds", default="42",
                    help="comma list; more than one appends @s<seed> to each tag")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    from scenerf_tpu_torch.ops.build import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = arm_grid()
    tags = args.configs.split(",")
    unknown = [t for t in tags if t not in grid]
    if unknown:
        ap.error(f"unknown arms {unknown}: one of {sorted(grid)}")
    prep = args.prep or os.path.join(args.root, "preprocess")
    if not write_val_voxel_anchors(args.root):
        print("sequence 08 has voxel files: the val split anchors on them", flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    results = {}
    for seed in seeds:
        for tag in tags:
            k = tag if len(seeds) == 1 else f"{tag}@s{seed}"
            results[k] = run_one(k, grid[tag], args.root, prep, args.steps, args.val_every,
                                 seed=seed, device=device, log=lambda s: print(s, flush=True))
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
            print(f"wrote {args.out}", flush=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
