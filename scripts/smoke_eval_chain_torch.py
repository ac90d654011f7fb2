#!/usr/bin/env python
"""The PyTorch port's whole train -> eval -> reconstruction chain on a
synthetic KITTI tree, each stage a subprocess through the port's click
commands, with each stage's wall clock printed and summed: the counterpart
of scripts/run_eval_chain.sh + scripts/smoke_eval_chain.py.

Stages: tree (scripts/make_fake_kitti.py writes sequences 00 and 08 at
once; voxel GT, a road and a wall, on every 5th frame of 08 with the port's
io_voxel) -> train-kitti (bf16, 4 sources, STEPS steps, the full B7
preset) -> save-depth-metrics -> agg-depth-metrics -> render-colors ->
eval-color (no LPIPS: its weights come only from the user's paths) ->
generate-novel-depths -> depth2tsdf -> eval-sr. A stage that fails ends the
chain with its exit code.

    python scripts/smoke_eval_chain_torch.py [--workdir DIR] [--device cuda:0]

The tree has FRAMES frames a sequence; the sweep reaches MAX_DISTANCE m
(9 of the CLI's 63 poses) at stride 2. --workdir (default build/eval_chain
in the checkout) must be empty or absent.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FRAMES, STEPS, STRIDE = 24, 25, 2
MAX_DISTANCE = 1.1


def write_voxel_gt(root: str, frames: int, sequence: str = "08") -> None:
    """A road layer at z ~ -1.7 m and a building wall at y ~ +8 m on every
    5th frame (the val split anchors on voxels/*.bin)."""
    from scenerf_tpu_torch.data import io_voxel

    vox_dir = os.path.join(root, "dataset", "sequences", sequence, "voxels")
    os.makedirs(vox_dir, exist_ok=True)
    grid = np.zeros((256, 256, 32), np.uint16)
    grid[:, :, 1:3] = 40
    grid[:, 168:173, 1:12] = 50
    labels = grid.reshape(-1)
    for i in range(0, frames, 5):
        labels.tofile(f"{vox_dir}/{i:06d}.label")
        io_voxel.pack(np.zeros(labels.size, np.uint8)).tofile(f"{vox_dir}/{i:06d}.invalid")
        io_voxel.pack((labels > 0).astype(np.uint8)).tofile(f"{vox_dir}/{i:06d}.bin")


class Chain:
    """Runs the stages in order, timing each; the first failure exits."""

    def __init__(self):
        self.stage_s = {}

    def run(self, name: str, *cmds) -> None:
        print(f"\n==== {name} ====", flush=True)
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, *c], cwd=REPO) for c in cmds]
        rcs = [p.wait() for p in procs]
        self.stage_s[name] = round(time.time() - t0, 1)
        if any(rcs):
            print(f"CHAIN FAILED at {name}: exit codes {rcs}", flush=True)
            sys.exit(next(rc for rc in rcs if rc))
        print(f"==== {name}: {self.stage_s[name]} s ====", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "eval_chain"))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    work = os.path.abspath(args.workdir)
    if os.path.isdir(work) and os.listdir(work):
        ap.error(f"--workdir {work} is not empty")
    root, prep, run = (os.path.join(work, d) for d in ("kitti", "preprocess", "run"))
    evals, recon = os.path.join(work, "eval"), os.path.join(work, "recon")
    chain = Chain()

    tree = os.path.join(REPO, "scripts", "make_fake_kitti.py")
    chain.run("tree", *([tree, "--root", root, "--frames", str(FRAMES), "--sequence", s]
                        for s in ("00", "08")))
    write_voxel_gt(root, FRAMES)

    train = ["-m", "scenerf_tpu_torch.cli.train", "train-kitti", "--root", root,
             "--preprocess_root", prep, "--logdir", run, "--n_epochs", "1",
             "--max_steps_per_epoch", str(STEPS), "--sequence_distance", "2.0",
             "--frames_interval", "0.4", "--enable_log", "True", "--compute_dtype", "bfloat16",
             "--n_sources", "4", "--exp_prefix", "smoke", "--sequences", "00",
             "--device", args.device]
    chain.run("train-kitti", train)
    (exp,) = os.listdir(os.path.join(run, "ckpts"))
    ckpt = os.path.join(run, "ckpts", exp)

    ev = ["-m", "scenerf_tpu_torch.cli.evaluation"]
    rc = ["-m", "scenerf_tpu_torch.cli.reconstruction"]
    data = ["--root", root, "--preprocess_root", prep, "--model_path", ckpt,
            "--sequence_distance", "2.0", "--frames_interval", "0.4"]
    dev = ["--device", args.device]
    sweep = ["--angle", "10.0", "--step", "0.5", "--max_distance", str(MAX_DISTANCE)]
    chain.run("save-depth-metrics", ev + ["save-depth-metrics", *data, "--eval_save_dir", evals,
                                          *dev])
    chain.run("agg-depth-metrics", ev + ["agg-depth-metrics", "--eval_save_dir", evals])
    chain.run("render-colors", ev + ["render-colors", *data, "--eval_save_dir", evals, *dev])
    chain.run("eval-color", ev + ["eval-color", "--eval_save_dir", evals, *dev])
    chain.run("generate-novel-depths", rc + ["generate-novel-depths", *data, "--eval_save_dir",
                                             evals, "--recon_save_dir", recon, "--scale",
                                             str(STRIDE), *sweep, *dev])
    chain.run("depth2tsdf", rc + ["depth2tsdf", *data, "--eval_save_dir", evals,
                                  "--recon_save_dir", recon, *sweep, *dev])
    chain.run("eval-sr", ev + ["eval-sr", *data, "--eval_save_dir", evals,
                               "--recon_save_dir", recon])
    total = round(sum(chain.stage_s.values()), 1)
    print("\nSTAGE WALL-CLOCK: " + json.dumps({**chain.stage_s, "total": total}), flush=True)
    print("EVAL CHAIN COMPLETE", flush=True)
    return chain.stage_s


if __name__ == "__main__":
    main()
