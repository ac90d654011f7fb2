"""Reconstruction entry points on the KITTI val split: render each frame's
novel-pose sweep (`generate-novel-depths`), then fuse it into a TSDF volume
(`depth2tsdf`, kernel T). File layout, options and skip-if-exists logic as
`scenerf_tpu/cli/reconstruction.py`:

    <recon_save_dir>/depth/<seq>/<frame>_<step>_<angle>.npy   full-res depth
    <recon_save_dir>/render_rgb/<seq>/<frame>_<step>_<angle>.png
    <recon_save_dir>/depth_visual/<seq>/<frame>_<step>_<angle>.png
    <recon_save_dir>/tsdf/<seq>/<frame>.npy                   [256, 256, 32]

    python -m scenerf_tpu_torch.cli.reconstruction generate-novel-depths \\
        --root ... --model_path model.pt --recon_save_dir out [--device cpu]
    python -m scenerf_tpu_torch.cli.reconstruction depth2tsdf \\
        --root ... --recon_save_dir out [--device cpu]

`--model_path` is the port's checkpoint (`utils/checkpoint.save_checkpoint`).
The BundleFusion variants are not ported yet.
"""
from __future__ import annotations

import os

import click
import numpy as np
import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.utils.checkpoint import load_model

SWEEP_CHUNK = 5000


@click.group()
def cli():
    """KITTI reconstruction: novel-pose sweeps and TSDF fusion."""


def _sweep_opts(f):
    for opt in reversed([click.option("--recon_save_dir", default=""),
                         click.option("--angle", default=10.0),
                         click.option("--step", default=0.5),
                         click.option("--max_distance", default=10.1)]):
        f = opt(f)
    return f


@cli.command("generate-novel-depths")
@common.add_opts(common.KITTI_OPTS)
@_sweep_opts
@click.option("--scale", default=2, help="render stride")
@common.DEVICE_OPT
def generate_novel_depths(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
                          frames_interval, recon_save_dir, angle, step, max_distance, scale,
                          device):
    """Render depth + RGB for the pose sweep on every val frame, upsampled to
    the full image size."""
    device = common.resolve_device(device)
    ds = common.kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval)
    rel_poses = geo.sample_rel_poses(step=step, angle=angle, max_distance=max_distance)
    pose_names = [f"_{s}_{a}" for (s, a) in rel_poses]
    poses = torch.from_numpy(geo.rel_pose_stack(rel_poses)).to(device)
    model = load_model(model_path, device)
    sphere_maps = {}  # per intrinsics: built on the host once

    for idx in range(len(ds)):
        item = ds[idx]
        frame_id, sequence = item["frame_id"], item["sequence"]
        dirs = {k: os.path.join(recon_save_dir, k, sequence)
                for k in ("depth", "depth_visual", "render_rgb")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        names = [f"{frame_id}{pn}" for pn in pose_names]
        if all(os.path.exists(os.path.join(dirs["depth"], n + ".npy"))
               and os.path.exists(os.path.join(dirs["depth_visual"], n + ".png"))
               and os.path.exists(os.path.join(dirs["render_rgb"], n + ".png"))
               for n in names):
            continue

        K = item["cam_K"]
        if K.tobytes() not in sphere_maps:
            sphere_maps[K.tobytes()] = model.compute_sphere_maps(K)
        levels = common.encode_frame(model, item["img_input"], K, sphere_maps[K.tobytes()])
        out = recon.render_sweep_full_res(model, model.pyramid_for_item(levels, 0),
                                          torch.from_numpy(K).to(device), poses, stride=scale,
                                          chunk=SWEEP_CHUNK, seed=idx * len(names))
        depths, colors = out["depth"].cpu().numpy(), out["color"].cpu().numpy()
        for pi, name in enumerate(names):
            np.save(os.path.join(dirs["depth"], name + ".npy"), depths[pi])
            common.save_color_png(os.path.join(dirs["render_rgb"], name + ".png"), colors[pi])
            common.save_depth_visual(os.path.join(dirs["depth_visual"], name + ".png"),
                                     depths[pi])
        print(f"saved sweep for frame {frame_id} ({len(names)} poses)")


def _load_sweep_frames(recon_save_dir, sequence, frame_id, rel_poses):
    """The sweep's saved depths, PNG colors (0..255 f32) and relative poses,
    skipping poses whose files are missing."""
    from PIL import Image

    depth_dir = os.path.join(recon_save_dir, "depth", sequence)
    rgb_dir = os.path.join(recon_save_dir, "render_rgb", sequence)
    depths, colors, poses = [], [], []
    for (step, angle), rel_pose in rel_poses.items():
        name = f"{frame_id}_{step}_{angle}"
        depth_path = os.path.join(depth_dir, name + ".npy")
        rgb_path = os.path.join(rgb_dir, name + ".png")
        if not (os.path.exists(depth_path) and os.path.exists(rgb_path)):
            continue
        depths.append(np.load(depth_path))
        colors.append(np.array(Image.open(rgb_path).convert("RGB"), np.float32))
        poses.append(np.asarray(rel_pose))
    return depths, colors, poses


@cli.command("depth2tsdf")
@common.add_opts(common.KITTI_OPTS)
@_sweep_opts
@common.DEVICE_OPT
def depth2tsdf(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
               frames_interval, recon_save_dir, angle, step, max_distance, device):
    """Fuse each val frame's rendered sweep into a TSDF volume: 256x256x32 at
    0.2 m, origin (0, -25.6, -2), camera pose inv(T_velo2cam) @ rel_pose."""
    device = common.resolve_device(device)
    ds = common.kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval)
    rel_poses = geo.sample_rel_poses(step=step, angle=angle, max_distance=max_distance)
    for idx in range(len(ds)):
        item = ds[idx]
        frame_id, sequence = item["frame_id"], item["sequence"]
        tsdf_dir = os.path.join(recon_save_dir, "tsdf", sequence)
        os.makedirs(tsdf_dir, exist_ok=True)
        tsdf_path = os.path.join(tsdf_dir, frame_id + ".npy")
        if os.path.exists(tsdf_path):
            continue
        depths, colors, poses = _load_sweep_frames(recon_save_dir, sequence, frame_id,
                                                   rel_poses)
        if not depths:
            continue
        vol = recon.fuse_kitti_sweep(torch.from_numpy(np.stack(depths)).to(device),
                                     torch.from_numpy(np.stack(colors)).to(device),
                                     item["cam_K"], item["T_velo_2_cam"], np.stack(poses))
        np.save(tsdf_path, vol.get_volume()[0])
        print("saved to", tsdf_path)


if __name__ == "__main__":
    cli()
