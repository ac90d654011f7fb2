"""Reconstruction entry points on the KITTI and BundleFusion val splits:
render each frame's novel-pose sweep (`generate-novel-depths`,
`generate-novel-depths-bf`), then fuse it into a TSDF volume (`depth2tsdf`,
`depth2tsdf-bf`, kernel T); fuse BundleFusion's GT depth maps into the GT
occupancy (`generate-sc-gt-bf`); print a camera's spherical angles
(`determine-angles`). File layout, options and skip-if-exists logic as
`scenerf_tpu/cli/reconstruction.py`:

    <recon_save_dir>/depth/<seq>/<frame>_<step>_<angle>.npy   full-res depth
    <recon_save_dir>/render_rgb/<seq>/<frame>_<step>_<angle>.png
    <recon_save_dir>/depth_visual/<seq>/<frame>_<step>_<angle>.png
    <recon_save_dir>/tsdf/<seq>/<frame>.npy    KITTI [256, 256, 32]
    <recon_save_dir>/tsdf/<seq>/<frame>.pkl    BF {tsdf_grid [120, 120, 96], mesh}
    <recon_save_dir>/sc_gt/<seq>/<frame>.pkl   BF {tsdf_grid, occ}

    python -m scenerf_tpu_torch.cli.reconstruction generate-novel-depths \\
        --root ... --model_path model.pt --recon_save_dir out [--device cpu]
    python -m scenerf_tpu_torch.cli.reconstruction depth2tsdf \\
        --root ... --recon_save_dir out [--device cpu]
    python -m scenerf_tpu_torch.cli.reconstruction generate-novel-depths-bf \\
        --root BF --model_path model.pt --recon_save_dir out [--device cpu]
    (likewise depth2tsdf-bf and generate-sc-gt-bf, without --model_path)

The BundleFusion sweep's file names carry the step and angle with two
decimals (`000016_0.20_-30.00`). Under torchrun, `--n_devices N` (0: every
rank) splits each pose's rays of the two sweep commands over the first N
ranks (`parallel/sharded_render.py`): rank 0 reads the frame and decides the
skip, every rank encodes it and renders its rows, rank 0 gathers and writes;
the fuse, mesh and GT-fuse commands run on one rank, as in JAX.
`--model_path` is the port's checkpoint (`utils/checkpoint.save_checkpoint`,
or a `CheckpointManager` directory).
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Dict

import click
import numpy as np
import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.cli.evaluation import BF_WINDOW_OPTS, bf_val_ds
from scenerf_tpu_torch.fusion.tsdf import tsdf_to_gt_occupancy
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.parallel import dist as D
from scenerf_tpu_torch.parallel.sharded_render import make_sharded_pose_sweep
from scenerf_tpu_torch.utils.checkpoint import load_model

SWEEP_CHUNK = 5000


@click.group()
def cli():
    """KITTI and BundleFusion reconstruction: novel-pose sweeps, TSDF fusion
    and BundleFusion's GT occupancy."""


def _sweep_opts(f):
    for opt in reversed([click.option("--recon_save_dir", default=""),
                         click.option("--angle", default=10.0),
                         click.option("--step", default=0.5),
                         click.option("--max_distance", default=10.1)]):
        f = opt(f)
    return f


def _generate_novel_depths_impl(ds, model: SceneRF, recon_save_dir: str, scale: int,
                                rel_poses: Dict, group=None) -> Dict:
    """Render each val frame's sweep (`rel_poses`: {(step, angle): 4x4},
    the keys naming the files) at stride `scale`, upsampled to the image
    size; a frame whose files all exist is skipped. Pose p of frame idx
    draws its noise from a generator seeded idx * P + p. Returns the frames
    done and, per frame, the seconds of the encode, of the sweep's renders
    and upsampling (each ended by a synchronize), and of the file writes.
    `group`: the ranks that split each pose's rays (rank 0 reads, decides,
    writes and returns the record; the module docstring)."""
    device = next(model.parameters()).device
    pose_names = [f"_{s}_{a}" for (s, a) in rel_poses]
    poses = torch.from_numpy(geo.rel_pose_stack(rel_poses)).to(device)
    sweep = (None if group is None
             else make_sharded_pose_sweep(model, group, stride=scale, ray_chunk=SWEEP_CHUNK))
    lead = D.rank(group) == 0
    sphere_maps = {}  # per intrinsics: built on the host once
    done = {"frames": [], "encode_s": [], "render_s": [], "write_s": []}
    for idx in range(len(ds)):
        item = None
        if lead:
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
                item = None
        # rank 0's frame (or skip) on every rank
        job = D.broadcast_object(None if item is None else {
            "img_input": item["img_input"], "cam_K": item["cam_K"]}, group)
        if job is None:
            continue

        t0 = time.perf_counter()
        K = job["cam_K"]
        if K.tobytes() not in sphere_maps:
            sphere_maps[K.tobytes()] = model.compute_sphere_maps(K)
        levels = common.encode_frame(model, job["img_input"], K, sphere_maps[K.tobytes()])
        t1 = common.synced_clock(device)
        out = recon.render_sweep_full_res(model, model.pyramid_for_item(levels, 0),
                                          torch.from_numpy(K).to(device), poses, stride=scale,
                                          chunk=SWEEP_CHUNK, seed=idx * len(pose_names),
                                          sweep=sweep)
        if not lead:
            continue
        depths, colors = out["depth"].cpu().numpy(), out["color"].cpu().numpy()
        t2 = time.perf_counter()
        for pi, name in enumerate(names):
            np.save(os.path.join(dirs["depth"], name + ".npy"), depths[pi])
            common.save_color_png(os.path.join(dirs["render_rgb"], name + ".png"), colors[pi])
            common.save_depth_visual(os.path.join(dirs["depth_visual"], name + ".png"),
                                     depths[pi])
        print(f"saved sweep for frame {frame_id} ({len(names)} poses)")
        done["frames"].append(frame_id)
        done["encode_s"].append(t1 - t0)
        done["render_s"].append(t2 - t1)
        done["write_s"].append(time.perf_counter() - t2)
    return done


@cli.command("generate-novel-depths")
@common.add_opts(common.KITTI_OPTS)
@_sweep_opts
@click.option("--scale", default=2, help="render stride")
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def generate_novel_depths(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
                          frames_interval, recon_save_dir, angle, step, max_distance, scale,
                          n_devices, device, dist_backend):
    """Render depth + RGB for the pose sweep on every val frame, upsampled to
    the full image size."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None
    ds = common.kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval)
    rel_poses = geo.sample_rel_poses(step=step, angle=angle, max_distance=max_distance)
    return _generate_novel_depths_impl(ds, load_model(model_path, device), recon_save_dir,
                                       scale, rel_poses, group=group)


def bf_rel_poses(angle: float, step: float, max_distance: float) -> Dict:
    """BundleFusion's sweep keyed by its two-decimal (step, angle) names."""
    return {(f"{s:.2f}", f"{a:.2f}"): p for (s, a), p in geo.sample_rel_poses_bf(
        angle=angle, max_distance=max_distance, step=step).items()}


def _bf_sweep_opts(f):
    for opt in reversed([click.option("--recon_save_dir", default=""),
                         click.option("--angle", default=30.0),
                         click.option("--step", default=0.2),
                         click.option("--max_distance", default=2.1),
                         *BF_WINDOW_OPTS]):
        f = opt(f)
    return f


@cli.command("generate-novel-depths-bf")
@click.option("--root", default="")
@click.option("--model_path", default="")
@click.option("--scale", default=2, help="render stride")
@_bf_sweep_opts
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def generate_novel_depths_bf(root, model_path, scale, recon_save_dir, angle, step,
                             max_distance, frame_interval, n_frames, n_devices, device,
                             dist_backend):
    """Render depth + RGB for BundleFusion's pose sweep (steps of 0.2 m up to
    2.1 m, yaw 0, -30, +30 degrees) on every val frame, upsampled to 640x480."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None
    return _generate_novel_depths_impl(bf_val_ds(root, frame_interval, n_frames, n_sources=0),
                                       load_model(model_path, device), recon_save_dir, scale,
                                       bf_rel_poses(angle, step, max_distance), group=group)


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


@cli.command("depth2tsdf-bf")
@click.option("--root", default="")
@_bf_sweep_opts
@common.DEVICE_OPT
def depth2tsdf_bf(root, recon_save_dir, angle, step, max_distance, frame_interval, n_frames,
                  device):
    """Fuse each BundleFusion val frame's rendered sweep into a TSDF volume:
    120x120x96 at 0.04 m, origin (-2.4, -2.4, 0), camera pose = rel_pose,
    the depth intrinsics; pickle the grid and its marching-cubes mesh
    (vertices, faces, normals, colors). Returns the frames done and, per
    frame, the seconds of the fuse (ended by a synchronize) and of the mesh,
    and the mesh's vertex count."""
    device = common.resolve_device(device)
    ds = bf_val_ds(root, frame_interval, n_frames, n_sources=0)
    rel_poses = bf_rel_poses(angle, step, max_distance)
    done = {"frames": [], "fuse_s": [], "mesh_s": [], "verts": []}
    for scan in ds.scans:
        frame_id, sequence = scan["frame_id"], scan["sequence"]
        tsdf_dir = os.path.join(recon_save_dir, "tsdf", sequence)
        os.makedirs(tsdf_dir, exist_ok=True)
        tsdf_path = os.path.join(tsdf_dir, frame_id + ".pkl")
        if os.path.exists(tsdf_path):
            continue
        depths, colors, poses = _load_sweep_frames(recon_save_dir, sequence, frame_id,
                                                   rel_poses)
        if not depths:
            continue
        t0 = common.synced_clock(device)
        vol = recon.bf_volume(device)
        cam_K = scan["cam_K_depth"].astype(np.float32)
        vol.integrate_frames(torch.from_numpy(np.stack(colors)).to(device),
                             torch.from_numpy(np.stack(depths)).to(device),
                             np.tile(cam_K[None], (len(depths), 1, 1)), np.stack(poses))
        t1 = common.synced_clock(device)
        verts, faces, norms, colors_v = vol.get_mesh()
        tsdf_grid, _ = vol.get_volume()
        t2 = time.perf_counter()
        with open(tsdf_path, "wb") as f:
            pickle.dump({"tsdf_grid": tsdf_grid, "verts": verts, "faces": faces,
                         "norms": norms, "colors": colors_v}, f)
        print("wrote to", tsdf_path)
        done["frames"].append(frame_id)
        done["fuse_s"].append(t1 - t0)
        done["mesh_s"].append(t2 - t1)
        done["verts"].append(len(verts))
    return done


@cli.command("generate-sc-gt-bf")
@click.option("--root", default="")
@click.option("--recon_save_dir", default="")
@common.add_opts(BF_WINDOW_OPTS)
@common.DEVICE_OPT
def generate_sc_gt_bf(root, recon_save_dir, frame_interval, n_frames, device):
    """BundleFusion's GT occupancy per val frame: the GT depth maps of every
    source, at their native resolution, fused into the BundleFusion grid
    (depth intrinsics, pose T_source2infer); 255 unknown, 0 free, 1 within a
    voxel of the surface. Returns the frames done and, per frame, the
    seconds of the fuse (ended by a synchronize)."""
    device = common.resolve_device(device)
    ds = bf_val_ds(root, frame_interval, n_frames)
    done = {"frames": [], "fuse_s": []}
    for idx, scan in enumerate(ds.scans):
        gt_dir = os.path.join(recon_save_dir, "sc_gt", scan["sequence"])
        os.makedirs(gt_dir, exist_ok=True)
        gt_path = os.path.join(gt_dir, scan["frame_id"] + ".pkl")
        if os.path.exists(gt_path):
            continue
        item = ds[idx]
        n = len(item["img_sources"])
        t0 = common.synced_clock(device)
        vol = recon.bf_volume(device)
        vol.integrate_frames(
            torch.from_numpy(np.stack(item["img_sources"]) * np.float32(255.0)).to(device),
            torch.from_numpy(np.stack(item["source_depths"])).to(device),
            np.tile(item["cam_K_depth"][None], (n, 1, 1)), np.stack(item["T_source2infers"]))
        tsdf_grid, _ = vol.get_volume()
        done["fuse_s"].append(common.synced_clock(device) - t0)
        occ = tsdf_to_gt_occupancy(tsdf_grid, recon.BF_VOXEL_SIZE)
        with open(gt_path, "wb") as f:
            pickle.dump({"tsdf_grid": tsdf_grid, "occ": occ.astype(np.uint8)}, f)
        print("wrote to", gt_path)
        done["frames"].append(scan["frame_id"])
    return done


@cli.command("determine-angles")
@click.option("--img_w", default=1220)
@click.option("--img_h", default=370)
@click.option("--fx", default=707.0912)
@click.option("--fy", default=707.0912)
@click.option("--cx", default=601.8873)
@click.option("--cy", default=183.1104)
def determine_angles(img_w, img_h, fx, fy, cx, cy):
    """FOV calibration: the min / max spherical angles of a camera's pixel
    grid (defaults: KITTI's camera)."""
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    out = geo.determine_angles(np.linalg.inv(K), img_w, img_h)
    for k, v in out.items():
        print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    cli()
