"""The reconstruction chain as plain functions on tensors, shared by the CLI
(`cli/reconstruction.py`, `cli/evaluation.py`) and `chip_smoke.py`: render
a frame's pose sweep, upsample it to full resolution, fuse it into the KITTI
or BundleFusion TSDF grid (kernel T) and score the KITTI occupancy against
the voxel GT.
Counterpart of `scenerf_tpu/cli/reconstruction.py:25-119,172-213` and
`scenerf_tpu/cli/evaluation.py:450-465`. The sweep runs in the model's
compute dtype (a checkpoint's config carries it: bf16 encodes and fields
for `compute_dtype="bfloat16"`); its depth and color come out f32, so the
upsampling and kernel T take f32 as before.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.fusion.tsdf import TSDFVolume, tsdf2occ
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

# the KITTI grid: 256 x 256 x 32 voxels of 0.2 m in front of the LiDAR
KITTI_SCENE_SIZE = np.array([51.2, 51.2, 6.4])
KITTI_VOX_ORIGIN = np.array([0, -25.6, -2])
KITTI_VOXEL_SIZE = 0.2
KITTI_TRUNC_MARGIN = 10.0
# the BundleFusion grid: 120 x 120 x 96 voxels of 0.04 m around the camera
BF_SCENE_SIZE = np.array([4.8, 4.8, 3.84])
BF_VOX_ORIGIN = np.array([-2.4, -2.4, 0.0])
BF_VOXEL_SIZE = 0.04
BF_TRUNC_MARGIN = 10.0


def upsample_to(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample (align_corners=False, no antialiasing) of [h, w] or
    [h, w, C] to [H, W] or [H, W, C]. It stands in for `jax.image.resize`,
    which drops out-of-range taps and renormalizes where torch clamps the
    index: upsampling, both give the border pixel there."""
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                        antialias=False)
    return out[0, 0] if img.dim() == 2 else out[0].permute(1, 2, 0).contiguous()


def render_sweep_full_res(model: SceneRF, pyramid: R.Pyramid, cam_K: torch.Tensor,
                          poses: torch.Tensor, stride: int = 2, chunk: int = 5000,
                          seed: int = 0, sweep=None) -> Optional[Dict[str, torch.Tensor]]:
    """`render_pose_sweep` at `stride` (or `sweep`, a
    `parallel.sharded_render.make_sharded_pose_sweep` of the same stride and
    chunk), then each pose's depth and color upsampled to the image size:
    depth [P, H, W], color [P, H, W, 3]; None where `sweep` gives None (a
    rank other than 0)."""
    if sweep is None:
        out = model.render_pose_sweep(pyramid, cam_K, poses, seed=seed, stride=stride,
                                      ray_chunk=chunk)
    else:
        out = sweep(pyramid, cam_K, poses, seed)
    if out is None or stride == 1:
        return out
    W, H = model.cfg.img_size
    return {k: torch.stack([upsample_to(x, (H, W)) for x in v]) for k, v in out.items()}


def quantize_colors(color: torch.Tensor) -> torch.Tensor:
    """Colors in [0, 1] -> the 0..255 integer values the CLI's PNGs store
    (`(clip(color, 0, 1) * 255).astype(uint8)`), as f32."""
    return (torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8).to(torch.float32)


def kitti_volume(device, mode: str = "closest") -> TSDFVolume:
    """An empty KITTI TSDF volume on `device`."""
    bnds = np.stack([KITTI_VOX_ORIGIN, KITTI_VOX_ORIGIN + KITTI_SCENE_SIZE], axis=1)
    return TSDFVolume(bnds, voxel_size=KITTI_VOXEL_SIZE, trunc_margin=KITTI_TRUNC_MARGIN,
                      mode=mode, device=device)


def bf_volume(device) -> TSDFVolume:
    """An empty BundleFusion TSDF volume on `device`."""
    bnds = np.stack([BF_VOX_ORIGIN, BF_VOX_ORIGIN + BF_SCENE_SIZE], axis=1)
    return TSDFVolume(bnds, voxel_size=BF_VOXEL_SIZE, trunc_margin=BF_TRUNC_MARGIN,
                      device=device)


def fuse_kitti_sweep(depths: torch.Tensor, colors: torch.Tensor, cam_K: np.ndarray,
                     T_velo_2_cam: np.ndarray, rel_poses: np.ndarray,
                     mode: str = "closest") -> TSDFVolume:
    """Fuse a frame's sweep, depths [F, H, W] and colors [F, H, W, 3] (0..255)
    rendered at the relative poses [F, 4, 4], into the KITTI grid on the
    depths' device (kernel T on the card): the camera -> LiDAR-world pose of
    each is inv(T_velo_2_cam) @ rel_pose, in numpy as the JAX package."""
    vol = kitti_volume(depths.device, mode)
    cam_poses = np.stack([np.linalg.inv(T_velo_2_cam) @ np.asarray(p) for p in rel_poses])
    vol.integrate_frames(colors, depths, np.tile(np.asarray(cam_K)[None], (len(cam_poses), 1, 1)),
                         cam_poses)
    return vol


def eval_sr_frame(tsdf: np.ndarray, target: np.ndarray, fov_mask: np.ndarray,
                  metric: SSCMetrics, fov_metric: SSCMetrics) -> np.ndarray:
    """Threshold a frame's TSDF to occupancy, cap it at the GT's highest
    occupied voxel (the LiDAR's height), and add it to the whole-scene and
    in-FOV metrics. Returns the occupancy."""
    t = np.copy(target)
    t[target == 255] = 0
    max_z = t.nonzero()[2].max()
    occ = tsdf2occ(tsdf, 0.25, 6.0)
    occ[:, :, max_z:] = 0
    metric.add_batch(occ[None], target[None])
    fov_metric.add_batch(occ[None], target[None], fov_mask.reshape(target.shape)[None])
    return occ
