"""Host-side KITTI IO in numpy: calibration, odometry poses, RGB frames,
LiDAR scans and their projection into depth, and the voxel -> pixel mapping.
The port's own copy of `scenerf_tpu/data/calib.py`. PIL is imported inside
`read_rgb` only.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def read_rgb(path: str, crop_hw: Tuple[int, int] = (370, 1220)) -> np.ndarray:
    """RGB [H, W, 3] f32 in [0, 1], cropped to the KITTI training size."""
    from PIL import Image

    img = np.array(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    return img[: crop_hw[0], : crop_hw[1], :]


def normalize_rgb(img: np.ndarray) -> np.ndarray:
    """ImageNet normalization, channel-last."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def read_poses(path: str) -> List[np.ndarray]:
    """KITTI odometry poses file -> list of 4x4 cam0->world transforms (f64)."""
    poses = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            T = np.array(line.split(), dtype=np.float64).reshape(3, 4)
            poses.append(np.vstack([T, [0, 0, 0, 1]]))
    return poses


def read_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """KITTI calib.txt -> {P2, Tr, T_cam0_2_cam2} (f64)."""
    raw = {}
    with open(calib_path) as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            raw[key] = np.array([float(x) for x in value.split()])
    out = {"P2": raw["P2"].reshape(3, 4), "Tr": np.eye(4)}
    out["Tr"][:3, :4] = raw["Tr"].reshape(3, 4)
    T2 = np.eye(4)
    T2[0, 3] = out["P2"][0, 3] / out["P2"][0, 0]
    out["T_cam0_2_cam2"] = T2
    return out


def dump_xyz(T: np.ndarray) -> np.ndarray:
    return T[0:3, 3]


def apply_transform(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    homo = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    return (T @ homo.T).T[:, :3]


def lidar_to_depth(lidar_points: np.ndarray, P: np.ndarray, T_velo_2_cam: np.ndarray,
                   image_size: Tuple[int, int], max_depth: float = 80.0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project LiDAR [N, >=3] (velodyne xyz) through T_velo_2_cam and P's
    [3, 3] block into an image of (W, H): (pixels [M, 2] int, depths [M],
    camera points [M, 3]) of the forward points with 0 < depth <= max_depth
    whose rounded pixel lies strictly inside the image (x > 0 and y > 0:
    row and column 0 are dropped, as the reference drops them)."""
    pts = lidar_points[:, :3]
    cam = apply_transform(pts[pts[:, 0] > 0], T_velo_2_cam)
    cam = cam[(cam[:, 2] > 0) & (cam[:, 2] <= max_depth)]
    img_pts = (P[:3, :3] @ cam.T).T
    img_pts = np.round(img_pts[:, :2] / img_pts[:, 2:3]).astype(int)
    W, H = image_size
    inb = (img_pts[:, 0] > 0) & (img_pts[:, 1] > 0) & (img_pts[:, 0] < W) & (img_pts[:, 1] < H)
    return img_pts[inb], cam[inb][:, 2], cam[inb]


def read_lidar(path: str) -> np.ndarray:
    """A velodyne scan: [N, 4] f32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def vox2pix(cam_E: np.ndarray, cam_K: np.ndarray, vox_origin: np.ndarray, voxel_size: float,
            img_W: int, img_H: int, scene_size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pixel of every voxel centroid [N, 2] int64, its FOV mask [N] and its
    camera depth [N], over the flattened [X, Y, Z] grid."""
    vox_origin = np.asarray(vox_origin, dtype=np.float32)
    vol_dim = np.ceil(np.asarray(scene_size) / voxel_size).astype(int)
    xv, yv, zv = np.meshgrid(*(np.arange(d) for d in vol_dim), indexing="ij")
    coords = np.stack([xv, yv, zv], axis=-1).reshape(-1, 3).astype(np.float32)
    world = vox_origin[None] + coords * voxel_size
    cam = apply_transform(world, cam_E)
    z = cam[:, 2]
    safe_z = np.where(z != 0, z, 1.0)
    fx, fy = cam_K[0, 0], cam_K[1, 1]
    cx, cy = cam_K[0, 2], cam_K[1, 2]
    pix = np.stack(
        [np.round(cam[:, 0] * fx / safe_z + cx),
         np.round(cam[:, 1] * fy / safe_z + cy)], axis=-1
    ).astype(np.int64)
    fov_mask = (pix[:, 0] >= 0) & (pix[:, 0] < img_W) & \
               (pix[:, 1] >= 0) & (pix[:, 1] < img_H) & (z > 0)
    return pix, fov_mask, z
