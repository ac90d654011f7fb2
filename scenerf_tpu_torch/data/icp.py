"""ICP refinement of KITTI's relative poses, and its on-disk cache. The
port's own copy of `scenerf_tpu/data/icp.py`.

Each source frame's odometry transforms to the input frame (infer) and to
the frame before it (target) are refined by point-to-point ICP on the LiDAR
clouds in the cam2 frame: each cloud voxel-downsampled at 0.05 m, max
correspondence 0.2 m, 200 iterations, from identity on the pre-transformed
source. The registration runs in the port's C++ (`native/icp.cpp`, built by
`native/build.py`). The cache is a pickle per input frame at
`{preprocess}/transform/{seq}_{interval}_all/{frame}.pkl`, a dict keyed by
the source id as a string, the JAX package's layout: a preprocess tree that
either package filled is read by the other.
"""
from __future__ import annotations

import ctypes
import os
import pickle
from typing import Callable, Dict

import numpy as np

from scenerf_tpu_torch.data.calib import apply_transform, read_lidar
from scenerf_tpu_torch.native.build import load

VOXEL = 0.05


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """The mean of the points in each occupied voxel cell, cells in
    lexicographic order, f32."""
    coords = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(coords, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inv.reshape(-1), points)
    return (sums / counts[:, None]).astype(np.float32)


def icp_point_to_point(source: np.ndarray, target: np.ndarray, max_correspondence: float = 0.2,
                       max_iteration: int = 200) -> np.ndarray:
    """The 4x4 f64 transform that aligns `source` [N, 3] onto `target` [M, 3]."""
    lib = load()
    fp = ctypes.POINTER(ctypes.c_float)
    src = np.ascontiguousarray(source, dtype=np.float32)
    tgt = np.ascontiguousarray(target, dtype=np.float32)
    T = np.eye(4, dtype=np.float64)
    lib.icp_register(src.ctypes.data_as(fp), len(src), tgt.ctypes.data_as(fp), len(tgt),
                     float(max_correspondence), int(max_iteration),
                     T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return T


def compute_transformation(lidar_path_source: str, lidar_path_infer: str, lidar_path_target: str,
                           pose_source: np.ndarray, pose_infer: np.ndarray,
                           pose_target: np.ndarray, T_velo_2_cam2: np.ndarray,
                           T_cam0_2_cam2: np.ndarray) -> Dict[str, np.ndarray]:
    """{"T_source2infer", "T_source2target"}: the odometry transforms between
    the cam2 frames, each composed with its ICP refinement (f64)."""
    pts_src = apply_transform(read_lidar(lidar_path_source)[:, :3], T_velo_2_cam2)
    pts_inf = apply_transform(read_lidar(lidar_path_infer)[:, :3], T_velo_2_cam2)
    pts_tgt = apply_transform(read_lidar(lidar_path_target)[:, :3], T_velo_2_cam2)

    T_cam2_2_cam0 = np.linalg.inv(T_cam0_2_cam2)
    T_source2infer = T_cam0_2_cam2 @ np.linalg.inv(pose_infer) @ pose_source @ T_cam2_2_cam0
    T_source2target = T_cam0_2_cam2 @ np.linalg.inv(pose_target) @ pose_source @ T_cam2_2_cam0

    refined_s2i = icp_point_to_point(
        voxel_downsample(apply_transform(pts_src, T_source2infer), VOXEL),
        voxel_downsample(pts_inf, VOXEL))
    refined_s2t = icp_point_to_point(
        voxel_downsample(apply_transform(pts_src, T_source2target), VOXEL),
        voxel_downsample(pts_tgt, VOXEL))
    return {"T_source2infer": T_source2infer @ refined_s2i,
            "T_source2target": T_source2target @ refined_s2t}


class TransformCache:
    """The refined transforms of one sequence's input frames, a pickle per
    frame at {transform_root}/{sequence}_{frames_interval}_all/{frame}.pkl,
    keyed by the source id as a string. A file is written to a temporary
    name and then renamed over the old one; a file that does not unpickle
    reads as empty and is written anew."""

    def __init__(self, transform_root: str, sequence: str, frames_interval: float):
        self.dir = os.path.join(transform_root, f"{sequence}_{frames_interval}_all")
        os.makedirs(self.dir, exist_ok=True)

    def path(self, frame_id: str) -> str:
        return os.path.join(self.dir, f"{frame_id}.pkl")

    def load(self, frame_id: str) -> Dict:
        try:
            with open(self.path(frame_id), "rb") as f:
                return pickle.load(f)
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            return {}

    def get_or_compute(self, frame_id: str, source_id: int,
                       compute_fn: Callable[[], Dict]) -> Dict:
        data = self.load(frame_id)
        key = str(source_id)
        if key not in data:
            data[key] = compute_fn()
            tmp = f"{self.path(frame_id)}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(data, f)
            os.replace(tmp, self.path(frame_id))
        return data[key]
