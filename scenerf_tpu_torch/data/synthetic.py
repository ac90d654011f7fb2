"""Synthetic scans in numpy matching the training batch contract: the
port's own copy of `scenerf_tpu/data/synthetic.py` (which imports JAX through
`scenerf_tpu.config`), with the same values for the same config and seed;
and KITTI's odometry calibration for runs without a KITTI tree.

Batch contract (all fixed-shape numpy arrays):
  img_input       [B, H, W, 3]     cam_K            [B, 3, 3]
  T_source2infer  [B, S, 4, 4]     T_source2target  [B, S, 4, 4]
  img_sources     [B, S, H, W, 3]  img_targets      [B, S, H, W, 3]
  source_mask     [B, S]           gt_pix [B, S, G, 2], gt_depth, gt_mask [B, S, G]
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from scenerf_tpu_torch.config import SceneRFConfig


# KITTI odometry calibration (camera 2 projection P2, LiDAR -> camera 0 Tr),
# the values scripts/make_fake_kitti.py writes into calib.txt
KITTI_P2 = np.array([[707.0912, 0, 601.8873, 45.758],
                     [0, 707.0912, 183.1104, -0.345],
                     [0, 0, 1, 0.005]], np.float64)
KITTI_TR = np.array([[2e-4, -0.9999, -0.0106, -0.0028],
                     [0.0104, 0.0106, -0.9999, -0.0753],
                     [0.9999, 1e-4, 0.0105, -0.2721]], np.float64)


def kitti_calibration():
    """(cam_K [3, 3], T_velo_2_cam [4, 4]) in f32 from KITTI_P2 / KITTI_TR, as
    the KITTI reader derives them: T_velo_2_cam = T_cam0_2_cam2 @ Tr, with
    the stereo baseline P2[0, 3] / P2[0, 0] as the only offset of camera 2."""
    Tr = np.eye(4)
    Tr[:3, :4] = KITTI_TR
    T_cam0_2_cam2 = np.eye(4)
    T_cam0_2_cam2[0, 3] = KITTI_P2[0, 3] / KITTI_P2[0, 0]
    return (KITTI_P2[:3, :3].astype(np.float32),
            (T_cam0_2_cam2 @ Tr).astype(np.float32))


def default_intrinsics(cfg: SceneRFConfig) -> np.ndarray:
    W, H = cfg.img_size
    f = 0.6 * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)


def texture(H: int, W: int, seed: int) -> np.ndarray:
    """[H, W, 3] smooth random-phase sinusoid image in [0, 1], the input
    frame of the JAX package's `make_batch` for the same seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(xx / (3 + 7 * rng.random()) + rng.random() * 6),
            0.5 + 0.5 * np.sin(yy / (3 + 7 * rng.random()) + rng.random() * 6),
            0.5 + 0.5 * np.sin((xx + yy) / (5 + 5 * rng.random())),
        ],
        axis=-1,
    )
    return img.astype(np.float32)


def input_frame(cfg: SceneRFConfig, seed: int = 0) -> np.ndarray:
    """One [1, H, W, 3] input frame at the config's image size."""
    W, H = cfg.img_size
    return texture(H, W, seed)[None]


def _plane_view(cam_K: np.ndarray, c: np.ndarray, H: int, W: int,
                z0: float, slope: float):
    """Render a textured slanted plane z = z0 + slope * x (world frame) from a
    camera at world position `c` (identity rotation) -> (img [H, W, 3],
    depth [H, W]); the texture is a smooth function of the world (x, y) hit
    point, so two views agree photometrically under reprojection."""
    fx, fy, cx, cy = cam_K[0, 0], cam_K[1, 1], cam_K[0, 2], cam_K[1, 2]
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float32)
    dx = (uu + 0.5 - cx) / fx
    dy = (vv + 0.5 - cy) / fy
    lam = (z0 + slope * c[0] - c[2]) / (1.0 - slope * dx)  # camera z == depth
    x = c[0] + lam * dx
    y = c[1] + lam * dy
    img = np.stack(
        [
            0.5 + 0.35 * np.sin(2.1 * x) * np.cos(1.7 * y),
            0.5 + 0.35 * np.sin(1.3 * x + 2.0) * np.sin(2.3 * y),
            0.5 + 0.35 * np.cos(1.9 * x - 0.7) * np.cos(1.1 * y + 1.3),
        ],
        axis=-1,
    ).astype(np.float32)
    return img, lam.astype(np.float32)


def make_geometric_batch(cfg: SceneRFConfig, seed: int = 0,
                         z0: float = 5.0, slope: float = 0.15) -> Dict[str, np.ndarray]:
    """One geometrically consistent frame: every view renders the same
    textured slanted plane and gt_depth is the analytic plane depth, so the
    reprojection loss has its minimum at the true depth."""
    rng = np.random.default_rng(seed)
    W, H = cfg.img_size
    S, G = cfg.n_sources, cfg.n_gt_depth
    cam_K = default_intrinsics(cfg)

    def pose_from(c: np.ndarray) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = c
        return T

    infer_img, _ = _plane_view(cam_K, np.zeros(3, np.float32), H, W, z0, slope)
    src_imgs, src_depths, T_s2i = [], [], []
    for s in range(S):
        c = np.array([0.25 * (s + 1), 0.1 * s, -0.35 * (s + 1)], np.float32)
        img, depth = _plane_view(cam_K, c, H, W, z0, slope)
        src_imgs.append(img)
        src_depths.append(depth)
        T_s2i.append(pose_from(c))

    gt_pix = rng.uniform(1, [W - 2, H - 2], size=(S, G, 2)).astype(np.float32)
    gt_depth = np.stack([
        src_depths[s][gt_pix[s, :, 1].astype(int), gt_pix[s, :, 0].astype(int)]
        for s in range(S)
    ])
    return {
        "img_input": infer_img[None],
        "cam_K": cam_K[None],
        "T_source2infer": np.stack(T_s2i)[None],
        # the target camera is the infer camera (the reference's KITTI pairing)
        "T_source2target": np.stack(T_s2i)[None],
        "img_sources": np.stack(src_imgs)[None],
        "img_targets": np.tile(infer_img[None, None], (1, S, 1, 1, 1)),
        "source_mask": np.ones((1, S), dtype=np.float32),
        "gt_pix": gt_pix[None],
        "gt_depth": gt_depth[None],
        "gt_mask": np.ones((1, S, G), dtype=np.float32),
    }


def make_batch(cfg: SceneRFConfig, batch_size: int = 1, seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of textured frames with forward-moving source poses and random
    GT-depth pixels (photometrically inconsistent: a shape and cost fixture)."""
    rng = np.random.default_rng(seed)
    W, H = cfg.img_size
    B, S, G = batch_size, cfg.n_sources, cfg.n_gt_depth
    cam_K = np.tile(default_intrinsics(cfg)[None], (B, 1, 1))

    def fwd_pose(dz: float) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = dz
        return T

    return {
        "img_input": np.stack([texture(H, W, seed + b) for b in range(B)]),
        "cam_K": cam_K,
        "T_source2infer": np.stack(
            [[fwd_pose(0.4 * (s + 1)) for s in range(S)] for _ in range(B)]),
        "T_source2target": np.stack([[fwd_pose(-0.4) for _ in range(S)] for _ in range(B)]),
        "img_sources": np.stack(
            [[texture(H, W, seed + 10 + s) for s in range(S)] for _ in range(B)]),
        "img_targets": np.stack(
            [[texture(H, W, seed + 20 + s) for s in range(S)] for _ in range(B)]),
        "source_mask": np.ones((B, S), dtype=np.float32),
        "gt_pix": rng.uniform(0, [W - 1, H - 1], size=(B, S, G, 2)).astype(np.float32),
        "gt_depth": rng.uniform(2.0, 0.8 * cfg.eval_depth, size=(B, S, G)).astype(np.float32),
        "gt_mask": np.ones((B, S, G), dtype=np.float32),
    }
