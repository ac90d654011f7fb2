"""Camera geometry, bilinear image sampling and spherical mapping in PyTorch.

Counterpart of `scenerf_tpu/geometry.py`, with the same conventions:
* pixels are (x, y) pairs, float32, origin at the top-left pixel center
* camera intrinsics K are 3x3, poses T are 4x4 (applied as T @ p)
* images are channel-last [H, W, C]

`bilinear_sample` is the plain version of the multi-level gather kernel
(`ops/gather.py`), fed by `normalize_pix` + `unnormalize_coords` (the JAX
`sample_feats_2d` / `grid_sample_norm` coordinate path); it is deliberately
not `F.grid_sample`, whose NCHW layout and arithmetic differ.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from scenerf_tpu_torch.config import SphereConfig


def apply_matrix(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(M @ p) for batched points: [..., D] x [E, D] -> [..., E]."""
    return torch.einsum("...i,ji->...j", pts, M)


def homogenize(pts: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., D+1] with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def pix_2_cam_pts(pix: torch.Tensor, inv_K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Unproject pixels [..., 2] to camera-frame points at z-depth [...]."""
    dirs = apply_matrix(homogenize(pix), inv_K[:3, :3])
    return dirs * depth[..., None]


def cam_pts_2_pix(cam_pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points to pixels; points with z <= 0 map to -1."""
    homo = apply_matrix(cam_pts, K)
    z = homo[..., 2:3]
    valid = z > 0
    safe_z = torch.where(valid, z, torch.ones_like(z))
    pix = homo[..., :2] / safe_z
    return torch.where(valid, pix, torch.full_like(pix, -1.0))


def transform_points(pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [..., 3] points."""
    return apply_matrix(homogenize(pts), T[:3, :4])


def rotate_vectors(vecs: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part of a 4x4 transform to [..., 3] vectors."""
    return apply_matrix(vecs, T[:3, :3])


def ray_directions(pix: torch.Tensor, inv_K: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Back-projected ray direction per pixel (unit if `normalize`)."""
    dirs = apply_matrix(homogenize(pix), inv_K[:3, :3])
    if normalize:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs


# --------------------------------------------------------------------------- #
# Bilinear sampling (grid_sample parity: zero padding, align_corners=False)
# --------------------------------------------------------------------------- #


def bilinear_sample(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample `img` [H, W, C] at continuous pixel coords (ix, iy) [N].

    Out-of-bounds corner taps contribute zero. The plain version of the
    gather kernel: same corner order and the same multiply/add sequence.
    """
    H, W, C = img.shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(H * W, C)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = xi.clamp(0, W - 1)
        yc = yi.clamp(0, H - 1)
        vals = flat[yc * W + xc]
        return vals * inb[:, None].to(img.dtype)

    v00 = tap(x0i, y0i)
    v10 = tap(x0i + 1, y0i)
    v01 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)

    wx = wx[:, None].to(img.dtype)
    wy = wy[:, None].to(img.dtype)
    top = v00 * (1 - wx) + v10 * wx
    bot = v01 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def unnormalize_coords(grid_xy: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized [-1, 1] coords [N, 2] -> continuous pixel coords (ix, iy) of
    an H x W map (grid_sample, align_corners=False)."""
    ix = ((grid_xy[:, 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid_xy[:, 1] + 1.0) * H - 1.0) * 0.5
    return ix, iy


def sample_pix_features(pix: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample image colors img [H, W, C] at pixel coords pix [N, 2]
    -> [N, C], normalizing by (size - 1) as the JAX package's
    `geometry.py:179 sample_pix_features` does (the effective sample point is
    pix * size / (size - 1) - 0.5). Runs the gather kernel, whose backward
    carries a gradient into `pix` where it requires one."""
    from scenerf_tpu_torch.ops.gather import gather_levels

    ix, iy = pix_feature_coords(pix, img.shape[0], img.shape[1])
    return gather_levels([img], ix[None], iy[None])


def pix_feature_coords(pix: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The continuous sample coords (ix, iy) [N] of `sample_pix_features` on
    an H x W image."""
    gx = (pix[:, 0] / (W - 1) - 0.5) * 2.0
    gy = (pix[:, 1] / (H - 1) - 0.5) * 2.0
    return unnormalize_coords(torch.stack([gx, gy], dim=-1), H, W)


def normalize_pix(pix: torch.Tensor, norm_wh: Tuple[int, int]) -> torch.Tensor:
    """Pixel coords [N, 2] -> normalized [-1, 1] coords by a caller-provided
    nominal (W, H), which can differ by one pixel from the map sampled."""
    return (pix / _norm(tuple(norm_wh), pix.dtype, pix.device)) * 2.0 - 1.0


@functools.lru_cache(maxsize=None)
def _norm(norm_wh: Tuple[int, int], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`norm_wh` as a tensor on `device`, copied there once per level and
    shared, never written (see `encoder/sphere_decoder._interp_matrix`)."""
    return torch.tensor(norm_wh, dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# Spherical (equirectangular) mapping
# --------------------------------------------------------------------------- #


def cam_pts_2_angles(cam_pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points -> (v_angle, h_angle, distance), angles in degrees."""
    x, y, z = cam_pts[..., 0], cam_pts[..., 1], cam_pts[..., 2]
    distance = torch.linalg.norm(cam_pts, dim=-1)
    safe = torch.clamp(distance, min=1e-12)
    v_angle = torch.acos(torch.clamp(-y / safe, -1.0, 1.0)) / math.pi * 180.0
    h_angle = 180.0 - torch.atan2(z, x) / math.pi * 180.0
    return v_angle, h_angle, distance


def cam_pts_2_sphere_coords(
    cam_pts: torch.Tensor, sphere: SphereConfig, round_coords: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points -> spherical-grid pixel coords [..., 2] + distance.

    `torch.round` rounds half to even, as `jnp.round` does."""
    v_angle, h_angle, distance = cam_pts_2_angles(cam_pts)
    proj_x = (h_angle - sphere.h_min) / sphere.h_fov
    proj_y = (v_angle - sphere.v_min) / sphere.v_fov
    coords = torch.stack(
        [proj_x * (sphere.width - 1), proj_y * (sphere.height - 1)], dim=-1
    )
    if round_coords:
        coords = torch.round(coords)
    return coords, distance


def pixel_grid(W: int, H: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """All pixel coords of a WxH image as [W*H, 2], x varying fastest."""
    xs = torch.arange(W, dtype=dtype, device=device)
    ys = torch.arange(H, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def sphere_coords_from_pixels(
    inv_K: torch.Tensor,
    sphere: SphereConfig,
    pix: torch.Tensor | None = None,
    img_size: Tuple[int, int] | None = None,
    round_coords: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixels -> spherical-grid coords. If `pix` is None, uses the full pixel
    grid of `img_size` (W, H). Returns (pix, sphere_coords, distance)."""
    if pix is None:
        if img_size is None:
            raise ValueError("pass pix or img_size")
        pix = pixel_grid(img_size[0], img_size[1], dtype=inv_K.dtype, device=inv_K.device)
    cam_pts = pix_2_cam_pts(pix, inv_K, torch.ones(pix.shape[:-1], dtype=pix.dtype,
                                                   device=pix.device))
    coords, distance = cam_pts_2_sphere_coords(cam_pts, sphere, round_coords=round_coords)
    return pix, coords, distance


# --------------------------------------------------------------------------- #
# Novel-pose sweeps for reconstruction (host numpy)
# --------------------------------------------------------------------------- #


def _y_rotation_pose(step: float, angle_deg: float) -> np.ndarray:
    """rot_y(angle) @ translate_z(step)."""
    rad = angle_deg / 180.0 * math.pi
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = step
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.array(
        [
            [math.cos(rad), 0.0, math.sin(rad)],
            [0.0, 1.0, 0.0],
            [-math.sin(rad), 0.0, math.cos(rad)],
        ],
        dtype=np.float32,
    )
    return rot @ trans


def sample_rel_poses(
    step: float = 0.5, angle: float = 0.0, max_distance: float = 10.1
) -> Dict[Tuple[float, float], np.ndarray]:
    """KITTI-style pose sweep: forward steps x yaw angles {0, +a, -a}.
    Returns {(step, angle): 4x4}."""
    angles: List[float] = [0.0] + ([angle, -angle] if angle != 0.0 else [])
    poses = {}
    for s in np.arange(0.0, max_distance, step):
        for a in angles:
            poses[(float(s), float(a))] = _y_rotation_pose(float(s), a)
    return poses


def sample_rel_poses_bf(
    angle: float = 0.0, max_distance: float = 2.1, step: float = 0.2
) -> Dict[Tuple[float, float], np.ndarray]:
    """BundleFusion-style pose sweep: forward steps x yaw angles {0, -a, +a}
    (KITTI's order is {0, +a, -a}). Returns {(step, angle): 4x4}."""
    angles: List[float] = [0.0] + ([-angle, angle] if angle != 0.0 else [])
    poses = {}
    for s in np.arange(0.0, max_distance, step):
        for a in angles:
            poses[(float(s), float(a))] = _y_rotation_pose(float(s), a)
    return poses


def determine_angles(inv_K: np.ndarray, img_W: int, img_H: int) -> Dict[str, float]:
    """Min/max spherical angles (degrees) of a camera's pixel grid: the FOV
    calibration that SphereConfig's base angles come from. The rays are
    unprojected in numpy (f32 pixels times the f64 inverse intrinsics), the
    angles computed in f32, as the JAX package computes them."""
    pix = pixel_grid(img_W, img_H).numpy()
    cam_pts = np.concatenate([pix, np.ones_like(pix[:, :1])], axis=1) @ \
        np.asarray(inv_K)[:3, :3].T
    v, h, _ = cam_pts_2_angles(torch.from_numpy(cam_pts.astype(np.float32)))
    return {
        "v_angle_min": float(v.min()),
        "v_angle_max": float(v.max()),
        "h_angle_min": float(h.min()),
        "h_angle_max": float(h.max()),
    }


def rel_pose_stack(poses: Dict[Tuple[float, float], np.ndarray]) -> np.ndarray:
    """Stack a pose sweep dict into one [P, 4, 4] array."""
    return np.stack(list(poses.values()), axis=0)
