"""Ray samplers: stratified uniform, log, and Gaussian-mixture (PrSamp)
sampling along rays. Counterpart of `scenerf_tpu/sampling.py`.

Randomness comes from an explicit `torch.Generator` where JAX takes a key.
The two never give the same numbers, so every sampler also accepts the raw
draw as `noise=` (tests inject JAX's draws). Samplers return
  cam_pts          [R, P, 3]  points in the *infer* camera frame (after T)
  depth_volume     [R, P]     z-depth in the *source* camera frame
  sensor_distance  [R, P]     distance along the ray from the source sensor
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import apply_matrix, homogenize, transform_points


def row_noise(
    generator: Optional[torch.Generator],
    n_rays: int,
    n_cols: int,
    full_rows: Optional[int] = None,
    row_offset: int = 0,
    dist: str = "uniform",
    device=None,
) -> torch.Tensor:
    """[n_rays, n_cols] noise that depends only on the global ray index: the
    draw covers `full_rows` rays and rows [row_offset, row_offset + n_rays)
    are sliced out, so a ray's noise does not depend on how rays are chunked."""
    rows = n_rays if full_rows is None else full_rows
    draw = torch.rand if dist == "uniform" else torch.randn
    noise = draw((rows, n_cols), generator=generator, device=device)
    return noise[row_offset:row_offset + n_rays]


def uniform_sensor_distances(
    generator: Optional[torch.Generator], n_rays: int, n_pts: int, d_min: float,
    d_max: float, full_rows: Optional[int] = None, row_offset: int = 0,
    noise: Optional[torch.Tensor] = None, device=None,
) -> torch.Tensor:
    """Stratified distances: linspace(d_min, d_max, n_pts) + U(0, step) jitter
    with step = (d_max - d_min) / n_pts."""
    if noise is None:
        noise = row_noise(generator, n_rays, n_pts, full_rows, row_offset, device=device)
    base = torch.linspace(d_min, d_max, n_pts, device=noise.device)
    step = (d_max - d_min) / n_pts
    return base[None, :] + noise * step


def log_sensor_distances(
    generator: Optional[torch.Generator], n_rays: int, n_pts: int, d_min: float,
    d_max: float, full_rows: Optional[int] = None, row_offset: int = 0,
    noise: Optional[torch.Tensor] = None, device=None,
) -> torch.Tensor:
    """Log-spaced distances concentrating samples near the camera."""
    if noise is None:
        noise = row_noise(generator, n_rays, n_pts, full_rows, row_offset, device=device)
    step = (d_max - d_min) / n_pts
    d_i = d_min + torch.arange(n_pts - 1, -1, -1, dtype=torch.float32,
                               device=noise.device) * (d_max - d_min) / n_pts
    d_i = d_i[None, :] + noise * step
    return d_max - torch.log(d_i - d_min + 1.0) / torch.log(
        torch.tensor(d_max - d_min + 1.0)) * (d_max - d_min)


def points_from_distances(
    sensor_distance: torch.Tensor,  # [R, P]
    unit_direction: torch.Tensor,   # [R, 3]
    T_source2infer: torch.Tensor,   # [4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """distance * direction in the source frame, moved to the infer frame.
    Returns (cam_pts_infer [R, P, 3], depth_volume [R, P])."""
    cam_pts_src = sensor_distance[..., None] * unit_direction[:, None, :]
    depth_volume = cam_pts_src[..., 2]
    cam_pts_infer = transform_points(cam_pts_src, T_source2infer)
    return cam_pts_infer, depth_volume


def sample_rays_uniform(
    generator: Optional[torch.Generator],
    pix: torch.Tensor,          # [R, 2]
    inv_K: torch.Tensor,
    T_source2infer: torch.Tensor,
    n_pts: int,
    d_min: float,
    d_max: float,
    method: str = "uniform",
    full_rows: Optional[int] = None,
    row_offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform/log stratified sampling along rays through `pix`.

    Returns (cam_pts_infer [R,P,3], depth_volume [R,P], sensor_distance [R,P],
    viewdir_infer [R,3]); viewdir_infer is the unnormalized back-projected
    direction rotated into the infer frame."""
    n_rays = pix.shape[0]
    raw_dir = apply_matrix(homogenize(pix), inv_K[:3, :3])
    unit_dir = raw_dir / torch.linalg.norm(raw_dir, dim=-1, keepdim=True)
    if method == "uniform":
        sd = uniform_sensor_distances(generator, n_rays, n_pts, d_min, d_max,
                                      full_rows, row_offset, noise, pix.device)
    elif method == "log":
        sd = log_sensor_distances(generator, n_rays, n_pts, d_min, d_max,
                                  full_rows, row_offset, noise, pix.device)
    else:
        raise ValueError(f"unknown sampling method: {method}")
    cam_pts, depth_volume = points_from_distances(sd, unit_dir, T_source2infer)
    viewdir_infer = apply_matrix(raw_dir, T_source2infer[:3, :3])
    return cam_pts, depth_volume, sd, viewdir_infer


def sample_rays_gaussian(
    generator: Optional[torch.Generator],
    unit_direction: torch.Tensor,   # [R, 3]
    T_source2infer: torch.Tensor,
    gaussian_means: torch.Tensor,   # [R, G] sensor distances
    gaussian_stds: torch.Tensor,    # [R, G]
    n_pts_per_gaussian: int,
    min_clamp_depth: float = 0.1,
    full_rows: Optional[int] = None,
    row_offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_pts_per_gaussian draws from each per-ray Gaussian along the ray,
    clamped at min_clamp_depth; `noise` optionally supplies the N(0,1)
    [R, G*Pg] draw."""
    n_rays, n_gauss = gaussian_means.shape
    mean_rep = torch.repeat_interleave(gaussian_means, n_pts_per_gaussian, dim=1)
    std_rep = torch.repeat_interleave(gaussian_stds, n_pts_per_gaussian, dim=1)
    if noise is None:
        noise = row_noise(generator, n_rays, n_gauss * n_pts_per_gaussian,
                          full_rows, row_offset, dist="normal",
                          device=gaussian_means.device)
    sd = torch.clamp(mean_rep + noise * std_rep, min=min_clamp_depth)
    cam_pts, depth_volume = points_from_distances(sd, unit_direction, T_source2infer)
    return cam_pts, depth_volume, sd


def gaussian_anchor_distances(n_gaussians: int, max_sample_depth: float,
                              device=None) -> torch.Tensor:
    """Evenly spaced Gaussian anchor distances: step/2 to max - step/2."""
    step = max_sample_depth / n_gaussians
    return torch.linspace(step / 2.0, max_sample_depth - step / 2.0, n_gaussians,
                          device=device)


def grid_pixels(x0: int, x1: int, y0: int, y1: int, stride: int, device=None,
                x_fastest: bool = False) -> torch.Tensor:
    """The stride-subsampled pixels of [x0, x1) x [y0, y1) as [N, 2] (x, y),
    y varying fastest (the order the training draws index), or x fastest
    (image row-major order, for rendering a whole image)."""
    xs = torch.arange(x0, x1, stride, dtype=torch.float32, device=device)
    ys = torch.arange(y0, y1, stride, dtype=torch.float32, device=device)
    if x_fastest:
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    else:
        gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def random_grid_pixels(
    generator: Optional[torch.Generator],
    n_rays: int,
    img_W: int,
    img_H: int,
    stride: int = 2,
    grid_size: int = 1,
    device=None,
) -> torch.Tensor:
    """n_rays training pixels [n_rays, 2] drawn without replacement from the
    stride-subsampled image grid (`torch.randperm` on `generator`). With
    grid_size > 1 (BundleFusion), n_rays / grid_size^2 pixels come from each
    of grid_size x grid_size image cells, cells in row-major order."""
    if grid_size <= 1:
        cells = [(0, img_W, 0, img_H)]
        n_per_cell = n_rays
    else:
        cw, ch = img_W // grid_size, img_H // grid_size
        cells = [(cx * cw, (cx + 1) * cw, cy * ch, (cy + 1) * ch)
                 for cy in range(grid_size) for cx in range(grid_size)]
        n_per_cell = n_rays // (grid_size * grid_size)
    out = []
    for x0, x1, y0, y1 in cells:
        pixels = grid_pixels(x0, x1, y0, y1, stride, device=device)
        idx = torch.randperm(pixels.shape[0], generator=generator, device=device)[:n_per_cell]
        out.append(pixels[idx])
    return out[0] if len(out) == 1 else torch.cat(out)
