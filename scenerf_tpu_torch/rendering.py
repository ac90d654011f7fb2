"""Ray rendering: PrSamp sampling -> point featurization -> field MLP ->
sort + alpha compositing. Counterpart of `scenerf_tpu/rendering.py`.

The per-point featurization projects each 3D sample to pixels, maps the
pixels onto the spherical grid (rounded cells), and bilinearly samples all
five pyramid levels in one gather-kernel launch. The field runs on the
samples in the order they were drawn; the sort-composite kernel then sorts
each ray by distance and composites it (the field is pointwise, so this is
the JAX order of sort-then-evaluate). Rays render in a Python loop over
chunks, with the noise drawn once for all rays and sliced. Outside
`torch.no_grad` the render carries gradients (the kernels' backwards are
autograd Functions); `with_som=True`, the training render, adds the RaySOM
(its EM, kernel S's, inside the sort-composite launch) and its KL.

On the mixed-precision path the pyramid, the latent and the field MLPs are
bf16; the sample positions, the Gaussian means and stds, the density and
rgb that reach the sort-composite kernel, and everything after it are f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import sampling as S
from scenerf_tpu_torch.config import SceneRFConfig, SphereConfig
from scenerf_tpu_torch.encoding import positional_encoding
from scenerf_tpu_torch.fields import ResnetFC, gaussian_params_from_offsets, radiance_outputs
from scenerf_tpu_torch.ops.composite import SOM_KEYS, SomInputs, sort_composite
from scenerf_tpu_torch.ops.gather import PyramidGrads, gather_levels
from scenerf_tpu_torch.som import ray_som
from scenerf_tpu_torch.utils import tracing

SCALES = (1, 2, 4, 8, 16)

Pyramid = Sequence[torch.Tensor]  # five contiguous [H_s, W_s, C_s] levels


def inverse(M: torch.Tensor) -> torch.Tensor:
    """Matrix inverse without the singularity check of `torch.linalg.inv`,
    which waits for the device on a CUDA tensor."""
    return torch.linalg.inv_ex(M).inverse


def pyramid_level_size(sphere: SphereConfig, scale: int) -> Tuple[int, int]:
    """Actual (H, W) of a pyramid level: round(sphere / scale)."""
    return int(round(sphere.height / scale)), int(round(sphere.width / scale))


def pyramid_norm_size(sphere: SphereConfig, scale: int) -> Tuple[int, int]:
    """(W, H) that normalizes sample coords at a level: the floor-divided
    nominal size, which can differ by one pixel from the actual map."""
    if scale == 1:
        return (sphere.width, sphere.height)
    return (sphere.width // scale, sphere.height // scale)


def pyramid_coords(
    cam_pts: torch.Tensor,   # [N, 3] points in the infer camera frame
    cam_K: torch.Tensor,
    inv_K: torch.Tensor,
    sphere: SphereConfig,
    level_hw: Sequence[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous sample coords (ix, iy) [L, N] of points on each pyramid
    level (H_l, W_l): project to pixels, map to rounded sphere cells, divide
    by the level's scale and normalize by its nominal size."""
    projected_pix = geo.cam_pts_2_pix(cam_pts, cam_K)
    _, sphere_coords, _ = geo.sphere_coords_from_pixels(inv_K, sphere, pix=projected_pix)
    ixs, iys = [], []
    for (H, W), scale in zip(level_hw, SCALES):
        coords = sphere_coords if scale == 1 else sphere_coords / scale
        grid = geo.normalize_pix(coords, pyramid_norm_size(sphere, scale))
        ix, iy = geo.unnormalize_coords(grid, H, W)
        ixs.append(ix)
        iys.append(iy)
    return torch.stack(ixs), torch.stack(iys)


def featurize_points(
    pyramid: Pyramid,
    cam_pts: torch.Tensor,   # [N, 3] points in the infer camera frame
    viewdir: torch.Tensor,   # [N, 3] unnormalized view directions
    cam_K: torch.Tensor,
    inv_K: torch.Tensor,
    sphere: SphereConfig,
    n_pe_freqs: int = 6,
    pyramid_grads: Optional[PyramidGrads] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point conditioning: (latent [N, d_latent], x_in [N, d_pe + 3]).
    `pyramid_grads`: the pyramid's shared gradient buffers (training)."""
    ix, iy = pyramid_coords(cam_pts, cam_K, inv_K, sphere,
                            [lv.shape[:2] for lv in pyramid])
    latent = gather_levels(pyramid, ix, iy, grads=pyramid_grads)

    pe = positional_encoding(cam_pts, num_freqs=n_pe_freqs)
    x_in = torch.cat([pe, viewdir], dim=-1)
    return latent, x_in


def render_ray_block(
    pixels: torch.Tensor,  # [r, 2]
    pyramid: Pyramid,
    cam_K: torch.Tensor,
    inv_K: torch.Tensor,
    T_source2infer: torch.Tensor,
    mlp: ResnetFC,
    mlp_gaussian: ResnetFC,
    cfg: SceneRFConfig,
    noise_uni: torch.Tensor,    # [r, n_pts_uni] U(0, 1)
    noise_gauss: torch.Tensor,  # [r, G * Pg] N(0, 1)
    with_som: bool = False,
    pyramid_grads: Optional[PyramidGrads] = None,
) -> Dict[str, torch.Tensor]:
    """Render one block of rays end to end with the given raw noise."""
    r = pixels.shape[0]
    dev = pixels.device

    raw_dir = geo.ray_directions(pixels, inv_K, normalize=False)
    unit_dir = raw_dir / torch.linalg.norm(raw_dir, dim=-1, keepdim=True)
    viewdir_infer = geo.rotate_vectors(raw_dir, T_source2infer)  # [r, 3]

    pts_uni, dv_uni, sd_uni, _ = S.sample_rays_uniform(
        None, pixels, inv_K, T_source2infer,
        cfg.n_pts_uni, cfg.min_sample_depth, cfg.max_sample_depth,
        method=cfg.sampling_method, noise=noise_uni,
    )

    # Gaussian mixture prediction at the anchor points
    anchors = S.gaussian_anchor_distances(cfg.n_gaussians, cfg.max_sample_depth, device=dev)
    anchor_pts_src = anchors[None, :, None] * unit_dir[:, None, :]  # [r, G, 3]
    anchor_pts = geo.transform_points(anchor_pts_src, T_source2infer)
    vd_anchor = viewdir_infer[:, None, :].expand(r, cfg.n_gaussians, 3).reshape(-1, 3)
    z_a, x_a = featurize_points(pyramid, anchor_pts.reshape(-1, 3), vd_anchor,
                                cam_K, inv_K, cfg.sphere, cfg.n_pe_freqs, pyramid_grads)
    offsets = mlp_gaussian(z_a, x_a).reshape(r, cfg.n_gaussians, 2)
    g_means, g_stds = gaussian_params_from_offsets(offsets, anchors, cfg.std,
                                                   cfg.mean_std_floor)

    pts_g, dv_g, sd_g = S.sample_rays_gaussian(
        None, unit_dir, T_source2infer, g_means, g_stds,
        cfg.n_pts_per_gaussian, cfg.min_clamp_depth, noise=noise_gauss,
    )
    if cfg.n_pts_uni > 0:
        pts = torch.cat([pts_uni, pts_g], dim=1)
        dv = torch.cat([dv_uni, dv_g], dim=1)
        sd = torch.cat([sd_uni, sd_g], dim=1)
    else:
        pts, dv, sd = pts_g, dv_g, sd_g

    # field on the samples in drawn order (positions detached, as in JAX)
    P = sd.shape[1]
    vd = viewdir_infer[:, None, :].expand(r, P, 3).reshape(-1, 3)
    z, x_in = featurize_points(pyramid, pts.detach().reshape(-1, 3), vd, cam_K, inv_K,
                               cfg.sphere, cfg.n_pe_freqs, pyramid_grads)
    # in the field's dtype; f32 from here on, where JAX's promotion takes them
    # against the f32 distances and weights of the composite
    density, rgb = (t.float() for t in radiance_outputs(mlp(z, x_in)))
    som_in = (SomInputs(g_means, g_stds, cfg.som_sigma, cfg.som_mask_threshold)
              if with_som else None)
    out = sort_composite(sd, dv, density.reshape(r, P), rgb.reshape(r, P, 3), som=som_in)

    if with_som:
        # the EM ran with the sort-composite (one launch on the card)
        som = ray_som(g_means, g_stds, out["sensor_distance"], out["alphas"],
                      som_sigma=cfg.som_sigma, mask_threshold=cfg.som_mask_threshold,
                      std_floor=cfg.kl_std_floor, em=[out.pop(k) for k in SOM_KEYS])
        out["loss_kl"] = som.loss_kl
        out["som_vars"] = som.new_vars
    out["gaussian_means"] = g_means
    out["gaussian_stds"] = g_stds
    return out


def render_rays(
    pixels: torch.Tensor,  # [R, 2]
    pyramid: Pyramid,
    cam_K: torch.Tensor,
    T_source2infer: torch.Tensor,
    mlp: ResnetFC,
    mlp_gaussian: ResnetFC,
    cfg: SceneRFConfig,
    generator: Optional[torch.Generator] = None,
    ray_chunk: Optional[int] = None,
    noise_uni: Optional[torch.Tensor] = None,
    noise_gauss: Optional[torch.Tensor] = None,
    with_som: bool = False,
    pyramid_grads: Optional[PyramidGrads] = None,
) -> Dict[str, torch.Tensor]:
    """Render R rays in chunks of `ray_chunk`. The noise is drawn once for
    all R rays from `generator` (or passed in as `noise_uni` [R, n_pts_uni],
    `noise_gauss` [R, G*Pg]) and sliced per chunk, so the result does not
    depend on the chunk size. The RaySOM (training only) runs if `with_som`.
    `pyramid_grads` (training): from `ops.gather.share_pyramid_grads`, whose
    levels `pyramid` must be; every chunk's gathers add their level
    gradients into its buffers."""
    inv_K = inverse(cam_K)
    chunk = ray_chunk or cfg.ray_chunk
    R = pixels.shape[0]
    if noise_uni is None:
        noise_uni = S.row_noise(generator, R, cfg.n_pts_uni, device=pixels.device)
    if noise_gauss is None:
        noise_gauss = S.row_noise(generator, R, cfg.n_pts_gauss, dist="normal",
                                  device=pixels.device)
    blocks = []
    for i in range(0, R, chunk):
        with tracing.span("chunk"):
            blocks.append(render_ray_block(
                pixels[i:i + chunk], pyramid, cam_K, inv_K, T_source2infer, mlp,
                mlp_gaussian, cfg, noise_uni[i:i + chunk], noise_gauss[i:i + chunk],
                with_som=with_som, pyramid_grads=pyramid_grads))
    if len(blocks) == 1:
        return blocks[0]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
