"""Training losses and the in-step depth metrics. Counterpart of
`scenerf_tpu/losses.py`: fixed shapes with value masks, so a masked mean
replaces the reference's boolean indexing."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import geometry as geo

DEPTH_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def l1_color_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-ray L1 color loss, mean over channels: [R, 3] -> [R]."""
    return torch.abs(target - pred).mean(dim=-1)


def reprojection_loss(
    noise: torch.Tensor,           # [R] N(0, 1) tie-break draw
    pix_source: torch.Tensor,      # [R, 2]
    color_source: torch.Tensor,    # [R, 3] colors sampled at pix_source
    depth_rendered: torch.Tensor,  # [R] (carries gradient)
    img_target: torch.Tensor,      # [H, W, 3]
    inv_K: torch.Tensor,
    cam_K: torch.Tensor,
    T_source2target: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """monodepth2-style min(reprojection, identity) L1 loss.

    Warps the source pixels into the target view at the rendered depth and
    compares the source color with the target color there and at the
    unwarped pixel (identity, plus `noise * 1e-5` to break ties); returns
    (per-ray minimum [R], valid [R]: the warped point lies in front of the
    target camera). The gradient reaches the depth through the warped pixel
    coords of the target-color gather."""
    cam_src = geo.pix_2_cam_pts(pix_source, inv_K, depth_rendered)
    cam_tgt = geo.transform_points(cam_src, T_source2target)
    pix_tgt = geo.cam_pts_2_pix(cam_tgt, cam_K)
    valid = cam_tgt[:, 2] > 0

    color_tgt = geo.sample_pix_features(pix_tgt, img_target)
    color_identity = geo.sample_pix_features(pix_source, img_target)

    loss_re = l1_color_loss(color_source, color_tgt)
    loss_id = l1_color_loss(color_source, color_identity) + noise * 1e-5
    return torch.minimum(loss_re, loss_id), valid


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8,
                group=None) -> torch.Tensor:
    """Mean of x over mask. With a process `group`, numerator and denominator
    are summed over its ranks first (differentiably), so rays split over the
    ranks give the unsplit masked mean (each rank's valid count may
    differ)."""
    m = mask.to(x.dtype)
    num, den = torch.sum(x * m), torch.sum(m)
    if group is not None:
        raise ValueError("the reference runs on one rank")
    return num / torch.clamp(den, min=eps)


def dist2closest_gaussian(
    gaussian_means: torch.Tensor,  # [R, G]
    gaussian_stds: torch.Tensor,   # [R, G]
    som_vars: torch.Tensor,        # [R, G]
    depth_rendered: torch.Tensor,  # [R]
) -> Dict[str, torch.Tensor]:
    """|closest Gaussian mean - rendered depth| and the matching std and
    RaySOM variance (logs). Depth is detached; the means carry gradient."""
    diff = torch.abs(gaussian_means - depth_rendered.detach()[:, None])
    closest, idx = torch.min(diff, dim=1)
    return {
        "loss_dist2closest_gauss": closest,
        "min_stds": torch.gather(gaussian_stds, 1, idx[:, None])[:, 0],
        "min_som_vars": torch.gather(som_vars, 1, idx[:, None])[:, 0],
    }


def depth_metrics(
    gt: torch.Tensor,
    pred: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    group=None,
) -> Dict[str, torch.Tensor]:
    """abs_rel / sq_rel / rmse / rmse_log / a1 / a2 / a3 over the masked GT
    pixels, predictions clamped to [min_depth, max_depth]. With a process
    `group`, each mean sums its numerator and denominator over the ranks
    (rmse and rmse_log take the square root after the mean over all)."""
    pred = torch.clamp(pred, min_depth, max_depth)
    if mask is None:
        mask = torch.ones_like(gt, dtype=torch.bool)
    gt_safe = torch.where(mask, gt, torch.ones_like(gt))

    def mmean(x):
        return masked_mean(x, mask, group=group)

    thresh = torch.maximum(gt_safe / pred, pred / gt_safe)
    return {
        "a1": mmean((thresh < 1.25).to(torch.float32)),
        "a2": mmean((thresh < 1.25 ** 2).to(torch.float32)),
        "a3": mmean((thresh < 1.25 ** 3).to(torch.float32)),
        "rmse": torch.sqrt(mmean((gt_safe - pred) ** 2)),
        "rmse_log": torch.sqrt(mmean((torch.log(gt_safe) - torch.log(pred)) ** 2)),
        "abs_rel": mmean(torch.abs(gt_safe - pred) / gt_safe),
        "sq_rel": mmean((gt_safe - pred) ** 2 / gt_safe),
    }
