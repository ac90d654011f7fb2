"""The plain versions of the program's kernels G (multi-level bilinear
gather), C (per-ray sort + alpha composite), S (RaySOM's EM, in `som.py`)
and K5 (batch norm + activation + residual), as plain PyTorch under
autograd. Frozen copies of the program's plain versions; no kernel, no
custom backward: autograd differentiates these ops directly.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .geometry import bilinear_sample
from .som import som_em_plain

ACTS = ("identity", "silu", "leaky")
LEAKY_SLOPE = 0.01
SOM_KEYS = ("som_new_means", "som_new_vars", "som_mask")

PyramidGrads = None  # the reference keeps no shared gradient buffers


# ------------------------------------------------------------------ G


def gather_levels(levels: Sequence[torch.Tensor], ix: torch.Tensor, iy: torch.Tensor,
                  grads=None) -> torch.Tensor:
    """Bilinear zero-padded gather of L channel-last levels at [L, N] coords
    -> [N, sum C_l]; a bf16 level is sampled in f32 and rounded once."""
    return torch.cat([bilinear_sample(lv.to(torch.promote_types(lv.dtype, torch.float32)),
                                      ix[i], iy[i]).to(lv.dtype)
                      for i, lv in enumerate(levels)], dim=-1)


def share_pyramid_grads(levels: Sequence[torch.Tensor]) -> Tuple[Tuple[torch.Tensor, ...], None]:
    """The pyramid as it is: autograd sums the gathers' level gradients."""
    return tuple(levels), None


# ------------------------------------------------------------------ C


def composite(density: torch.Tensor, sensor_distance: torch.Tensor,
              depth_volume: torch.Tensor, colors: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Alpha-composite densities along rays already sorted by distance:
    deltas[0] = d[0]; alpha = 1 - exp(-delta * sigma); T = exclusive cumprod
    of (1 - alpha + 1e-10); weights = alpha * T. Depth integrates the
    source-frame z (depth_volume), not the ray length."""
    sd = torch.clamp(sensor_distance, min=0.0)
    deltas = torch.cat([sd[:, :1], sd[:, 1:] - sd[:, :-1]], dim=1)
    alphas = 1.0 - torch.exp(-deltas * density)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=1),
        dim=1,
    )[:, :-1]
    weights = alphas * trans

    depth = torch.sum(weights * depth_volume, dim=-1)
    color = torch.sum(weights[..., None] * colors, dim=-2)

    abs_diff = torch.abs(depth[:, None] - depth_volume)
    closest, closest_idx = torch.min(abs_diff, dim=1)
    weights_at_depth = torch.gather(weights, 1, closest_idx[:, None])[:, 0]
    return {
        "depth": depth,
        "color": color,
        "alphas": alphas,
        "weights": weights,
        "weights_at_depth": weights_at_depth,
        "closest_pts_to_depth": closest,
        "closest_idx": closest_idx.to(torch.int32),
        "sensor_distance": sensor_distance,
        "depth_volume": depth_volume,
    }


class SomInputs(NamedTuple):
    """What RaySOM's EM takes beside the sorted samples."""
    means: torch.Tensor  # [R, C] predicted Gaussian means
    stds: torch.Tensor   # [R, C] predicted Gaussian stds
    som_sigma: float
    mask_threshold: float


def sort_composite(sd: torch.Tensor, dv: torch.Tensor, density: torch.Tensor,
                   rgb: torch.Tensor, som: Optional[SomInputs] = None) -> Dict[str, torch.Tensor]:
    """Stable sort of each ray's samples by `sd` [R, P], then `composite`;
    with `som`, RaySOM's EM on the sorted samples (keys `SOM_KEYS`)."""
    sd_sorted, order = torch.sort(sd, dim=1, stable=True)
    dv_sorted = torch.gather(dv, 1, order)
    dens_sorted = torch.gather(density, 1, order)
    rgb_sorted = torch.gather(rgb, 1, order[..., None].expand(-1, -1, 3))
    out = composite(dens_sorted, sd_sorted, dv_sorted, rgb_sorted)
    if som is not None:
        em = som_em_plain(som.means, som.stds, out["sensor_distance"], out["alphas"],
                          som.som_sigma, som.mask_threshold)
        out.update(zip(SOM_KEYS, em))
    return out


# ------------------------------------------------------------------ K5


def activation(z: torch.Tensor, act: str) -> torch.Tensor:
    """The activation; leaky is `where(z >= 0, z, 0.01 z)`."""
    if act == "silu":
        return F.silu(z)
    if act == "leaky":
        return torch.where(z >= 0, z, LEAKY_SLOPE * z)
    if act == "identity":
        return z
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
                   momentum: float, eps: float, act: str = "identity",
                   residual: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Batch norm over every axis but the last (channel-last), then the
    residual, then the activation. Training mode normalises by the batch's
    biased variance (E[x^2] - E[x]^2, in f32) and moves the running
    statistics by `momentum` (the kept share)."""
    if group is not None:
        raise ValueError("the reference runs on one rank")
    if training:
        dims = tuple(range(x.dim() - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = torch.mean(xf, dim=dims)
        mean2 = torch.mean(torch.square(xf), dim=dims)
        var = torch.maximum(mean2 - torch.square(mean), torch.zeros_like(mean))
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    mul = weight * torch.rsqrt(var + eps)
    add = bias - mean * mul
    cd = torch.promote_types(x.dtype, torch.float32)
    z = x.to(cd) * mul.to(cd) + add.to(cd)
    if residual is not None:
        z = z + residual.to(cd)
    return activation(z, act).to(x.dtype)
