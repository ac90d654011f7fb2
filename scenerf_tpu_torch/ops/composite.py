"""Kernels C and C-bwd: per-ray sort + alpha composite and its backward, and
their plain PyTorch version.

`sort_composite(sd, dv, density, rgb)` takes the per-ray samples in the order
they were drawn, sorts them by sensor distance and alpha-composites them. On
a CUDA tensor it launches `csrc/composite.cu`, and where autograd needs it,
`csrc/composite_bwd.cu` for the gradient of depth and color; on a CPU tensor
it runs `sort_composite_plain`, whose autograd is the backward's plain
version. It replaces the TPU-shaped `scenerf_tpu/sampling.py:198
sort_samples_by_distance` + `rendering.py:102 composite` (see the kernel
sources).

Both return a dict with the per-ray `depth` [R], `color` [R, 3],
`weights_at_depth` [R], `closest_pts_to_depth` [R], `closest_idx` [R] and
the sorted `sensor_distance`, `depth_volume`, `alphas`, `weights` [R, P].
Only `depth` and `color` carry a gradient on the kernel path: the training
step reads the sorted samples and alphas detached (the RaySOM) and the rest
as logs. Given `som` (the training render), `sort_composite` also runs
RaySOM's EM update on the sorted samples and alphas (`som.som_em_plain`):
on a CUDA tensor inside kernel C's launch, which then counts as a launch of
kernel S too; the dict then also holds `som_new_means`, `som_new_vars` and
`som_mask` [R, C], with no gradient.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from scenerf_tpu_torch.ops import build
from scenerf_tpu_torch.som import em_launch_args, som_em_plain

MAX_PTS = 64  # samples per ray the kernel holds in one warp's registers


def composite(density: torch.Tensor, sensor_distance: torch.Tensor,
              depth_volume: torch.Tensor, colors: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Alpha-composite densities along rays already sorted by distance.

    deltas[0] = d[0]; alpha = 1 - exp(-delta * sigma); T = exclusive cumprod
    of (1 - alpha + 1e-10); weights = alpha * T. Depth integrates the
    source-frame z (depth_volume), not the ray length.
    """
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


def sort_composite_plain(sd: torch.Tensor, dv: torch.Tensor, density: torch.Tensor,
                         rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stable sort by distance, gather the payloads, then `composite`."""
    sd_sorted, order = torch.sort(sd, dim=1, stable=True)
    dv_sorted = torch.gather(dv, 1, order)
    dens_sorted = torch.gather(density, 1, order)
    rgb_sorted = torch.gather(rgb, 1, order[..., None].expand(-1, -1, 3))
    return composite(dens_sorted, sd_sorted, dv_sorted, rgb_sorted)


class SomInputs(NamedTuple):
    """What RaySOM's EM takes beside the sorted samples."""
    means: torch.Tensor  # [R, C] predicted Gaussian means
    stds: torch.Tensor   # [R, C] predicted Gaussian stds
    som_sigma: float
    mask_threshold: float


_OUT_KEYS = ("sensor_distance", "depth_volume", "alphas", "weights", "depth", "color",
             "weights_at_depth", "closest_pts_to_depth", "closest_idx")
SOM_KEYS = ("som_new_means", "som_new_vars", "som_mask")


def sort_composite_forward(sd, dv, density, rgb, with_order: bool = False,
                           som: Optional[SomInputs] = None):
    """Kernel C on contiguous f32 inputs -> (outputs in `_OUT_KEYS` order,
    order [R, P] int32 or None, RaySOM's EM outputs in `SOM_KEYS` order
    or None); with `som`, the EM runs in the same launch."""
    R, P = sd.shape
    dev = sd.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((R, P), **f32) for _ in range(4)]
    outs += [torch.empty((R,), **f32), torch.empty((R, 3), **f32),
             torch.empty((R,), **f32), torch.empty((R,), **f32),
             torch.empty((R,), dtype=torch.int32, device=dev)]
    order = torch.empty((R, P), dtype=torch.int32, device=dev) if with_order else None
    em, som_args = None, (None, None, 0, 0.0, 0.0, 0.0, None, None, None)
    if som is not None:
        (means, stds), scalars, em = em_launch_args(som.means, som.stds, P, som.som_sigma,
                                                    som.mask_threshold)
        if means.shape[0] != R or means.device != dev:
            raise ValueError(f"sort_composite: RaySOM means {tuple(means.shape)} on "
                             f"{means.device} for {R} rays on {dev}")
        som_args = (means.data_ptr(), stds.data_ptr(), *scalars, *(t.data_ptr() for t in em))
    status = build.library().scenerf_sort_composite_f32(
        *(t.data_ptr() for t in (sd, dv, density, rgb)), R, P,
        *(t.data_ptr() for t in outs), build.ptr(order), *som_args,
        build.stream_handle(dev))
    build.check(status, "sort_composite")
    build.LAUNCHES["sort_composite"] += 1
    if som is not None:
        build.LAUNCHES["ray_som"] += 1
        build.LAUNCHES["ray_som_in_sort_composite"] += 1
    return outs, order, em


def sort_composite_backward(sd_sorted, dv_sorted, order, density, rgb, d_depth, d_color):
    """Launch kernel C-bwd: (d_sd, d_dv, d_density, d_rgb) in drawn order for
    the cotangents d_depth [R], d_color [R, 3] of kernel C's depth and color."""
    R, P = sd_sorted.shape
    d_depth = d_depth.to(torch.float32).contiguous()
    d_color = d_color.to(torch.float32).contiguous()
    d_sd, d_dv, d_density = (torch.empty_like(sd_sorted) for _ in range(3))
    d_rgb = torch.empty_like(rgb)
    status = build.library().scenerf_sort_composite_bwd_f32(
        *(t.data_ptr() for t in (sd_sorted, dv_sorted, order, density, rgb,
                                 d_depth, d_color)), R, P,
        *(t.data_ptr() for t in (d_sd, d_dv, d_density, d_rgb)),
        build.stream_handle(sd_sorted.device))
    build.check(status, "sort_composite_bwd")
    build.LAUNCHES["sort_composite_bwd"] += 1
    return d_sd, d_dv, d_density, d_rgb


class _SortComposite(torch.autograd.Function):
    """Kernel C forward (writing the sort order), kernel C-bwd backward."""

    @staticmethod
    def forward(ctx, sd, dv, density, rgb, som):
        outs, order, em = sort_composite_forward(sd, dv, density, rgb, with_order=True,
                                                 som=som)
        ctx.save_for_backward(outs[0], outs[1], density, rgb)
        ctx.order = order  # an intermediate, not an input or output
        em = em or ()
        ctx.mark_non_differentiable(*(t for k, t in zip(_OUT_KEYS, outs)
                                      if k not in ("depth", "color")), *em)
        return (*outs, *em)

    @staticmethod
    def backward(ctx, *grads):
        sd_sorted, dv_sorted, density, rgb = ctx.saved_tensors
        d_depth, d_color = grads[_OUT_KEYS.index("depth")], grads[_OUT_KEYS.index("color")]
        d = sort_composite_backward(sd_sorted, dv_sorted, ctx.order, density, rgb,
                                    d_depth, d_color)
        return (*(g if need else None for g, need in zip(d, ctx.needs_input_grad)), None)


def sort_composite(sd: torch.Tensor, dv: torch.Tensor, density: torch.Tensor,
                   rgb: torch.Tensor, som: Optional[SomInputs] = None) -> Dict[str, torch.Tensor]:
    """Sort each ray's samples by `sd` [R, P] and alpha-composite them; with
    `som`, also RaySOM's EM on the sorted samples (keys `SOM_KEYS`)."""
    R, P = sd.shape
    if dv.shape != (R, P) or density.shape != (R, P) or rgb.shape != (R, P, 3):
        raise ValueError(f"sort_composite: shapes {tuple(sd.shape)}, {tuple(dv.shape)}, "
                         f"{tuple(density.shape)}, {tuple(rgb.shape)}")
    # kernel C has an f32 instantiation only; the caller converts (a bf16
    # field's density and rgb where JAX's promotion would), this does not
    for t in (sd, dv, density, rgb, *((som.means, som.stds) if som is not None else ())):
        if t.dtype != torch.float32:
            raise ValueError(f"sort_composite takes f32 tensors, got {t.dtype}")
    if not build.use_kernel(sd):
        out = sort_composite_plain(sd, dv, density, rgb)
        if som is not None:
            em = som_em_plain(som.means, som.stds, out["sensor_distance"], out["alphas"],
                              som.som_sigma, som.mask_threshold)
            out.update(zip(SOM_KEYS, em))
        return out

    if P > MAX_PTS:
        raise ValueError(f"sort_composite kernel takes at most {MAX_PTS} samples per ray, got {P}")
    dev = sd.device
    ins = [t.contiguous() for t in (sd, dv, density, rgb)]
    for t in ins:
        if t.device != dev:
            raise ValueError("sort_composite kernel takes tensors on one device")
    keys = _OUT_KEYS + (SOM_KEYS if som is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return dict(zip(keys, _SortComposite.apply(*ins, som)))
    outs, _, em = sort_composite_forward(*ins, with_order=False, som=som)
    return dict(zip(keys, (*outs, *(em or ()))))
