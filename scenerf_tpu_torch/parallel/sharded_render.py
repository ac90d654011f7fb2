"""Eval renders with their rays split over ranks: the counterpart of
`scenerf_tpu/parallel/sharded_render.py`. Rays are independent, so for the
large eval renders (LiDAR pixel sets, full images, pose sweeps) every rank
of a process group renders its contiguous slice of the pixel rows against
its own copy of the frame's pyramid, and the slices are gathered on rank 0,
which alone returns the result (the other ranks return None).

The noise of a ray does not depend on the split: every rank draws the whole
render's noise from the shared generator seed, exactly as the one-rank
render draws it (`rendering.render_rays`: U(0, 1) [N, n_pts_uni], then N(0,
1) [N, n_pts_gauss]), and takes its rows. The rows are padded with zeros to
a multiple of W * chunk (JAX's `pad_to`), so each rank renders n_local =
padded / W rows in chunks of `local_chunk(n_local, chunk)`; the padding is
cut after the gather. So the gathered result is the one-rank render's up to
the rounding of products whose batch differs (the last chunk's). A world of
one rank has no group and no renderer here: its callers render with
`render_rays` / `render_pose_sweep`, unchanged.

Every rank of the group must call a renderer with the same arguments
(pixels, poses and seeds: broadcast from rank 0 where only it read them).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from scenerf_tpu_torch import sampling as S
from scenerf_tpu_torch.parallel import dist as D

Output = Optional[Dict[str, torch.Tensor]]


def local_chunk(n_local: int, ray_chunk: int) -> int:
    """The largest block of at most `ray_chunk` rays that divides a rank's
    `n_local` rows (JAX's `_local_chunk`)."""
    return n_local if n_local <= ray_chunk else math.gcd(n_local, ray_chunk)


def _render_split(model, pyramid, cam_K, T, pixels, generator, ray_chunk: int, group,
                  uni=None, gauss=None) -> Output:
    """Depth [N] and color [N, 3] of `pixels` [N, 2] on rank 0 of `group`; the
    noise of all N rays drawn from `generator` unless given."""
    cfg = model.cfg
    dev = pixels.device
    W, r = D.size(group), D.rank(group)
    N = pixels.shape[0]
    if uni is None:
        uni = S.row_noise(generator, N, cfg.n_pts_uni, device=dev)
    if gauss is None:
        gauss = S.row_noise(generator, N, cfg.n_pts_gauss, dist="normal", device=dev)
    total = N + (-N) % (W * ray_chunk)
    n_local = total // W
    lo, hi = r * n_local, min(N, (r + 1) * n_local)
    real = max(0, hi - lo)

    def rows(t: torch.Tensor) -> torch.Tensor:
        out = t.new_zeros((n_local, *t.shape[1:]))
        out[:real] = t[lo:lo + real]
        return out

    with torch.no_grad():
        out = model.render_rays(pyramid, cam_K, T, rows(pixels),
                                ray_chunk=local_chunk(n_local, ray_chunk),
                                noise_uni=rows(uni), noise_gauss=rows(gauss))
        depth = D.gather_rows(out["depth"], total, group)
        color = D.gather_rows(out["color"], total, group)
    if depth is None:
        return None
    return {"depth": depth[:N], "color": color[:N]}


def _need_group(group) -> None:
    if group is None:
        raise ValueError("a sharded render needs a process group (one rank renders with "
                         "render_rays / render_pose_sweep)")


def make_sharded_renderer(model, group, ray_chunk: int) -> Callable[..., Output]:
    """render(pyramid, cam_K, T, pixels, generator, noise_uni=None,
    noise_gauss=None) -> {"depth" [N], "color" [N, 3]} on rank 0 of `group`
    (None on the others), the rays split over the group's ranks, the noise
    of all N rays drawn from `generator` unless given."""
    _need_group(group)

    def render(pyramid, cam_K, T, pixels, generator, noise_uni=None,
               noise_gauss=None) -> Output:
        return _render_split(model, pyramid, cam_K, T, pixels, generator, ray_chunk, group,
                             noise_uni, noise_gauss)

    return render


def make_sharded_pose_sweep(model, group, stride: int,
                            ray_chunk: Optional[int] = None) -> Callable[..., Output]:
    """sweep(pyramid, cam_K, poses [P, 4, 4], seed) -> {"depth" [P, h, w],
    "color" [P, h, w, 3]} on rank 0 of `group` (None on the others): pose p
    draws from a generator seeded seed + p, as `model.render_pose_sweep`,
    each pose's strided pixel grid split over the ranks."""
    _need_group(group)
    chunk = ray_chunk or model.cfg.eval_ray_chunk

    def sweep(pyramid, cam_K, poses, seed: int = 0) -> Output:
        dev = pyramid[0].device
        pixels, (h, w) = model._strided_pixels(stride, dev)
        depths, colors = [], []
        for p in range(poses.shape[0]):
            g = torch.Generator(device=dev).manual_seed(seed + p)
            out = _render_split(model, pyramid, cam_K, poses[p], pixels, g, chunk, group)
            if out is not None:
                depths.append(out["depth"].reshape(h, w))
                colors.append(out["color"].reshape(h, w, 3))
        if not depths:
            return None
        return {"depth": torch.stack(depths), "color": torch.stack(colors)}

    return sweep
