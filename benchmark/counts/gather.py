"""Kernel G's bytes and operations, after the program's `chip_smoke.py`
`bound` of the gather: 9 operations per output element (four taps, their
weights, three blends), the output written once and the f32 coordinates
read once. The level rows read are left out: which rows the points touch
depends on the data (chip_smoke counts them from the coordinates, which the
benchmark does not see), so these bytes are a lower bound and the roofline
share read from them can only come out low. Counted per unit of work: a
training step's or a pose's gathers, whatever launches the program makes.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from benchmark.counts.peaks import bound_s

N_LEVELS = 5


def gather_work(points: int, channels: int, itemsize: int, levels: int) -> Tuple[float, float]:
    """(bytes, operations) of gathering `channels` over `levels` levels at
    `points` points."""
    return points * channels * itemsize + 2 * 4 * levels * points, 9.0 * points * channels


def render_points(cfg, n_rays: int) -> int:
    """Points gathered from the pyramid to render n_rays: the samples and
    the Gaussian anchors of every ray."""
    return n_rays * (cfg.n_pts_per_ray + cfg.n_gaussians)


def bound(pieces: Iterable[Tuple[float, float]]) -> float:
    """The least time of a set of gathers, each at its own bound."""
    return sum(bound_s(b, o) for b, o in pieces)


def render_pieces(cfg, d_latent: int, n_rays: int, itemsize: int):
    return [gather_work(render_points(cfg, n_rays), d_latent, itemsize, N_LEVELS)]


def encoder_pieces(sphere_gathers, itemsize: int):
    return [gather_work(n, c, itemsize, 1) for n, c in sphere_gathers]


def train_step_s(cfg, d_latent: int, sphere_gathers, itemsize: int) -> float:
    """G's least time in a training step: the encoder's sphere resamples,
    each source's training and GT-depth renders, and the reprojection loss's
    three image gathers (3 f32 channels) a source."""
    pieces = encoder_pieces(sphere_gathers, itemsize)
    for _ in range(cfg.n_sources):
        pieces += render_pieces(cfg, d_latent, cfg.n_rays, itemsize)
        pieces += render_pieces(cfg, d_latent, cfg.n_gt_depth, itemsize)
        pieces += [gather_work(cfg.n_rays, 3, 4, 1)] * 3
    return bound(pieces)


def pose_s(cfg, d_latent: int, n_rays: int, itemsize: int) -> float:
    """G's least time in rendering one pose of n_rays."""
    return bound(render_pieces(cfg, d_latent, n_rays, itemsize))


def encode_s(sphere_gathers, itemsize: int) -> float:
    return bound(encoder_pieces(sphere_gathers, itemsize))
