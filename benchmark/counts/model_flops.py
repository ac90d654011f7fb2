"""Model FLOPs: the forward's convolutions and matrix products, counted by
`torch.utils.flop_counter.FlopCounterMode` over the reference model run on
the meta device at the cell's shapes (2 per multiply-add). A training step
is three times its forward, but for the GT-depth render, which runs forward
only; recomputation is not counted. The same meta run records what kernels
G and K5 see in the encoder: every sphere resample's points and channels,
and every batch norm site's rows, channels, activation and residual.
"""
from __future__ import annotations

import functools
import json
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


@functools.lru_cache(maxsize=None)
def _encoder(conf_json: str) -> dict:
    from benchmark.drivers.train import reference_model
    from benchmark.reference.encoder import sphere_decoder as SD
    from benchmark.reference.encoder.norm import FusedBatchNorm

    conf = json.loads(conf_json)
    model = reference_model(conf, "meta")
    cfg = model.cfg
    W, H = cfg.img_size
    maps = {s: torch.empty(*SD.level_hw(cfg.sphere, s), 2, device="meta") for s in SD.SCALES}
    sites: List[Tuple[int, int, str, bool]] = []
    gathers: List[Tuple[int, int]] = []

    def on_bn(mod, args, kwargs):
        x = args[0]
        res = (args[1] if len(args) > 1 else kwargs.get("residual")) is not None
        sites.append((x.numel() // x.shape[-1], x.shape[-1], mod.act, res))

    hooks = [m.register_forward_pre_hook(on_bn, with_kwargs=True)
             for m in model.modules() if isinstance(m, FusedBatchNorm)]
    plain = SD.gather_levels

    def counting(levels, ix, iy, grads=None):
        gathers.append((ix.shape[1], sum(lv.shape[-1] for lv in levels)))
        return plain(levels, ix, iy, grads)

    SD.gather_levels = counting
    try:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model.net_rgb(torch.empty(1, H, W, 3, device="meta"), maps)
    finally:
        SD.gather_levels = plain
        for h in hooks:
            h.remove()
    return {"flops": fc.get_total_flops(), "bn_sites": sites, "sphere_gathers": gathers}


def encoder(conf: dict) -> dict:
    """{"flops": the encoder's forward FLOPs, "bn_sites": [(rows, channels,
    act, has_residual)], "sphere_gathers": [(points, channels)]}."""
    return _encoder(json.dumps(conf, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _field_per_point(conf_json: str) -> Tuple[float, float]:
    from benchmark.drivers.train import reference_model

    model = reference_model(json.loads(conf_json), "meta")
    cfg = model.cfg
    n = 1024
    z = torch.empty(n, model.d_latent, device="meta")
    x = torch.empty(n, cfg.d_in, device="meta")
    out = []
    for mlp in (model.mlp, model.mlp_gaussian):
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            mlp(z, x)
        out.append(fc.get_total_flops() / n)
    return out[0], out[1]


def field_per_point(conf: dict) -> Tuple[float, float]:
    """(FLOPs of the radiance field, of the Gaussian field) per point."""
    return _field_per_point(json.dumps(conf, sort_keys=True))


def render(conf: dict, cfg, n_rays: int) -> float:
    """Forward FLOPs of rendering n_rays: the radiance field at every sample
    and the Gaussian field at every anchor."""
    f_rad, f_gauss = field_per_point(conf)
    return n_rays * (cfg.n_pts_per_ray * f_rad + cfg.n_gaussians * f_gauss)


def train_step(conf: dict, cfg) -> float:
    """A training step: 3 x (encoder + the training renders) + the GT-depth
    renders, for every source of the one batch item."""
    per_src = 3 * render(conf, cfg, cfg.n_rays) + render(conf, cfg, cfg.n_gt_depth)
    return 3 * encoder(conf)["flops"] + cfg.n_sources * per_src


def d_latent(conf: dict) -> int:
    """The channels of the pyramid the fields read."""
    from benchmark.drivers.train import reference_model

    return reference_model(conf, "meta").d_latent
