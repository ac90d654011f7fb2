"""The SceneRF model in PyTorch: spherical U-Net image encoder + two
conditioned ResnetFC heads + the ray renderer, with the self-supervised loss
stack. Counterpart of `scenerf_tpu/model.py`: the serve path (encode one
frame, render depth and color at a sweep of poses) and the training forward
(`SceneRF.forward`: per-item and per-source renders, losses and the GT-depth
metrics).

Submodule names follow the reference Lightning layout (net_rgb, mlp,
mlp_gaussian), so a reference `state_dict` loads through
`utils/weights.load_reference_state_dict`.

`cfg.compute_dtype="bfloat16"` is the JAX package's mixed precision: the
parameters, the optimizer state and the batch-norm statistics stay f32;
the convs, batch norms, activations, the feature pyramid and the field MLPs
compute in bf16 (each module casts its input and weights when it runs, as
flax's `dtype=` fields do); the renderer's geometry, the sort-composite and
every loss stay f32, so gradients reach the f32 parameters through the casts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import geometry as geo
from . import losses as L
from . import rendering as R
from . import sampling as S
from .config import SceneRFConfig
from .encoder.sphere_decoder import build_sphere_maps
from .encoder.unet_sphere import UNet2DSphere
from .fields import ResnetFC
from .ops import PyramidGrads, share_pyramid_grads

LEVEL_KEYS = ("1_1", "1_2", "1_4", "1_8", "1_16")
LOSS_KEYS = ("loss_reprojection", "loss_color", "loss_kl", "loss_dist2closest_gauss")
LOG_KEYS = ("min_som_vars", "min_stds", "closest_pts_to_depth", "weights_at_depth")
NOISE_KEYS = ("pixels", "uni", "gauss", "reproj", "gt_uni", "gt_gauss")

Noise = Dict[str, torch.Tensor]  # NOISE_KEYS -> [B, S, ...] draws of one step


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`. A host tensor goes to the card through pinned memory
    without blocking: a blocking copy would end in a stream synchronize, so
    the host would wait there for the device's queued work."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def compute_sphere_maps(cfg: SceneRFConfig, cam_K) -> Dict[int, np.ndarray]:
    """Sphere inverse maps {scale: [out_H, out_W, 2]} of a camera's full
    pixel grid, built on the host in f32."""
    if isinstance(cam_K, torch.Tensor):
        cam_K = cam_K.detach().cpu()
    inv_K = torch.linalg.inv(torch.as_tensor(np.asarray(cam_K), dtype=torch.float32))
    pix, pix_sphere, _ = geo.sphere_coords_from_pixels(inv_K, cfg.sphere,
                                                       img_size=cfg.img_size)
    return build_sphere_maps(pix.numpy(), pix_sphere.numpy(), cfg.sphere)


class SceneRF(nn.Module):
    def __init__(self, cfg: SceneRFConfig):
        super().__init__()
        self.cfg = cfg
        # the modules' compute dtype: None on the f32 path (no casts), bf16
        # for compute_dtype="bfloat16" (parameters and BN statistics stay f32)
        dt = None if cfg.dtype == torch.float32 else cfg.dtype
        self.net_rgb = UNet2DSphere(cfg.encoder, cfg.encoder_features, cfg.bn_momentum, dt)
        self.d_latent = self.net_rgb.d_latent
        self.mlp = ResnetFC(cfg.d_in, 4, self.d_latent, cfg.n_blocks, cfg.d_hidden, dt)
        self.mlp_gaussian = ResnetFC(cfg.d_in, 2, self.d_latent, cfg.n_blocks,
                                     cfg.d_hidden, dt)

    # ---------------------------------------------------------------- encode
    def compute_sphere_maps(self, cam_K) -> Dict[int, np.ndarray]:
        """Sphere inverse maps for a camera, on the host (once per intrinsics)."""
        return compute_sphere_maps(self.cfg, cam_K)

    def encode(self, img: torch.Tensor, cam_K,
               sphere_maps: Optional[Dict[int, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
        """img [B, H, W, 3] on the model's device -> levels dict
        {"1_1".."1_16": [B, H_s, W_s, C_s]}. In eval mode (the serve path) it
        runs without autograd on the BN running statistics; in train mode the
        BNs use batch statistics and update their running averages, and the
        levels carry gradients. `sphere_maps` (numpy or device tensors) skip
        the host-side map build."""
        if sphere_maps is None:
            sphere_maps = self.compute_sphere_maps(cam_K)
        maps = {s: torch.as_tensor(m, device=img.device) for s, m in sphere_maps.items()}
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self.net_rgb(img.to(self.cfg.dtype), maps)

    @staticmethod
    def pyramid_for_item(levels: Dict[str, torch.Tensor], b: int) -> R.Pyramid:
        """One batch item's five levels, in rendering.SCALES order."""
        return tuple(levels[k][b] for k in LEVEL_KEYS)

    # ---------------------------------------------------------------- render
    def render_rays(self, pyramid: R.Pyramid, cam_K: torch.Tensor,
                    T_source2infer: torch.Tensor, pixels: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    ray_chunk: Optional[int] = None,
                    noise_uni: Optional[torch.Tensor] = None,
                    noise_gauss: Optional[torch.Tensor] = None,
                    with_som: bool = False,
                    pyramid_grads: Optional[PyramidGrads] = None) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (see rendering.render_rays)."""
        return R.render_rays(pixels, pyramid, cam_K, T_source2infer, self.mlp,
                             self.mlp_gaussian, self.cfg, generator=generator,
                             ray_chunk=ray_chunk, noise_uni=noise_uni,
                             noise_gauss=noise_gauss, with_som=with_som,
                             pyramid_grads=pyramid_grads)

    def _strided_pixels(self, stride: int, device) -> tuple:
        W, H = self.cfg.img_size
        pixels = S.grid_pixels(0, W, 0, H, stride, device=device, x_fastest=True)
        return pixels, (-(-H // stride), -(-W // stride))

    def render_image(self, pyramid: R.Pyramid, cam_K: torch.Tensor,
                     T_source2infer: torch.Tensor, generator: torch.Generator,
                     stride: int = 1, ray_chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Depth [H/stride, W/stride] and color [..., 3] at one pose."""
        pixels, (h, w) = self._strided_pixels(stride, pyramid[0].device)
        with torch.no_grad():
            out = self.render_rays(pyramid, cam_K, T_source2infer, pixels, generator,
                                   ray_chunk=ray_chunk or self.cfg.eval_ray_chunk)
        return {"depth": out["depth"].reshape(h, w),
                "color": out["color"].reshape(h, w, 3)}

    def render_pose_sweep(self, pyramid: R.Pyramid, cam_K: torch.Tensor,
                          poses: torch.Tensor, seed: int = 0, stride: int = 2,
                          ray_chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Depth [P, H/stride, W/stride] and color [P, ..., 3] for a stack of
        poses [P, 4, 4]; pose p draws its noise from a generator seeded with
        seed + p."""
        dev = pyramid[0].device
        depths, colors = [], []
        for p in range(poses.shape[0]):
            g = torch.Generator(device=dev).manual_seed(seed + p)
            out = self.render_image(pyramid, cam_K, poses[p], g, stride=stride,
                                    ray_chunk=ray_chunk)
            depths.append(out["depth"])
            colors.append(out["color"])
        return {"depth": torch.stack(depths), "color": torch.stack(colors)}

    # --------------------------------------------------------------- forward
    def _per_source(self, pyramid: R.Pyramid, pyramid_grads: Optional[PyramidGrads],
                    item_K: torch.Tensor, item_inv_K: torch.Tensor,
                    src: Dict[str, torch.Tensor], noise: Noise, with_losses: bool = True,
                    with_depth_eval: bool = True, ray_group=None) -> Dict[str, torch.Tensor]:
        """Losses and logs (the training render) and the depth metrics (the
        GT-depth render) of one (item, source) pair, each when asked for.
        `ray_group`: the rays (and GT rows) of `noise` and `src` are this
        rank's slice, and the masked means sum over the group."""
        cfg = self.cfg
        res = {}
        if with_losses:
            pix = noise["pixels"]
            out = self.render_rays(pyramid, item_K, src["T_source2infer"], pix,
                                   noise_uni=noise["uni"], noise_gauss=noise["gauss"],
                                   with_som=True, pyramid_grads=pyramid_grads)
            color_src = geo.sample_pix_features(pix, src["img_source"])
            d2g = L.dist2closest_gaussian(out["gaussian_means"], out["gaussian_stds"],
                                          out["som_vars"], out["depth"])
            loss_reproj, valid = L.reprojection_loss(
                noise["reproj"], pix, color_src, out["depth"], src["img_target"], item_inv_K,
                item_K, src["T_source2target"])
            res = {
                "loss_reprojection": L.masked_mean(loss_reproj, valid, group=ray_group),
                "loss_color": torch.abs(out["color"] - color_src).mean(),
                "loss_kl": out["loss_kl"].mean(),
                "loss_dist2closest_gauss": d2g["loss_dist2closest_gauss"].mean(),
                "min_som_vars": d2g["min_som_vars"].mean(),
                "min_stds": d2g["min_stds"].mean(),
                "closest_pts_to_depth": out["closest_pts_to_depth"].mean(),
                "weights_at_depth": out["weights_at_depth"].mean(),
            }
        if with_depth_eval:
            # depth metrics at the GT pixels: logs only, no gradient
            with torch.no_grad():
                ev = self.render_rays([lv.detach() for lv in pyramid], item_K,
                                      src["T_source2infer"], src["gt_pix"],
                                      ray_chunk=cfg.eval_ray_chunk, noise_uni=noise["gt_uni"],
                                      noise_gauss=noise["gt_gauss"])
                dm = L.depth_metrics(src["gt_depth"], ev["depth"], mask=src["gt_mask"] > 0,
                                     max_depth=cfg.eval_depth, group=ray_group)
            res.update({f"depth/{k}": v for k, v in dm.items()})
        return res

    def forward(self, batch: Dict[str, torch.Tensor], noise: Noise, train: bool = True,
                sphere_maps: Optional[Dict[int, torch.Tensor]] = None,
                with_losses: bool = True, with_depth_eval: bool = True, ray_group=None,
                levels: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training (train=True) or validation forward over a batch of
        device tensors (see data/synthetic.py for the contract) with every
        random draw given in `noise` (`draw_noise`). Puts the model in train
        or eval mode. Returns (total_loss, metrics): losses summed over the
        valid sources and divided by the batch size, logs and depth metrics
        as masked means over the sources; the metric names are the JAX
        package's. `with_losses=False` skips the training renders (no loss
        or log keys; total_loss 0), `with_depth_eval=False` the GT-depth
        renders (no depth/* keys); one of them must be on. Nothing here waits
        for the device.

        `ray_group` (a process group of W ranks, JAX's `ray_shard_n`): every
        rank holds the same batch and noise, and rank r renders rows [r n/W,
        (r+1) n/W) of each source's n_rays pixel sample and of its n_gt_depth
        GT rows, with those rows' noise; the masked means (reprojection, depth
        metrics) sum numerator and denominator over the group, the other
        losses and logs are this rank's means. Averaged over the ranks (the
        trainer's gradient and metric mean), a step equals the unsplit one up
        to the order of f32 sums.

        `levels`: the encoder's output to render from, in place of encoding
        `batch["img_input"]` (the check of a step stage by stage)."""
        if not (with_losses or with_depth_eval):
            raise ValueError("forward with with_losses=False requires with_depth_eval=True "
                             "(nothing to compute)")
        cfg = self.cfg
        self.train(train)
        B, S_n = batch["T_source2infer"].shape[:2]
        if ray_group is not None:
            raise ValueError("the reference runs on one rank")
        if levels is None:
            levels = self.encode(batch["img_input"], batch["cam_K"][0],
                                 sphere_maps=sphere_maps)

        sums: Dict[str, torch.Tensor] = {}
        for b in range(B):
            # every gather on the item's pyramid adds into one gradient
            # buffer per level (None: no gradient recorded)
            pyramid, pyramid_grads = share_pyramid_grads(self.pyramid_for_item(levels, b))
            item_K = batch["cam_K"][b]
            item_inv_K = R.inverse(item_K)
            for s in range(S_n):
                src = {
                    "T_source2infer": batch["T_source2infer"][b, s],
                    "T_source2target": batch["T_source2target"][b, s],
                    "img_source": batch["img_sources"][b, s],
                    "img_target": batch["img_targets"][b, s],
                    "gt_pix": batch["gt_pix"][b, s],
                    "gt_depth": batch["gt_depth"][b, s],
                    "gt_mask": batch["gt_mask"][b, s],
                }
                res = self._per_source(pyramid, pyramid_grads, item_K, item_inv_K, src,
                                       {k: v[b, s] for k, v in noise.items()}, with_losses,
                                       with_depth_eval, ray_group)
                m = batch["source_mask"][b, s]
                for k, v in res.items():
                    sums[k] = sums[k] + m * v if k in sums else m * v

        if with_losses:
            totals = {k: sums[k] / B for k in LOSS_KEYS}
            total_loss = (totals["loss_kl"]
                          + totals["loss_dist2closest_gauss"] * cfg.dist2closest_weight)
            if cfg.use_reprojection:
                total_loss = total_loss + totals["loss_reprojection"] * cfg.reprojection_weight
            if cfg.use_color:
                total_loss = total_loss + totals["loss_color"]
            metrics = dict(totals)
            metrics["loss_som_kl"] = metrics.pop("loss_kl")
        else:
            total_loss = torch.zeros((), device=batch["source_mask"].device)
            metrics = {}
        denom = torch.clamp(batch["source_mask"].sum(), min=1.0)
        for k in sums:
            if k not in LOSS_KEYS:
                metrics[k] = sums[k] / denom
        metrics["total_loss"] = total_loss
        return total_loss, metrics
