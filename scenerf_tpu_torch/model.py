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

from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import losses as L
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch import sampling as S
from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.encoder.sphere_decoder import build_sphere_maps
from scenerf_tpu_torch.encoder.unet_sphere import UNet2DSphere
from scenerf_tpu_torch.fields import ResnetFC
from scenerf_tpu_torch.ops.gather import PyramidGrads, share_pyramid_grads
from scenerf_tpu_torch.parallel import dist as D
from scenerf_tpu_torch.utils import tracing

LEVEL_KEYS = ("1_1", "1_2", "1_4", "1_8", "1_16")
LOSS_KEYS = ("loss_reprojection", "loss_color", "loss_kl", "loss_dist2closest_gauss")
LOG_KEYS = ("min_som_vars", "min_stds", "closest_pts_to_depth", "weights_at_depth")
NOISE_KEYS = ("pixels", "uni", "gauss", "reproj", "gt_uni", "gt_gauss")
# an item's per-source batch keys and draws, of its training and its GT-depth renders
TRAIN_KEYS = ("T_source2infer", "T_source2target", "img_sources", "img_targets")
TRAIN_NOISE = ("pixels", "uni", "gauss", "reproj")
GT_KEYS = ("T_source2infer", "gt_pix", "gt_depth", "gt_mask")
GT_NOISE = ("gt_uni", "gt_gauss")

Noise = Dict[str, torch.Tensor]  # NOISE_KEYS -> [B, S, ...] draws of one step


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`. A host tensor goes to the card through pinned memory
    without blocking: a blocking copy would end in a stream synchronize, so
    the host would wait there for the device's queued work."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        tracing.count("h2d_bytes", t.numel() * t.element_size())
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
               sphere_maps: Optional[Dict[int, np.ndarray]] = None,
               net: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """img [B, H, W, 3] on the model's device -> levels dict
        {"1_1".."1_16": [B, H_s, W_s, C_s]}. In eval mode (the serve path) it
        runs without autograd on the BN running statistics; in train mode the
        BNs use batch statistics and update their running averages, and the
        levels carry gradients. `sphere_maps` (numpy or device tensors) skip
        the host-side map build. `net` runs `net_rgb` in its place (the
        trainer's CUDA-graph replay of it; None: the module)."""
        with tracing.span("encode"):
            if sphere_maps is None:
                sphere_maps = self.compute_sphere_maps(cam_K)
            maps = {s: torch.as_tensor(m, device=img.device) for s, m in sphere_maps.items()}
            with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
                return (net or self.net_rgb)(img.to(self.cfg.dtype), maps)

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
        with tracing.span("render_image"), torch.no_grad():
            pixels, (h, w) = self._strided_pixels(stride, pyramid[0].device)
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
    def draw_noise(self, n_items: int, n_sources: int, generator: torch.Generator,
                   device) -> Noise:
        """Every random draw of one training forward, [B, S, ...] per key:
        the training pixels (`sampling.random_grid_pixels`), the render's
        U(0, 1) / N(0, 1) sample noise, the reprojection tie-break N(0, 1)
        and the GT-depth render's noise. They are drawn on the generator's
        device and moved to `device` (a host generator gives the same draws
        to a run on the CPU and on the card)."""
        cfg = self.cfg
        W, H = cfg.img_size
        R_, G = cfg.n_rays, cfg.n_gt_depth
        gdev = generator.device
        pixels = torch.stack([torch.stack([
            S.random_grid_pixels(generator, R_, W, H, stride=cfg.pixel_stride,
                                 grid_size=cfg.sample_grid_size, device=gdev)
            for _ in range(n_sources)]) for _ in range(n_items)])
        lead = (n_items, n_sources)
        kw = dict(generator=generator, device=gdev)
        noise = {
            "pixels": pixels,
            "uni": torch.rand(*lead, R_, cfg.n_pts_uni, **kw),
            "gauss": torch.randn(*lead, R_, cfg.n_pts_gauss, **kw),
            "reproj": torch.randn(*lead, R_, **kw),
            "gt_uni": torch.rand(*lead, G, cfg.n_pts_uni, **kw),
            "gt_gauss": torch.randn(*lead, G, cfg.n_pts_gauss, **kw),
        }
        return {k: to_device(v, device) for k, v in noise.items()}

    def loss_weights(self) -> Dict[str, float]:
        """The weight of each LOSS_KEYS term that `forward`'s total_loss sums,
        in its order; a term the config switches off is left out. Its keys
        are the outputs of a training render that gradients reach."""
        cfg = self.cfg
        weights = {"loss_kl": 1.0, "loss_dist2closest_gauss": cfg.dist2closest_weight}
        if cfg.use_reprojection:
            weights["loss_reprojection"] = cfg.reprojection_weight
        if cfg.use_color:
            weights["loss_color"] = 1.0
        return weights

    @staticmethod
    def item_inputs(batch: Dict[str, torch.Tensor], noise: Noise, b: int,
                    with_losses: bool, with_depth_eval: bool) -> Tuple[Dict, Dict]:
        """Item b's inputs of its training renders and of its GT-depth
        renders (each None when not asked for): its camera, and per source
        key [S, ...]."""
        K = batch["cam_K"][b]
        train = gt = None
        if with_losses:
            train = {"cam_K": K, "inv_K": R.inverse(K),
                     **{k: batch[k][b] for k in TRAIN_KEYS},
                     **{k: noise[k][b] for k in TRAIN_NOISE}}
        if with_depth_eval:
            gt = {"cam_K": K, **{k: batch[k][b] for k in GT_KEYS},
                  **{k: noise[k][b] for k in GT_NOISE}}
        return train, gt

    def render_train_item(self, pyramid: R.Pyramid, item: Dict[str, torch.Tensor],
                          ray_group=None) -> List[Dict[str, torch.Tensor]]:
        """The training renders of one item's sources (`item_inputs`) with
        their losses and logs, one dict of LOSS_KEYS + LOG_KEYS a source.
        Every gather on the item's pyramid adds into one gradient buffer per
        level (none when no gradient is recorded). `ray_group`: the rays of
        `item` are this rank's slice, and the masked mean sums over the
        group."""
        pyramid, pyramid_grads = share_pyramid_grads(pyramid)
        out = []
        for s in range(item["pixels"].shape[0]):
            pix = item["pixels"][s]
            r = self.render_rays(pyramid, item["cam_K"], item["T_source2infer"][s], pix,
                                 noise_uni=item["uni"][s],
                                 noise_gauss=item["gauss"][s], with_som=True,
                                 pyramid_grads=pyramid_grads)
            color_src = geo.sample_pix_features(pix, item["img_sources"][s])
            d2g = L.dist2closest_gaussian(r["gaussian_means"], r["gaussian_stds"],
                                          r["som_vars"], r["depth"])
            loss_reproj, valid = L.reprojection_loss(
                item["reproj"][s], pix, color_src, r["depth"], item["img_targets"][s],
                item["inv_K"], item["cam_K"], item["T_source2target"][s])
            out.append({
                "loss_reprojection": L.masked_mean(loss_reproj, valid, group=ray_group),
                "loss_color": torch.abs(r["color"] - color_src).mean(),
                "loss_kl": r["loss_kl"].mean(),
                "loss_dist2closest_gauss": d2g["loss_dist2closest_gauss"].mean(),
                "min_som_vars": d2g["min_som_vars"].mean(),
                "min_stds": d2g["min_stds"].mean(),
                "closest_pts_to_depth": r["closest_pts_to_depth"].mean(),
                "weights_at_depth": r["weights_at_depth"].mean(),
            })
        return out

    @torch.no_grad()
    def render_gt_item(self, pyramid: R.Pyramid, item: Dict[str, torch.Tensor],
                       ray_group=None) -> List[Dict[str, torch.Tensor]]:
        """The depth metrics at one item's GT pixels (`item_inputs`), one dict
        of "depth/*" keys a source: logs only, no gradient. `ray_group`: the
        GT rows are this rank's slice, the metrics sum over the group."""
        pyramid = [lv.detach() for lv in pyramid]
        out = []
        for s in range(item["gt_pix"].shape[0]):
            ev = self.render_rays(pyramid, item["cam_K"], item["T_source2infer"][s],
                                  item["gt_pix"][s], ray_chunk=self.cfg.eval_ray_chunk,
                                  noise_uni=item["gt_uni"][s], noise_gauss=item["gt_gauss"][s])
            dm = L.depth_metrics(item["gt_depth"][s], ev["depth"], mask=item["gt_mask"][s] > 0,
                                 max_depth=self.cfg.eval_depth, group=ray_group)
            out.append({f"depth/{k}": v for k, v in dm.items()})
        return out

    def _ray_slice(self, noise: Noise, batch: Dict[str, torch.Tensor], group,
                   with_losses: bool, with_depth_eval: bool) -> Tuple[Noise, Dict]:
        """This rank's rows of every source's rays and GT rows (`forward`'s
        `ray_group`); raises unless the world divides them."""
        W, r = D.size(group), D.rank(group)
        n, g = noise["pixels"].shape[2], batch["gt_pix"].shape[2]
        if with_losses and n % W:
            raise ValueError(f"n_rays={n} must be a multiple of the {W} ranks for ray_shard")
        if with_depth_eval and g % W:
            raise ValueError(f"n_gt_depth={g} must be a multiple of the {W} ranks for "
                             f"ray_shard with depth eval (the GT rows are split like the "
                             f"rays)")
        rows = {"pixels": n, "uni": n, "gauss": n, "reproj": n, "gt_uni": g, "gt_gauss": g}
        noise = {k: v[:, :, r * (rows[k] // W):(r + 1) * (rows[k] // W)]
                 for k, v in noise.items()}
        gk = g // W
        batch = {**batch, **{k: batch[k][:, :, r * gk:(r + 1) * gk]
                             for k in ("gt_pix", "gt_depth", "gt_mask")}}
        return noise, batch

    def forward(self, batch: Dict[str, torch.Tensor], noise: Noise, train: bool = True,
                sphere_maps: Optional[Dict[int, torch.Tensor]] = None,
                with_losses: bool = True, with_depth_eval: bool = True, ray_group=None,
                graphs=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
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

        `graphs` (the trainer's `step_graphs.StepGraphs` for these shapes;
        None: every block eager): the encoder and each item's training and
        GT-depth renders replay its CUDA graphs, reached through the same
        calls of `encode` and `pyramid_for_item` and the same spans."""
        if not (with_losses or with_depth_eval):
            raise ValueError("forward with with_losses=False requires with_depth_eval=True "
                             "(nothing to compute)")
        self.train(train)
        B, S_n = batch["T_source2infer"].shape[:2]
        if ray_group is not None:
            noise, batch = self._ray_slice(noise, batch, ray_group, with_losses,
                                           with_depth_eval)
        levels = self.encode(batch["img_input"], batch["cam_K"][0], sphere_maps=sphere_maps,
                             net=graphs and graphs.encoder)

        sums: Dict[str, torch.Tensor] = {}
        for b in range(B):
            pyramid = self.pyramid_for_item(levels, b)
            train_in, gt_in = self.item_inputs(batch, noise, b, with_losses, with_depth_eval)
            res = [{} for _ in range(S_n)]
            if with_losses:
                with tracing.span("render_train"):
                    run = (graphs.render_train[b] if graphs
                           else partial(self.render_train_item, ray_group=ray_group))
                    for r, out in zip(res, run(pyramid, train_in)):
                        r.update(out)
            if with_depth_eval:
                with tracing.span("render_gt"):
                    run = (graphs.render_gt[b] if graphs
                           else partial(self.render_gt_item, ray_group=ray_group))
                    for r, out in zip(res, run(pyramid, gt_in)):
                        r.update(out)
            for s in range(S_n):
                m = batch["source_mask"][b, s]
                for k, v in res[s].items():
                    sums[k] = sums[k] + m * v if k in sums else m * v

        if with_losses:
            totals = {k: sums[k] / B for k in LOSS_KEYS}
            total_loss = sum(totals[k] * w for k, w in self.loss_weights().items())
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
