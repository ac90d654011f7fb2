"""The SceneRF model in PyTorch: spherical U-Net image encoder + two
conditioned ResnetFC heads + the ray renderer (serve path: encode one frame,
render depth and color at a sweep of poses). Counterpart of
`scenerf_tpu/model.py`; the training forward and losses are not ported yet.

Submodule names follow the reference Lightning layout (net_rgb, mlp,
mlp_gaussian), so a reference `state_dict` loads through
`utils/weights.load_reference_state_dict`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch import rendering as R
from scenerf_tpu_torch.config import SceneRFConfig
from scenerf_tpu_torch.encoder.sphere_decoder import build_sphere_maps
from scenerf_tpu_torch.encoder.unet_sphere import UNet2DSphere
from scenerf_tpu_torch.fields import ResnetFC

LEVEL_KEYS = ("1_1", "1_2", "1_4", "1_8", "1_16")


def compute_sphere_maps(cfg: SceneRFConfig, cam_K) -> Dict[int, np.ndarray]:
    """Sphere inverse maps {scale: [out_H, out_W, 2]} of a camera's full
    pixel grid, built on the host in f32."""
    inv_K = torch.linalg.inv(torch.as_tensor(np.asarray(cam_K), dtype=torch.float32))
    pix, pix_sphere, _ = geo.sphere_coords_from_pixels(inv_K, cfg.sphere,
                                                       img_size=cfg.img_size)
    return build_sphere_maps(pix.numpy(), pix_sphere.numpy(), cfg.sphere)


class SceneRF(nn.Module):
    def __init__(self, cfg: SceneRFConfig):
        super().__init__()
        if cfg.dtype != torch.float32:
            raise NotImplementedError("the port runs in float32 only so far "
                                      f"(compute_dtype={cfg.compute_dtype!r})")
        self.cfg = cfg
        self.net_rgb = UNet2DSphere(cfg.encoder, cfg.encoder_features)
        self.d_latent = self.net_rgb.d_latent
        self.mlp = ResnetFC(cfg.d_in, 4, self.d_latent, cfg.n_blocks, cfg.d_hidden)
        self.mlp_gaussian = ResnetFC(cfg.d_in, 2, self.d_latent, cfg.n_blocks,
                                     cfg.d_hidden)

    # ---------------------------------------------------------------- encode
    def compute_sphere_maps(self, cam_K) -> Dict[int, np.ndarray]:
        """Sphere inverse maps for a camera, on the host (once per intrinsics)."""
        return compute_sphere_maps(self.cfg, cam_K)

    def encode(self, img: torch.Tensor, cam_K,
               sphere_maps: Optional[Dict[int, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
        """img [B, H, W, 3] on the model's device -> levels dict
        {"1_1".."1_16": [B, H_s, W_s, C_s]} (eval mode, no grad)."""
        if sphere_maps is None:
            sphere_maps = self.compute_sphere_maps(cam_K)
        maps = {s: torch.tensor(m, device=img.device) for s, m in sphere_maps.items()}
        with torch.no_grad():
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
                    with_som: bool = False) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (see rendering.render_rays)."""
        return R.render_rays(pixels, pyramid, cam_K, T_source2infer, self.mlp,
                             self.mlp_gaussian, self.cfg, generator=generator,
                             ray_chunk=ray_chunk, noise_uni=noise_uni,
                             noise_gauss=noise_gauss, with_som=with_som)

    def _strided_pixels(self, stride: int, device) -> tuple:
        W, H = self.cfg.img_size
        xs = torch.arange(0, W, stride, dtype=torch.float32, device=device)
        ys = torch.arange(0, H, stride, dtype=torch.float32, device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1), (len(ys), len(xs))

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
