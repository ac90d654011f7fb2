"""Spherical-grid U-Net decoder.

Counterpart of `scenerf_tpu/encoder/sphere_decoder.py`. Every encoder tap is
resampled onto the equirectangular sphere grid through an inverse map
sphere_cell -> source pixel (sentinel -10 marks out-of-FOV cells, which
sample zeros), then upsampled through the pyramid. The map depends only on
the intrinsics and is built once on the host in numpy; the resampling is the
gather kernel (`ops/gather.py`), whose backward carries the gradient into
the taps. Tensors are channel-last [B, H, W, C]. The decoder's batch norms
move their running averages with momentum 0.9 (flax's convention), as
`scenerf_tpu/encoder/sphere_decoder.py:143` sets. `dtype` is the compute
dtype of the convs (see `backbones.Conv2dCL`); the resamples and the
resizes run in the taps' dtype (bf16 taps through kernel G's bf16
instantiation, the resize matrices rounded to bf16 as JAX's
`_interp_matrix_align_corners(..., x.dtype)`).
Parameter names follow the reference: conv2, up{16,8,4,2,1}._net.0 (conv)
and _net.{1,2,3}.conv_block{1,2}.{0,1} (BasicBlocks).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.config import SphereConfig
from scenerf_tpu_torch.encoder.backbones import Conv2dCL
from scenerf_tpu_torch.encoder.norm import FusedBatchNorm
from scenerf_tpu_torch.ops.gather import gather_levels

Levels = Dict[str, torch.Tensor]

SCALES = (1, 2, 4, 8, 16, 32)
DECODER_BN_EPS = 1e-5
DECODER_BN_MOMENTUM = 0.9


def level_hw(sphere: SphereConfig, scale: int) -> Tuple[int, int]:
    return int(round(sphere.height / scale)), int(round(sphere.width / scale))


def build_sphere_maps(pix: np.ndarray, pix_sphere: np.ndarray,
                      sphere: SphereConfig) -> Dict[int, np.ndarray]:
    """Inverse maps sphere_cell -> source pixel coords at every scale:
    {scale: [out_H, out_W, 2] f32}, sentinel -10 where no pixel lands.
    Duplicate cells keep the last write (numpy assignment order)."""
    pix = np.asarray(pix, np.float32)
    pix_sphere = np.asarray(pix_sphere, np.float32)
    maps = {}
    for scale in SCALES:
        out_H, out_W = level_hw(sphere, scale)
        sx = np.clip(np.round(pix_sphere[:, 0] / scale).astype(np.int32), 0, out_W - 1)
        sy = np.clip(np.round(pix_sphere[:, 1] / scale).astype(np.int32), 0, out_H - 1)
        pix_scale = np.floor(pix / np.float32(scale))
        base = np.full((out_H * out_W, 2), -10.0, dtype=np.float32)
        base[sy * out_W + sx] = pix_scale
        maps[scale] = base.reshape(out_H, out_W, 2)
    return maps


def sphere_map_coords(sphere_map: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out_H, out_W, 2] map of image pixel coords -> continuous sample coords
    (ix, iy) [out_H*out_W] on an h x w tap (the normalize/unnormalize round
    trip of the JAX path, kept for identical rounding)."""
    flat = sphere_map.reshape(-1, 2)
    grid = torch.stack([flat[:, 0] / w, flat[:, 1] / h], dim=-1) * 2.0 - 1.0
    return geo.unnormalize_coords(grid, h, w)


def sphere_scatter_gather(feat: torch.Tensor, sphere_map: torch.Tensor) -> torch.Tensor:
    """Resample a batched image-space tap [B, h, w, C] onto the sphere grid
    -> [B, out_H, out_W, C] of the tap's dtype, one gather-kernel call per
    batch item."""
    _, h, w, _ = feat.shape
    out_H, out_W, _ = sphere_map.shape
    ix, iy = sphere_map_coords(sphere_map, h, w)
    return torch.stack([
        gather_levels([f.contiguous()], ix[None], iy[None]).reshape(out_H, out_W, -1)
        for f in feat
    ])


def interp_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix with align_corners=True
    (a uniform average when either side is a single pixel, as in the JAX
    package; F.interpolate differs there)."""
    if n_out == 1 or n_in == 1:
        return np.ones((n_out, n_in), np.float32) / n_in
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    M = np.zeros((n_out, n_in), dtype=np.float32)
    M[np.arange(n_out), lo] += 1.0 - frac
    M[np.arange(n_out), hi] += frac
    return M


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int, dtype: torch.dtype, device: torch.device
                   ) -> torch.Tensor:
    """`interp_matrix_align_corners` on `device` in `dtype`, copied there once
    per size (a handful a model) and shared, never written: a copy from
    pageable host memory waits for the card's queue to drain, and inside a
    training step's CUDA graph capture it is refused, so the step's first,
    eager run makes the matrices its graphs read."""
    return torch.as_tensor(interp_matrix_align_corners(n_in, n_out), dtype=dtype,
                           device=device)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (align_corners=True) of [B, H, W, C] via two matmuls
    in x's dtype (the matrices rounded to it)."""
    H, W = x.shape[-3], x.shape[-2]
    My = _interp_matrix(H, out_hw[0], x.dtype, x.device)
    Mx = _interp_matrix(W, out_hw[1], x.dtype, x.device)
    x = torch.einsum("oh,bhwc->bowc", My, x)
    return torch.einsum("pw,bhwc->bhpc", Mx, x)


class BasicBlock(nn.Module):
    """Dilated residual block: leaky(bn2(conv2(leaky(bn1(conv1 x)))) + x),
    each BN fused with its leaky-ReLU (JAX's: gradient 1 at 0), the second
    with the residual too."""

    def __init__(self, channels: int, dilation: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = dilation
        self.conv_block1 = nn.Sequential(
            Conv2dCL(channels, channels, 3, padding=d, dilation=d, dtype=dtype),
            FusedBatchNorm(channels, DECODER_BN_EPS, DECODER_BN_MOMENTUM, act="leaky"))
        self.conv_block2 = nn.Sequential(
            Conv2dCL(channels, channels, 3, padding=d, dilation=d, dtype=dtype),
            FusedBatchNorm(channels, DECODER_BN_EPS, DECODER_BN_MOMENTUM, act="leaky"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_block1(x)
        conv2, bn2 = self.conv_block2
        return bn2(conv2(h), x)


class UpSampleBN(nn.Module):
    """Upsample to the skip's size, concat, 3x3 conv, 3 dilated BasicBlocks."""

    def __init__(self, c_in: int, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self._net = nn.Sequential(
            Conv2dCL(c_in, channels, 3, padding=1, dtype=dtype),
            *(BasicBlock(channels, d, dtype) for d in (1, 2, 3)))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = resize_bilinear_align_corners(x, (skip.shape[-3], skip.shape[-2]))
        return self._net(torch.cat([up, skip], dim=-1))


class DecoderSphere(nn.Module):
    """Resample each tap onto the sphere grid, then upsample through the
    pyramid. Levels {"1_1": F//32 ch, "1_2": F//16, "1_4": F//8,
    "1_8": F//4, "1_16": F//2}."""

    def __init__(self, num_features: int, tap_channels: Dict[str, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        Fn = num_features
        self.conv2 = Conv2dCL(tap_channels["s32"], Fn, 1, dtype=dtype)
        self.up16 = UpSampleBN(Fn + tap_channels["s16"], Fn // 2, dtype)
        self.up8 = UpSampleBN(Fn // 2 + tap_channels["s8"], Fn // 4, dtype)
        self.up4 = UpSampleBN(Fn // 4 + tap_channels["s4"], Fn // 8, dtype)
        self.up2 = UpSampleBN(Fn // 8 + tap_channels["s2"], Fn // 16, dtype)
        self.up1 = UpSampleBN(Fn // 16 + tap_channels["s1"], Fn // 32, dtype)

    def forward(self, taps: Dict[str, torch.Tensor],
                maps: Dict[int, torch.Tensor]) -> Levels:
        x32 = self.conv2(taps["s32"])
        sph = {s: sphere_scatter_gather(taps[f"s{s}"], maps[s]) for s in (1, 2, 4, 8, 16)}
        sph[32] = sphere_scatter_gather(x32, maps[32])
        x_1_16 = self.up16(sph[32], sph[16])
        x_1_8 = self.up8(x_1_16, sph[8])
        x_1_4 = self.up4(x_1_8, sph[4])
        x_1_2 = self.up2(x_1_4, sph[2])
        x_1_1 = self.up1(x_1_2, sph[1])
        return {"1_1": x_1_1, "1_2": x_1_2, "1_4": x_1_4, "1_8": x_1_8,
                "1_16": x_1_16}


def decoder_latent_dim(num_features: int) -> int:
    """Concat width of all five levels = d_latent of the field MLP."""
    return sum(num_features // k for k in (2, 4, 8, 16, 32))
