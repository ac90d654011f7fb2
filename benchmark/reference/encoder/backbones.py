"""Image backbones for the spherical U-Net encoder.

Counterpart of `scenerf_tpu/encoder/backbones.py`. The decoder consumes the
taps
  "s1"  = the input image          "s8"  = stage-2 output (stride 8)
  "s2"  = stage-0 output (stride 2) "s16" = stage-4 output (stride 16)
  "s4"  = stage-1 output (stride 4) "s32" = conv_head output, before its BN
all channel-last [B, H, W, C]. EfficientNet uses timm's parameter names
(conv_stem, bn1, blocks.{s}.{b}.*, conv_head) so a reference checkpoint loads
as it is; convs use TF-SAME padding like the `tf_` timm variants. The batch
norms use batch statistics in train mode, with `bn_momentum` (flax's
convention, `config.bn_momentum`) for their running averages.

`dtype` is the compute dtype, as flax's `nn.Conv(dtype=...)`: parameters
stay f32, and every conv casts its input, weight and bias to `dtype` when it
runs (bf16 on the mixed-precision path), so the activations, the squeeze-
excitation and the batch norms' inputs and outputs are in `dtype`. None (the
f32 path) casts nothing: a conv computes in its input's and parameters'
dtype, so an f64 copy of the module computes in f64.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import FusedBatchNorm

Taps = Dict[str, torch.Tensor]

# (expand_ratio, kernel, stride, base_filters, base_repeats) per stage
_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

VARIANTS = {
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
    "b4": (1.4, 1.8),
    "b5": (1.6, 2.2),
    "b6": (1.8, 2.6),
    "b7": (2.0, 3.1),
}

TAP_STAGES = {0: "s2", 1: "s4", 2: "s8", 4: "s16"}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_padding(size: Tuple[int, int], kernel: Tuple[int, int],
                 stride: Tuple[int, int], dilation: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """TF-SAME (top, bottom, left, right) padding: the extra pixel of an odd
    total goes to the bottom/right."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class Conv2dCL(nn.Conv2d):
    """nn.Conv2d over channel-last [B, H, W, C] tensors, initialized like
    flax's nn.Conv (lecun_normal weights, zero bias). With `same=True` the
    padding is TF-SAME for the input size (asymmetric where it must be).
    `dtype`: the compute dtype x, weight and bias are cast to (the f32
    parameters stay f32), as flax's `nn.Conv(dtype=...)`; None casts
    nothing."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, same: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(c_in, c_out, kernel, stride=stride, padding=padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.same = same
        self.compute_dtype = dtype
        fan_in = (c_in // groups) * kernel * kernel
        # flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2.0 * std, b=2.0 * std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if self.compute_dtype is not None:
            x, weight = x.to(self.compute_dtype), weight.to(self.compute_dtype)
            bias = None if bias is None else bias.to(self.compute_dtype)
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if self.same:
            pt, pb, pl, pr = same_padding(tuple(x.shape[-2:]), self.kernel_size,
                                          self.stride, self.dilation)
            if pt == pb and pl == pr:
                padding = (pt, pl)
            else:
                x = F.pad(x, (pl, pr, pt, pb))
                padding = (0, 0)
        y = F.conv2d(x, weight, bias, self.stride, padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class SqueezeExcite(nn.Module):
    """h * sigmoid(conv(silu(conv(mean(h))))), in h's dtype (the convs in
    the compute dtype), as the JAX package's MBConv."""

    def __init__(self, c_mid: int, c_se: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_reduce = Conv2dCL(c_mid, c_se, 1, dtype=dtype)
        self.conv_expand = Conv2dCL(c_se, c_mid, 1, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        se = torch.mean(h, dim=(1, 2), keepdim=True)
        se = F.silu(self.conv_reduce(se))
        return h * torch.sigmoid(self.conv_expand(se))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation. timm names: with
    expansion conv_pw/bn1, conv_dw/bn2, se, conv_pwl/bn3; without (stage 0)
    conv_dw/bn1, se, conv_pw/bn2."""

    def __init__(self, c_in: int, c_out: int, expand_ratio: int, kernel: int,
                 stride: int, se_ratio: float = 0.25, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.99, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c_mid = c_in * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = stride == 1 and c_in == c_out
        dw = Conv2dCL(c_mid, c_mid, kernel, stride=stride, groups=c_mid, bias=False,
                      same=True, dtype=dtype)
        se = SqueezeExcite(c_mid, max(1, int(c_in * se_ratio)), dtype)
        if self.expand:
            self.conv_pw = Conv2dCL(c_in, c_mid, 1, bias=False, dtype=dtype)
            self.bn1 = FusedBatchNorm(c_mid, bn_eps, bn_momentum, act="silu")
            self.conv_dw = dw
            self.bn2 = FusedBatchNorm(c_mid, bn_eps, bn_momentum, act="silu")
            self.se = se
            self.conv_pwl = Conv2dCL(c_mid, c_out, 1, bias=False, dtype=dtype)
            self.bn3 = FusedBatchNorm(c_out, bn_eps, bn_momentum)
        else:
            self.conv_dw = dw
            self.bn1 = FusedBatchNorm(c_mid, bn_eps, bn_momentum, act="silu")
            self.se = se
            self.conv_pw = Conv2dCL(c_mid, c_out, 1, bias=False, dtype=dtype)
            self.bn2 = FusedBatchNorm(c_out, bn_eps, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The projection BN adds the block's residual (identity activation)
        in its fused pass."""
        res = x if self.residual else None
        if self.expand:
            h = self.bn1(self.conv_pw(x))
            h = self.bn2(self.conv_dw(h))
            return self.bn3(self.conv_pwl(self.se(h)), res)
        h = self.bn1(self.conv_dw(x))
        return self.bn2(self.conv_pw(self.se(h)), res)


class EfficientNet(nn.Module):
    """EfficientNet feature extractor returning the U-Net taps (no classifier).
    `num_features` is the conv_head width (2560 for B7)."""

    def __init__(self, width: float = 2.0, depth: float = 3.1,
                 num_features: int = 2560, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.99, dtype: Optional[torch.dtype] = None):
        super().__init__()
        stem = round_filters(32, width)
        self.conv_stem = Conv2dCL(3, stem, 3, stride=2, bias=False, same=True, dtype=dtype)
        self.bn1 = FusedBatchNorm(stem, bn_eps, bn_momentum, act="silu")
        c_in = stem
        stages = []
        self.tap_channels = {"s1": 3}
        for si, (expand, kernel, stride, base_f, base_r) in enumerate(_STAGES):
            f_out = round_filters(base_f, width)
            blocks = []
            for bi in range(round_repeats(base_r, depth)):
                blocks.append(MBConv(c_in, f_out, expand, kernel,
                                     stride if bi == 0 else 1, bn_eps=bn_eps,
                                     bn_momentum=bn_momentum, dtype=dtype))
                c_in = f_out
            stages.append(nn.ModuleList(blocks))
            if si in TAP_STAGES:
                self.tap_channels[TAP_STAGES[si]] = f_out
        self.blocks = nn.ModuleList(stages)
        self.conv_head = Conv2dCL(c_in, num_features, 1, bias=False, dtype=dtype)
        self.tap_channels["s32"] = num_features

    def forward(self, x: torch.Tensor) -> Taps:
        taps: Taps = {"s1": x}
        h = self.bn1(self.conv_stem(x))
        for si, stage in enumerate(self.blocks):
            for block in stage:
                h = block(h)
            if si in TAP_STAGES:
                taps[TAP_STAGES[si]] = h
        # the reference taps the raw conv_head activation, before its BN
        taps["s32"] = self.conv_head(h)
        return taps


class TinyBackbone(nn.Module):
    """Small 5-level CNN with the same tap interface, for tests and smoke
    runs (no reference counterpart; names follow the JAX package)."""

    WIDTHS = (8, 12, 16, 24)

    def __init__(self, num_features: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c_in = 3
        for i, w in enumerate(self.WIDTHS):
            setattr(self, f"conv{i}", Conv2dCL(c_in, w, 3, stride=2, same=True, dtype=dtype))
            c_in = w
        self.conv_bottleneck = Conv2dCL(c_in, num_features, 3, stride=2, same=True,
                                        dtype=dtype)
        self.tap_channels = {"s1": 3, "s2": 8, "s4": 12, "s8": 16, "s16": 24,
                             "s32": num_features}

    def forward(self, x: torch.Tensor) -> Taps:
        taps: Taps = {"s1": x}
        h = x
        for i, name in enumerate(("s2", "s4", "s8", "s16")):
            h = F.relu(getattr(self, f"conv{i}")(h))
            taps[name] = h
        taps["s32"] = self.conv_bottleneck(h)
        return taps


def make_backbone(name: str, num_features: int | None = None,
                  bn_momentum: float = 0.99, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Build a backbone by config name: 'effnet-b{0..7}' or 'tiny'."""
    if name == "tiny":
        return TinyBackbone(num_features=num_features or 64, dtype=dtype)
    if name.startswith("effnet-"):
        width, depth = VARIANTS[name.split("-", 1)[1]]
        return EfficientNet(width=width, depth=depth,
                            num_features=num_features or round_filters(1280, width),
                            bn_momentum=bn_momentum, dtype=dtype)
    raise ValueError(f"unknown backbone: {name}")
