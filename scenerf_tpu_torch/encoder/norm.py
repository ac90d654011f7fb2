"""Batch normalization over channel-last tensors, eval path.

Counterpart of `scenerf_tpu/encoder/norm.py:31 FusedBatchNorm` with
`use_running_average=True`: the running statistics fold into per-channel
`mul = weight * rsqrt(var + eps)` and `add = bias - mean * mul` in f32, and
`x * mul + add` applies in the compute dtype. Parameter and buffer names are
torch BatchNorm's (weight, bias, running_mean, running_var). Batch statistics
(training) are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn


class FusedBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., C] channel-last."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)
