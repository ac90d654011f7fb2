"""Batch normalization over channel-last tensors.

Counterpart of `scenerf_tpu/encoder/norm.py:31 FusedBatchNorm`. In eval mode
(`use_running_average=True` there) the running statistics fold into
per-channel `mul = weight * rsqrt(var + eps)` and `add = bias - mean * mul` in
f32, and `x * mul + add` applies in the compute dtype. In train mode
(`nn.Module.train()`) the statistics are the batch's: f32 `mean` and
`mean(x^2)` over every axis but the last, `var = max(mean2 - mean^2, 0)` (the
biased variance; `torch.maximum` splits the gradient at a tie as JAX's
maximum does), and the running statistics move in flax's momentum
convention, `ra = momentum * ra + (1 - momentum) * batch` (the opposite of
torch BatchNorm's `momentum`). Parameter and buffer names are torch
BatchNorm's (weight, bias, running_mean, running_var).
"""
from __future__ import annotations

import torch
from torch import nn


class FusedBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., C] channel-last."""
        if self.training:
            dims = tuple(range(x.dim() - 1))
            xf = x.to(torch.float32)
            mean = torch.mean(xf, dim=dims)
            mean2 = torch.mean(torch.square(xf), dim=dims)
            var = torch.maximum(mean2 - torch.square(mean), torch.zeros_like(mean))
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)
