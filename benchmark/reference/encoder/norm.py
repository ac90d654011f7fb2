"""Batch normalization over channel-last tensors, fused with its activation.

Counterpart of `scenerf_tpu/encoder/norm.py:31 FusedBatchNorm` and the
activation the JAX package applies to its output (swish in the backbone,
leaky-ReLU in the decoder). In eval mode (`use_running_average=True` there)
the running statistics fold into per-channel `mul = weight * rsqrt(var +
eps)` and `add = bias - mean * mul` in f32, and `x * mul + add` applies in the
compute dtype. In train mode (`nn.Module.train()`) the statistics are the
batch's: f32 `mean` and `mean(x^2)` over every axis but the last, `var =
max(mean2 - mean^2, 0)` (the biased variance), and the running statistics
move in flax's momentum convention, `ra = momentum * ra + (1 - momentum) *
batch` (the opposite of torch BatchNorm's `momentum`). `forward(x,
residual)` returns `act(x * mul + add + residual)`, one fused op
(`ops/norm.py`: kernel K5 on the card). Parameter and buffer names are torch
BatchNorm's (weight, bias, running_mean, running_var).

`group` (a `torch.distributed` process group, or None) is JAX's `axis_name`:
in train mode the batch statistics are those of every rank's rows together
(`ops/norm.py batch_norm_act_synced`), so the running statistics move alike
on every rank. Eval mode, and a module without a group, take the one-rank
path.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import ACTS, batch_norm_act


class FusedBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.99,
                 act: str = "identity", group=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"act must be one of {ACTS}, got {act!r}")
        self.eps = eps
        self.momentum = momentum
        self.act = act
        self.group = group
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, residual: [..., C] channel-last."""
        return batch_norm_act(x, self.weight, self.bias, self.running_mean, self.running_var,
                              self.training, self.momentum, self.eps, self.act, residual,
                              self.group)


def set_sync_group(module: nn.Module, group) -> int:
    """Give every FusedBatchNorm under `module` the process group `group`
    (None: no sync); returns how many there are."""
    sites = [m for m in module.modules() if isinstance(m, FusedBatchNorm)]
    for m in sites:
        m.group = group
    return len(sites)
