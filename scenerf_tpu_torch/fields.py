"""Conditioned radiance-field MLP (pixelNeRF-style ResnetFC with per-block
latent injection). Counterpart of `scenerf_tpu/fields.py`, with the reference
parameter names: lin_in, blocks.{i}.fc_{0,1}, lin_z.{i}, lin_out."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _kaiming_linear(d_in: int, d_out: int, zero: bool = False) -> nn.Linear:
    """Linear with kaiming_normal(fan_in) weights (zeros if `zero`), zero bias."""
    lin = nn.Linear(d_in, d_out)
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        nn.init.kaiming_normal_(lin.weight, a=0, mode="fan_in")
    nn.init.zeros_(lin.bias)
    return lin


class ResnetBlockFC(nn.Module):
    """x + fc_1(relu(fc_0(relu(x)))); fc_1 starts at zero (identity block)."""

    def __init__(self, d_hidden: int):
        super().__init__()
        self.fc_0 = _kaiming_linear(d_hidden, d_hidden)
        self.fc_1 = _kaiming_linear(d_hidden, d_hidden, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc_1(F.relu(self.fc_0(F.relu(x))))


class ResnetFC(nn.Module):
    """h = lin_in(x); for each block: h = block(h + lin_z_i(z));
    out = lin_out(relu(h)).

    The n_blocks latent projections run as ONE [N, d_latent] x
    [d_latent, n * d_hidden] matmul (weights concatenated at forward time), so
    the wide latent is read once.
    """

    def __init__(self, d_in: int, d_out: int, d_latent: int, n_blocks: int = 3,
                 d_hidden: int = 512):
        super().__init__()
        self.n_blocks = n_blocks
        self.d_hidden = d_hidden
        self.lin_in = _kaiming_linear(d_in, d_hidden)
        self.lin_z = nn.ModuleList(_kaiming_linear(d_latent, d_hidden)
                                   for _ in range(n_blocks))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden) for _ in range(n_blocks))
        self.lin_out = _kaiming_linear(d_hidden, d_out)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = self.lin_in(x)
        wcat = torch.cat([l.weight for l in self.lin_z], dim=0)  # [n*dh, d_latent]
        bcat = torch.cat([l.bias for l in self.lin_z])
        tzs = torch.matmul(z.to(wcat.dtype), wcat.t()) + bcat
        for i, block in enumerate(self.blocks):
            h = block(h + tzs[..., i * self.d_hidden:(i + 1) * self.d_hidden])
        return self.lin_out(F.relu(h))


def radiance_outputs(mlp_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a d_out=4 field output into (density [N] = softplus(x - 1),
    rgb [N, 3] = sigmoid)."""
    rgb = torch.sigmoid(mlp_out[..., :3])
    density = F.softplus(mlp_out[..., 3] - 1.0)
    return density, rgb


def gaussian_params_from_offsets(
    offsets: torch.Tensor,           # [..., G, 2] raw mlp_gaussian output
    anchor_distances: torch.Tensor,  # [G]
    base_std: float,
    floor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean = relu(anchor + dm) + floor, std = relu(ds + base_std) + floor."""
    means = F.relu(anchor_distances + offsets[..., 0]) + floor
    stds = F.relu(offsets[..., 1] + base_std) + floor
    return means, stds
