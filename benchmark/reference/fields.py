"""Conditioned radiance-field MLP (pixelNeRF-style ResnetFC with per-block
latent injection). Counterpart of `scenerf_tpu/fields.py`, with the reference
parameter names: lin_in, blocks.{i}.fc_{0,1}, lin_z.{i}, lin_out.

`dtype` is the compute dtype, as flax's `nn.Dense(dtype=...)`: the weights
stay f32 and each layer casts its input, weight and bias to it when it runs
(bf16 on the mixed-precision path: the products are bf16 `torch.matmul`s,
the ReLUs and the residual adds bf16, and so is the output). None (the f32
path) casts nothing."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`lin(x)` in the compute dtype `dtype` (None: as it is)."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


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

    def __init__(self, d_hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.fc_0 = _kaiming_linear(d_hidden, d_hidden)
        self.fc_1 = _kaiming_linear(d_hidden, d_hidden, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return x + _dense(self.fc_1, F.relu(_dense(self.fc_0, F.relu(x), dt)), dt)


class ResnetFC(nn.Module):
    """h = lin_in(x); for each block: h = block(h + lin_z_i(z));
    out = lin_out(relu(h)).

    The n_blocks latent projections run as ONE [N, d_latent] x
    [d_latent, n * d_hidden] matmul (weights concatenated at forward time), so
    the wide latent is read once.
    """

    def __init__(self, d_in: int, d_out: int, d_latent: int, n_blocks: int = 3,
                 d_hidden: int = 512, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_blocks = n_blocks
        self.d_hidden = d_hidden
        self.compute_dtype = dtype
        self.lin_in = _kaiming_linear(d_in, d_hidden)
        self.lin_z = nn.ModuleList(_kaiming_linear(d_latent, d_hidden)
                                   for _ in range(n_blocks))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden, dtype) for _ in range(n_blocks))
        self.lin_out = _kaiming_linear(d_hidden, d_out)

    def forward(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = _dense(self.lin_in, x, dt)
        wcat = torch.cat([l.weight for l in self.lin_z], dim=0)  # [n*dh, d_latent]
        bcat = torch.cat([l.bias for l in self.lin_z])
        if dt is not None:  # as JAX: the concatenated f32 weights cast once
            wcat, bcat = wcat.to(dt), bcat.to(dt)
        tzs = torch.matmul(z.to(wcat.dtype), wcat.t()) + bcat
        for i, block in enumerate(self.blocks):
            h = block(h + tzs[..., i * self.d_hidden:(i + 1) * self.d_hidden])
        return _dense(self.lin_out, F.relu(h), dt)


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
    """mean = relu(anchor + dm) + floor, std = relu(ds + base_std) + floor.
    Both come out f32: with bf16 offsets the means promote to f32 against the
    f32 anchors, and the stds are computed in bf16 (the scalars do not
    promote, as in JAX) and converted exactly to f32, where JAX's promotion
    takes them at their first f32 operand."""
    means = F.relu(anchor_distances + offsets[..., 0]) + floor
    stds = F.relu(offsets[..., 1] + base_std) + floor
    return means, stds.to(means.dtype)
