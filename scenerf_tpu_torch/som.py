"""RaySOM: self-organizing-map EM update of the per-ray Gaussian mixture and
the KL loss toward the re-estimated Gaussians. Counterpart of
`scenerf_tpu/som.py` (plain PyTorch; every EM quantity is detached, only the
final KL sees the predicted means/stds)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RaySOMResult(NamedTuple):
    loss_kl: torch.Tensor    # [R]
    new_means: torch.Tensor  # [R, C]
    new_vars: torch.Tensor   # [R, C]


def kl_gauss(m1, m2, s1, s2, std_floor: float = 1.5):
    """KL(N(m1,s1) || N(m2,s2)) with the target std floored."""
    s2 = torch.clamp(s2, min=std_floor)
    std_err = torch.log(s2 / s1 + 1e-8)
    mean_err = (s1 ** 2 + (m1 - m2) ** 2) / (2.0 * s2 ** 2)
    return std_err + mean_err - 0.5


def ray_som(
    gauss_means: torch.Tensor,       # [R, C]
    gauss_stds: torch.Tensor,        # [R, C]
    sensor_distances: torch.Tensor,  # [R, P] sorted sample distances
    density: torch.Tensor,           # [R, P] per-sample alphas
    som_sigma: float,
    mask_threshold: float = 0.1,
    std_floor: float = 1.5,
) -> RaySOMResult:
    m = gauss_means.detach()
    s = gauss_stds.detach()
    d = sensor_distances.detach()
    dens = density.detach() + 1e-8

    dist = torch.abs(m[:, None, :] - d[:, :, None])                      # [R, P, C]
    rel_w = torch.exp(-((m[:, :, None] - m[:, None, :]) ** 2) / (2.0 * som_sigma ** 2))
    p_c1_given_c2 = rel_w / torch.sum(rel_w, dim=2, keepdim=True)

    var = s ** 2
    p_z_c1 = (torch.exp(-(dist ** 2) / (2.0 * var[:, None, :]))
              / (math.sqrt(2.0 * math.pi) * s[:, None, :]) + 1e-5)
    p_z_c1 = p_z_c1 * dens[:, :, None] + 1e-8                             # [R, P, C1]

    n_protos = m.shape[1]
    p_z_c2 = torch.einsum("rpc,rkc->rpk", p_z_c1, p_c1_given_c2) + n_protos * 1e-8
    p_best, best = torch.max(p_z_c2, dim=2)                               # [R, P]

    # w_rel[r, c, p] = rel_w[r, c, best[r, p]]
    w_rel = torch.gather(rel_w, 2, best[:, None, :].expand(-1, n_protos, -1))
    w = w_rel * p_z_c1.transpose(1, 2) / p_best[:, None, :] + 1e-5       # [R, C, P]
    w_sum = torch.sum(w, dim=2)
    new_means = torch.sum(w * d[:, None, :], dim=2) / w_sum
    new_vars = torch.sum(w * (d[:, None, :] - new_means[..., None]) ** 2, dim=2) / w_sum

    mean_diffs = torch.abs(m - new_means)
    var_diffs = torch.abs(torch.sqrt(var) - torch.sqrt(new_vars))
    mean_mask = (mean_diffs > mask_threshold) & (new_vars > 0)
    var_mask = (var_diffs > mask_threshold) & (new_vars > 0)
    mask = (mean_mask & var_mask).to(gauss_means.dtype)

    new_stds = torch.sqrt(new_vars)
    loss = kl_gauss(gauss_means, new_means.detach(), gauss_stds, new_stds.detach(), std_floor)
    loss_kl = torch.mean(loss * mask, dim=1)
    return RaySOMResult(loss_kl=loss_kl, new_means=new_means, new_vars=new_vars)
