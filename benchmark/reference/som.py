"""RaySOM: self-organizing-map EM update of the per-ray Gaussian mixture and
the KL loss toward the re-estimated Gaussians. Counterpart of
`scenerf_tpu/som.py`.

The EM half is detached: on a CUDA tensor it runs kernel S
(`ops/csrc/som.cu`), on a CPU tensor `som_em_plain`, its plain version. The
training render runs the same EM inside kernel C's launch
(`ops.composite.sort_composite(som=...)`) and hands its outputs to
`ray_som(em=...)`. The KL, the only part with a gradient, is plain PyTorch
on [R, C] under autograd and sees the predicted means/stds.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


MAX_PROTOS = 8  # mixture components per ray the kernel holds


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


def _sum_over_protos(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (the C prototypes) left to right, as kernel S
    adds them."""
    acc = t[..., 0]
    for c in range(1, t.shape[-1]):
        acc = acc + t[..., c]
    return acc


def som_assign_plain(m: torch.Tensor, s: torch.Tensor, d: torch.Tensor, alphas: torch.Tensor,
                     som_sigma: float):
    """The E half of `som_em_plain`: (rel_w [R, C2, C1], p(z | c1)
    [R, P, C1], the best prototype's p(z | c2) and its index [R, P]).

    A sample far from every prototype has its likelihood at the 1e-5 floor
    for all of them, and its best prototype is then decided by the rounding
    of p(z | c2); so the sums over prototypes run left to right and every
    division is a true division, in the kernel's order (the JAX package's
    einsum rounds such samples its own way)."""
    m, s, d = m.detach(), s.detach(), d.detach()
    dens = alphas.detach() + 1e-8

    dist = torch.abs(m[:, None, :] - d[:, :, None])                      # [R, P, C]
    dm = m[:, :, None] - m[:, None, :]
    rel_w = torch.exp(-(dm * dm) / torch.full_like(dm, 2.0 * som_sigma ** 2))  # [R, C2, C1]
    p_c1_given_c2 = rel_w / _sum_over_protos(rel_w)[..., None]

    p_z_c1 = (torch.exp(-(dist * dist) / (2.0 * (s * s)[:, None, :]))
              / (math.sqrt(2.0 * math.pi) * s[:, None, :]) + 1e-5)
    p_z_c1 = p_z_c1 * dens[:, :, None] + 1e-8                             # [R, P, C1]

    n_protos = m.shape[1]
    p_z_c2 = _sum_over_protos(p_z_c1[:, :, None, :] * p_c1_given_c2[:, None, :, :]
                              ) + n_protos * 1e-8                         # [R, P, C2]
    p_best, best = torch.max(p_z_c2, dim=2)                               # [R, P]
    return rel_w, p_z_c1, p_best, best


def som_em_plain(m: torch.Tensor, s: torch.Tensor, d: torch.Tensor, alphas: torch.Tensor,
                 som_sigma: float, mask_threshold: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One EM step of the mixture means m and stds s [R, C] toward the sorted
    samples d [R, P] weighted by their alphas -> (new_means, new_vars, mask)
    [R, C]; the plain version of kernel S (inputs detached)."""
    rel_w, p_z_c1, p_best, best = som_assign_plain(m, s, d, alphas, som_sigma)
    m, s, d = m.detach(), s.detach(), d.detach()
    var = s * s
    n_protos = m.shape[1]

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
    return new_means, new_vars, (mean_mask & var_mask).to(m.dtype)


def som_em(m: torch.Tensor, s: torch.Tensor, d: torch.Tensor, alphas: torch.Tensor,
           som_sigma: float, mask_threshold: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The EM step: `som_em_plain`."""
    return som_em_plain(m, s, d, alphas, som_sigma, mask_threshold)


def ray_som(
    gauss_means: torch.Tensor,       # [R, C]
    gauss_stds: torch.Tensor,        # [R, C]
    sensor_distances: torch.Tensor,  # [R, P] sorted sample distances
    density: torch.Tensor,           # [R, P] per-sample alphas
    som_sigma: float,
    mask_threshold: float = 0.1,
    std_floor: float = 1.5,
    em: Optional[Sequence[torch.Tensor]] = None,
) -> RaySOMResult:
    """The EM step and the KL toward its Gaussians. `em`: the EM's
    (new_means, new_vars, mask) of these inputs where the caller already has
    them (kernel C's training launch runs it), else computed here."""
    if em is None:
        em = som_em(gauss_means, gauss_stds, sensor_distances, density, som_sigma,
                    mask_threshold)
    new_means, new_vars, mask = em
    new_stds = torch.sqrt(new_vars)
    loss = kl_gauss(gauss_means, new_means, gauss_stds, new_stds, std_floor)
    loss_kl = torch.mean(loss * mask.to(gauss_means.dtype), dim=1)
    return RaySOMResult(loss_kl=loss_kl, new_means=new_means, new_vars=new_vars)
