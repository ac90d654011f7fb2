"""NeRF positional encoding, laid out as `scenerf_tpu/encoding.py`:
[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with f_k = pi * 2^k and
each cosine computed as a sine with a pi/2 phase offset."""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def positional_encoding_dim(num_freqs: int = 6, d_in: int = 3, include_input: bool = True) -> int:
    return num_freqs * 2 * d_in + (d_in if include_input else 0)


@functools.lru_cache(maxsize=None)
def _freqs_phases(num_freqs: int, freq_factor: float, dtype: torch.dtype,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoding's [2F] frequencies and phases on `device`, copied there
    once and shared, never written (see `encoder/sphere_decoder._interp_matrix`)."""
    freqs = freq_factor * (2.0 ** np.arange(num_freqs, dtype=np.float32))
    freqs = np.repeat(freqs, 2)
    phases = np.zeros(2 * num_freqs, dtype=np.float32)
    phases[1::2] = math.pi * 0.5
    return (torch.as_tensor(freqs, dtype=dtype, device=device),
            torch.as_tensor(phases, dtype=dtype, device=device))


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int = 6,
    freq_factor: float = math.pi,
    include_input: bool = True,
) -> torch.Tensor:
    """[..., d_in] points -> [..., d_out]; block j of 2F covers the d_in coords
    at flat positions j * d_in + c, even j = sin, odd j = cos."""
    d_in = x.shape[-1]
    freqs_t, phases_t = _freqs_phases(num_freqs, freq_factor, x.dtype, x.device)
    scaled = x[..., None, :] * freqs_t[:, None] + phases_t[:, None]
    embed = torch.sin(scaled).reshape(*x.shape[:-1], 2 * num_freqs * d_in)
    if include_input:
        embed = torch.cat([x, embed], dim=-1)
    return embed
