"""Kernel G: multi-level bilinear gather, and its plain PyTorch version.

`gather_levels(levels, ix, iy)` samples every channel-last level
[H_l, W_l, C_l] at its own continuous pixel coords (ix[l], iy[l]) [N] with
zero padding, and returns the concatenation [N, sum C_l]. On a CUDA tensor it
launches `csrc/gather.cu`; on a CPU tensor it runs `gather_levels_plain`.
It replaces the TPU-shaped row-gather sampling of
`scenerf_tpu/geometry.py:106 bilinear_sample` (see the kernel source).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.ops import build


def gather_levels_plain(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                        iy: torch.Tensor) -> torch.Tensor:
    """`geometry.bilinear_sample` per level, then `torch.cat`."""
    return torch.cat([geo.bilinear_sample(lv, ix[i], iy[i])
                      for i, lv in enumerate(levels)], dim=-1)


def gather_levels(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                  iy: torch.Tensor) -> torch.Tensor:
    """Bilinear zero-padded gather of L channel-last levels at [L, N] coords
    -> [N, sum C_l]."""
    if len(levels) != ix.shape[0] or ix.shape != iy.shape or ix.dim() != 2:
        raise ValueError(f"{len(levels)} levels need ix, iy of shape [L, N]; "
                         f"got {tuple(ix.shape)}, {tuple(iy.shape)}")
    if not build.use_kernel(ix):
        return gather_levels_plain(levels, ix, iy)

    dev = ix.device
    for lv in levels:
        if lv.device != dev or lv.dtype != torch.float32 or lv.dim() != 3:
            raise ValueError("gather_levels kernel takes f32 [H, W, C] levels on "
                             f"{dev}; got {lv.dtype} {tuple(lv.shape)} on {lv.device}")
        if not lv.is_contiguous():
            raise ValueError("gather_levels kernel takes contiguous levels")
    if ix.dtype != torch.float32 or iy.dtype != torch.float32 or iy.device != dev:
        raise ValueError("gather_levels kernel takes f32 coords on the levels' device")
    ix = ix.contiguous()
    iy = iy.contiguous()
    n_levels, n_points = ix.shape
    widths = [lv.shape[2] for lv in levels]
    out = torch.empty((n_points, sum(widths)), dtype=torch.float32, device=dev)

    ptrs = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
    meta, col = [], 0
    for lv, c in zip(levels, widths):
        meta += [lv.shape[0], lv.shape[1], c, col]
        col += c
    hwcc = (ctypes.c_int * len(meta))(*meta)
    lib = build.library()
    status = lib.scenerf_gather_levels_f32(
        ptrs, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(), n_points,
        out.data_ptr(), out.shape[1], build.stream_handle(dev))
    build.check(status, "gather_levels")
    build.LAUNCHES["gather_levels"] += 1
    return out
