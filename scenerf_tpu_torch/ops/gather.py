"""Kernels G and G-bwd: multi-level bilinear gather and its backward, and
their plain PyTorch version.

`gather_levels(levels, ix, iy)` samples every channel-last level
[H_l, W_l, C_l] at its own continuous pixel coords (ix[l], iy[l]) [N] with
zero padding, and returns the concatenation [N, sum C_l]. On a CUDA tensor it
launches `csrc/gather.cu`, and where autograd needs it, `csrc/gather_bwd.cu`
for the gradient of the levels (and of the coords, when they require one);
on a CPU tensor it runs `gather_levels_plain`, whose autograd is the
backward's plain version. It replaces the TPU-shaped row-gather sampling of
`scenerf_tpu/geometry.py:106 bilinear_sample` and its custom VJPs in
`scenerf_tpu/ops/gather_scatter.py` (see the kernel sources).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.ops import build


def gather_levels_plain(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                        iy: torch.Tensor) -> torch.Tensor:
    """`geometry.bilinear_sample` per level, then `torch.cat`."""
    return torch.cat([geo.bilinear_sample(lv, ix[i], iy[i])
                      for i, lv in enumerate(levels)], dim=-1)


def _level_meta(levels: Sequence[torch.Tensor]):
    """ctypes [H, W, C, column offset] per level, and the total width."""
    meta, col = [], 0
    for lv in levels:
        meta += [lv.shape[0], lv.shape[1], lv.shape[2], col]
        col += lv.shape[2]
    return (ctypes.c_int * len(meta))(*meta), col


def _launch_forward(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                    iy: torch.Tensor) -> torch.Tensor:
    n_levels, n_points = ix.shape
    hwcc, width = _level_meta(levels)
    out = torch.empty((n_points, width), dtype=torch.float32, device=ix.device)
    ptrs = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
    status = build.library().scenerf_gather_levels_f32(
        ptrs, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(), n_points,
        out.data_ptr(), width, build.stream_handle(ix.device))
    build.check(status, "gather_levels")
    build.LAUNCHES["gather_levels"] += 1
    return out


def gather_levels_backward(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                           iy: torch.Tensor, d_out: torch.Tensor,
                           level_needs_grad: Sequence[bool], coords_need_grad: bool):
    """Launch kernel G-bwd: (d_levels, d_ix, d_iy) for the cotangent `d_out`
    [N, sum C_l] of `gather_levels(levels, ix, iy)`. A level whose flag is
    False gets None; d_ix, d_iy are None unless `coords_need_grad`."""
    n_levels, n_points = ix.shape
    hwcc, width = _level_meta(levels)
    if d_out.shape != (n_points, width):
        raise ValueError(f"gather_levels_backward: cotangent {tuple(d_out.shape)}, "
                         f"expected {(n_points, width)}")
    d_out = d_out.to(torch.float32).contiguous()
    d_levels: List[Optional[torch.Tensor]] = [
        torch.zeros_like(lv) if need else None for lv, need in zip(levels, level_needs_grad)]
    d_ix = torch.empty_like(ix) if coords_need_grad else None
    d_iy = torch.empty_like(iy) if coords_need_grad else None
    vals = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
    grads = (ctypes.c_void_p * n_levels)(*[build.ptr(g) for g in d_levels])
    status = build.library().scenerf_gather_levels_bwd_f32(
        vals, grads, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(), n_points,
        d_out.data_ptr(), width, build.ptr(d_ix), build.ptr(d_iy),
        build.stream_handle(ix.device))
    build.check(status, "gather_levels_bwd")
    build.LAUNCHES["gather_levels_bwd"] += 1
    return d_levels, d_ix, d_iy


class _GatherLevels(torch.autograd.Function):
    """Kernel G forward, kernel G-bwd backward."""

    @staticmethod
    def forward(ctx, ix, iy, *levels):
        ctx.save_for_backward(ix, iy, *levels)
        return _launch_forward(levels, ix, iy)

    @staticmethod
    def backward(ctx, d_out):
        ix, iy, *levels = ctx.saved_tensors
        coords = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        d_levels, d_ix, d_iy = gather_levels_backward(
            levels, ix, iy, d_out, ctx.needs_input_grad[2:], coords)
        return (d_ix if ctx.needs_input_grad[0] else None,
                d_iy if ctx.needs_input_grad[1] else None, *d_levels)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ix, iy, *levels)):
        return _GatherLevels.apply(ix, iy, *levels)
    return _launch_forward(levels, ix, iy)
