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

Many gathers read one pyramid in a training step (every render chunk's
samples and Gaussian anchors, for every source). `share_pyramid_grads` passes
the pyramid through one autograd node and returns a `PyramidGrads` that the
caller hands to each of those gathers: their backwards add into one f32
gradient buffer per level, zeroed once, and the node gives the buffers to
autograd once, so no backward launch zeroes a full level gradient and
autograd sums none.

Levels are f32, or bf16 on the mixed-precision path (all levels of one
gather alike; the coords are f32 always). In bf16 the gather interpolates in
f32, from corner values converted exactly and f32 weights, and rounds each
output to bf16 once; JAX's `bilinear_sample` on a bf16 level rounds the
weights to bf16 as well (`scenerf_tpu/geometry.py:135-136`) and
interpolates in bf16. The backward reads the bf16 cotangent and adds into
the same f32 gradient buffers; autograd gets each level's gradient in the
level's dtype, cast once per pyramid (per step), not per gather.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from scenerf_tpu_torch import geometry as geo
from scenerf_tpu_torch.ops import build


# the level types the kernels are instantiated for, and their entries' suffix
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def gather_levels_plain(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                        iy: torch.Tensor) -> torch.Tensor:
    """`geometry.bilinear_sample` per level, then `torch.cat`; a bf16 level
    is sampled in f32 and the result rounded to bf16 once."""
    return torch.cat([geo.bilinear_sample(_compute(lv), ix[i], iy[i]).to(lv.dtype)
                      for i, lv in enumerate(levels)], dim=-1)


def _compute_dtype(lv: torch.Tensor) -> torch.dtype:
    """The dtype a level is sampled and its gradient summed in: f32 for
    bf16, else its own."""
    return torch.promote_types(lv.dtype, torch.float32)


def _compute(lv: torch.Tensor) -> torch.Tensor:
    return lv.to(_compute_dtype(lv))


def levels_dtype(levels: Sequence[torch.Tensor], kernel: bool = False) -> torch.dtype:
    """The one element type of a gather's levels; raises on a mix, and for
    the kernels (`kernel`) on a type without an instantiation."""
    dtypes = {lv.dtype for lv in levels}
    if len(dtypes) != 1 or (kernel and not dtypes <= set(DTYPES)):
        what = "levels of one dtype" + (", f32 or bf16" if kernel else "")
        raise ValueError(f"gather_levels takes {what}; got {[lv.dtype for lv in levels]}")
    return dtypes.pop()


# a launch that would run fewer warps than this widens its lane groups
MIN_WARPS = 1024


def channels_per_vector(dtype: torch.dtype) -> int:
    """Channels of one 16-byte vector: what a lane of kernels G and G-bwd
    moves at a time (4 f32, 8 bf16)."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def lanes_per_point(widths: Sequence[int], n_points: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> int:
    """Lanes of a warp that serve one point in kernels G and G-bwd: the next
    power of two >= ceil(max width / v) (each lane moves v channels, one
    16-byte vector of `dtype`), in [1, 32]; for `n_points` so few that the
    launch would run fewer than MIN_WARPS warps, doubled until it does not
    (or 32)."""
    need = min(-(-max(widths) // channels_per_vector(dtype)), 32)
    lanes = 1
    while lanes < need:
        lanes *= 2
    while n_points is not None and lanes < 32 and n_points * lanes < MIN_WARPS * 32:
        lanes *= 2
    return lanes


def rounds_per_warp(n_points: int, lanes: int) -> int:
    """Point groups one warp of kernel G serves one after another: 4 where
    the launch would run >= 131,072 warps (the serve chunk's 320,000
    points), else 1. A warp's next points are the next samples of its ray,
    whose corner rows at the coarse levels it has just read into L1; fewer
    warps pay for it only where there are many."""
    warps = -(-n_points * lanes // 32)
    return 4 if warps >= 131072 else 1


def _level_meta(levels: Sequence[torch.Tensor], n_points: int):
    """ctypes [H, W, C, column offset] per level, the total width, and the
    lanes per point."""
    meta, col = [], 0
    for lv in levels:
        meta += [lv.shape[0], lv.shape[1], lv.shape[2], col]
        col += lv.shape[2]
    lanes = lanes_per_point([lv.shape[2] for lv in levels], n_points, levels[0].dtype)
    return (ctypes.c_int * len(meta))(*meta), col, lanes


def forward_launch_args(levels: Sequence[torch.Tensor], n_points: int):
    """Kernel G's launch arguments after the level table: (hwcc, out_cols,
    lanes, rounds, async_wide). The wide levels go through the kernel's
    cp.async ring in launches of one round; the long launches' four rounds
    reuse L1 instead, which the ring's 48 KB of shared memory per block
    would take from them."""
    hwcc, width, lanes = _level_meta(levels, n_points)
    rounds = rounds_per_warp(n_points, lanes)
    return hwcc, width, lanes, rounds, int(rounds == 1)


def _launch_forward(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                    iy: torch.Tensor) -> torch.Tensor:
    n_levels, n_points = ix.shape
    hwcc, width, lanes, rounds, async_wide = forward_launch_args(levels, n_points)
    dtype = levels_dtype(levels, kernel=True)
    out = torch.empty((n_points, width), dtype=dtype, device=ix.device)
    ptrs = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
    status = getattr(build.library(), f"scenerf_gather_levels_{DTYPES[dtype]}")(
        ptrs, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(), n_points, out.data_ptr(), width,
        lanes, rounds, async_wide, build.stream_handle(ix.device))
    build.check(status, "gather_levels")
    build.count_launch("gather_levels", dtype)
    return out


def gather_levels_backward(levels: Sequence[torch.Tensor], ix: torch.Tensor,
                           iy: torch.Tensor, d_out: torch.Tensor,
                           d_levels: Sequence[Optional[torch.Tensor]],
                           coords_need_grad: bool):
    """Launch kernel G-bwd for the cotangent `d_out` [N, sum C_l] (of the
    levels' dtype) of `gather_levels(levels, ix, iy)`: add the level
    gradients into `d_levels` (f32 buffers shaped as the levels; None for a
    level that needs none) and return (d_ix, d_iy), both None unless
    `coords_need_grad`."""
    n_levels, n_points = ix.shape
    dtype = levels_dtype(levels, kernel=True)
    hwcc, width, lanes = _level_meta(levels, n_points)
    if d_out.shape != (n_points, width) or d_out.dtype != dtype:
        raise ValueError(f"gather_levels_backward: cotangent {d_out.dtype} "
                         f"{tuple(d_out.shape)}, expected {dtype} {(n_points, width)}")
    for lv, d in zip(levels, d_levels):
        if d is not None and (d.shape != lv.shape or d.dtype != torch.float32
                              or d.device != lv.device or not d.is_contiguous()):
            raise ValueError("gather_levels_backward: a level gradient buffer must be a "
                             f"contiguous f32 {tuple(lv.shape)} on {lv.device}")
    d_out = d_out.contiguous()
    d_ix = torch.empty_like(ix) if coords_need_grad else None
    d_iy = torch.empty_like(iy) if coords_need_grad else None
    vals = (ctypes.c_void_p * n_levels)(*[lv.data_ptr() for lv in levels])
    grads = (ctypes.c_void_p * n_levels)(*[build.ptr(g) for g in d_levels])
    status = getattr(build.library(), f"scenerf_gather_levels_bwd_{DTYPES[dtype]}")(
        vals, grads, hwcc, n_levels, ix.data_ptr(), iy.data_ptr(), n_points,
        d_out.data_ptr(), width, build.ptr(d_ix), build.ptr(d_iy), lanes, 0,
        build.stream_handle(ix.device))
    build.check(status, "gather_levels_bwd")
    build.count_launch("gather_levels_bwd", dtype)
    return d_ix, d_iy


def _plain_backward(levels, ix, iy, d_out, d_levels, coords_need_grad: bool):
    """G-bwd's plain version with G-bwd's contract: autograd of
    `gather_levels_plain`, its level gradients added into `d_levels` (in
    f32: a bf16 level is differentiated through its f32 copy)."""
    with torch.enable_grad():
        lvs = [_compute(lv.detach()).requires_grad_(d is not None)
               for lv, d in zip(levels, d_levels)]
        x = ix.detach().requires_grad_(coords_need_grad)
        y = iy.detach().requires_grad_(coords_need_grad)
        wrt = [t for t in (*lvs, x, y) if t.requires_grad]
        out = gather_levels_plain(lvs, x, y).to(d_out.dtype)
        grads = iter(torch.autograd.grad(out, wrt, d_out))
    for d in d_levels:
        if d is not None:
            d.add_(next(grads))
    if not coords_need_grad:
        return None, None
    return next(grads), next(grads)


class _GradBuffers:
    """One pyramid's level gradient buffers, allocated and zeroed at the
    first gather backward that needs them, taken by the pyramid node."""

    def __init__(self, levels: Sequence[torch.Tensor]):
        self._like = [(lv.shape, _compute_dtype(lv), lv.device) if lv.requires_grad else None
                      for lv in levels]
        self._buffers: Optional[List[Optional[torch.Tensor]]] = None

    def get(self) -> List[Optional[torch.Tensor]]:
        if self._buffers is None:
            self._buffers = [None if like is None else
                             torch.zeros(like[0], dtype=like[1], device=like[2])
                             for like in self._like]
        return self._buffers

    def take(self) -> Optional[List[Optional[torch.Tensor]]]:
        buffers, self._buffers = self._buffers, None
        return buffers


class PyramidGrads:
    """The link from the gathers on one pyramid to its shared gradient
    buffers (see `share_pyramid_grads`). `levels`: the pyramid as the gathers
    must take it; `token`: a scalar each gather takes as an input, so that
    the pyramid node runs after the last of them."""

    def __init__(self, levels: Tuple[torch.Tensor, ...], token: torch.Tensor,
                 buffers: _GradBuffers):
        self.levels = levels
        self.token = token
        self.buffers = buffers


class _PyramidNode(torch.autograd.Function):
    """Forward: the levels as they are, and the token. Backward: the shared
    f32 buffers (plus any level gradient from a consumer other than a
    gather), each cast once to its level's dtype."""

    @staticmethod
    def forward(ctx, buffers: _GradBuffers, *levels):
        ctx.buffers = buffers
        ctx.dtypes = [lv.dtype for lv in levels]
        ctx.set_materialize_grads(False)
        return (levels[0].new_zeros((), dtype=torch.float32), *levels)

    @staticmethod
    def backward(ctx, d_token, *d_levels):
        buffers = ctx.buffers.take() or [None] * len(d_levels)
        out = []
        for buf, d, dtype in zip(buffers, d_levels, ctx.dtypes):
            if d is not None:
                buf = d if buf is None else buf.add_(d)
            out.append(None if buf is None else buf.to(dtype))
        return (None, *out)


def share_pyramid_grads(levels: Sequence[torch.Tensor]
                        ) -> Tuple[Tuple[torch.Tensor, ...], Optional[PyramidGrads]]:
    """Pass a pyramid through its gradient node: (levels, PyramidGrads) for
    the gathers that read it in this forward, or (levels, None) when no
    gradient is recorded."""
    levels = tuple(levels)
    if not (torch.is_grad_enabled() and any(lv.requires_grad for lv in levels)):
        return levels, None
    buffers = _GradBuffers(levels)
    token, *out = _PyramidNode.apply(buffers, *levels)
    return tuple(out), PyramidGrads(tuple(out), token, buffers)


class _GatherLevels(torch.autograd.Function):
    """Kernel G forward, kernel G-bwd backward (the plain versions where the
    tensors lie on the CPU). With a pyramid's buffers the level gradients
    are added into them and none is returned; the token gets a zero."""

    @staticmethod
    def forward(ctx, buffers: Optional[_GradBuffers], ix, iy, token, *levels):
        ctx.buffers = buffers
        ctx.kernel = build.use_kernel(ix)
        ctx.save_for_backward(ix, iy, *levels)
        if ctx.kernel:
            return _launch_forward(levels, ix, iy)
        return gather_levels_plain(levels, ix, iy)

    @staticmethod
    def backward(ctx, d_out):
        ix, iy, *levels = ctx.saved_tensors
        needs = ctx.needs_input_grad
        coords = needs[1] or needs[2]
        if ctx.buffers is not None:
            d_levels = ctx.buffers.get()
        else:
            d_levels = [torch.zeros(lv.shape, dtype=_compute_dtype(lv), device=lv.device)
                        if need else None for lv, need in zip(levels, needs[4:])]
        backward = gather_levels_backward if ctx.kernel else _plain_backward
        d_ix, d_iy = backward(levels, ix, iy, d_out, d_levels, coords)
        if ctx.buffers is not None:
            d_levels, token = [None] * len(levels), d_out.new_zeros((), dtype=torch.float32)
        else:
            # the level's dtype, once per gather (a gather on no shared pyramid)
            d_levels = [None if d is None else d.to(lv.dtype) for d, lv in zip(d_levels, levels)]
            token = None
        return (None, d_ix if needs[1] else None, d_iy if needs[2] else None, token,
                *d_levels)


def gather_levels(levels: Sequence[torch.Tensor], ix: torch.Tensor, iy: torch.Tensor,
                  grads: Optional[PyramidGrads] = None) -> torch.Tensor:
    """Bilinear zero-padded gather of L channel-last levels at [L, N] coords
    -> [N, sum C_l]. `grads`: the pyramid's `PyramidGrads` when `levels` came
    from `share_pyramid_grads`."""
    if len(levels) != ix.shape[0] or ix.shape != iy.shape or ix.dim() != 2:
        raise ValueError(f"{len(levels)} levels need ix, iy of shape [L, N]; "
                         f"got {tuple(ix.shape)}, {tuple(iy.shape)}")
    if grads is not None and (len(levels) != len(grads.levels)
                              or any(a is not b for a, b in zip(levels, grads.levels))):
        raise ValueError("gather_levels: `grads` belongs to another pyramid")
    shared = grads is not None and torch.is_grad_enabled()
    levels_dtype(levels)
    if not build.use_kernel(ix):
        if shared:
            return _GatherLevels.apply(grads.buffers, ix, iy, grads.token, *levels)
        return gather_levels_plain(levels, ix, iy)

    dev = ix.device
    levels_dtype(levels, kernel=True)
    for lv in levels:
        if lv.device != dev or lv.dim() != 3:
            raise ValueError(f"gather_levels kernel takes [H, W, C] levels on {dev}; got "
                             f"{tuple(lv.shape)} on {lv.device}")
        if not lv.is_contiguous():
            raise ValueError("gather_levels kernel takes contiguous levels")
    if ix.dtype != torch.float32 or iy.dtype != torch.float32 or iy.device != dev:
        raise ValueError("gather_levels kernel takes f32 coords on the levels' device")
    ix = ix.contiguous()
    iy = iy.contiguous()
    if shared:
        return _GatherLevels.apply(grads.buffers, ix, iy, grads.token, *levels)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ix, iy, *levels)):
        return _GatherLevels.apply(None, ix, iy, None, *levels)
    return _launch_forward(levels, ix, iy)
