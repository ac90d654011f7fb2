"""Kernel T: TSDF integration of a frame sequence into a voxel volume, and its
plain PyTorch version.

`integrate(tsdf, weight, color, depths, colors_packed, cam_intrs, world2cams,
vol_origin, voxel_size, trunc_margin, obs_weight, mode)` fuses F depth frames
[F, H, W] (with their packed colors, intrinsics [F, 3, 3] and world->camera
poses [F, 4, 4]) into the volumes tsdf, weight and color [X, Y, Z], frame by
frame in sweep order. It updates the three volumes IN PLACE and returns
nothing (the JAX package's arrays were immutable and it returned new ones).
On a CUDA tensor it launches `csrc/tsdf.cu`; on a CPU tensor it runs
`integrate_plain`. It replaces the TPU-shaped `scenerf_tpu/fusion/tsdf.py:44
_integrate_one` + `:124 _integrate_frames` (a fused gather + elementwise
update over the whole grid, the frames folded in one `lax.scan`).

Rounding: every product, sum and quotient is rounded on its own, in the JAX
package's order, except the two products-plus-sum that XLA contracts into an
fma when it compiles `_integrate_one` (checked against its output on the
CPU): the voxel's world coordinate `origin + i * voxel_size` and the running
averages `tsdf * weight + obs_weight * dist` (and the same for each color
channel). Kernel T computes those two with `fmaf`, the plain version with
`fma` below, and both agree with JAX bit for bit.

Modes, as the JAX package: "closest" keeps the signed distance of smallest
magnitude (`>=`, so a later frame wins a tie: the result depends on the frame
order), "average" the truncated weighted running average.

What kernel T decides from the poses has a plain twin here: `lane_axis` (the
grid axis, x or y, its warps' lanes run along, voted by the frames' camera
rows),
`tile_boxes` (its tiles of TILE_LANES x TILE_WARPS x TILE_RUN voxels, in its
block order) and `tiles_unseen` (the frames it culls per tile before the
exact chain: every voxel of the tile behind the camera or past one image
edge, with a margin that covers the f32 chain's rounding). The plain
version culls nothing.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from scenerf_tpu_torch.ops import build

COLOR_CONST = 256.0 * 256.0
MODES = ("closest", "average")

Origin = Union[torch.Tensor, Sequence[float]]


def _origin_values(vol_origin: Origin) -> list:
    """The origin as three f32-rounded Python floats."""
    return torch.as_tensor(vol_origin, dtype=torch.float32).cpu().tolist()


def _unpack_rgb(packed: torch.Tensor):
    """Packed B*65536 + G*256 + R -> (r, g, b), in the JAX package's ops."""
    return (torch.remainder(packed, 256.0),
            torch.remainder(torch.floor(packed / 256.0), 256.0),
            torch.floor(packed / COLOR_CONST))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded to f32 once, as an fma: the f64
    product is exact and the f64 sum is rounded twice only where c and a * b
    lie more than 2^5 apart in magnitude (then the result can differ from an
    fma's on a 2^-29 share of the inputs)."""
    return (a.double() * b.double() + c.double()).float()


def world_coords(shape, origin: torch.Tensor, voxel_size: torch.Tensor):
    """World x, y, z of the voxel centres along each axis ([X, 1, 1], [1, Y, 1],
    [1, 1, Z]): `origin + i * voxel_size` as one fma."""
    out = []
    for axis, n in enumerate(shape):
        view = [1, 1, 1]
        view[axis] = n
        i = torch.arange(n, dtype=torch.float32, device=origin.device).view(view)
        out.append(fma(i, voxel_size, origin[axis]))
    return out


def _integrate_one_plain(tsdf, weight, color, depth_im, color_packed, cam_intr, world2cam,
                         origin, voxel_size, trunc_margin, obs_weight, mode):
    X, Y, Z = tsdf.shape
    H, W = depth_im.shape
    f32 = dict(dtype=torch.float32, device=tsdf.device)
    wx, wy, wz = world_coords((X, Y, Z), origin, voxel_size)
    R, t = world2cam[:3, :3], world2cam[:3, 3]
    cx = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + t[0]
    cy = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + t[1]
    cz = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + t[2]

    safe_z = torch.where(cz > 0, cz, torch.ones((), **f32))
    px = torch.round(cam_intr[0, 0] * cx / safe_z + cam_intr[0, 2])
    py = torch.round(cam_intr[1, 1] * cy / safe_z + cam_intr[1, 2])
    # the range check on the rounded floats: no out-of-range value is cast
    in_fov = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (cz > 0)
    pxc = torch.clamp(px, 0, W - 1).to(torch.int64)
    pyc = torch.clamp(py, 0, H - 1).to(torch.int64)
    flat = pyc * W + pxc
    depth_val = torch.where(in_fov, torch.take(depth_im, flat), torch.zeros((), **f32))
    new_col = torch.take(color_packed, flat)

    depth_diff = depth_val - cz
    valid = (depth_val > 0) & (depth_diff >= -trunc_margin)
    if mode == "closest":
        take = valid & (torch.abs(tsdf) >= torch.abs(depth_diff))
        tsdf.copy_(torch.where(take, depth_diff, tsdf))
        color.copy_(torch.where(take, new_col, color))
        weight.copy_(weight + torch.where(valid, obs_weight, torch.zeros((), **f32)))
        return
    dist = torch.clamp(depth_diff / trunc_margin, max=1.0)
    w_new = weight + obs_weight
    avg = fma(tsdf, weight, obs_weight * dist) / w_new
    mixed = [torch.clamp(torch.round(fma(old, weight, obs_weight * new) / w_new), max=255.0)
             for old, new in zip(_unpack_rgb(color), _unpack_rgb(new_col))]
    packed = mixed[2] * COLOR_CONST + mixed[1] * 256.0 + mixed[0]
    tsdf.copy_(torch.where(valid, avg, tsdf))
    color.copy_(torch.where(valid, packed, color))
    weight.copy_(torch.where(valid, w_new, weight))


def integrate_plain(tsdf: torch.Tensor, weight: torch.Tensor, color: torch.Tensor,
                    depths: torch.Tensor, colors_packed: torch.Tensor,
                    cam_intrs: torch.Tensor, world2cams: torch.Tensor, vol_origin: Origin,
                    voxel_size: float, trunc_margin: float, obs_weight: float = 1.0,
                    mode: str = "closest") -> None:
    """`_integrate_frames` of the JAX package, one frame after the other, each
    a whole-grid elementwise pass; updates tsdf, weight and color in place.
    The scalars are rounded to f32 first, as JAX's weak types are."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    f32 = dict(dtype=torch.float32, device=tsdf.device)
    origin = torch.tensor(_origin_values(vol_origin), **f32)
    vs, trunc, obs = (torch.tensor(float(v), **f32)
                      for v in (voxel_size, trunc_margin, obs_weight))
    for f in range(depths.shape[0]):
        _integrate_one_plain(tsdf, weight, color, depths[f], colors_packed[f], cam_intrs[f],
                             world2cams[f], origin, vs, trunc, obs, mode)


def pixel_ties(shape, vol_origin: Origin, voxel_size: float, cam_intrs: torch.Tensor,
               world2cams: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """[X, Y, Z] bool: voxels where some frame (with the voxel in front of its
    camera) projects within `tol` px of a .5 rounding boundary, the
    projection computed in f64. There a 1-ulp difference in the f32 chain
    picks the neighbouring pixel, so two implementations that round
    differently may disagree on such voxels and only there."""
    f64 = dict(dtype=torch.float64, device=cam_intrs.device)
    origin = _origin_values(vol_origin)
    w = [(origin[a] + torch.arange(n, **f64) * float(voxel_size)).view(
        [n if b == a else 1 for b in range(3)]) for a, n in enumerate(shape)]
    near = torch.zeros(tuple(shape), dtype=torch.bool, device=cam_intrs.device)
    for K, M in zip(cam_intrs.double(), world2cams.double()):
        cx, cy, cz = (M[r, 0] * w[0] + M[r, 1] * w[1] + M[r, 2] * w[2] + M[r, 3]
                      for r in range(3))
        z = torch.where(cz > 0, cz, torch.ones_like(cz))
        for p in (K[0, 0] * cx / z + K[0, 2], K[1, 1] * cy / z + K[1, 2]):
            near |= ((p - torch.floor(p) - 0.5).abs() < tol) & (cz > 0)
    return near


# kernel T's tile and cull (csrc/tsdf.cu: kWarpSize, kWarps, kRun, kMargin,
# kMaxPixel; `kernel_plan_constants` reads them from the built kernel)
TILE_LANES, TILE_WARPS, TILE_RUN = 32, 8, 4
CULL_MARGIN = 2.0 ** -18
CULL_MAX_PIXEL = 2.0 ** 20


def kernel_plan_constants() -> tuple:
    """(TILE_LANES, TILE_WARPS, TILE_RUN, CULL_MARGIN, CULL_MAX_PIXEL) as the
    built kernel T has them: the twins below must use the same."""
    out = (ctypes.c_double * 5)()
    build.check(build.library().scenerf_tsdf_plan_constants(out), "tsdf_plan_constants")
    return tuple(out)


def lane_axis(world2cams: torch.Tensor) -> int:
    """The grid axis, x (0) or y (1), kernel T's lanes run along for these
    poses [F, 4, 4]: each frame votes for y where |R[0][1]| - |R[1][1]|
    exceeds |R[0][0]| - |R[1][0]| in f32, else for x, and y wins with more
    than half the votes: the axis whose step moves a projection along an
    image row."""
    R = world2cams.to(torch.float32)
    s = R[:, 0, :2].abs() - R[:, 1, :2].abs()
    return int(2 * int((s[:, 1] > s[:, 0]).sum()) > len(R))


def tile_layout(axis: int):
    """Kernel T's roles of the grid axes for lanes along `axis` (x or y):
    (A, B, L), lanes along A, warps along B (the other of x and y), each
    thread's run along L = z, and the tile's extent along each."""
    if axis not in (0, 1):
        raise ValueError(f"kernel T lays its lanes along x or y, not axis {axis}")
    return (axis, 1 - axis, 2), (TILE_LANES, TILE_WARPS, TILE_RUN)


def tile_boxes(shape, axis: int):
    """Kernel T's tiles for lanes along `axis`, in its block order: starts and
    counts [T, 3] (int64, per grid axis)."""
    roles, ext = tile_layout(axis)
    n = [-(-shape[r] // e) for r, e in zip(roles, ext)]
    t = torch.arange(n[0] * n[1] * n[2])
    tl, ta, tb = t % n[2], (t // n[2]) % n[0], t // (n[2] * n[0])
    start = torch.zeros(len(t), 3, dtype=torch.int64)
    for role, e, ti in zip(roles, ext, (ta, tb, tl)):
        start[:, role] = ti * e
    count = torch.minimum(torch.tensor([ext[roles.index(a)] for a in range(3)]),
                          torch.tensor(shape) - start)
    return start, count


def voxel_tiles(shape, axis: int) -> torch.Tensor:
    """[X, Y, Z] int64: the index of the kernel's tile that holds each voxel."""
    roles, ext = tile_layout(axis)
    n = [-(-shape[r] // e) for r, e in zip(roles, ext)]
    t = [torch.arange(shape[a]) // ext[roles.index(a)] for a in range(3)]
    ta, tb, tl = (t[r].view([shape[r] if b == r else 1 for b in range(3)]) for r in roles)
    return (tb * n[0] + ta) * n[2] + tl


def tiles_unseen(shape, vol_origin: Origin, voxel_size: float, cam_intrs: torch.Tensor,
                 world2cams: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[T, F] bool, kernel T's cull per tile (lanes along
    `lane_axis(world2cams)`): True where tile t skips frame f, tested on the
    tile's corner voxels in f64 (csrc/tsdf.cu "The cull's margins"): every
    corner behind the camera, or every corner in front and past the same
    image edge, each by a margin of 2^-18 times the rows' magnitudes."""
    f64 = torch.float64
    start, count = tile_boxes(shape, lane_axis(world2cams))
    origin = torch.tensor(_origin_values(vol_origin), dtype=torch.float32)
    vs = torch.tensor(float(voxel_size), dtype=torch.float32)
    lo = fma(start.float(), vs, origin).to(f64)  # [T, 3]
    hi = fma((start + count - 1).float(), vs, origin).to(f64)
    K = cam_intrs.to(torch.float32).cpu()
    M = world2cams.to(torch.float32).cpu()[:, :3, :]  # [F, 3, 4]
    k = torch.stack([K[:, 0, 0], K[:, 0, 2], K[:, 1, 1], K[:, 1, 2]], 1)  # [F, 4]
    finite = (torch.isfinite(k).all(1) & torch.isfinite(M).flatten(1).all(1)
              & (k[:, 1].double().abs() < CULL_MAX_PIXEL)
              & (k[:, 3].double().abs() < CULL_MAX_PIXEL)
              & (float(W) < CULL_MAX_PIXEL) & (float(H) < CULL_MAX_PIXEL))
    k, M = k.to(f64), M.to(f64)
    wmax = torch.maximum(lo.abs(), hi.abs())  # [T, 3]
    S = M[None, :, :, 3].abs() + torch.einsum("ta,fra->tfr", wmax, M[:, :, :3].abs())
    e = {"left": -1.5 - k[:, 1], "right": W + 0.5 - k[:, 1],
         "top": -1.5 - k[:, 3], "bottom": H + 0.5 - k[:, 3]}
    fx, fy = k[:, 0].abs() * S[..., 0], k[:, 2].abs() * S[..., 1]
    tz = CULL_MARGIN * S[..., 2]
    tau = {name: CULL_MARGIN * ((fx if name in ("left", "right") else fy)
                                + e[name].abs() * S[..., 2]) for name in e}
    out = {name: torch.ones(len(start), len(k), dtype=torch.bool)
           for name in ("behind", "front", *e)}
    for q in range(8):
        w = torch.stack([hi[:, a] if q >> a & 1 else lo[:, a] for a in range(3)], 1)
        c = torch.einsum("ta,fra->tfr", w, M[:, :, :3]) + M[None, :, :, 3]  # [T, F, 3]
        u, v = k[:, 0] * c[..., 0], k[:, 2] * c[..., 1]
        out["behind"] &= c[..., 2] <= -tz
        out["front"] &= c[..., 2] > tz
        out["left"] &= u - e["left"] * c[..., 2] <= -tau["left"]
        out["right"] &= u - e["right"] * c[..., 2] >= tau["right"]
        out["top"] &= v - e["top"] * c[..., 2] <= -tau["top"]
        out["bottom"] &= v - e["bottom"] * c[..., 2] >= tau["bottom"]
    past = out["left"] | out["right"] | out["top"] | out["bottom"]
    return (out["behind"] | (out["front"] & past)) & finite


def integrate(tsdf: torch.Tensor, weight: torch.Tensor, color: torch.Tensor,
              depths: torch.Tensor, colors_packed: torch.Tensor, cam_intrs: torch.Tensor,
              world2cams: torch.Tensor, vol_origin: Origin, voxel_size: float,
              trunc_margin: float, obs_weight: float = 1.0, mode: str = "closest") -> None:
    """Fuse the frames [F, H, W] into the [X, Y, Z] volumes in place (see the
    module docstring): kernel T on CUDA tensors, `integrate_plain` on CPU
    tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    vols, frames, mats = (tsdf, weight, color), (depths, colors_packed), (cam_intrs, world2cams)
    if tsdf.dim() != 3 or any(v.shape != tsdf.shape for v in vols):
        raise ValueError("tsdf, weight and color must be [X, Y, Z] volumes of one shape")
    F_ = depths.shape[0]
    if depths.dim() != 3 or colors_packed.shape != depths.shape:
        raise ValueError(f"depths and colors_packed must be [F, H, W]; got "
                         f"{tuple(depths.shape)}, {tuple(colors_packed.shape)}")
    if cam_intrs.shape != (F_, 3, 3) or world2cams.shape != (F_, 4, 4):
        raise ValueError(f"{F_} frames need cam_intrs [F, 3, 3] and world2cams [F, 4, 4]; got "
                         f"{tuple(cam_intrs.shape)}, {tuple(world2cams.shape)}")
    if not build.use_kernel(tsdf):
        integrate_plain(tsdf, weight, color, depths, colors_packed, cam_intrs, world2cams,
                        vol_origin, voxel_size, trunc_margin, obs_weight, mode)
        return

    dev = tsdf.device
    for t in (*vols, *frames, *mats):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"tsdf_integrate kernel takes f32 tensors on {dev}; got "
                             f"{t.dtype} on {t.device}")
    for v in vols:
        if not v.is_contiguous():
            raise ValueError("tsdf_integrate kernel updates contiguous volumes in place")
    X, Y, Z = tsdf.shape
    _, H, W = depths.shape
    if F_ == 0:
        return
    frames = [t.contiguous() for t in frames]
    mats = [t.contiguous() for t in mats]
    ox, oy, oz = _origin_values(vol_origin)
    status = build.library().scenerf_tsdf_integrate_f32(
        *(v.data_ptr() for v in vols), *(t.data_ptr() for t in frames),
        *(t.data_ptr() for t in mats), F_, H, W, X, Y, Z, ox, oy, oz, float(voxel_size),
        float(trunc_margin), float(obs_weight), MODES.index(mode), build.stream_handle(dev))
    build.check(status, "tsdf_integrate")
    build.LAUNCHES["tsdf_integrate"] += 1
