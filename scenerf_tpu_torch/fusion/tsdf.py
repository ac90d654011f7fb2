"""Volumetric TSDF fusion of rendered RGB-D frames: the port's counterpart of
`scenerf_tpu/fusion/tsdf.py`.

`TSDFVolume` holds the tsdf, weight and packed-color volumes as tensors on a
device and integrates frames through kernel T (`ops/tsdf.py`: one launch
for a whole frame sequence on the card, the plain version on the CPU). Modes
as the JAX package: "closest" keeps the minimum-|distance| signed distance in
meters (the behaviour the evaluation thresholds assume), "average" the
truncated weighted running average. The occupancy thresholds (`tsdf2occ*`,
`tsdf_to_gt_occupancy`) are host numpy, and so are the mesh and point
cloud (`get_mesh`, `get_point_cloud`: marching cubes of the tsdf volume,
`fusion/meshing.py`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from scenerf_tpu_torch.ops import tsdf as T
from scenerf_tpu_torch.ops.build import resolve_device

COLOR_CONST = T.COLOR_CONST


def pack_colors(color_im: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] (0..255 floats) -> packed single channel B*65536 + G*256 + R,
    f32 (exact: it stays below 2^24)."""
    c = torch.floor(color_im.to(torch.float32))
    return torch.floor(c[..., 2] * COLOR_CONST + c[..., 1] * 256.0 + c[..., 0])


def unpack_colors(packed: np.ndarray) -> np.ndarray:
    """Packed channel (a host volume) -> [..., 3] uint8-valued floats (r, g, b)."""
    b = np.floor(packed / COLOR_CONST)
    g = np.floor((packed - b * COLOR_CONST) / 256.0)
    r = packed - b * COLOR_CONST - g * 256.0
    return np.stack([r, g, b], axis=-1)


class TSDFVolume:
    """A TSDF voxel volume on `device` (default cuda:0; raises without CUDA:
    pass device="cpu" for the CPU), with the JAX package's grid, sentinel and
    integration semantics."""

    def __init__(self, vol_bnds, voxel_size: float, trunc_margin: float = 10.0,
                 mode: str = "closest", device=None):
        if mode not in T.MODES:
            raise ValueError(f"mode must be one of {T.MODES}, got {mode!r}")
        vol_bnds64 = np.asarray(vol_bnds, dtype=np.float64)
        if vol_bnds64.shape != (3, 2):
            raise ValueError(f"vol_bnds must be [3, 2], got {vol_bnds64.shape}")
        self._voxel_size = float(voxel_size)
        self._trunc_margin = float(trunc_margin)
        self.mode = mode
        # the dims from the float64 bounds: in f32, 51.2 / 0.2 rounds up to
        # 257, not the 256 x 256 x 32 KITTI grid
        self._vol_dim = np.ceil(
            (vol_bnds64[:, 1] - vol_bnds64[:, 0]) / self._voxel_size).astype(int)
        self._vol_origin = vol_bnds64[:, 0].astype(np.float32)
        self.device = resolve_device(device)
        shape = tuple(int(d) for d in self._vol_dim)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.tsdf = torch.full(shape, 255.0, **f32)  # out-of-view sentinel
        self.weight = torch.zeros(shape, **f32)
        self.color = torch.zeros(shape, **f32)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.tsdf.shape)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def integrate(self, color_im, depth_im, cam_intr, cam_pose, obs_weight: float = 1.0):
        """Integrate one RGB-D frame. cam_pose is camera->world; it is
        inverted once here (in numpy float64, then f32, as the JAX package)."""
        self.integrate_frames(color_im[None], depth_im[None], np.asarray(cam_intr)[None],
                              np.asarray(cam_pose)[None], obs_weight)

    def integrate_frames(self, color_ims, depth_ims, cam_intrs, cam_poses,
                         obs_weight: float = 1.0):
        """Integrate a frame stack, in order, in one call of kernel T:
        color_ims [F, H, W, 3] (0..255), depth_ims [F, H, W], cam_intrs
        [F, 3, 3], cam_poses [F, 4, 4] camera->world (numpy or tensors)."""
        packed = pack_colors(self._f32(color_ims))
        w2cs = np.stack([np.linalg.inv(np.asarray(p)) for p in cam_poses])
        T.integrate(self.tsdf, self.weight, self.color, self._f32(depth_ims), packed,
                    self._f32(cam_intrs), self._f32(w2cs.astype(np.float32)),
                    self._vol_origin, self._voxel_size, self._trunc_margin,
                    float(obs_weight), mode=self.mode)

    def get_volume(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tsdf, packed color) as host numpy."""
        return self.tsdf.cpu().numpy(), self.color.cpu().numpy()

    def _surface(self, tsdf_vol: np.ndarray, color_vol: np.ndarray):
        """Marching cubes of `tsdf_vol` at 0: world vertices, faces, normals
        and each vertex's color (the packed color of its nearest voxel)."""
        from scenerf_tpu_torch.fusion.meshing import marching_cubes

        verts, faces, norms = marching_cubes(tsdf_vol, level=0.0)
        ind = np.clip(np.round(verts).astype(int), 0, np.asarray(tsdf_vol.shape) - 1)
        colors = unpack_colors(color_vol[ind[:, 0], ind[:, 1], ind[:, 2]])
        verts = verts * self._voxel_size + self._vol_origin
        return verts, faces, norms, colors.astype(np.uint8)

    def get_point_cloud(self) -> Tuple[np.ndarray, np.ndarray]:
        """The surface's vertices in world coordinates [V, 3] and their uint8
        colors [V, 3]."""
        verts, _, _, colors = self._surface(*self.get_volume())
        return verts, colors

    def get_mesh(self, mask: Optional[np.ndarray] = None):
        """The surface mesh: world vertices [V, 3], faces [F, 3] int32,
        normals [V, 3] and uint8 vertex colors [V, 3]. Voxels outside `mask`
        (any array of the grid's size) count as empty (tsdf 1)."""
        tsdf_vol, color_vol = self.get_volume()
        if mask is not None:
            tsdf_vol = tsdf_vol.copy()  # on the CPU it shares the volume's memory
            tsdf_vol[~mask.reshape(tsdf_vol.shape).astype(bool)] = 1.0
        return self._surface(tsdf_vol, color_vol)


def tsdf2occ_bf(tsdf: np.ndarray, min_th: float, th: float = 0.25,
                max_th: float = 0.2, voxel_size: float = 0.04) -> np.ndarray:
    """BundleFusion occupancy threshold ramped along the z (height) axis."""
    Z = tsdf.shape[2]
    ramp = voxel_size + np.arange(Z).reshape(1, 1, Z) * voxel_size * th
    ramp = np.clip(ramp, min_th, max_th)
    occ = np.zeros(tsdf.shape, dtype=np.float32)
    occ[(np.abs(tsdf) < ramp) & (np.abs(tsdf) != 255)] = 1
    return occ


def tsdf_to_gt_occupancy(tsdf: np.ndarray, voxel_size: float) -> np.ndarray:
    """Fused-depth GT occupancy: 255 unknown, 0 free, 1 surface."""
    occ = np.full_like(tsdf, 255.0)
    occ[(tsdf > voxel_size) & (tsdf != 255)] = 0
    occ[(np.abs(tsdf) < voxel_size) & (tsdf != 255)] = 1
    return occ


def tsdf2occ(tsdf: np.ndarray, th: float, max_th: float = 4.0,
             voxel_size: float = 0.2) -> np.ndarray:
    """TSDF -> occupancy with a threshold ramped along the x (forward) axis:
    it grows with the distance from the sensor, clamped to [0.2, max_th];
    never-observed voxels (255) stay empty."""
    X = tsdf.shape[0]
    ramp = (0.1 + np.arange(X).reshape(X, 1, 1) * voxel_size) * th
    ramp = np.clip(ramp, 0.2, max_th)
    occ = np.zeros(tsdf.shape, dtype=np.float32)
    occ[(np.abs(tsdf) < ramp) & (np.abs(tsdf) != 255)] = 1
    return occ
