"""Isosurface mesh extraction and PLY export on the host: the port's
counterpart of `scenerf_tpu/fusion/meshing.py`.

`marching_cubes` calls the port's copy of the JAX package's C++ extractor
(`native/meshing.cpp`, built at first use by `native/build.py`), so the
same volume gives the same vertices and faces in both packages.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from scenerf_tpu_torch.native.build import load

METHODS = {"mc": 0, "tetra": 1}


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   method: str = "mc") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The `level` isosurface of a [X, Y, Z] float volume (host numpy):
    (verts [V, 3] f32 in voxel coordinates, faces [F, 3] int32, normals
    [V, 3] f32). method="mc" is marching cubes (one vertex per crossed cube
    edge); "tetra" the 6-tetrahedra decomposition (about twice the
    triangles), kept as a table-free cross-check."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {tuple(METHODS)}, got {method!r}")
    lib = load()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    fp = ctypes.POINTER(ctypes.c_float)
    handle = lib.mc_run2(vol.ctypes.data_as(fp), nx, ny, nz, float(level), METHODS[method])
    try:
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        lib.mc_counts(handle, ctypes.byref(nv), ctypes.byref(nf))
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        norms = np.empty((nv.value, 3), np.float32)
        if nv.value:
            lib.mc_copy(handle, verts.ctypes.data_as(fp),
                        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        norms.ctypes.data_as(fp))
    finally:
        lib.mc_free(handle)
    return verts, faces, norms


def meshwrite(filename: str, verts, faces, norms, colors):
    """ASCII PLY mesh: vertices with normals and uint8 colors, triangles."""
    verts, faces, norms = np.asarray(verts), np.asarray(faces), np.asarray(norms)
    colors = np.asarray(colors).astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {verts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {faces.shape[0]}\n")
        f.write("property list uchar int vertex_index\nend_header\n")
        for i in range(verts.shape[0]):
            f.write("%f %f %f %f %f %f %d %d %d\n" % (
                verts[i, 0], verts[i, 1], verts[i, 2], norms[i, 0], norms[i, 1], norms[i, 2],
                colors[i, 0], colors[i, 1], colors[i, 2]))
        for i in range(faces.shape[0]):
            f.write("3 %d %d %d\n" % (faces[i, 0], faces[i, 1], faces[i, 2]))


def pcwrite(filename: str, xyzrgb):
    """ASCII PLY point cloud of [N, 6] rows (x, y, z, r, g, b)."""
    xyzrgb = np.asarray(xyzrgb)
    xyz, rgb = xyzrgb[:, :3], xyzrgb[:, 3:].astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {xyz.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(xyz.shape[0]):
            f.write("%f %f %f %d %d %d\n" % (xyz[i, 0], xyz[i, 1], xyz[i, 2],
                                             rgb[i, 0], rgb[i, 1], rgb[i, 2]))
