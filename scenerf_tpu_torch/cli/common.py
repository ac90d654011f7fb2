"""Shared helpers of the port's CLI entry points: the KITTI options, the val
reader, the device, the encode, and the PNG writers (PIL and matplotlib
imported inside them)."""
from __future__ import annotations

from typing import Dict, Optional

import click
import numpy as np
import torch

from scenerf_tpu_torch.data.kitti import KittiDataset
from scenerf_tpu_torch.model import SceneRF

KITTI_OPTS = [
    click.option("--root", default=""),
    click.option("--preprocess_root", default=""),
    click.option("--model_path", default=""),
    click.option("--eval_save_dir", default=""),
    click.option("--sequence_distance", default=10.0),
    click.option("--frames_interval", default=0.4),
]

# zlib level of the PNGs, lossless at every level: a swept frame writes two
# 1220x370 PNGs per pose, and at PIL's default level 6 their encoding costs
# more host time than level 1 by several times
PNG_COMPRESS_LEVEL = 1

DEVICE_OPT = click.option("--device", default="cuda:0",
                          help="torch device; cuda:0 unless given cpu")


def add_opts(opts):
    def deco(f):
        for opt in reversed(opts):
            f = opt(f)
        return f
    return deco


def kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval,
                 load_voxels=False) -> KittiDataset:
    return KittiDataset("val", root, preprocess_root, frames_interval=frames_interval,
                        sequence_distance=sequence_distance, n_sources=0,
                        load_voxels=load_voxels)


def resolve_device(name: str) -> torch.device:
    """The entry points' device: raises for a CUDA device without CUDA."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {name}: no CUDA device here (pass --device cpu "
                               "to run on the CPU)")
    return device


def encode_frame(model: SceneRF, img_input: np.ndarray, cam_K: np.ndarray,
                 sphere_maps: Optional[Dict[int, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
    """Encode one [H, W, 3] (or a batch of) normalized input frames on the
    model's device -> the levels dict."""
    if img_input.ndim == 3:
        img_input = img_input[None]
    device = next(model.parameters()).device
    return model.encode(torch.from_numpy(np.ascontiguousarray(img_input)).to(device), cam_K,
                        sphere_maps=sphere_maps)


def save_depth_visual(path: str, depth: np.ndarray, min_depth=0.1, max_depth=100.0):
    """Magma-colormapped disparity PNG."""
    import matplotlib as mpl
    import matplotlib.cm as cm
    from PIL import Image

    depth = np.clip(depth, min_depth, max_depth)
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    disp = 1.0 / depth - min_disp / (max_disp - min_disp)
    vmax = np.percentile(disp, 95)
    normalizer = mpl.colors.Normalize(vmin=disp.min(), vmax=vmax)
    mapper = cm.ScalarMappable(norm=normalizer, cmap="magma")
    colormapped = (mapper.to_rgba(disp)[:, :, :3] * 255).astype(np.uint8)
    Image.fromarray(colormapped).save(path, compress_level=PNG_COMPRESS_LEVEL)


def save_color_png(path: str, color: np.ndarray):
    """[H, W, 3] colors in [0, 1] -> an 8-bit PNG."""
    from PIL import Image

    Image.fromarray((np.clip(color, 0, 1) * 255).astype(np.uint8)).save(
        path, compress_level=PNG_COMPRESS_LEVEL)
