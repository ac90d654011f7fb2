"""Shared helpers of the port's CLI entry points: the KITTI options, the val
readers, the device, the encode, the evaluation tables and pixel grid, and
the PNG writers (PIL and matplotlib imported inside them)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _at_most_one_device(ctx, param, value: int) -> int:
    if value > 1:
        raise click.UsageError(f"--n_devices {value}: the port renders on one device "
                               "(0 or 1)", ctx)
    return value


N_DEVICES_OPT = click.option("--n_devices", default=0, callback=_at_most_one_device,
                             help="devices to render on: 0 or 1 (one, --device)")


def kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval,
                 load_voxels=False) -> KittiDataset:
    """The val frames without sources (the reconstruction commands)."""
    return KittiDataset("val", root, preprocess_root, frames_interval=frames_interval,
                        sequence_distance=sequence_distance, n_sources=0,
                        load_voxels=load_voxels)


def eval_val_ds(root, preprocess_root, sequence_distance, frames_interval) -> KittiDataset:
    """The val frames with every source of their scans, in order, and every
    LiDAR return of each (the evaluation commands)."""
    return KittiDataset("val", root, preprocess_root, frames_interval=frames_interval,
                        sequence_distance=sequence_distance, n_sources=1000,
                        n_rays=1_000_000, seed=0)


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


def strided_pixel_grid(img_size: Tuple[int, int],
                       stride: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pixels (x, y) every `stride` of a (W, H) image, x-major: the grid has
    shape (n_x, n_y), flattened with y fastest."""
    xs = np.arange(0, img_size[0], stride, dtype=np.float32)
    ys = np.arange(0, img_size[1], stride, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pixels = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    return pixels, gx.shape


def print_depth_metrics_table(agg_depth_errors: Dict, n_frames: Dict):
    """The per-distance table of summed depth-error 7-vectors, each row their
    mean, and the "All" row over every distance."""
    print("|distance|abs_rel |sq_rel  |rmse     |rmse_log|a1      |a2      |a3      |n_frames|")
    total = None
    total_frames = 0
    for distance in sorted(agg_depth_errors):
        e = agg_depth_errors[distance]
        n = n_frames[distance]
        total = np.copy(e) if total is None else total + e
        total_frames += n
        print("|{:08d}|{:02.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:08d}|".format(
            distance, *(e[j] / n for j in range(7)), n))
    if total is not None:
        print("|{}|{:02.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:.6f}|{:08d}|".format(
            "All     ", *(total[j] / total_frames for j in range(7)), total_frames))


def print_color_metrics_table(psnr_accum, ssim_accum, lpips_accum, cnt_accum,
                              lpips_enabled=True):
    """The per-distance table of summed PSNR / SSIM / LPIPS; without LPIPS
    weights its column reads "skipped" rather than a misleading 0."""
    def lp(v):
        return "{:.6f}".format(v) if lpips_enabled else "skipped "
    print("|distance |psnr |ssim   |lpips     |n_frames|")
    tp = ts = tl = tf = 0.0
    for distance in sorted(psnr_accum):
        tp += psnr_accum[distance]
        ts += ssim_accum[distance]
        tl += lpips_accum[distance]
        tf += cnt_accum[distance]
        print("|{:08d}|{:02.6f}|{:.6f}|{}|{:.6f}|".format(
            distance,
            psnr_accum[distance] / cnt_accum[distance],
            ssim_accum[distance] / cnt_accum[distance],
            lp(lpips_accum[distance] / cnt_accum[distance]),
            cnt_accum[distance]))
    if tf:
        print("|{}|{:02.6f}|{:.6f}|{}|{:.6f}|".format(
            "All     ", tp / tf, ts / tf, lp(tl / tf), tf))


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
