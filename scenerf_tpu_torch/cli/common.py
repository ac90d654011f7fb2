"""Shared helpers of the port's CLI entry points: the KITTI options, the val
readers, the device, the encode, the evaluation tables and pixel grid, and
the PNG writers (PIL imported inside them; the depth visual's colormap
read from magma.txt, without matplotlib)."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import click
import numpy as np
import torch

from scenerf_tpu_torch.data.kitti import KittiDataset
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.parallel import dist as D

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

DEVICE_OPT = click.option("--device", default=None,
                          help="torch device; cuda:0 unless given (under torchrun: "
                               "cuda:LOCAL_RANK, or the named device on every rank)")
DIST_BACKEND_OPT = click.option("--dist_backend", default=None,
                                type=click.Choice(["nccl", "gloo"]),
                                help="under torchrun: nccl on CUDA, gloo on the CPU unless "
                                     "given")


def add_opts(opts):
    def deco(f):
        for opt in reversed(opts):
            f = opt(f)
        return f
    return deco


N_DEVICES_OPT = click.option(
    "--n_devices", default=0, type=click.IntRange(min=0),
    help="ranks to shard the renders over (under torchrun): the first N of the world, 0 all")


def join_world(device: Optional[str], backend: Optional[str]) -> D.World:
    """The world of this process (`parallel.dist.init`): torchrun's ranks, or
    one rank on `device` (cuda:0 unless given) without torchrun."""
    try:
        if D.env_ranks()[1] == 1:
            return D.init(resolve_device(device or "cuda:0"))
        return D.init(device, backend)
    except RuntimeError as e:
        raise click.UsageError(str(e))


def render_world(n_devices: int, device: Optional[str], backend: Optional[str]):
    """(this rank's device, whether it renders, the group of the ranks that
    shard the renders) of an eval or sweep command: the first `n_devices`
    ranks of the world (0: all of them). More than the world's ranks raises.
    A sub-group is made by every rank of the world (a collective)."""
    world = join_world(device, backend)
    if n_devices > world.size:
        raise click.UsageError(f"--n_devices {n_devices}: the world has {world.size} "
                               f"rank{'s' if world.size > 1 else ''} (start more under "
                               f"torchrun, or take 0 for all)")
    n = n_devices or world.size
    if n == world.size:
        return world.device, True, world.group
    group = torch.distributed.new_group(ranks=list(range(n))) if n > 1 else None
    return world.device, world.rank < n, group


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


def resolve_device(name: Optional[str]) -> torch.device:
    """The entry points' device (cuda:0 when None): raises for a CUDA device
    without CUDA."""
    device = torch.device(name or "cuda:0")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {device}: no CUDA device here (pass --device cpu "
                               "to run on the CPU)")
    return device


def synced_clock(device: torch.device) -> float:
    """The host clock once `device`'s queued work has ended."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


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


MAGMA_PATH = Path(__file__).with_name("magma.txt")
_magma = []


def colormap_magma(x: np.ndarray) -> np.ndarray:
    """matplotlib's "magma" colormap of normalized values [...] -> RGB
    [..., 3] in [0, 1], as `matplotlib.cm.ScalarMappable.to_rgba` maps them:
    256 bins, values below 0 (above 1) take the first (last) color, NaN
    black. The 256 colors are read from magma.txt beside this file, so
    matplotlib is not needed."""
    if not _magma:
        _magma.append(np.loadtxt(MAGMA_PATH))
    lut = _magma[0]
    n = len(lut)
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over | bad] = n - 1
    rgb = lut[idx]
    rgb[bad] = 0.0
    return rgb


def save_depth_visual(path: str, depth: np.ndarray, min_depth=0.1, max_depth=100.0):
    """Magma-colormapped disparity PNG: the disparity of the clipped depth,
    normalized from its minimum to its 95th percentile."""
    from PIL import Image

    depth = np.clip(depth, min_depth, max_depth)
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    disp = 1.0 / depth - min_disp / (max_disp - min_disp)
    vmin, vmax = disp.min(), np.percentile(disp, 95)
    x = np.array(disp, copy=True)
    if vmin == vmax:
        x.fill(0)
    else:
        x -= vmin
        x /= (vmax - vmin)
    colormapped = (colormap_magma(x) * 255).astype(np.uint8)
    Image.fromarray(colormapped).save(path, compress_level=PNG_COMPRESS_LEVEL)


def save_color_png(path: str, color: np.ndarray):
    """[H, W, 3] colors in [0, 1] -> an 8-bit PNG."""
    from PIL import Image

    Image.fromarray((np.clip(color, 0, 1) * 255).astype(np.uint8)).save(
        path, compress_level=PNG_COMPRESS_LEVEL)
