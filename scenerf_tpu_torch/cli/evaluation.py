"""Evaluation entry points on the KITTI and BundleFusion val splits, with
the file layouts, printed tables and skip-if-exists behaviour of
`scenerf_tpu/cli/evaluation.py`:

- novel depth: `save-depth-metrics` renders depth at every LiDAR pixel of
  every source of each val frame (at the source's pose in the frame's
  camera) and pickles the summed Eigen errors per ceil(source distance),
  `<eval_save_dir>/depth_metrics/<seq>/<frame>.npy`
  ({"depth_errors": {k: 7-vector}, "n_frames": {k: count}}, readable by
  both packages); `agg-depth-metrics` sums them over sequence 08 into the
  "Total" table. `save-depth-metrics-bf` renders at every nonzero pixel of
  each source's depth PNG (errors capped at 10 m; the distance is the
  length of the source's translation), `agg-depth-metrics-bf` sums
  copyroom's;
- novel views: `render-colors` renders each source's pose at stride 3
  (407x124) into `<eval_save_dir>/render_rgb/<seq>/<frame>_<source>_<dist>.png`
  beside a copy of the source frame under `rgb/`; `eval-color` scores the
  pairs (PSNR, SSIM on the host; LPIPS-VGG16 on `--device`, from weights the
  user names) per ceil(distance). `render-colors-bf` renders at stride 2
  and upsamples to 640x480 (bilinear); `eval-color-bf` scores at 640x480;
- scene reconstruction: `eval-sr` scores the fused TSDFs of
  `cli/reconstruction.py` against the voxel GT, `eval-sc-bf` the
  BundleFusion TSDFs against the fused GT occupancy of `generate-sc-gt-bf`
  (host numpy).

    python -m scenerf_tpu_torch.cli.evaluation save-depth-metrics --root ... \\
        --preprocess_root ... --model_path ckpts/<exp> --eval_save_dir out [--device cpu]
    python -m scenerf_tpu_torch.cli.evaluation agg-depth-metrics --eval_save_dir out
    python -m scenerf_tpu_torch.cli.evaluation render-colors ...same flags...
    python -m scenerf_tpu_torch.cli.evaluation eval-color --eval_save_dir out \\
        [--lpips_weights lpips.npz | --lpips_vgg_path vgg16.pth --lpips_lin_path lpips_vgg.pth]
    python -m scenerf_tpu_torch.cli.evaluation save-depth-metrics-bf --root BF \\
        --model_path ckpts/<exp> --eval_save_dir out [--frame_interval 2 --n_frames 16]
    (likewise render-colors-bf; agg-depth-metrics-bf / eval-color-bf
    --eval_save_dir out; eval-sc-bf --root BF --recon_save_dir recon)

`--model_path` is the port's checkpoint: a `save_checkpoint` file or a
`CheckpointManager` directory (its best, else its last); the renders run in
its compute dtype through the port's kernels. The renders draw their noise
from one generator per source on the model's device: seeded `sid` in
save-depth-metrics (every frame's source `sid` alike, as the JAX package
folds `sid` into one key) and `idx * 1000 + sid` in render-colors (frame
`idx` of the val set).

Under torchrun, `--n_devices N` (0: every rank) splits the renders of
save-depth-metrics(-bf) and render-colors(-bf) over the first N ranks
(`parallel/sharded_render.py`): rank 0 reads each item, decides what to skip
and broadcasts it with the frame, every rank encodes the frame and renders
its slice of the rays, and rank 0 gathers them, writes every file and prints
every table (the other ranks write nothing).
"""
from __future__ import annotations

import glob
import math
import os
import pickle
import shutil
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import click
import numpy as np
import torch

from scenerf_tpu_torch import reconstruction as recon
from scenerf_tpu_torch.cli import common
from scenerf_tpu_torch.data.bundlefusion import BundlefusionDataset
from scenerf_tpu_torch.data.kitti import VAL_ERROR_FRAMES
from scenerf_tpu_torch.fusion.tsdf import tsdf2occ_bf
from scenerf_tpu_torch.model import SceneRF
from scenerf_tpu_torch.parallel import dist as D
from scenerf_tpu_torch.parallel.sharded_render import make_sharded_renderer
from scenerf_tpu_torch.utils.checkpoint import load_model
from scenerf_tpu_torch.utils.image_metrics import psnr, ssim
from scenerf_tpu_torch.utils.lpips import LPIPS
from scenerf_tpu_torch.utils.ssc_metrics import SSCMetrics

EVAL_CHUNK = 4000
KITTI_EVAL_DEPTH = 80.0
KITTI_COLOR_STRIDE = 3
KITTI_COLOR_SIZE = (407, 124)  # (W, H) of the compared images
BF_EVAL_DEPTH = 10.0
BF_COLOR_STRIDE = 2
BF_COLOR_SIZE = (640, 480)  # (W, H): renders upsampled to it, compared at it
BF_SC_VOXEL = 0.04


@click.group()
def cli():
    """KITTI and BundleFusion evaluation."""


# --------------------------------------------------------------------------- #
# shared eval machinery
# --------------------------------------------------------------------------- #


def compute_depth_errors_np(gt, pred, min_depth=1e-3, max_depth=80.0) -> np.ndarray:
    """The Eigen depth errors of one source as a 7-vector: abs_rel, sq_rel,
    rmse, rmse_log, a1, a2, a3 (prediction clipped to [min_depth,
    max_depth])."""
    pred = np.clip(pred, min_depth, max_depth)
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean((gt - pred) ** 2 / gt)
    return np.array([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3])


def render_depth_at_pixels(model: SceneRF, pyramid, cam_K, T, pixels, chunk: int,
                           generator: Optional[torch.Generator],
                           noise_uni: Optional[torch.Tensor] = None,
                           noise_gauss: Optional[torch.Tensor] = None):
    """Depth [R] and color [R, 3] (numpy) of the rays through `pixels` [R, 2]
    at pose `T` (source to the encoded frame), rendered without gradients in
    chunks of `chunk` (the last one ragged). The noise is drawn from
    `generator` unless given as `noise_uni` / `noise_gauss`."""
    if model.training:
        raise ValueError("render_depth_at_pixels renders a model in eval mode")
    dev = pyramid[0].device

    def on_dev(a, dtype=torch.float32):
        return None if a is None else torch.as_tensor(a, dtype=dtype).to(dev)

    with torch.no_grad():
        out = model.render_rays(pyramid, on_dev(cam_K), on_dev(T), on_dev(pixels), generator,
                                ray_chunk=chunk, noise_uni=on_dev(noise_uni),
                                noise_gauss=on_dev(noise_gauss))
    return out["depth"].cpu().numpy(), out["color"].cpu().numpy()


class FrameEncoder:
    """The encoded pyramid of an item, with the sphere maps built once per
    intrinsics on the host."""

    def __init__(self, model: SceneRF):
        self.model = model
        self.sphere_maps = {}

    def __call__(self, item):
        K = item["cam_K"]
        if K.tobytes() not in self.sphere_maps:
            self.sphere_maps[K.tobytes()] = self.model.compute_sphere_maps(K)
        levels = common.encode_frame(self.model, item["img_input"], K,
                                     self.sphere_maps[K.tobytes()])
        return self.model.pyramid_for_item(levels, 0)


def _device_of(model: SceneRF) -> torch.device:
    return next(model.parameters()).device


def bf_val_ds(root: str, frame_interval: int = 2, n_frames: int = 16,
              n_sources: int = 1000) -> BundlefusionDataset:
    """BundleFusion's val frames (copyroom) with every source of their
    windows, in order (the evaluation commands); `n_sources=0` reads none."""
    return BundlefusionDataset("val", root, n_sources=n_sources, frame_interval=frame_interval,
                               n_frames=n_frames, seed=0)


BF_WINDOW_OPTS = [click.option("--frame_interval", default=2),
                  click.option("--n_frames", default=16)]
BF_OPTS = [click.option("--root", default=""), click.option("--model_path", default=""),
           click.option("--eval_save_dir", default=""), *BF_WINDOW_OPTS]


# --------------------------------------------------------------------------- #
# save-depth-metrics / agg-depth-metrics
# --------------------------------------------------------------------------- #


def kitti_lidar(item, sid):
    """A KITTI source's LiDAR pixels [R, 2], depths [R] and distance."""
    return (item["loc2d_with_depths"][sid].astype(np.float32), item["lidar_depths"][sid],
            item["source_distances"][sid])


def _source_renderer(model: SceneRF, group, chunk: int) -> Callable:
    """render(pyramid, cam_K, T, pixels, seed) -> (depth [R], color [R, 3])
    numpy, the noise from a generator on the model's device seeded `seed`:
    `render_depth_at_pixels` on one rank; over a group the rays split over
    its ranks, the result on rank 0 (None on the others)."""
    dev = _device_of(model)
    sharded = None if group is None else make_sharded_renderer(model, group, chunk)

    def render(pyramid, cam_K, T, pixels, seed: int):
        generator = torch.Generator(device=dev).manual_seed(seed)
        if group is None:
            return render_depth_at_pixels(model, pyramid, cam_K, T, pixels, chunk, generator)
        if model.training:
            raise ValueError("the eval renders take a model in eval mode")
        on_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
        out = sharded(pyramid, on_dev(cam_K), on_dev(T), on_dev(pixels), generator)
        return None if out is None else (out["depth"].cpu().numpy(), out["color"].cpu().numpy())

    return render


def _frame_job(item, **extra) -> Dict:
    """What every rank needs of an item to encode it: its input frame and
    camera (rank 0 broadcasts it), plus `extra`."""
    return {"img_input": item["img_input"], "cam_K": item["cam_K"], **extra}


def _save_depth_metrics_impl(dataset, model: SceneRF, eval_save_dir: str, eval_depth: float,
                             chunk: int = EVAL_CHUNK, source_gt: Callable = kitti_lidar,
                             group=None) -> Dict:
    """Per val frame: skip it if its pickle exists, else encode it once and
    render each source at its ground-truth pixels (`source_gt(item, sid)` ->
    pixels, depths, distance); sum the errors per ceil(distance), pickle
    them and print the frame's table. Returns the frames done and, per
    frame, the host seconds of the item read, the seconds of the encode and
    of the renders and errors (each ended by a synchronize), and the rays of
    each source rendered. `group`: the ranks that split the renders (rank 0
    reads, decides, writes and returns the record; the module docstring)."""
    dev = _device_of(model)
    encode = FrameEncoder(model)
    render = _source_renderer(model, group, chunk)
    lead = D.rank(group) == 0
    done = {"frames": [], "read_s": [], "encode_s": [], "render_s": [], "rays": []}
    for idx in range(len(dataset)):
        job = None
        if lead:
            scan = dataset.scans[idx]
            save_dir = os.path.join(eval_save_dir, "depth_metrics", scan["sequence"])
            os.makedirs(save_dir, exist_ok=True)
            save_filepath = os.path.join(save_dir, f"{scan['frame_id']}.npy")
            if not os.path.exists(save_filepath):
                t0 = time.perf_counter()
                item = dataset[idx]
                t1 = time.perf_counter()
                gts = [(sid, *source_gt(item, sid)) for sid in range(len(item["img_sources"]))]
                gts = [g for g in gts if len(g[2])]
                job = _frame_job(item, renders=[(sid, pixels, item["T_source2infers"][sid])
                                                for sid, pixels, _, _ in gts])
        # rank 0's decision on every rank: a rank that skipped a frame another
        # renders would meet the next collective out of step
        job = D.broadcast_object(job, group)
        if job is None:
            continue
        pyramid = encode(job)
        t2 = common.synced_clock(dev)
        preds = [render(pyramid, job["cam_K"], T, pixels, sid)
                 for sid, pixels, T in job["renders"]]
        if not lead:
            continue
        agg, n_frames, rays = {}, {}, []
        for (sid, pixels, gt, dist), (pred, _) in zip(gts, preds):
            errors = compute_depth_errors_np(np.asarray(gt), pred, max_depth=eval_depth)
            rays.append(len(gt))
            k = math.ceil(dist)
            if k not in agg:
                agg[k], n_frames[k] = errors, 1
            else:
                agg[k] = agg[k] + errors
                n_frames[k] += 1
        t4 = common.synced_clock(dev)

        with open(save_filepath, "wb") as f:
            pickle.dump({"depth_errors": agg, "n_frames": n_frames}, f)
        print(f"==== Frame {item['frame_id']} ====")
        common.print_depth_metrics_table(agg, n_frames)
        done["frames"].append(item["frame_id"])
        done["read_s"].append(t1 - t0)
        done["encode_s"].append(t2 - t1)
        done["render_s"].append(t4 - t2)
        done["rays"].append(rays)
    return done


def _agg_depth_metrics_impl(eval_save_dir: str, sequences):
    """Sum every frame's pickle of `sequences` and print the "Total" table."""
    agg, n_frames = {}, {}
    for sequence in sequences:
        for path in sorted(glob.glob(os.path.join(
                eval_save_dir, "depth_metrics", sequence, "*.npy"))):
            with open(path, "rb") as f:
                data = pickle.load(f)
            for k in data["depth_errors"]:
                if k not in agg:
                    agg[k] = data["depth_errors"][k]
                    n_frames[k] = data["n_frames"][k]
                else:
                    agg[k] = agg[k] + data["depth_errors"][k]
                    n_frames[k] += data["n_frames"][k]
    print("====== Total ======")
    common.print_depth_metrics_table(agg, n_frames)
    return agg, n_frames


@cli.command("save-depth-metrics")
@common.add_opts(common.KITTI_OPTS)
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def save_depth_metrics(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
                       frames_interval, n_devices, device, dist_backend):
    """Render depth at the LiDAR pixels of every val source frame; save
    per-frame error pickles."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None
    ds = common.eval_val_ds(root, preprocess_root, sequence_distance, frames_interval)
    return _save_depth_metrics_impl(ds, load_model(model_path, device), eval_save_dir,
                                    eval_depth=KITTI_EVAL_DEPTH, group=group)


def bf_source_distance(item, sid) -> float:
    """A BundleFusion source's distance: the length of its translation to
    the infer frame."""
    return float(np.linalg.norm(item["T_source2infers"][sid][:3, 3]))


def bf_depth_png(item, sid):
    """A BundleFusion source's GT: every nonzero pixel of its depth PNG
    [R, 2], the depths there [R] (f64 metres) and its distance."""
    depth_im = item["source_depths"][sid]
    ys, xs = np.nonzero(depth_im > 0)
    return (np.stack([xs, ys], -1).astype(np.float32), depth_im[ys, xs],
            bf_source_distance(item, sid))


@cli.command("save-depth-metrics-bf")
@common.add_opts(BF_OPTS)
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def save_depth_metrics_bf(root, model_path, eval_save_dir, frame_interval, n_frames, n_devices,
                          device, dist_backend):
    """Render depth at every nonzero depth-PNG pixel of every BundleFusion val
    source frame; save per-frame error pickles (capped at 10 m)."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None
    return _save_depth_metrics_impl(bf_val_ds(root, frame_interval, n_frames),
                                    load_model(model_path, device), eval_save_dir,
                                    eval_depth=BF_EVAL_DEPTH, source_gt=bf_depth_png,
                                    group=group)


@cli.command("agg-depth-metrics")
@click.option("--eval_save_dir", default="")
def agg_depth_metrics(eval_save_dir):
    """Aggregate the per-frame depth-error pickles of sequence 08 into the
    per-distance table."""
    return _agg_depth_metrics_impl(eval_save_dir, ["08"])


@cli.command("agg-depth-metrics-bf")
@click.option("--eval_save_dir", default="")
def agg_depth_metrics_bf(eval_save_dir):
    """Aggregate the per-frame depth-error pickles of copyroom into the
    per-distance table."""
    return _agg_depth_metrics_impl(eval_save_dir, ["copyroom"])


# --------------------------------------------------------------------------- #
# render-colors / eval-color
# --------------------------------------------------------------------------- #


def kitti_distance(item, sid) -> float:
    return item["source_distances"][sid]


def _render_colors_impl(dataset, model: SceneRF, eval_save_dir: str, stride: int, chunk: int,
                        source_image_saver: Callable,
                        source_distance: Callable = kitti_distance,
                        upsample_to: Optional[tuple] = None, group=None) -> Dict:
    """Per val frame and source whose render is missing: save the source
    image under rgb/ (`source_image_saver(item, sid, path)`) if missing, and
    the source pose's render at `stride` under render_rgb/, upsampled
    (bilinear) to `upsample_to` (H, W) where given; the frame is
    encoded once, where a render is missing. Returns the images rendered
    and, per rendered frame, the host seconds of the item read, and the
    seconds of the encode, renders and PNG writes (ended by a synchronize).
    `group`: the ranks that split the renders (rank 0 reads, decides, writes
    and returns the record; the module docstring)."""
    dev = _device_of(model)
    encode = FrameEncoder(model)
    render = _source_renderer(model, group, chunk)
    lead = D.rank(group) == 0
    pixels, grid_shape = common.strided_pixel_grid(model.cfg.img_size, stride)
    pixels = torch.from_numpy(pixels).to(dev)
    done = {"images": 0, "read_s": [], "render_s": []}
    for idx in range(len(dataset)):
        job = None
        if lead:
            t0 = time.perf_counter()
            item = dataset[idx]
            t1 = time.perf_counter()
            frame_id, sequence = item["frame_id"], item["sequence"]
            rgb_save_dir = os.path.join(eval_save_dir, "rgb", sequence)
            render_save_dir = os.path.join(eval_save_dir, "render_rgb", sequence)
            os.makedirs(rgb_save_dir, exist_ok=True)
            os.makedirs(render_save_dir, exist_ok=True)
            todo = []
            for sid in range(len(item["img_sources"])):
                dist = source_distance(item, sid)
                name = f"{frame_id}_{item['source_frame_ids'][sid]}_{dist:.2f}.png"
                rgb_filepath = os.path.join(rgb_save_dir, name)
                render_filepath = os.path.join(render_save_dir, name)
                if os.path.exists(render_filepath):
                    continue
                if not os.path.exists(rgb_filepath):
                    source_image_saver(item, sid, rgb_filepath)
                todo.append((sid, item["T_source2infers"][sid], render_filepath))
            if todo:
                job = _frame_job(item, renders=todo)
        job = D.broadcast_object(job, group)  # rank 0's decision on every rank
        if job is None:
            continue
        pyramid = encode(job)
        for sid, T, render_filepath in job["renders"]:
            out = render(pyramid, job["cam_K"], T, pixels, idx * 1000 + sid)
            if out is None:
                continue
            color = out[1]
            # the grid is x-major (n_x, n_y): transpose to (H, W, 3)
            img = np.transpose(color.reshape(grid_shape[0], grid_shape[1], 3), (1, 0, 2))
            if upsample_to is not None:
                img = recon.upsample_to(torch.from_numpy(img), upsample_to).numpy()
            common.save_color_png(render_filepath, img)
            print("Color saved", render_filepath)
            done["images"] += 1
        if lead:
            done["read_s"].append(t1 - t0)
            done["render_s"].append(common.synced_clock(dev) - t1)
    return done


@cli.command("render-colors")
@common.add_opts(common.KITTI_OPTS)
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def render_colors(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
                  frames_interval, n_devices, device, dist_backend):
    """Render novel RGB views at stride 3 for every val source frame."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None
    ds = common.eval_val_ds(root, preprocess_root, sequence_distance, frames_interval)

    def save_src(item, sid, path):
        src = os.path.join(root, "dataset/sequences/08/image_2",
                           f"{item['source_frame_ids'][sid]}.png")
        shutil.copyfile(src, path)

    return _render_colors_impl(ds, load_model(model_path, device), eval_save_dir,
                               stride=KITTI_COLOR_STRIDE, chunk=EVAL_CHUNK,
                               source_image_saver=save_src, group=group)


@cli.command("render-colors-bf")
@common.add_opts(BF_OPTS)
@common.N_DEVICES_OPT
@common.DEVICE_OPT
@common.DIST_BACKEND_OPT
def render_colors_bf(root, model_path, eval_save_dir, frame_interval, n_frames, n_devices,
                     device, dist_backend):
    """Render novel RGB views at stride 2 for every BundleFusion val source
    frame, upsampled to 640x480."""
    device, renders, group = common.render_world(n_devices, device, dist_backend)
    if not renders:
        return None

    def save_src(item, sid, path):
        common.save_color_png(path, item["img_sources"][sid])

    W, H = BF_COLOR_SIZE
    return _render_colors_impl(bf_val_ds(root, frame_interval, n_frames),
                               load_model(model_path, device), eval_save_dir,
                               stride=BF_COLOR_STRIDE, chunk=EVAL_CHUNK,
                               source_image_saver=save_src, source_distance=bf_source_distance,
                               upsample_to=(H, W), group=group)


def _eval_color_impl(eval_save_dir: str, sequence: str, resize, skip_frames=(),
                     lpips_metric: Optional[LPIPS] = None) -> Dict:
    """PSNR, SSIM and (with `lpips_metric`) LPIPS of every rgb/ and
    render_rgb/ pair of `sequence`, both resized to `resize` (W, H), summed
    per ceil(source distance) and printed; frames in `skip_frames` left out.
    Returns the sums and counts, and per pair the host seconds of PSNR +
    SSIM and the seconds of LPIPS (its result read back)."""
    from PIL import Image

    if lpips_metric is None:
        # the reference's lpips column is a published metric: not a silent 0
        print("LPIPS: skipped (no weights supplied -- pass --lpips_weights, or "
              "--lpips_vgg_path and --lpips_lin_path)")
    else:
        dev = next(lpips_metric.parameters()).device

    rgb_dir = os.path.join(eval_save_dir, "rgb", sequence)
    render_dir = os.path.join(eval_save_dir, "render_rgb", sequence)
    psnr_a, ssim_a, lpips_a = (defaultdict(float) for _ in range(3))
    cnt_a = defaultdict(int)
    host_s, lpips_s = [], []
    for rgb_path in sorted(glob.glob(os.path.join(rgb_dir, "*.png"))):
        filename = os.path.basename(rgb_path)
        parts = filename[:-4].split("_")
        frame_id, source_distance = parts[0], float(parts[-1])
        if frame_id in skip_frames:
            continue
        render_path = os.path.join(render_dir, filename)
        if not os.path.exists(render_path):
            continue
        rgb = Image.open(rgb_path).convert("RGB").resize(resize)
        rgb = np.array(rgb, np.float32) / 255.0
        rendered = Image.open(render_path).convert("RGB")
        if rendered.size != resize:
            rendered = rendered.resize(resize)
        rendered = np.array(rendered, np.float32) / 255.0

        k = math.ceil(source_distance)
        t0 = time.perf_counter()
        psnr_a[k] += psnr(rendered, rgb)
        ssim_a[k] += ssim(rendered, rgb)
        host_s.append(time.perf_counter() - t0)
        if lpips_metric is not None:
            t0 = time.perf_counter()
            lpips_a[k] += float(lpips_metric(torch.from_numpy((rendered - 0.5) * 2).to(dev),
                                             torch.from_numpy((rgb - 0.5) * 2).to(dev)))
            lpips_s.append(time.perf_counter() - t0)
        cnt_a[k] += 1
    common.print_color_metrics_table(psnr_a, ssim_a, lpips_a, cnt_a,
                                     lpips_enabled=lpips_metric is not None)
    return {"psnr": psnr_a, "ssim": ssim_a, "lpips": lpips_a, "count": cnt_a,
            "host_s": host_s, "lpips_s": lpips_s}


LPIPS_OPTS = [
    click.option("--eval_save_dir", default=""),
    click.option("--lpips_weights", default="", help="the JAX package's converted lpips npz"),
    click.option("--lpips_vgg_path", default="", help="torchvision vgg16 state dict"),
    click.option("--lpips_lin_path", default="", help="lpips linear weights state dict"),
    common.DEVICE_OPT,
]


def _lpips_metric(lpips_weights, lpips_vgg_path, lpips_lin_path, device) -> Optional[LPIPS]:
    """LPIPS on `device` from the weights the user names, else None."""
    if lpips_weights:
        return LPIPS.from_npz(lpips_weights, common.resolve_device(device))
    if lpips_vgg_path:
        return LPIPS.from_torch_checkpoint(lpips_vgg_path, lpips_lin_path,
                                           common.resolve_device(device))
    return None


@cli.command("eval-color")
@common.add_opts(LPIPS_OPTS)
def eval_color(eval_save_dir, lpips_weights, lpips_vgg_path, lpips_lin_path, device):
    """PSNR / SSIM / LPIPS of the rendered novel views at 407x124, grouped
    by distance. LPIPS runs on --device, and only with weights given."""
    return _eval_color_impl(eval_save_dir, "08", KITTI_COLOR_SIZE, skip_frames=VAL_ERROR_FRAMES,
                            lpips_metric=_lpips_metric(lpips_weights, lpips_vgg_path,
                                                       lpips_lin_path, device))


@cli.command("eval-color-bf")
@common.add_opts(LPIPS_OPTS)
def eval_color_bf(eval_save_dir, lpips_weights, lpips_vgg_path, lpips_lin_path, device):
    """PSNR / SSIM / LPIPS of copyroom's rendered novel views at 640x480 (no
    resize), grouped by distance."""
    return _eval_color_impl(eval_save_dir, "copyroom", BF_COLOR_SIZE,
                            lpips_metric=_lpips_metric(lpips_weights, lpips_vgg_path,
                                                       lpips_lin_path, device))


# --------------------------------------------------------------------------- #
# eval-sr
# --------------------------------------------------------------------------- #


@cli.command("eval-sr")
@common.add_opts(common.KITTI_OPTS)
@click.option("--recon_save_dir", default="")
def eval_sr(root, preprocess_root, model_path, eval_save_dir, sequence_distance,
            frames_interval, recon_save_dir):
    """Scene-reconstruction occupancy IoU/P/R against the voxel GT."""
    ds = common.kitti_val_ds(root, preprocess_root, sequence_distance, frames_interval,
                             load_voxels=True)
    metric, fov_metric = SSCMetrics(2), SSCMetrics(2)
    for idx in range(len(ds)):
        item = ds[idx]
        tsdf_path = os.path.join(recon_save_dir, "tsdf", item["sequence"],
                                 item["frame_id"] + ".npy")
        if not os.path.exists(tsdf_path):
            continue
        recon.eval_sr_frame(np.load(tsdf_path), item["target_1_1"], item["fov_mask_1"],
                            metric, fov_metric)

    print("==== Whole Scene ====")
    s = metric.get_stats()
    print(s["iou"], s["precision"], s["recall"])
    print("==== in FOV ====")
    s = fov_metric.get_stats()
    print(s["iou"], s["precision"], s["recall"])
    return metric.get_stats(), fov_metric.get_stats()


@cli.command("eval-sc-bf")
@click.option("--root", default="")
@click.option("--recon_save_dir", default="")
@common.add_opts(BF_WINDOW_OPTS)
def eval_sc_bf(root, recon_save_dir, frame_interval, n_frames):
    """BundleFusion scene-completion IoU / precision / recall of the fused
    TSDFs (depth2tsdf-bf) against the fused-depth GT occupancy
    (generate-sc-gt-bf): occupied where |tsdf| is below a threshold ramped
    along the height, 0.1 x voxel per voxel, within [voxel, 10 x voxel]."""
    ds = bf_val_ds(root, frame_interval, n_frames, n_sources=0)
    metric = SSCMetrics(2)
    for scan in ds.scans:
        name = scan["frame_id"] + ".pkl"
        tsdf_path = os.path.join(recon_save_dir, "tsdf", scan["sequence"], name)
        gt_path = os.path.join(recon_save_dir, "sc_gt", scan["sequence"], name)
        if not (os.path.exists(tsdf_path) and os.path.exists(gt_path)):
            continue
        with open(tsdf_path, "rb") as f:
            tsdf = pickle.load(f)["tsdf_grid"]
        with open(gt_path, "rb") as f:
            target = pickle.load(f)["occ"]
        occ = tsdf2occ_bf(tsdf, min_th=BF_SC_VOXEL, th=0.1, max_th=BF_SC_VOXEL * 10,
                          voxel_size=BF_SC_VOXEL)
        metric.add_batch(occ[None], np.asarray(target)[None])
    s = metric.get_stats()
    print("==== Scene Completion ====")
    print(s["iou"], s["precision"], s["recall"])
    return s


if __name__ == "__main__":
    cli()
