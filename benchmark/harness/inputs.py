"""Every input of a run, made from its seed: the weights, the frames and
their cameras, the training draws and the sweep poses. The program and the
reference get the same ones.

The frames are frozen copies of the program's synthetic generators
(`data/synthetic.py`: `texture`, `_plane_view`, `make_geometric_batch`),
with the plane's depth, slant and texture phase and the source cameras'
offsets drawn from the seed, so that every seed gives frames of the same
sizes and a different scene. The poses are a frozen copy of the program's
`geometry.sample_rel_poses` / `sample_rel_poses_bf`, and the training draws
of `SceneRF.draw_noise` with `sampling.random_grid_pixels`.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the part `keys` of a run seeded `seed` (any whole
    number, also beyond 32 bits)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


# ---------------------------------------------------------------- weights


def draw_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict of f32 tensors of `shapes`, drawn on `device` in one call
    of U(-1, 1) and scaled by kind: a weight of two or more dimensions
    U(+-sqrt(3 / fan_in)) (variance 1 / fan_in, fan_in the product of its
    trailing sizes), a bias U(+-0.1), a batch norm's scale 1 + U(+-0.2), its
    running mean U(+-0.1) and its running variance 1 + U(+-0.5)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        last = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            u.mul_(math.sqrt(3.0 / math.prod(shape[1:])))
        elif last == "weight":
            u.mul_(0.2).add_(1.0)
        elif last == "running_var":
            u.mul_(0.5).add_(1.0)
        else:  # bias, running_mean
            u.mul_(0.1)
        out[name] = u
    return out


# ---------------------------------------------------------------- frames


def texture(H: int, W: int, rng: np.random.Generator) -> np.ndarray:
    """[H, W, 3] smooth random-phase sinusoid image in [0, 1]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(xx / (3 + 7 * rng.random()) + rng.random() * 6),
            0.5 + 0.5 * np.sin(yy / (3 + 7 * rng.random()) + rng.random() * 6),
            0.5 + 0.5 * np.sin((xx + yy) / (5 + 5 * rng.random())),
        ],
        axis=-1,
    )
    return img.astype(np.float32)


def plane_view(cam_K: np.ndarray, c: np.ndarray, H: int, W: int, z0: float, slope: float,
               freq: float, phase: np.ndarray):
    """A textured slanted plane z = z0 + slope * x (world frame) seen from a
    camera at world position `c` (identity rotation) -> (img [H, W, 3],
    depth [H, W]); the texture is a smooth function of the world hit point,
    so two views agree photometrically under reprojection."""
    fx, fy, cx, cy = cam_K[0, 0], cam_K[1, 1], cam_K[0, 2], cam_K[1, 2]
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float32)
    dx = (uu + 0.5 - cx) / fx
    dy = (vv + 0.5 - cy) / fy
    lam = (z0 + slope * c[0] - c[2]) / (1.0 - slope * dx)  # camera z == depth
    x = (c[0] + lam * dx) * freq
    y = (c[1] + lam * dy) * freq
    img = np.stack(
        [
            0.5 + 0.35 * np.sin(2.1 * x + phase[0]) * np.cos(1.7 * y),
            0.5 + 0.35 * np.sin(1.3 * x + phase[1]) * np.sin(2.3 * y),
            0.5 + 0.35 * np.cos(1.9 * x - phase[2]) * np.cos(1.1 * y + 1.3),
        ],
        axis=-1,
    ).astype(np.float32)
    return img, lam.astype(np.float32)


def camera(conf: dict) -> np.ndarray:
    return np.asarray(conf["cam_K"], np.float32)


def make_batch(conf: dict, cfg, seed: int, index: int) -> Dict[str, np.ndarray]:
    """Training batch `index` of a run seeded `seed` (batch size 1, the
    program's batch contract): every view sees one textured slanted plane,
    the sources stand behind and beside the infer camera, and gt_depth is the
    plane's depth at random pixels of each source."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2, index])
    W, H = cfg.img_size
    S, G = cfg.n_sources, cfg.n_gt_depth
    cam_K = camera(conf)
    lo, hi = conf["scene"]["depth"]
    z0 = float(rng.uniform(lo, hi))
    slope = float(rng.uniform(-0.2, 0.2))
    freq = float(conf["scene"]["texture_per_m"]) * float(rng.uniform(0.7, 1.4))
    phase = rng.uniform(0, 2 * np.pi, 3)
    step = float(conf["scene"]["source_step"])

    def pose_from(c: np.ndarray) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = c
        return T

    infer_img, _ = plane_view(cam_K, np.zeros(3, np.float32), H, W, z0, slope, freq, phase)
    src_imgs, src_depths, T_s2i = [], [], []
    for s in range(S):
        c = (np.array([0.7 * (s + 1), 0.3 * s, -(s + 1)], np.float32) * step
             * rng.uniform(0.8, 1.2, 3).astype(np.float32))
        img, depth = plane_view(cam_K, c, H, W, z0, slope, freq, phase)
        src_imgs.append(img)
        src_depths.append(depth)
        T_s2i.append(pose_from(c))

    gt_pix = rng.uniform(1, [W - 2, H - 2], size=(S, G, 2)).astype(np.float32)
    gt_depth = np.stack([
        src_depths[s][gt_pix[s, :, 1].astype(int), gt_pix[s, :, 0].astype(int)]
        for s in range(S)
    ])
    return {
        "img_input": infer_img[None],
        "cam_K": cam_K[None],
        "T_source2infer": np.stack(T_s2i)[None],
        # the target camera is the infer camera (the reference's KITTI pairing)
        "T_source2target": np.stack(T_s2i)[None],
        "img_sources": np.stack(src_imgs)[None],
        "img_targets": np.tile(infer_img[None, None], (1, S, 1, 1, 1)),
        "source_mask": np.ones((1, S), dtype=np.float32),
        "gt_pix": gt_pix[None],
        "gt_depth": gt_depth[None],
        "gt_mask": np.ones((1, S, G), dtype=np.float32),
    }


def make_frame(conf: dict, cfg, seed: int, index: int) -> np.ndarray:
    """Sweep frame `index` of a run seeded `seed`: [1, H, W, 3], a textured
    slanted plane as `make_batch`'s input frame, over a random-phase
    texture."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 3, index])
    W, H = cfg.img_size
    lo, hi = conf["scene"]["depth"]
    img, _ = plane_view(camera(conf), np.zeros(3, np.float32), H, W,
                        float(rng.uniform(lo, hi)), float(rng.uniform(-0.2, 0.2)),
                        float(conf["scene"]["texture_per_m"]) * float(rng.uniform(0.7, 1.4)),
                        rng.uniform(0, 2 * np.pi, 3))
    return (0.6 * img + 0.4 * texture(H, W, rng))[None]


# ---------------------------------------------------------------- draws


def grid_pixels(x0: int, x1: int, y0: int, y1: int, stride: int, device) -> torch.Tensor:
    """The stride-subsampled pixels of [x0, x1) x [y0, y1) as [N, 2] (x, y),
    y varying fastest."""
    xs = torch.arange(x0, x1, stride, dtype=torch.float32, device=device)
    ys = torch.arange(y0, y1, stride, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def random_grid_pixels(gen: torch.Generator, n_rays: int, W: int, H: int, stride: int,
                       grid_size: int, device) -> torch.Tensor:
    """n_rays training pixels [n_rays, 2] drawn without replacement from the
    stride-subsampled image grid; with grid_size > 1, n_rays / grid_size^2
    from each of grid_size x grid_size cells, in row-major order."""
    if grid_size <= 1:
        cells, n_per_cell = [(0, W, 0, H)], n_rays
    else:
        cw, ch = W // grid_size, H // grid_size
        cells = [(cx * cw, (cx + 1) * cw, cy * ch, (cy + 1) * ch)
                 for cy in range(grid_size) for cx in range(grid_size)]
        n_per_cell = n_rays // (grid_size * grid_size)
    out = []
    for x0, x1, y0, y1 in cells:
        pixels = grid_pixels(x0, x1, y0, y1, stride, device)
        idx = torch.randperm(pixels.shape[0], generator=gen, device=device)[:n_per_cell]
        out.append(pixels[idx])
    return torch.cat(out)


def draw_noise(cfg, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """Every random draw of training step `index` ([1, S, ...] per key, the
    program's `Noise` contract), drawn on `device`."""
    W, H = cfg.img_size
    S, R_, G = cfg.n_sources, cfg.n_rays, cfg.n_gt_depth
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4, index))
    pixels = torch.stack([random_grid_pixels(gen, R_, W, H, cfg.pixel_stride,
                                             cfg.sample_grid_size, device)
                          for _ in range(S)])[None]
    kw = dict(generator=gen, device=device)
    lead = (1, S)
    return {
        "pixels": pixels,
        "uni": torch.rand(*lead, R_, cfg.n_pts_uni, **kw),
        "gauss": torch.randn(*lead, R_, cfg.n_pts_gauss, **kw),
        "reproj": torch.randn(*lead, R_, **kw),
        "gt_uni": torch.rand(*lead, G, cfg.n_pts_uni, **kw),
        "gt_gauss": torch.randn(*lead, G, cfg.n_pts_gauss, **kw),
    }


# ---------------------------------------------------------------- poses


def y_rotation_pose(step: float, angle_deg: float) -> np.ndarray:
    """rot_y(angle) @ translate_z(step)."""
    rad = angle_deg / 180.0 * math.pi
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = step
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.array([[math.cos(rad), 0.0, math.sin(rad)],
                            [0.0, 1.0, 0.0],
                            [-math.sin(rad), 0.0, math.cos(rad)]], dtype=np.float32)
    return rot @ trans


def sweep_poses(step: float, angles: List[float], max_distance: float) -> np.ndarray:
    """[P, 4, 4] relative poses of a novel-view sweep: forward steps of
    `step` below `max_distance`, each at the yaws `angles` in degrees, in
    their order (KITTI's CLI: 0, 10, -10; BundleFusion's: 0, -30, 30)."""
    return np.stack([y_rotation_pose(float(s), float(a))
                     for s in np.arange(0.0, max_distance, step) for a in angles])


def pose_seed(seed: int, frame: int, pose: int) -> int:
    """The seed of the generator that pose `pose` of frame `frame` draws its
    render noise from."""
    return sub_seed(seed, 5, frame, pose)
