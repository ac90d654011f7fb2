"""Experiment configuration for the PyTorch port.

Field for field the same dataclasses, defaults and presets as
`scenerf_tpu.config` (which cannot be imported here: it pulls in JAX), so a
config maps 1:1 between the two packages. The knobs that only steer XLA on a
TPU are left out: `featurize_gather`, `resample_gather`, `decoder_conv`,
`source_unroll` and the `remat_*` switches.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SphereConfig:
    """Spherical (equirectangular) grid the feature pyramid lives on.

    Angles are in degrees; defaults are the KITTI camera FOV enlarged by
    (add_fov_hor, add_fov_ver).
    """

    width: int = 1500
    height: int = 452
    v_angle_min: float = 75.4815
    v_angle_max: float = 104.7294
    h_angle_min: float = 49.5950
    h_angle_max: float = 131.1128
    add_fov_hor: float = 20.0
    add_fov_ver: float = 8.0

    @property
    def v_min(self) -> float:
        return self.v_angle_min - self.add_fov_ver

    @property
    def v_max(self) -> float:
        return self.v_angle_max + self.add_fov_ver

    @property
    def h_min(self) -> float:
        return self.h_angle_min - self.add_fov_hor

    @property
    def h_max(self) -> float:
        return self.h_angle_max + self.add_fov_hor

    @property
    def h_fov(self) -> float:
        return abs(self.h_max - self.h_min)

    @property
    def v_fov(self) -> float:
        return abs(self.v_max - self.v_min)


@dataclasses.dataclass(frozen=True)
class SceneRFConfig:
    """One config for the whole model + train/eval stack."""

    name: str = "kitti"

    # ---- image / camera ----
    img_size: Tuple[int, int] = (1220, 370)  # (W, H)
    sphere: SphereConfig = dataclasses.field(default_factory=SphereConfig)

    # ---- ray sampling (PrSamp) ----
    n_rays: int = 1200
    n_pts_uni: int = 32
    n_gaussians: int = 4
    n_pts_per_gaussian: int = 8
    std: float = 2.5
    max_sample_depth: float = 100.0
    max_infer_depth: float = 120.0
    eval_depth: float = 80.0
    min_sample_depth: float = 0.2
    min_clamp_depth: float = 0.1
    mean_std_floor: float = 1.5
    som_sigma: float = 2.0
    kl_std_floor: float = 1.5
    pixel_stride: int = 2
    sampling_method: str = "uniform"   # "uniform" | "log"
    sample_grid_size: int = 1

    # ---- field MLP ----
    d_hidden: int = 512
    n_blocks: int = 3
    n_pe_freqs: int = 6
    d_latent: int = 2480

    # ---- encoder ----
    encoder: str = "effnet-b7"         # "effnet-b0".."effnet-b7" | "tiny"
    encoder_features: int = 2560
    bn_momentum: float = 0.99
    bn_eps: float = 1e-3

    # ---- losses ----
    use_color: bool = True
    use_reprojection: bool = True
    reprojection_weight: float = 1.0
    dist2closest_weight: float = 0.01
    som_mask_threshold: float = 0.1

    # ---- optimization ----
    lr: float = 1e-5
    weight_decay: float = 0.0
    lr_decay_gamma: float = 0.95
    batch_size: int = 1
    n_sources: int = 4
    n_gt_depth: int = 1024

    # ---- scene / reconstruction ----
    scene_size: Tuple[float, float, float] = (51.2, 51.2, 6.4)
    vox_origin: Tuple[float, float, float] = (0.0, -25.6, -2.0)
    voxel_size: float = 0.2
    tsdf_trunc_margin: float = 10.0
    occ_threshold: float = 0.25
    occ_max_threshold: float = 6.0
    sweep_step: float = 0.5
    sweep_angle: float = 10.0
    sweep_max_distance: float = 10.1

    # ---- execution ----
    ray_chunk: int = 300               # rays per block in the training render
    eval_ray_chunk: int = 4096         # rays per block at eval (no grad)
    compute_dtype: str = "float32"     # "float32" | "bfloat16"

    @property
    def n_pts_gauss(self) -> int:
        return self.n_gaussians * self.n_pts_per_gaussian

    @property
    def n_pts_per_ray(self) -> int:
        return self.n_pts_uni + self.n_pts_gauss

    @property
    def d_pe(self) -> int:
        return 3 + 2 * self.n_pe_freqs * 3

    @property
    def d_in(self) -> int:
        return self.d_pe + 3  # PE + viewdir

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "SceneRFConfig":
        return dataclasses.replace(self, **kw)


def kitti(**overrides) -> SceneRFConfig:
    """The published KITTI (outdoor) preset."""
    return SceneRFConfig(name="kitti").replace(**overrides)


def bundlefusion(**overrides) -> SceneRFConfig:
    """The published BundleFusion (indoor) preset."""
    cfg = SceneRFConfig(
        name="bundlefusion",
        img_size=(640, 480),
        sphere=SphereConfig(
            width=960,
            height=720,
            v_angle_min=69.125,
            v_angle_max=110.875,
            h_angle_min=64.6698,
            h_angle_max=115.3302,
            add_fov_hor=14.0,
            add_fov_ver=11.0,
        ),
        n_rays=1080,
        max_sample_depth=12.0,
        max_infer_depth=12.0,
        eval_depth=10.0,
        std=0.2,
        mean_std_floor=0.5,
        som_sigma=0.02,
        reprojection_weight=5.0,
        dist2closest_weight=0.1,
        lr=1e-4,
        sample_grid_size=2,
        scene_size=(4.8, 4.8, 3.84),
        vox_origin=(-2.4, -2.4, 0.0),
        voxel_size=0.04,
        sweep_step=0.2,
        sweep_angle=30.0,
        sweep_max_distance=2.1,
        ray_chunk=2048,
    )
    return cfg.replace(**overrides)


def tiny(**overrides) -> SceneRFConfig:
    """A small config for tests / smoke runs: full code paths, toy sizes."""
    cfg = SceneRFConfig(
        name="tiny",
        img_size=(64, 48),
        sphere=SphereConfig(width=80, height=64, add_fov_hor=5.0, add_fov_ver=3.0),
        n_rays=64,
        n_pts_uni=8,
        n_gaussians=3,
        n_pts_per_gaussian=4,
        d_hidden=32,
        n_blocks=2,
        d_latent=0,
        encoder="tiny",
        encoder_features=64,
        n_sources=2,
        n_gt_depth=32,
        ray_chunk=32,
        eval_ray_chunk=64,
    )
    return cfg.replace(**overrides)


PRESETS = {"kitti": kitti, "bundlefusion": bundlefusion, "tiny": tiny}
