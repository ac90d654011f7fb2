"""Synthetic input frames in numpy (counterpart of the parts of
`scenerf_tpu/data/synthetic.py` the serve path needs): the default pinhole
intrinsics and the procedurally textured input image."""
from __future__ import annotations

import numpy as np

from scenerf_tpu_torch.config import SceneRFConfig


def default_intrinsics(cfg: SceneRFConfig) -> np.ndarray:
    W, H = cfg.img_size
    f = 0.6 * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)


def texture(H: int, W: int, seed: int) -> np.ndarray:
    """[H, W, 3] smooth random-phase sinusoid image in [0, 1], the input
    frame of the JAX package's `make_batch` for the same seed."""
    rng = np.random.default_rng(seed)
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


def input_frame(cfg: SceneRFConfig, seed: int = 0) -> np.ndarray:
    """One [1, H, W, 3] input frame at the config's image size."""
    W, H = cfg.img_size
    return texture(H, W, seed)[None]
