"""Novel-view image metrics on the host: PSNR and SSIM in numpy and scipy,
with skimage's numerics (`peak_signal_noise_ratio`;
`structural_similarity(channel_axis=-1, data_range=1)`: a uniform 7x7
window, the sample covariance, the border cropped). The port's own copy of
`scenerf_tpu/utils/image_metrics.py`; LPIPS is `utils/lpips.py`.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    err = np.mean((pred.astype(np.float64) - target.astype(np.float64)) ** 2)
    return float(10.0 * np.log10((data_range ** 2) / err))


def _ssim_single(im1: np.ndarray, im2: np.ndarray, data_range: float,
                 win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """SSIM of one channel: uniform window, sample covariance, border cropped."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    def filt(x):
        return uniform_filter(x, size=win_size)

    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM of [H, W] or [H, W, C] images: the mean over channels."""
    if pred.ndim == 2:
        return _ssim_single(pred, target, data_range)
    vals = [_ssim_single(pred[..., c], target[..., c], data_range)
            for c in range(pred.shape[-1])]
    return float(np.mean(vals))
