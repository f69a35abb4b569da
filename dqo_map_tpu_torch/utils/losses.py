"""Loss and metric functions: L1, PSNR, SSIM with an 11x11 Gaussian window
(counterpart of `dqo_map_tpu/utils/losses.py`). Images are channel-first
(C,H,W) for `ssim`, any shape for the others.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@lru_cache(maxsize=4)
def _gaussian_taps(window_size: int, sigma: float) -> tuple:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return tuple(float(x) for x in (g / g.sum()).astype(np.float32))


def _blur_separable(x: torch.Tensor, taps: tuple) -> torch.Tensor:
    """Separable zero-padded ('same') Gaussian blur of (..., H, W): a sum
    of shifted copies along H, then along W."""
    r = len(taps) // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, r, r))
    y = 0.0
    for i, t in enumerate(taps):
        y = y + t * xp[..., i:i + H, :]
    yp = F.pad(y, (r, r, 0, 0))
    z = 0.0
    for i, t in enumerate(taps):
        z = z + t * yp[..., :, i:i + W]
    return z


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a (C,H,W) pair with 'same' zero padding (window
    sigma 1.5, C1 = 0.01^2, C2 = 0.03^2); the five window means run as one
    stacked separable blur."""
    taps = _gaussian_taps(window_size, 1.5)
    m = _blur_separable(torch.stack(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2]), taps)
    mu1, mu2 = m[0], m[1]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m[2] - mu1_sq
    sigma2_sq = m[3] - mu2_sq
    sigma12 = m[4] - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()
