"""Loss and metric functions: L1, L2, masked L1, PSNR, SSIM with an 11x11
Gaussian window and multi-scale SSIM (counterpart of
`dqo_map_tpu/utils/losses.py`). Images are channel-first (C,H,W) for `ssim`
and `ms_ssim`, any shape for the others.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def masked_l1(a: torch.Tensor, b: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean of |a-b| over the elements where `mask` holds (0 for an empty
    mask); the mask broadcasts over trailing dimensions of `a`."""
    m = mask.to(a.dtype)
    while m.ndim < a.ndim:
        m = m[..., None]
    num = (torch.abs(a - b) * m).sum()
    den = m.sum() * (a.numel() / max(1, mask.numel()))
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)


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


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM of a (C,H,W) pair with the standard weights. The
    levels adapt down when the image is too small for 5 halvings (the
    11-tap window needs 11 pixels a side), so small images score with
    fewer scales."""
    max_lv, side = 1, min(img1.shape[-2:])
    while max_lv < levels and (side >> 1) >= 11:
        side >>= 1
        max_lv += 1
    levels = min(levels, max_lv)
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           device=img1.device)[:levels]
    weights = weights / weights.sum()

    def downsample(x):
        C, H, W = x.shape
        Hc, Wc = H - H % 2, W - W % 2
        return x[:, :Hc, :Wc].reshape(C, Hc // 2, 2, Wc // 2, 2).mean(dim=(2, 4))

    taps = _gaussian_taps(11, 1.5)
    C1, C2 = 0.01**2, 0.03**2
    mcs, a, b = [], img1, img2
    for i in range(levels):
        m = _blur_separable(torch.stack([a, b, a * a, b * b, a * b]), taps)
        mu1, mu2 = m[0], m[1]
        s1 = m[2] - mu1 * mu1
        s2 = m[3] - mu2 * mu2
        s12 = m[4] - mu1 * mu2
        cs = ((2 * s12 + C2) / (s1 + s2 + C2)).mean()
        if i == levels - 1:
            val = ((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1)).mean()
        mcs.append(torch.clamp(cs, min=0.0))
        a, b = downsample(a), downsample(b)
    mcs = torch.stack(mcs)
    return torch.prod(mcs[:-1] ** weights[:-1]) * (val ** weights[-1])
