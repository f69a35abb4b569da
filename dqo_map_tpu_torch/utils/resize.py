"""`resize_like_pil`: PIL's `Image.resize(size)` at its default resample,
BICUBIC, on the host in numpy, bit for bit, for grey (`L`) and RGB uint8
images. The arithmetic is Pillow's `libImaging/Resample.c`: each axis's
coefficients in double (`precompute_coeffs`, the cubic with a = -0.5 over
a support widened by the ratio when shrinking, normalised per output
pixel), rounded to integers of `PRECISION_BITS` = 22 fractional bits; the
horizontal pass first, each output clipped to uint8, then the vertical
pass; an axis that keeps its size is not resampled."""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 2.0                     # the bicubic filter's


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's `bicubic_filter` (a = -0.5), in its operation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def coefficients(in_size: int, out_size: int):
    """Resample.c's `precompute_coeffs` and `normalize_coeffs_8bpc` for one
    axis: (xmin (out,), int64 weights (out, ksize)), input pixel
    xmin[i] + t weighted by weights[i, t] (0 past the pixel's window)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    t = np.arange(ksize)
    live = t[None, :] < xmax[:, None]
    w = np.where(live, _bicubic(((t[None, :] + xmin[:, None]).astype(
        np.float64) - center[:, None] + 0.5) * ss), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):       # summed in the C loop's order
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    one = float(1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one))
    return xmin, np.where(live, k, 0).astype(np.int64)


def _resample(x: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit pass along axis 0 of the int32 array `x` to `out_size`.
    The sums are int32 and run over the taps in Resample.c's order, so
    every partial sum is the C loop's own."""
    xmin, k = coefficients(x.shape[0], out_size)
    k = k.astype(np.int32)
    shape = (out_size,) + (1,) * (x.ndim - 1)
    acc = np.full((out_size,) + x.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    tap = np.empty_like(acc)
    for t in range(k.shape[1]):
        np.take(x, np.minimum(xmin + t, x.shape[0] - 1), axis=0, out=tap)
        tap *= k[:, t].reshape(shape)
        acc += tap
    # clip8: the sum's integer part, clamped to uint8
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_like_pil(img: np.ndarray, size) -> np.ndarray:
    """`np.asarray(Image.fromarray(img).resize(size))` for an (H, W) or
    (H, W, 3) uint8 `img` and `size` = (width, height). Raises
    `ValueError` on any other image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"resizing reads (H, W) or (H, W, 3) uint8 images "
                         f"(PIL's L and RGB), got {img.dtype} {img.shape}")
    W, H = (int(s) for s in size)
    if W < 1 or H < 1:
        raise ValueError(f"size {size} is not positive")
    out = img
    if W != img.shape[1]:                  # the horizontal pass first
        cols = np.ascontiguousarray(np.swapaxes(out, 0, 1), np.int32)
        out = np.ascontiguousarray(np.swapaxes(_resample(cols, W), 0, 1))
    if H != img.shape[0]:
        out = _resample(np.ascontiguousarray(out, np.int32), H)
    return out.copy() if out is img else out
