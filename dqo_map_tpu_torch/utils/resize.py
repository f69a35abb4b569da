"""`resize_like_pil`: PIL's `Image.resize(size)` on the host in numpy, bit
for bit: at its default resample, BICUBIC, for PIL's modes `L`, `RGB`,
`LA`, `RGBA`, `CMYK` and `I;16`, and NEAREST, which Pillow takes for `P`
and `1` whatever the resample asked (`Image.resize`; `Geometry.c`'s
`ImagingScaleAffine`). The BICUBIC arithmetic is Pillow's
`libImaging/Resample.c`: each axis's coefficients in double
(`precompute_coeffs`, the cubic with a = -0.5 over a support widened by
the ratio when shrinking, normalised per output pixel); for 8-bit bands
rounded to integers of `PRECISION_BITS` = 22 fractional bits, each output
clipped to uint8; for `I;16` summed in double and rounded; the horizontal
pass first, then the vertical; an axis that keeps its size is not
resampled. `LA` and `RGBA` are resampled premultiplied by alpha, as
Pillow's `Image.resize` converts them to `La` / `RGBa` and back
(`libImaging/Convert.c`); `CMYK` band by band as it is."""

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


def coefficients_double(in_size: int, out_size: int):
    """Resample.c's `precompute_coeffs` for one axis: (xmin (out,), the
    normalised double weights (out, ksize)), input pixel xmin[i] + t
    weighted by weights[i, t] (0 past the pixel's window)."""
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
    return xmin, w


def coefficients(in_size: int, out_size: int):
    """Resample.c's `precompute_coeffs` and `normalize_coeffs_8bpc` for one
    axis: (xmin (out,), int64 weights (out, ksize)), the double weights
    rounded to `PRECISION_BITS` fractional bits."""
    xmin, w = coefficients_double(in_size, out_size)
    one = float(1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one))
    return xmin, k.astype(np.int64)


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


def _resample16(x: np.ndarray, out_size: int) -> np.ndarray:
    """One pass of Resample.c's `ImagingResample*_16bpc` along axis 0 of a
    uint16 array: the double coefficients summed in the C loop's order,
    `ROUND_UP`, then the low and the high byte each clipped to 0-255 on
    their own, as the C code stores them."""
    xmin, w = coefficients_double(x.shape[0], out_size)
    shape = (out_size,) + (1,) * (x.ndim - 1)
    ss = np.zeros((out_size,) + x.shape[1:])
    for t in range(w.shape[1]):
        ss = ss + np.take(x, np.minimum(xmin + t, x.shape[0] - 1),
                          axis=0) * w[:, t].reshape(shape)
    v = np.where(ss >= 0.0, ss + 0.5, ss - 0.5).astype(np.int64)  # C's (int)
    lo = np.clip(np.fmod(v, 256), 0, 255)
    hi = np.clip(v >> 8, 0, 255)
    return (hi * 256 + lo).astype(np.uint16)


def _resize_planes(img: np.ndarray, W: int, H: int, one_pass) -> np.ndarray:
    """The horizontal pass first, then the vertical; an axis that keeps its
    size is not resampled."""
    out = img
    if W != img.shape[1]:
        cols = np.ascontiguousarray(np.swapaxes(out, 0, 1))
        out = np.ascontiguousarray(np.swapaxes(one_pass(cols, W), 0, 1))
    if H != img.shape[0]:
        out = one_pass(np.ascontiguousarray(out), H)
    return out


def _pass8(x: np.ndarray, out_size: int) -> np.ndarray:
    return _resample(x.astype(np.int32), out_size)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Convert.c's `rgbA2rgba` / `lA2la`: each colour sample times alpha
    over 255 with `MULDIV255`'s rounding."""
    a = img[..., -1:].astype(np.int64)
    tmp = img[..., :-1].astype(np.int64) * a + 128
    return np.concatenate([((tmp >> 8) + tmp) >> 8, a], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Convert.c's `rgba2rgbA` / `la2lA`: each colour sample times 255 over
    alpha, clipped, where alpha is neither 0 nor 255."""
    a = img[..., -1:].astype(np.int64)
    c = img[..., :-1].astype(np.int64)
    div = np.clip(255 * c // np.maximum(a, 1), 0, 255)
    return np.concatenate([np.where((a == 0) | (a == 255), c, div), a],
                          axis=-1).astype(np.uint8)


def _nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """`ImagingScaleAffine`: output pixel x samples input column
    floor(x0 + x * scale) with x0 = scale / 2, the positions summed in
    double one step at a time as the C loop does, and likewise the rows;
    a position past the image leaves its pixel 0."""
    def taps(n_in, n_out):
        a = n_in / n_out
        pos = np.add.accumulate(np.concatenate([[a * 0.5],
                                                np.full(n_out - 1, a)]))
        idx = pos.astype(np.int64)
        return np.minimum(idx, n_in - 1), idx < n_in
    cols, col_ok = taps(img.shape[1], W)
    rows, row_ok = taps(img.shape[0], H)
    out = img[rows][:, cols]
    out[~row_ok] = 0
    out[:, ~col_ok] = 0
    return out


# the arrays of PIL's modes: (ndim, channels, dtype)
MODES = {"1": (2, 1, bool), "L": (2, 1, np.uint8), "P": (2, 1, np.uint8),
         "I;16": (2, 1, np.uint16), "LA": (3, 2, np.uint8),
         "RGB": (3, 3, np.uint8), "RGBA": (3, 4, np.uint8),
         "CMYK": (3, 4, np.uint8)}


def _mode_of(img: np.ndarray) -> str:
    """The mode an array without one is read as: (H, W) uint8 `L`, uint16
    `I;16`; (H, W, 2 / 3 / 4) uint8 `LA`, `RGB`, `RGBA`."""
    for mode in ("L", "I;16", "LA", "RGB", "RGBA"):
        ndim, ch, dt = MODES[mode]
        if img.ndim == ndim and img.dtype == dt and (
                ndim == 2 or img.shape[2] == ch):
            return mode
    raise ValueError(f"resizing reads (H, W) uint8 or uint16 and "
                     f"(H, W, 2 / 3 / 4) uint8 images (PIL's L, I;16, "
                     f"LA, RGB and RGBA) without a mode, got {img.dtype} "
                     f"{img.shape}")


def resize_like_pil(img: np.ndarray, size, mode: str = None) -> np.ndarray:
    """`np.asarray(Image.fromarray(img, mode).resize(size))` at size =
    (width, height), for the array of an image of PIL's `mode`: `1`
    ((H, W) bool), `L` or `P` ((H, W) uint8), `I;16` ((H, W) uint16),
    `LA` ((H, W, 2) uint8), `RGB` ((H, W, 3) uint8), `RGBA` or `CMYK`
    ((H, W, 4) uint8). Without a mode the array is read as `L`, `I;16`,
    `LA`, `RGB` or `RGBA` by its shape and type. As in Pillow, an image at
    its own size comes back as a copy, whatever its type; `P` and `1` are
    resized NEAREST; `LA` and `RGBA` resampled BICUBIC with their colour
    premultiplied by alpha (Pillow's `La` / `RGBa`), each band as `L`;
    `CMYK` band by band; `I;16` through the 16-bit path. Raises
    `ValueError` on an unknown mode or an array that is not its mode's."""
    img = np.asarray(img)
    W, H = (int(s) for s in size)
    if W < 1 or H < 1:
        raise ValueError(f"size {size} is not positive")
    if img.ndim >= 2 and img.shape[:2] == (H, W):
        return img.copy()
    if mode is None:
        mode = _mode_of(img)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(MODES)}")
    ndim, ch, dt = MODES[mode]
    if img.ndim != ndim or img.dtype != dt or (ndim == 3 and
                                               img.shape[2] != ch):
        shape = "(H, W)" if ndim == 2 else f"(H, W, {ch})"
        raise ValueError(f"a {mode} image is {shape} {np.dtype(dt).name}, "
                         f"got {img.dtype} {img.shape}")
    if mode in ("1", "P"):
        return _nearest(img, W, H)
    if mode == "I;16":
        return _resize_planes(img, W, H, _resample16)
    if mode in ("LA", "RGBA"):
        return _unpremultiply(_resize_planes(_premultiply(img), W, H,
                                             _pass8))
    return _resize_planes(img, W, H, _pass8)
