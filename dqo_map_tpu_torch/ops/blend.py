"""Front-to-back alpha blending with the hit-Gaussian depth model: the plain
PyTorch version of the forward blend kernel (counterpart of
`dqo_map_tpu/ops/blend.py`; the CUDA rasterizer's `renderCUDA_withMask`).

Per pixel, over its tile's depth-sorted entries:

- alpha = min(0.99, opacity * exp(power)); an entry is skipped where
  power > 0 or alpha < 1/255; transmittance is multiplicative, and an entry
  contributes while the transmittance after it, test_T, is >= T_threshold;
- color = sum of w * rgb + end_T * bg, with w = alpha * T;
- the hit: the first non-skipped entry with alpha >= opaque_threshold. Its
  depth is the plane intersection ndm / (n . ray) * ray_z where that lies
  within scale_max * depth_threshold of the splat and |n . ray| >=
  normal_threshold, else the splat z; its camera-frame normal rides along;
- aux maps: hit id, first-max color id (strict >, the earliest max wins),
  color and hit weights, end_T (the last contributing test_T), weight sum
  and T_final;
- per entry, n_touched: the pixels it contributes to with test_T > 0.5.

A pixel is done once T < T_threshold and its hit is found; it is then left
alone, so T_final is the transmittance where the pixel stopped.

`blend_tiles_ref` walks the entries one at a time for all tiles at once
(`blend_step` is one such step, the counterpart of the reference's
`blend_chunk` with a chunk of one entry). It is written in the CUDA
kernel's order of float operations (`ops/blend_cuda.py`, built without
FMA contraction), so the two agree to the last bit where the exp does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99

# rows of the packed (16, L) entry features, shared with the CUDA kernel:
# 0:2 xy | 2:5 conic | 5 opacity (0 for padding: doubles as the validity
# lane) | 6:9 rgb | 9 depth (camera z) | 10:13 normal_c | 13 scale_max
# | 14 gaussian id | 15 ndm = normal_c . mean_c
NF = 16


class BlendParams(NamedTuple):
    opaque_threshold: float
    depth_threshold: float
    normal_threshold: float   # already cos(deg)
    T_threshold: float


def gather_entry_feats(point_list, valid_entries, xy, conic, opacity, color,
                       depth, mean_c, normal_c, scale_max):
    """Per-gaussian arrays in sorted entry order, as the (16, L) rows above.
    Padding entries get opacity 0."""
    ndm = (mean_c[:, 0] * normal_c[:, 0] + mean_c[:, 1] * normal_c[:, 1]
           + mean_c[:, 2] * normal_c[:, 2])
    gid = torch.arange(xy.shape[0], dtype=torch.float32, device=xy.device)
    rows = torch.stack([
        xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2], opacity,
        color[:, 0], color[:, 1], color[:, 2], depth,
        normal_c[:, 0], normal_c[:, 1], normal_c[:, 2], scale_max, gid, ndm,
    ])
    feats = rows[:, point_list]
    feats[5] = torch.where(valid_entries, feats[5], 0.0)
    return feats


def tile_rays(tiles: torch.Tensor, tw: int, tile_size: int, K: torch.Tensor):
    """Pixel coordinates and unit camera rays of each tile's pixels in
    row-major order: five (len(tiles), tile_size^2) tensors."""
    p = torch.arange(tile_size * tile_size, device=tiles.device)
    px = ((tiles % tw)[:, None] * tile_size + p % tile_size).float()
    py = ((tiles // tw)[:, None] * tile_size + p // tile_size).float()
    rx = (px - K[0, 2]) / K[0, 0]
    ry = (py - K[1, 2]) / K[1, 1]
    nrm = torch.sqrt(rx * rx + ry * ry + 1.0)
    return px, py, rx / nrm, ry / nrm, 1.0 / nrm


class PixelState:
    """Per-pixel blend state, (tiles, n_px) each, carried across entries."""

    def __init__(self, shape, device):
        z = lambda: torch.zeros(shape, device=device)  # noqa: E731
        self.T = torch.ones(shape, device=device)
        self.color = [z(), z(), z()]
        self.weight_sum = z()
        self.end_T = torch.ones(shape, device=device)
        self.best_w = torch.full(shape, -1.0, device=device)
        self.best_id = torch.full(shape, -1, dtype=torch.int64, device=device)
        self.hit_found = torch.zeros(shape, dtype=torch.bool, device=device)
        self.hit_id = torch.full(shape, -1, dtype=torch.int64, device=device)
        self.hit_depth = z()
        self.hit_weight = z()
        self.hit_normal = [z(), z(), z()]
        self.done = torch.zeros(shape, dtype=torch.bool, device=device)


def blend_step(s: PixelState, f: torch.Tensor, px, py, rx, ry, rz,
               params: BlendParams) -> torch.Tensor:
    """Blend one entry per tile into the pixel state. `f` (16, tiles) holds
    each tile's current entry; pixel tensors are (tiles, n_px). Returns the
    entry's n_touched per tile."""
    e = [f[r][:, None] for r in range(NF)]
    active = ~s.done
    dx = e[0] - px
    dy = e[1] - py
    power = -0.5 * (e[2] * dx * dx + e[4] * dy * dy) - e[3] * dx * dy
    G = torch.exp(power)
    alpha_raw = torch.clamp(e[5] * G, max=ALPHA_MAX)
    skip = (power > 0.0) | (alpha_raw < ALPHA_MIN)
    alpha = torch.where(skip, 0.0, alpha_raw)
    test_T = s.T * (1.0 - alpha)
    contrib = active & (~skip) & (test_T >= params.T_threshold)
    w = torch.where(contrib, alpha * s.T, 0.0)

    s.color = [s.color[c] + w * e[6 + c] for c in range(3)]
    s.weight_sum = s.weight_sum + w
    take = active & (w > s.best_w)
    s.best_w = torch.where(take, w, s.best_w)
    gid = e[14].to(torch.int64)
    s.best_id = torch.where(take & (w > 0.0), gid, s.best_id)
    s.end_T = torch.where(contrib, torch.minimum(s.end_T, test_T), s.end_T)

    new_hit = active & (~s.hit_found) & (~skip) & (
        alpha_raw >= params.opaque_threshold)
    ndr = e[10] * rx + e[11] * ry + e[12] * rz
    hz = e[15] / (ndr + 1e-8) * rz
    plane_ok = (torch.abs(hz - e[9]) <= e[13] * params.depth_threshold) & (
        torch.abs(ndr) >= params.normal_threshold)
    s.hit_depth = torch.where(new_hit, torch.where(plane_ok, hz, e[9]),
                              s.hit_depth)
    s.hit_weight = torch.where(new_hit, alpha * s.T, s.hit_weight)
    s.hit_id = torch.where(new_hit, gid, s.hit_id)
    s.hit_normal = [torch.where(new_hit, e[10 + c], s.hit_normal[c])
                    for c in range(3)]
    s.hit_found = s.hit_found | new_hit

    s.T = torch.where(active, test_T, s.T)
    s.done = s.done | ((s.T < params.T_threshold) & s.hit_found)
    return torch.sum(contrib & (test_T > 0.5), dim=1)


def untile_map(x: torch.Tensor, tile_size: int, width: int, height: int):
    """(num_tiles, n_px[,C]) -> (H,W[,C])."""
    TH = (height + tile_size - 1) // tile_size
    TW = (width + tile_size - 1) // tile_size
    tail = x.shape[2:]
    x = x.reshape((TH, TW, tile_size, tile_size) + tail)
    x = x.transpose(1, 2).reshape((TH * tile_size, TW * tile_size) + tail)
    return x[:height, :width]


def blend_tiles_ref(feats: torch.Tensor, tile_offsets: torch.Tensor,
                    tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                    width: int, height: int, K: torch.Tensor,
                    params: BlendParams, bg, stats=None):
    """Blend every tile's live entries, the `tile_counts[t]` entries of the
    (16, L) `feats` from `tile_offsets[t]` on; the padding after them is
    not visited. Returns the image maps and `n_touched_entries` (L,), 0 on
    padding. With a `stats` dict, puts there in "pairs" the number of
    (pixel, entry) pairs blended before each pixel was done: the work this
    input needs."""
    dev = feats.device
    TW = (width + tile_size - 1) // tile_size
    n = tile_size * tile_size
    tiles = torch.nonzero(tile_counts > 0)[:, 0]
    start, cnt = tile_offsets[tiles], tile_counts[tiles]
    k_max = int(cnt.max()) if len(tiles) else 0
    px, py, rx, ry, rz = tile_rays(tiles, TW, tile_size, K)
    s = PixelState((len(tiles), n), dev)
    nt = torch.zeros(feats.shape[1], dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(k_max):
        has = k < cnt
        if stats is not None:
            pairs += (~s.done & has[:, None]).sum()
        idx = start + torch.clamp(cnt - 1, max=k)
        f = feats[:, idx]
        f[5] = torch.where(has, f[5], 0.0)
        touched = blend_step(s, f, px, py, rx, ry, rz, params)
        nt[idx[has]] = touched[has]

    def full(vals, fill, dtype=torch.float32):
        out = torch.full((num_tiles, n), fill, dtype=dtype, device=dev)
        out[tiles] = vals
        return untile_map(out, tile_size, width, height)

    if stats is not None:
        stats["pairs"] = int(pairs)
    bg = [float(b) for b in bg]
    color = [full(s.color[c] + s.end_T * bg[c], bg[c]) for c in range(3)]
    return {
        "render": torch.stack(color, dim=-1),
        "depth": full(s.hit_depth, 0.0),
        "depth_index_map": full(s.hit_id, -1, torch.int64).int(),
        "color_index_map": full(s.best_id, -1, torch.int64).int(),
        "color_hit_weight": full(torch.clamp(s.best_w, min=0.0), 0.0),
        "depth_hit_weight": full(s.hit_weight, 0.0),
        "T_map": full(s.end_T, 1.0),
        "weight_sum": full(s.weight_sum, 0.0),
        "T_final": full(s.T, 1.0),
        "normal_c": torch.stack([full(s.hit_normal[c], 0.0) for c in range(3)],
                                dim=-1),
        "n_touched_entries": nt.int(),
    }
