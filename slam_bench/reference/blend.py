"""Frozen copy of the port's `ops/blend.py`, part of the benchmark's plain
reference: it imports nothing of the port, and later changes to the
port do not reach it.

The original's docstring:

Front-to-back alpha blending with the hit-Gaussian depth model: the plain
PyTorch versions of the two blend kernels, forward and backward
(counterpart of `dqo_map_tpu/ops/blend.py` and of the math of
`dqo_map_tpu/ops/blend_pallas.py::_fwd_kernel` / `_bwd_kernel`; the CUDA
rasterizer's `renderCUDA_withMask` and `renderCUDA_flat`).

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

The one-surface background (`bgt`, the local optimize scans' frozen stable
render): per pixel a surface of premultiplied colour S at depth D with
transmittance tau. Entries behind it (camera z > D) are scaled by tau and
cut where test_T * tau < T_threshold; S lands once, scaled by the
transmittance over the entries in front, at the first entry behind it, or
at the end with the final T when no entry is behind it.

A pixel is done once T < T_threshold and its hit is found (and, with the
background, once it has passed the surface); it is then left alone, so
T_final is the transmittance where the pixel stopped.

`blend_blocks_ref` walks the entries one at a time for all tiles at once
(`blend_step` is one such step, the counterpart of the reference's
`blend_chunk` with a chunk of one entry). It is written in the CUDA
kernel's order of float operations (`csrc/blend_fwd.cu`, built without FMA
contraction), so the two agree to the last bit where the exp does.

`blend_bwd_ref` is the vector-Jacobian product of that forward with respect
to the 16 feature rows, walking the entries in the same order: the colour
cotangent reaches xy, conic, opacity and rgb through dL/dalpha, with the
suffix of the colour sum taken as the saved total less the running prefix
(the surface's term joins the prefix where the pixel crosses it); the depth
and normal cotangents go to the pixel's hit entry (plane: rows 10:13 and
15, splat: row 9). The 0.99 clamp is straight-through, and the hit
selection and the plane / splat branch are constants, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99

# rows of the packed (16, L) entry features, shared with the CUDA kernels:
# 0:2 xy | 2:5 conic | 5 opacity (0 for padding: doubles as the validity
# lane) | 6:9 rgb | 9 depth (camera z) | 10:13 normal_c | 13 scale_max
# | 14 gaussian id | 15 ndm = normal_c . mean_c
NF = 16
NC = 8               # colour block: rgb, hit depth, hit normal_c, pad
NA = 8               # aux: hit id, colour id, colour w, hit w, end_T, wsum,
                     #      T_final, hit depth
NB = 8               # background operand: S rgb, D, tau, pad
# the gradient rows the backward writes (13 scale_max, 14 id get none)
GRAD_ROWS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15)


class BlendParams(NamedTuple):
    opaque_threshold: float
    depth_threshold: float
    normal_threshold: float   # already cos(deg)
    T_threshold: float


def gather_entry_feats(point_list, valid_entries, xy, conic, opacity, color,
                       depth, mean_c, normal_c, scale_max):
    """Per-gaussian arrays in sorted entry order, as the (16, L) rows above.
    Padding entries get opacity 0. The gather is an `index_select`, whose
    backward is an `index_add_`: the backward of `rows[:, point_list]`
    sorts the indices and took ~26 ms a call at office0 on an H100."""
    ndm = (mean_c[:, 0] * normal_c[:, 0] + mean_c[:, 1] * normal_c[:, 1]
           + mean_c[:, 2] * normal_c[:, 2])
    gid = torch.arange(xy.shape[0], dtype=torch.float32, device=xy.device)
    rows = torch.stack([
        xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2], opacity,
        color[:, 0], color[:, 1], color[:, 2], depth,
        normal_c[:, 0], normal_c[:, 1], normal_c[:, 2], scale_max, gid, ndm,
    ])
    feats = rows.index_select(1, point_list)
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
        one = lambda: torch.ones(shape, device=device)  # noqa: E731
        self.T = one()
        self.color = [z(), z(), z()]
        self.weight_sum = z()
        self.end_T = one()
        self.best_w = torch.full(shape, -1.0, device=device)
        self.best_id = torch.full(shape, -1, dtype=torch.int64, device=device)
        self.hit_found = torch.zeros(shape, dtype=torch.bool, device=device)
        self.hit_id = torch.full(shape, -1, dtype=torch.int64, device=device)
        self.hit_depth = z()
        self.hit_weight = z()
        self.hit_normal = [z(), z(), z()]
        self.done = torch.zeros(shape, dtype=torch.bool, device=device)
        self.crossed = torch.zeros(shape, dtype=torch.bool, device=device)
        self.T_front = one()


def _bg_pixels(bgt: Optional[torch.Tensor], tiles: torch.Tensor):
    """The background operand's S (3 tensors), D and tau at the given
    tiles' pixels, or None."""
    if bgt is None:
        return None
    b = bgt[tiles]
    return [b[..., c] for c in range(3)], b[..., 3], b[..., 4]


def blend_step(s: PixelState, f: torch.Tensor, px, py, rx, ry, rz,
               params: BlendParams, bgp=None) -> torch.Tensor:
    """Blend one entry per tile into the pixel state. `f` (16, tiles) holds
    each tile's current entry; pixel tensors are (tiles, n_px); `bgp` the
    background surface at those pixels (`_bg_pixels`) or None. Returns the
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

    if bgp is not None:
        S, D, tau = bgp
        behind = (e[5] != 0.0) & (e[9] > D)
        w = torch.where(behind, torch.where(
            test_T * tau < params.T_threshold, 0.0, w * tau), w)
        cross = active & behind & (~s.crossed)
        s.color = [s.color[c] + torch.where(cross, S[c] * s.T_front, 0.0)
                   for c in range(3)]
        s.crossed = s.crossed | cross
        s.T_front = torch.where(active & (~behind),
                                s.T_front * (1.0 - alpha), s.T_front)

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
    finished = (s.T < params.T_threshold) & s.hit_found
    if bgp is not None:
        finished = finished & s.crossed
    s.done = s.done | finished
    return torch.sum(contrib & (test_T > 0.5), dim=1)


def _walk(tile_offsets, tile_counts):
    """The tiles with live entries, their starts and counts, and the
    longest walk."""
    tiles = torch.nonzero(tile_counts > 0)[:, 0]
    start, cnt = tile_offsets[tiles], tile_counts[tiles]
    k_max = int(cnt.max()) if len(tiles) else 0
    return tiles, start, cnt, k_max


def _entry(feats, start, cnt, k):
    """The k-th live entry of each walked tile, (16, tiles), with opacity 0
    (no effect) where the tile has fewer; and which tiles have one."""
    has = k < cnt
    idx = start + torch.clamp(cnt - 1, max=k)
    f = feats[:, idx]
    f[5] = torch.where(has, f[5], 0.0)
    return f, idx, has


def blend_blocks_ref(feats: torch.Tensor, tile_offsets: torch.Tensor,
                     tile_counts: torch.Tensor, num_tiles: int,
                     tile_size: int, width: int, K: torch.Tensor,
                     params: BlendParams, bg, bgt: Optional[torch.Tensor] = None,
                     stats=None):
    """Blend every tile's live entries, the `tile_counts[t]` entries of the
    (16, L) `feats` from `tile_offsets[t]` on; the padding after them is
    not visited. `bgt` (num_tiles, n_px, 8) is the background surface
    (`pack_bg_tiled`) or None. Returns the kernel's blocks: colour
    (num_tiles, n_px, 8), aux (num_tiles, n_px, 8) and n_touched per entry
    (L,) int32, 0 on padding; a tile with no entries gets the init values.
    With a `stats` dict, puts there in "pairs" the number of (pixel, entry)
    pairs blended before each pixel was done: the work this input needs."""
    feats = feats.detach()
    dev = feats.device
    TW = (width + tile_size - 1) // tile_size
    n = tile_size * tile_size
    tiles, start, cnt, k_max = _walk(tile_offsets, tile_counts)
    px, py, rx, ry, rz = tile_rays(tiles, TW, tile_size, K)
    bgp = _bg_pixels(bgt, tiles)
    s = PixelState((len(tiles), n), dev)
    nt = torch.zeros(feats.shape[1], dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(k_max):
        f, idx, has = _entry(feats, start, cnt, k)
        if stats is not None:
            pairs += (~s.done & has[:, None]).sum()
        touched = blend_step(s, f, px, py, rx, ry, rz, params, bgp)
        nt[idx[has]] = touched[has]
    if stats is not None:
        stats["pairs"] = int(pairs)

    def full(vals, fill, dtype=torch.float32):
        out = torch.full((num_tiles, n), fill, dtype=dtype, device=dev)
        out[tiles] = vals.to(dtype)
        return out

    end_T, T = full(s.end_T, 1.0), full(s.T, 1.0)
    crossed = full(s.crossed, False, torch.bool)
    color = []
    for c in range(3):
        col = full(s.color[c], 0.0) + end_T * float(bg[c])
        if bgt is not None:
            col = col + torch.where(crossed, 0.0, bgt[:num_tiles, :, c] * T)
        color.append(col)
    hit_depth = full(s.hit_depth, 0.0)
    cblock = torch.stack(color + [hit_depth] + [full(s.hit_normal[c], 0.0)
                                                for c in range(3)]
                         + [torch.zeros_like(T)], dim=-1)
    aux = torch.stack([
        full(s.hit_id, -1.0), full(s.best_id, -1.0),
        full(torch.clamp(s.best_w, min=0.0), 0.0), full(s.hit_weight, 0.0),
        end_T, full(s.weight_sum, 0.0), T, hit_depth], dim=-1)
    return cblock, aux, nt.int()


def blend_bwd_ref(feats: torch.Tensor, tile_offsets: torch.Tensor,
                  tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                  width: int, K: torch.Tensor, params: BlendParams, bg,
                  color: torch.Tensor, aux: torch.Tensor,
                  dcolor: torch.Tensor, bgt: Optional[torch.Tensor] = None,
                  stats=None) -> torch.Tensor:
    """The blend's vector-Jacobian product: the cotangent `dcolor`
    (num_tiles, n_px, 8) of the colour block (rgb, hit depth, hit normal)
    taken back to the (16, L) entry features, 0 on padding and on rows 13
    and 14. `color` and `aux` are the forward's blocks. A pixel's alpha
    terms are walked while its T >= T_threshold (after that no entry
    contributes), its hit routing until its hit entry has passed. With a
    `stats` dict, puts there in "pairs" the number of (pixel, entry) pairs
    walked with T >= T_threshold."""
    feats = feats.detach()
    dev = feats.device
    TW = (width + tile_size - 1) // tile_size
    n = tile_size * tile_size
    thr = params.T_threshold
    tiles, start, cnt, k_max = _walk(tile_offsets, tile_counts)
    px, py, rx, ry, rz = tile_rays(tiles, TW, tile_size, K)
    bgp = _bg_pixels(bgt, tiles)
    dc, col, ax = dcolor[tiles], color[tiles], aux[tiles]
    d0, d1, d2, d3 = dc[..., 0], dc[..., 1], dc[..., 2], dc[..., 3]
    dn = [dc[..., 4], dc[..., 5], dc[..., 6]]
    hid, end_T = ax[..., 0], ax[..., 4]
    bg = [float(b) for b in bg]
    dot_total = ((col[..., 0] - end_T * bg[0]) * d0
                 + (col[..., 1] - end_T * bg[1]) * d1
                 + (col[..., 2] - end_T * bg[2]) * d2)
    bgdot = d0 * bg[0] + d1 * bg[1] + d2 * bg[2]
    if bgp is not None:
        S, D, tau = bgp
        sdot = S[0] * d0 + S[1] * d1 + S[2] * d2
        crossed = torch.zeros_like(hid, dtype=torch.bool)
        T_front = torch.ones_like(hid)
    T = torch.ones_like(hid)
    prefix = torch.zeros_like(hid)
    pending = hid >= 0
    dfeats = torch.zeros_like(feats)
    rows = torch.as_tensor(GRAD_ROWS, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(k_max):
        f, idx, has = _entry(feats, start, cnt, k)
        e = [f[r][:, None] for r in range(NF)]
        zero = torch.zeros_like(T)

        # the depth and normal cotangents of the pixels whose hit this is
        route = pending & has[:, None] & (e[14] == hid)
        ndr = e[10] * rx + e[11] * ry + e[12] * rz
        hz = e[15] / (ndr + 1e-8) * rz
        plane_ok = (torch.abs(hz - e[9]) <= e[13] * params.depth_threshold) & (
            torch.abs(ndr) >= params.normal_threshold)
        inv = 1.0 / (ndr + 1e-8)
        dd_plane = torch.where(route & plane_ok, d3, 0.0)
        dd_splat = torch.where(route, d3, 0.0) - dd_plane
        d_ndr = dd_plane * (-e[15] * inv * inv) * rz
        g_hit = [dd_splat,
                 d_ndr * rx + torch.where(route, dn[0], 0.0),
                 d_ndr * ry + torch.where(route, dn[1], 0.0),
                 d_ndr * rz + torch.where(route, dn[2], 0.0),
                 dd_plane * inv * rz]
        pending = pending & (~route)

        # the alpha terms
        active = has[:, None] & (T >= thr)
        if stats is not None:
            pairs += active.sum()
        dx = e[0] - px
        dy = e[1] - py
        ca, cb, cc = e[2], e[3], e[4]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        G = torch.exp(power)
        alpha_raw = torch.clamp(e[5] * G, max=ALPHA_MAX)
        skip = (power > 0.0) | (alpha_raw < ALPHA_MIN)
        alpha = torch.where(skip, 0.0, alpha_raw)
        one_m = 1.0 - alpha
        test_T = T * one_m
        contrib = active & (~skip) & (test_T >= thr)
        w = torch.where(contrib, alpha * T, 0.0)
        cd = e[6] * d0 + e[7] * d1 + e[8] * d2
        tfac = 1.0
        if bgp is not None:
            behind = (e[5] != 0.0) & (e[9] > D)
            tfac = torch.where(behind, torch.where(test_T * tau < thr, 0.0, tau),
                               1.0)
            w = w * tfac
            cross = active & behind & (~crossed)
            prefix = prefix + torch.where(cross, sdot * T_front, 0.0)
            crossed = crossed | cross
            T_front = torch.where(active & (~behind), T_front * one_m, T_front)
        prefix = prefix + w * cd
        suffix = dot_total - prefix
        dL = torch.where(contrib, cd * T * tfac - suffix / one_m
                         - end_T * bgdot / one_m, 0.0)
        gl = e[5] * dL * G
        g_alpha = [gl * (-(ca * dx + cb * dy)), gl * (-(cc * dy + cb * dx)),
                   gl * (-0.5 * dx * dx), gl * (-dx * dy),
                   gl * (-0.5 * dy * dy), G * dL,
                   w * d0, w * d1, w * d2]
        T = torch.where(active, test_T, T)

        g = torch.stack([torch.where(contrib, v, zero) for v in g_alpha]
                        + g_hit).sum(dim=2)                 # (14, tiles)
        dfeats[rows[:, None], idx[has][None, :]] = g[:, has]
    if stats is not None:
        stats["pairs"] = int(pairs)
    return dfeats


# ---------------------------------------------------------------------------
# layouts: image maps <-> the kernels' (num_tiles, n_px[, C]) tile rows
# ---------------------------------------------------------------------------

def tile_map(x: torch.Tensor, tile_size: int, width: int, height: int):
    """(H,W[,C]) -> (num_tiles, n_px[,C]) in the kernels' tile-row order,
    edge tiles zero-padded."""
    TH = (height + tile_size - 1) // tile_size
    TW = (width + tile_size - 1) // tile_size
    tail = tuple(x.shape[2:])
    pad = torch.zeros((TH * tile_size, TW * tile_size) + tail, dtype=x.dtype,
                      device=x.device)
    pad[:height, :width] = x
    x = pad.reshape((TH, tile_size, TW, tile_size) + tail).transpose(1, 2)
    return x.reshape((TH * TW, tile_size * tile_size) + tail)


def untile_map(x: torch.Tensor, tile_size: int, width: int, height: int):
    """(num_tiles, n_px[,C]) -> (H,W[,C]): the inverse of `tile_map`."""
    TH = (height + tile_size - 1) // tile_size
    TW = (width + tile_size - 1) // tile_size
    tail = x.shape[2:]
    x = x.reshape((TH, TW, tile_size, tile_size) + tail)
    x = x.transpose(1, 2).reshape((TH * tile_size, TW * tile_size) + tail)
    return x[:height, :width]


def pack_bg_tiled(S: torch.Tensor, D: torch.Tensor, tau: torch.Tensor):
    """The (num_tiles, n_px, 8) background operand from tiled maps S
    (T, n_px, 3), D and tau (T, n_px)."""
    return torch.cat([S, D[..., None], tau[..., None],
                      torch.zeros(D.shape + (NB - 5,), dtype=S.dtype,
                                  device=S.device)], dim=-1).contiguous()


def tile_px_maps(maps: list, tile_size: int, width: int, height: int):
    """(H,W[,C]) maps stacked into the (num_tiles, n_px, 8) layout,
    channel-padded to 8."""
    cat = torch.cat([m[..., None] if m.dim() == 2 else m for m in maps], -1)
    cat = torch.cat([cat, torch.zeros(cat.shape[:2] + (NB - cat.shape[-1],),
                                      dtype=cat.dtype, device=cat.device)], -1)
    return tile_map(cat, tile_size, width, height).contiguous()


def unpack_blocks(color, aux, nt, tile_size: int, width: int, height: int,
                  tiled: bool = False) -> dict:
    """The blocks as the rasterizer's maps: (H, W[, C]) or, `tiled`, the
    (num_tiles, n_px[, C]) tile rows."""
    if tiled:
        def lay(x):
            return x
    else:
        def lay(x):
            return untile_map(x, tile_size, width, height)

    return {
        "render": lay(color[:, :, 0:3]),
        "depth": lay(color[:, :, 3]),
        "normal_c": lay(color[:, :, 4:7]),
        "depth_index_map": torch.round(lay(aux[:, :, 0])).int(),
        "color_index_map": torch.round(lay(aux[:, :, 1])).int(),
        "color_hit_weight": lay(aux[:, :, 2]),
        "depth_hit_weight": lay(aux[:, :, 3]),
        "T_map": lay(aux[:, :, 4]),
        "weight_sum": lay(aux[:, :, 5]),
        "T_final": lay(aux[:, :, 6]),
        "n_touched_entries": nt,
    }


def blend_tiles_ref(feats: torch.Tensor, tile_offsets: torch.Tensor,
                    tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                    width: int, height: int, K: torch.Tensor,
                    params: BlendParams, bg, bgt=None, stats=None):
    """`blend_blocks_ref` as image maps."""
    return unpack_blocks(*blend_blocks_ref(
        feats, tile_offsets, tile_counts, num_tiles, tile_size, width, K,
        params, bg, bgt, stats), tile_size, width, height)
