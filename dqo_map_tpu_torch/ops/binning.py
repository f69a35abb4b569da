"""Tile binning: cell enumeration, exact conic cull, one sort, and the
CHUNK-aligned per-tile entry layout (counterpart of
`dqo_map_tpu/ops/binning.py`; the CUDA rasterizer's `duplicateWithKeys`,
radix sort and `identifyTileRanges`).

Every Gaussian enumerates up to R tile cells of its tight rect (a centred
R-window when the rect is larger; `clipped` counts the cells left out), and
each cell is tested exactly against the conic: a cell whose minimum
Mahalanobis quadratic exceeds ln 255 holds no pixel with alpha >= 1/255, so
dropping it changes no pixel. The kept cells sort on one int64 key, tile
then quantized depth, stably, so equal keys keep the enumeration order.

The entry list is sized from the binning's own count: each tile's entries
start at a multiple of `align` (the `tile_offsets`), its live entries are
the first `tile_counts` of them and the rest of its slots are padding, the
list is exactly `demand` long, and no entry is dropped for want of room
(`dropped` is 0).
The per-tile cap of `align * max_chunks` entries stays; what it cuts, the
farthest entries of the most crowded tiles, is `tile_dropped`.

`cell_entry` inverts the layout: the entry of each enumerated (cell,
Gaussian) pair, -1 where the cell was culled, cut or masked off. A
Gaussian's entries are the column of its row, so K4's backward sums each
Gaussian's entry gradients there, in cell order, with no sort and no
atomics (`csrc/project.cu`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import trace
from .projection import Preprocessed

DEPTH_BITS = 19
DEPTH_RANGE = 100.0   # zfar; 100 m / 2^19 = 0.2 mm ordering resolution
CULL_TAU = 5.5413     # ln(255): Q_min > tau  =>  alpha < 1/255 everywhere


class Binning(NamedTuple):
    point_list: torch.Tensor   # (L,) int64 gaussian index per slot
    entry_tile: torch.Tensor   # (L,) int64 tile id (T for padding slots)
    entry_valid: torch.Tensor  # (L,) bool
    tile_offsets: torch.Tensor  # (T+1,) int64 aligned starts into point_list
    tile_counts: torch.Tensor  # (T,) int64 live entries of each tile
    block_tile: torch.Tensor   # (L/align,) int64 tile per block (-1 unused)
    tile_order: torch.Tensor   # (T,) int64 tiles by live entries, most first
    cell_entry: torch.Tensor   # (R, P) int32 entry of cell j of gaussian g
    num_entries: int           # valid entries kept
    demand: int                # aligned layout size L (entries + padding)
    num_blocks: int            # align-sized blocks, L / align
    dropped: int               # entries lost for want of room: always 0
    tile_dropped: int          # entries cut by the per-tile chunk cap
    clipped: int               # upper bound of rect cells the R window cut


def tile_grid_size(width: int, height: int, tile_size: int):
    return (height + tile_size - 1) // tile_size, (width + tile_size - 1) // tile_size


def _cell_qmin(lx, ux, ly, uy, Ca, Cb, Cc):
    """Exact min of Q(d) = 0.5(Ca dx^2 + Cc dy^2) + Cb dx dy over the box
    [lx,ux] x [ly,uy]: 0 if the origin is inside, else on an edge, where Q
    is a 1-D quadratic with its minimizer clamped to the edge."""
    def q(dx, dy):
        return 0.5 * (Ca * dx * dx + Cc * dy * dy) + Cb * dx * dy

    inv_c = 1.0 / torch.where(Cc == 0, 1e-12, Cc)
    inv_a = 1.0 / torch.where(Ca == 0, 1e-12, Ca)

    def edge_x(X):
        return q(X, torch.clamp(-Cb * X * inv_c, ly, uy))

    def edge_y(Y):
        return q(torch.clamp(-Cb * Y * inv_a, lx, ux), Y)

    qmin = torch.minimum(torch.minimum(edge_x(lx), edge_x(ux)),
                         torch.minimum(edge_y(ly), edge_y(uy)))
    inside = (lx <= 0) & (ux >= 0) & (ly <= 0) & (uy >= 0)
    return torch.where(inside, 0.0, qmin)


def _depth_order_key(depth: torch.Tensor, fused: bool) -> torch.Tensor:
    """int64 depth key: 19-bit quantized depth where the tile id fits 12
    bits (the reference's fused key), else the order-preserving bits of the
    f32 depth."""
    if fused:
        dq = torch.clamp(depth * (1.0 / DEPTH_RANGE), 0.0, 1.0)
        return (dq * ((1 << DEPTH_BITS) - 1)).to(torch.int64)
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= (1 << 31)
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | (1 << 31))


def bin_gaussians(pre: Preprocessed, width: int, height: int, tile_size: int,
                  max_tiles_per_gaussian: int,
                  tile_mask: Optional[torch.Tensor] = None,
                  align: int = 256, max_chunks: int = 32) -> Binning:
    P = pre.xy.shape[0]
    R = max_tiles_per_gaussian
    if R >= 32:
        raise ValueError(f"max_tiles_per_gaussian must be < 32, got {R}")
    dev = pre.xy.device
    TH, TW = tile_grid_size(width, height, tile_size)
    num_tiles = TH * TW

    xy_T = pre.xy.detach().T
    ex, ey = pre.ext.detach().T[0], pre.ext.detach().T[1]
    conic = pre.conic.detach()
    depth = pre.depth.detach()

    # tight tile rect per gaussian; max bounds are exclusive, and the exact
    # exclusive bound of pixel floor(x + ex) is floor((x + ex)/ts) + 1
    i32 = torch.int32
    rect_min_x = torch.clamp(torch.floor((xy_T[0] - ex) / tile_size), 0, TW).to(i32)
    rect_min_y = torch.clamp(torch.floor((xy_T[1] - ey) / tile_size), 0, TH).to(i32)
    rect_max_x = torch.clamp(torch.floor((xy_T[0] + ex) / tile_size) + 1, 0, TW).to(i32)
    rect_max_y = torch.clamp(torch.floor((xy_T[1] + ey) / tile_size) + 1, 0, TH).to(i32)
    rw = torch.clamp(rect_max_x - rect_min_x, min=0)
    rh = torch.clamp(rect_max_y - rect_min_y, min=0)
    area = rw * rh
    gauss_valid = pre.valid & (area > 0) & (ex > 0)

    # over-R rects keep a centred sub-window of about R cells
    over = area > R
    s = torch.sqrt(R / torch.clamp(area.float(), min=1.0))
    rw2 = torch.clamp(torch.floor(rw.float() * s), min=1)
    rw2 = torch.minimum(rw2, rw.float()).to(i32)
    rh2 = torch.minimum(torch.clamp(R // torch.clamp(rw2, min=1), min=1),
                        torch.clamp(rh, min=1))
    rw2 = torch.minimum(torch.clamp(R // torch.clamp(rh2, min=1), min=1),
                        torch.clamp(rw, min=1))
    cx0 = torch.minimum(torch.maximum(torch.floor(xy_T[0] / tile_size).to(i32),
                                      rect_min_x), rect_max_x - 1)
    cy0 = torch.minimum(torch.maximum(torch.floor(xy_T[1] / tile_size).to(i32),
                                      rect_min_y), rect_max_y - 1)
    ox = torch.minimum(torch.maximum(cx0 - rw2 // 2, rect_min_x), rect_max_x - rw2)
    oy = torch.minimum(torch.maximum(cy0 - rh2 // 2, rect_min_y), rect_max_y - rh2)
    rw_e = torch.where(over, rw2, rw)
    rh_e = torch.where(over, rh2, rh)
    ox = torch.where(over, ox, rect_min_x)
    oy = torch.where(over, oy, rect_min_y)
    area_k = torch.where(gauss_valid, torch.clamp(rw_e * rh_e, max=R), 0)

    # dense (R, P) cell enumeration
    jj = torch.arange(R, dtype=i32, device=dev)[:, None].expand(R, P)
    rw_f = torch.clamp(rw_e, min=1).float()[None, :]
    ty = torch.floor(jj.float() / rw_f).to(i32)    # exact: jj < 32
    tx = jj - ty * rw_e[None, :]
    cellx = ox[None, :] + tx
    celly = oy[None, :] + ty
    enum_ok = jj < area_k[None, :]

    # exact per-cell cull: pixel centres of cell (cx,cy) span
    # [cx*ts, cx*ts + ts-1]
    lx = cellx.float() * tile_size - xy_T[0][None, :]
    ux = lx + (tile_size - 1)
    ly = celly.float() * tile_size - xy_T[1][None, :]
    uy = ly + (tile_size - 1)
    c_T = conic.T
    qmin = _cell_qmin(lx, ux, ly, uy, c_T[0][None, :], c_T[1][None, :],
                      c_T[2][None, :])
    keep = enum_ok & (qmin <= CULL_TAU)

    tile_id = (celly * TW + cellx).to(torch.int64)
    tile_key = torch.where(keep, tile_id, num_tiles)
    fused = num_tiles < (1 << 12)
    shift = DEPTH_BITS if fused else 32
    dkey = _depth_order_key(depth, fused)
    key = ((tile_key << shift) | dkey[None, :]).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    sorted_tile = sorted_key >> shift
    sorted_id = order % P

    # per-tile ranges in sort order, then the aligned layout
    offsets = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev), side="left")
    counts = offsets[1:] - offsets[:-1]
    kept_counts = torch.clamp(counts, max=align * max_chunks)
    if tile_mask is not None:
        masked_on = tile_mask.reshape(-1).bool()
        kept_counts = torch.where(masked_on, kept_counts, 0)
    padded = ((kept_counts + align - 1) // align) * align
    poffs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       torch.cumsum(padded, 0)])
    trunc = counts - kept_counts
    if tile_mask is not None:
        trunc = torch.where(masked_on, trunc, 0)
    clipped = torch.sum(torch.where(gauss_valid, torch.clamp(area - area_k, min=0), 0))
    # the one host read of the binning: the layout size and the receipts
    with trace.span("bin_gaussians/wait"):
        L, num_entries, tile_dropped, clipped = (
            int(x) for x in torch.stack([poffs[-1], kept_counts.sum(),
                                         trunc.sum(),
                                         clipped.to(torch.int64)]).tolist())

    tiles = torch.arange(num_tiles, device=dev)
    t_of_o = torch.repeat_interleave(tiles, padded, output_size=L)
    rank = torch.arange(L, device=dev) - poffs[t_of_o]
    valid = rank < kept_counts[t_of_o]
    src = torch.where(valid, offsets[t_of_o] + rank, 0)
    point_list = sorted_id[src]      # padding slots read sorted_id[0]
    # each live entry's enumerated cell (j, g) at j * P + g; padding slots
    # all land on one spare slot past the end
    cell = torch.where(valid, order[src], R * P)
    cell_entry = torch.full((R * P + 1,), -1, dtype=torch.int32, device=dev)
    cell_entry.scatter_(0, cell, torch.arange(L, dtype=torch.int32,
                                              device=dev))
    entry_tile = torch.where(valid, t_of_o, num_tiles)
    block_tile = torch.where(valid[::align], entry_tile[::align], -1)
    # the launch order of both blends (K1 and K2): a CTA walks a tile's
    # entries serially, so the crowded tiles start first
    tile_order = torch.argsort(kept_counts, descending=True, stable=True)
    return Binning(
        point_list=point_list, entry_tile=entry_tile, entry_valid=valid,
        tile_offsets=poffs, tile_counts=kept_counts, block_tile=block_tile,
        tile_order=tile_order, cell_entry=cell_entry[:R * P].view(R, P),
        num_entries=num_entries, demand=L, num_blocks=L // align,
        dropped=0, tile_dropped=tile_dropped, clipped=clipped,
    )
