"""Frozen copy of the port's `ops/rasterize.py`, part of the benchmark's plain
reference: it imports nothing of the port, and later changes to the
port do not reach it.

The original's docstring:

The rasterizer's front door (counterpart of `dqo_map_tpu/ops/rasterize.py`):
EWA projection, tile binning, then the per-tile blend, returning the
reference's map set: color, depth, normal, colour / depth index maps, hit
weights, transmittance, n_touched.

The blend is the hand-written kernels for tensors on the card and their
plain versions for tensors on the CPU (`blend_cuda.blend_tiles`), and is
differentiable in the Gaussians' parameters. The entry list is sized by the
binning itself, so the receipts carry `dropped_entries` = 0; `tile_dropped`
and `clipped_cells` report the two caps that do change the image.

The optimize scans bin each frame once (`compute_binning`) and blend every
iteration from the current parameters with that binning (`binning=`), with
the one-surface background (`bg_tiled=`) and in tile space (`tiled=`).
`coverage_tile_mask` and `gaussian_tile_overlap` are their sort-free tile
and row selectors: two products of 0/1 interval indicators.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import binning as binning_mod
from .blend import BlendParams
from .blend_fn import blend_tiles, pack_entries
from .projection import preprocess

CHUNK = 256          # entries per block and per-tile alignment


class RenderSettings(NamedTuple):
    width: int
    height: int
    opaque_threshold: float = 0.6
    depth_threshold: float = 1.0
    normal_threshold_cos: float = 0.5       # cos(60 deg)
    color_sigma: float = 3.0
    T_threshold: float = 1e-4
    tile_size: int = 16
    max_tiles_per_gaussian: int = 16
    max_chunks_per_tile: int = 32           # per-tile entry cap / CHUNK
    sh_degree: int = 3
    scale_modifier: float = 1.0
    bg: tuple = (0.0, 0.0, 0.0)
    chunk: int = CHUNK

    @staticmethod
    def from_args(width, height, args) -> "RenderSettings":
        return RenderSettings(
            width=width, height=height,
            opaque_threshold=args.renderer_opaque_threshold,
            depth_threshold=args.renderer_depth_threshold,
            normal_threshold_cos=float(
                math.cos(math.radians(args.renderer_normal_threshold))),
            color_sigma=args.color_sigma,
            T_threshold=args.T_threshold,
            tile_size=args.tile_size,
            max_tiles_per_gaussian=args.max_tiles_per_gaussian,
            max_chunks_per_tile=getattr(args, "max_chunks_per_tile", 32),
            sh_degree=args.active_sh_degree,
        )


def _preprocess(means3d, scales, rots, cam, settings: RenderSettings,
                valid_mask=None):
    pre = preprocess(means3d, scales, rots, cam, settings.color_sigma,
                     settings.width, settings.height, settings.scale_modifier)
    if valid_mask is not None:
        pre = pre._replace(valid=pre.valid & valid_mask,
                           radius=torch.where(valid_mask, pre.radius, 0.0))
    return pre


def _bin(pre, settings: RenderSettings, tile_mask=None):
    return binning_mod.bin_gaussians(
        pre, settings.width, settings.height, settings.tile_size,
        settings.max_tiles_per_gaussian, tile_mask, align=settings.chunk,
        max_chunks=settings.max_chunks_per_tile)


def blend_inputs(means3d: torch.Tensor, scales: torch.Tensor,
                 rots: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: dict, settings: RenderSettings,
                 tile_mask: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None, binning=None):
    """Projection, tile binning (unless a `binning` of the same camera is
    given) and the entry pack: everything the blend reads. Returns
    (Preprocessed, Binning, feats (16, L))."""
    pre = _preprocess(means3d, scales, rots, cam, settings, valid_mask)
    b = _bin(pre, settings, tile_mask) if binning is None else binning
    return pre, b, pack_entries(pre, b, colors, opacities)


def compute_binning(means3d: torch.Tensor, scales: torch.Tensor,
                    rots: torch.Tensor, cam: dict, settings: RenderSettings,
                    tile_mask: Optional[torch.Tensor] = None,
                    valid_mask: Optional[torch.Tensor] = None):
    """The tile binning alone, for reuse across the renders of one camera
    (every iteration of an optimize scan): the blend then evaluates alpha
    from the current parameters with the tile lists and depth order frozen
    here."""
    with torch.no_grad():
        pre = _preprocess(means3d, scales, rots, cam, settings, valid_mask)
        return _bin(pre, settings, tile_mask)


def _rect_indicators(pre, tile_size: int, TH: int, TW: int, valid):
    """(P, TW) and (P, TH) 0/1 indicators of each valid gaussian's tile
    rect (the binning's rect from the 3-sigma radius; max exclusive)."""
    xy = pre.xy.detach()
    radius = torch.where(valid, pre.radius.detach(), -1.0)
    ts = tile_size
    xmin = torch.floor((xy[:, 0] - radius) / ts)
    xmax = torch.floor((xy[:, 0] + radius + ts - 1) / ts)
    ymin = torch.floor((xy[:, 1] - radius) / ts)
    ymax = torch.floor((xy[:, 1] + radius + ts - 1) / ts)
    tx = torch.arange(TW, dtype=torch.float32, device=xy.device)
    ty = torch.arange(TH, dtype=torch.float32, device=xy.device)
    Ax = ((tx[None, :] >= xmin[:, None]) & (tx[None, :] < xmax[:, None])
          & (radius > 0)[:, None]).float()
    Ay = ((ty[None, :] >= ymin[:, None]) & (ty[None, :] < ymax[:, None])).float()
    return Ax, Ay


def coverage_tile_mask(means3d: torch.Tensor, scales: torch.Tensor,
                       rots: torch.Tensor, cam: dict, settings: RenderSettings,
                       valid_mask: Optional[torch.Tensor] = None):
    """(TH, TW) int32: tiles whose rect overlaps any valid gaussian's
    projected rect, the per-tile coverage count as one (TH, P) x (P, TW)
    product, with no sort."""
    TH, TW = binning_mod.tile_grid_size(settings.width, settings.height,
                                        settings.tile_size)
    with torch.no_grad():
        pre = _preprocess(means3d, scales, rots, cam, settings)
        valid = pre.valid if valid_mask is None else pre.valid & valid_mask
        Ax, Ay = _rect_indicators(pre, settings.tile_size, TH, TW, valid)
        return (Ay.T @ Ax > 0.5).int()


def gaussian_tile_overlap(pre, tile_mask: torch.Tensor, tile_size: int,
                          TH: int, TW: int) -> torch.Tensor:
    """(P,) bool: does each valid gaussian's rect overlap a masked-on tile?
    The transpose of `coverage_tile_mask`'s product."""
    Ax, Ay = _rect_indicators(pre, tile_size, TH, TW, pre.valid)
    Mx = tile_mask.float() @ Ax.T                             # (TH, P)
    return torch.sum(Ay * Mx.T, dim=1) > 0.5


def blend_params(settings: RenderSettings) -> BlendParams:
    return BlendParams(
        opaque_threshold=settings.opaque_threshold,
        depth_threshold=settings.depth_threshold,
        normal_threshold=settings.normal_threshold_cos,
        T_threshold=settings.T_threshold,
    )


def rasterize(means3d: torch.Tensor, scales: torch.Tensor, rots: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor, cam: dict,
              settings: RenderSettings,
              tile_mask: Optional[torch.Tensor] = None,
              valid_mask: Optional[torch.Tensor] = None,
              with_normal: bool = True,
              with_n_touched: bool = True,
              binning=None, bg_tiled: Optional[torch.Tensor] = None,
              tiled: bool = False) -> dict:
    """Render a view, differentiably in the five per-gaussian inputs.

    means3d (P,3); scales (P,3) activated; rots (P,4) normalized wxyz;
    opacities (P,) activated; colors (P,3) RGB (`eval_colors` for SH);
    valid_mask (P,) excludes dead slots. Returns (H,W[,C]) maps, the
    per-gaussian n_touched (P,) and the binning receipts.

    `binning` reuses a `compute_binning` of the same camera and gaussians;
    `bg_tiled` (num_tiles, 256, 8) is the one-surface background
    (`blend.pack_bg_tiled`); `tiled` returns the maps as the kernels'
    (num_tiles, 256[, C]) tile rows, edge tiles padded.
    """
    H, W = settings.height, settings.width
    pre, b, feats = blend_inputs(means3d, scales, rots, opacities, colors,
                                 cam, settings, tile_mask, valid_mask,
                                 binning)
    TH, TW = binning_mod.tile_grid_size(W, H, settings.tile_size)
    out = blend_tiles(feats, b.tile_offsets, b.tile_counts, TH * TW,
                      settings.tile_size, W, H, cam["K"],
                      blend_params(settings), settings.bg, bg_tiled, tiled,
                      tile_order=b.tile_order)

    # n_touched per gaussian: a segment sum over the entries
    P = means3d.shape[0]
    nte = out.pop("n_touched_entries")
    n_touched = torch.zeros(P, dtype=torch.int32, device=means3d.device)
    if with_n_touched:
        n_touched.index_add_(0, b.point_list,
                             torch.where(b.entry_valid, nte, 0).int().detach())
    out["n_touched"] = n_touched

    # normal map: the hit entry's camera-frame normal rotated to world,
    # n_w = R^T n_c with R = w2c[:3,:3]
    nc = out.pop("normal_c")
    if with_normal:
        R = cam["w2c"][:3, :3]
        n0, n1, n2 = nc[..., 0], nc[..., 1], nc[..., 2]
        out["normal"] = torch.stack([
            R[0, 0] * n0 + R[1, 0] * n1 + R[2, 0] * n2,
            R[0, 1] * n0 + R[1, 1] * n1 + R[2, 1] * n2,
            R[0, 2] * n0 + R[1, 2] * n1 + R[2, 2] * n2,
        ], dim=-1)
    else:
        out["normal"] = torch.zeros_like(nc)

    out["dropped_entries"] = b.dropped
    out["tile_dropped"] = b.tile_dropped
    out["entry_demand"] = b.demand
    out["clipped_cells"] = b.clipped
    out["num_entries"] = b.num_entries
    return out


def eval_colors(sh: torch.Tensor, means3d: torch.Tensor, cam_pos: torch.Tensor,
                sh_degree: int) -> torch.Tensor:
    """SH -> view-dependent RGB."""
    from .sh import eval_sh
    dirs = means3d - cam_pos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return eval_sh(sh_degree, sh, dirs)
