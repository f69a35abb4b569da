"""The rasterizer's front door (counterpart of `dqo_map_tpu/ops/rasterize.py`):
EWA projection, tile binning, then the per-tile blend, returning the
reference's map set: color, depth, normal, colour / depth index maps, hit
weights, transmittance, n_touched.

The blend is the hand-written kernel for tensors on the card and its plain
version for tensors on the CPU (`blend_cuda.blend_tiles`). The entry list is
sized by the binning itself, so the receipts carry `dropped_entries` = 0;
`tile_dropped` and `clipped_cells` report the two caps that do change the
image.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import binning as binning_mod
from .blend import BlendParams
from .blend_cuda import blend_tiles, pack_entries
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


def blend_inputs(means3d: torch.Tensor, scales: torch.Tensor,
                 rots: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: dict, settings: RenderSettings,
                 tile_mask: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None):
    """Projection, tile binning and the entry pack: everything the blend
    reads. Returns (Preprocessed, Binning, feats (16, L))."""
    H, W = settings.height, settings.width
    pre = preprocess(means3d, scales, rots, cam, settings.color_sigma, W, H,
                     settings.scale_modifier)
    if valid_mask is not None:
        pre = pre._replace(valid=pre.valid & valid_mask,
                           radius=torch.where(valid_mask, pre.radius, 0.0))
    b = binning_mod.bin_gaussians(
        pre, W, H, settings.tile_size, settings.max_tiles_per_gaussian,
        tile_mask, align=settings.chunk,
        max_chunks=settings.max_chunks_per_tile)
    return pre, b, pack_entries(pre, b, colors, opacities)


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
              with_n_touched: bool = True) -> dict:
    """Render a view.

    means3d (P,3); scales (P,3) activated; rots (P,4) normalized wxyz;
    opacities (P,) activated; colors (P,3) RGB (`eval_colors` for SH);
    valid_mask (P,) excludes dead slots. Returns (H,W[,C]) maps, the
    per-gaussian n_touched (P,) and the binning receipts.
    """
    H, W = settings.height, settings.width
    pre, b, feats = blend_inputs(means3d, scales, rots, opacities, colors,
                                 cam, settings, tile_mask, valid_mask)
    TH, TW = binning_mod.tile_grid_size(W, H, settings.tile_size)
    out = blend_tiles(feats, b.tile_offsets, b.tile_counts, TH * TW,
                      settings.tile_size, W, H, cam["K"],
                      blend_params(settings), settings.bg)

    # n_touched per gaussian: a segment sum over the entries
    P = means3d.shape[0]
    nte = out.pop("n_touched_entries")
    n_touched = torch.zeros(P, dtype=torch.int32, device=means3d.device)
    if with_n_touched:
        n_touched.index_add_(0, b.point_list,
                             torch.where(b.entry_valid, nte, 0).int())
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
    from ..utils.sh import eval_sh
    dirs = means3d - cam_pos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return eval_sh(sh_degree, sh, dirs)
