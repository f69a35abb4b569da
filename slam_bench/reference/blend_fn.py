"""The blend as a differentiable function of the entry features, in plain
PyTorch: the forward is the frozen `blend.blend_blocks_ref`, the backward
`blend.blend_bwd_ref` (the port's `ops/blend_cuda.py::BlendFunction` with
its CPU branch on every device). Under `precision.lowered` the features,
the output blocks, the cotangent and the gradient are rounded where they
pass between the two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blend import (BlendParams, blend_blocks_ref, blend_bwd_ref,
                    gather_entry_feats, unpack_blocks)
from .precision import rnd


def pack_entries(pre, b, colors, opacities) -> torch.Tensor:
    """Feature-major (16, L) entry features of a binning."""
    return gather_entry_feats(
        b.point_list, b.entry_valid, pre.xy, pre.conic, opacities, colors,
        pre.depth, pre.mean_c, pre.normal_c, pre.scale_max).contiguous()


class Geometry(NamedTuple):
    num_tiles: int
    tile_size: int
    width: int
    params: BlendParams
    bg: tuple


class BlendFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, tile_offsets, tile_counts, K, bgt, geom: Geometry):
        feats = rnd(feats)
        color, aux, nt = blend_blocks_ref(
            feats, tile_offsets, tile_counts, geom.num_tiles, geom.tile_size,
            geom.width, K, geom.params, geom.bg, bgt=rnd(bgt))
        color, aux = rnd(color), rnd(aux)
        ctx.save_for_backward(feats, tile_offsets, tile_counts, K, bgt, color,
                              aux)
        ctx.geom = geom
        ctx.mark_non_differentiable(aux, nt)
        return color, aux, nt

    @staticmethod
    def backward(ctx, dcolor, _daux, _dnt):
        feats, tile_offsets, tile_counts, K, bgt, color, aux = ctx.saved_tensors
        g = ctx.geom
        dfeats = blend_bwd_ref(feats, tile_offsets, tile_counts, g.num_tiles,
                               g.tile_size, g.width, K, g.params, g.bg, color,
                               aux, rnd(dcolor.contiguous()), bgt=rnd(bgt))
        return rnd(dfeats), None, None, None, None, None


def blend_tiles(feats: torch.Tensor, tile_offsets: torch.Tensor,
                tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                width: int, height: int, K: torch.Tensor, params: BlendParams,
                bg, bgt: Optional[torch.Tensor] = None, tiled: bool = False,
                tile_order: Optional[torch.Tensor] = None) -> dict:
    """The maps of `blend.unpack_blocks`; `tile_order` is a launch order
    and changes nothing here."""
    geom = Geometry(num_tiles, tile_size, width, params,
                    tuple(float(x) for x in bg))
    color, aux, nt = BlendFunction.apply(feats, tile_offsets, tile_counts, K,
                                         bgt, geom)
    return unpack_blocks(color, aux, nt, tile_size, width, height, tiled)
