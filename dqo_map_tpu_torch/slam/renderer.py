"""Renderer facade over the rasterizer (counterpart of
`dqo_map_tpu/slam/renderer.py`): renders a MapState subset and returns the
reference's map dict.

Alive slots are packed below the `count` watermark, so a render takes the
prefix [0:count]; dead slots inside it are culled by the valid mask. Slot
ids in the index maps are therefore global. A render is differentiable in
the state's parameter tensors.

The colour passes (`render_color_pass`, `render_instance`,
`render_semantic`) blend per-Gaussian colours given in place of the SH
colours (`colors_precomp`) through the same rasterizer, so through K1,
with the map's geometry detached.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gaussian_map import STABLE, UNSTABLE, MapState
from ..ops.rasterize import (RenderSettings, compute_binning,
                             coverage_tile_mask, rasterize)


class Renderer:
    def __init__(self, args, width: int, height: int):
        self.settings = RenderSettings.from_args(width, height, args)

    def render(self, cam_inputs: dict, state: MapState, subset: str = "global",
               tile_mask: Optional[torch.Tensor] = None) -> dict:
        return render_state(state, cam_inputs, self.settings, subset, tile_mask)


def palette_color(ids: torch.Tensor) -> torch.Tensor:
    """(P,) int ids -> (P,3) RGB in [0.15, 1] by a multiplicative hash of
    the id's low 32 bits; an id < 0 is black."""
    h = ((ids.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    rgb = torch.stack([((h >> s) & 255).float() / 255.0 for s in (0, 8, 16)],
                      dim=-1) * 0.85 + 0.15
    return torch.where((ids >= 0)[:, None], rgb, 0.0)


def render_color_pass(state: MapState, cam_inputs: dict,
                      settings: RenderSettings,
                      colors: torch.Tensor) -> torch.Tensor:
    """The (H,W,3) blend of the per-Gaussian `colors` (capacity, 3) with the
    whole map's geometry, which these passes never train (detached)."""
    geometry = state.replace(**{f: getattr(state, f).detach() for f in (
        "xyz", "scaling", "rotation", "opacity")})
    return render_state(geometry, cam_inputs, settings,
                        colors_precomp=colors)["render"]


def render_instance(state: MapState, cam_inputs: dict,
                    settings: RenderSettings) -> torch.Tensor:
    """The object-instance image: each Gaussian's `obj_id` through the
    palette."""
    return render_color_pass(state, cam_inputs, settings,
                             palette_color(state.obj_id))


def render_semantic(state: MapState, cam_inputs: dict,
                    settings: RenderSettings,
                    categories: torch.Tensor) -> torch.Tensor:
    """The semantic image: obj_id -> category (`categories`, the object
    layer's (MAX_OBJECTS,) table) -> palette; Gaussians of no object are
    black."""
    n = categories.shape[0]
    oid = state.obj_id
    cat = torch.where((oid >= 0) & (oid < n),
                      categories[torch.clamp(oid, 0, n - 1).long()], -1)
    return render_color_pass(state, cam_inputs, settings, palette_color(cat))


def subset_mask(state: MapState, subset: str) -> torch.Tensor:
    if subset == "global":
        return state.status != 0
    if subset == "unstable":
        return state.status == UNSTABLE
    if subset == "stable":
        return state.status == STABLE
    raise ValueError(subset)


def state_leaves(state: MapState, subset: str = "global"):
    """Positions, log-scales and quaternions of the alive prefix [0:count]
    as stored (for `activate=True`), and the subset's mask over it."""
    B = state.count
    return (state.xyz[:B], state.scaling[:B], state.rotation[:B],
            subset_mask(state, subset)[:B])


def state_render_args(state: MapState, cam_inputs: dict,
                      settings: RenderSettings, subset: str = "global",
                      colors_precomp: Optional[torch.Tensor] = None) -> dict:
    """The rasterizer's per-gaussian inputs for a MapState subset, over the
    alive prefix [0:count], as stored (`activate=True`: the rasterizer
    applies exp, normalize and sigmoid); the colours as the SH, or
    `colors_precomp` (capacity, 3) where given."""
    B = state.count
    xyz, scaling, rotation, valid = state_leaves(state, subset)
    colors = (colors_precomp if colors_precomp is not None else state.sh)
    return dict(means3d=xyz, scales=scaling, rots=rotation,
                opacities=state.opacity[:B], colors=colors[:B],
                valid_mask=valid, activate=True)


def compute_binning_state(state: MapState, cam_inputs: dict,
                          settings: RenderSettings, subset: str = "global",
                          tile_mask: Optional[torch.Tensor] = None):
    """The tile binning of a MapState subset, for `render_state(...,
    binning=...)` at the same camera while the map's slots stay put."""
    xyz, scaling, rotation, valid = state_leaves(state, subset)
    return compute_binning(xyz, scaling, rotation, cam_inputs, settings,
                           tile_mask=tile_mask, valid_mask=valid,
                           activate=True)


def coverage_mask_state(state: MapState, cam_inputs: dict,
                        settings: RenderSettings, subset: str = "unstable"):
    """(TH, TW) tile mask of the tiles a MapState subset's projected rects
    cover (`coverage_tile_mask`)."""
    xyz, scaling, rotation, valid = state_leaves(state, subset)
    return coverage_tile_mask(xyz, scaling, rotation, cam_inputs, settings,
                              valid_mask=valid, activate=True)


def render_state(state: MapState, cam_inputs: dict, settings: RenderSettings,
                 subset: str = "global",
                 tile_mask: Optional[torch.Tensor] = None,
                 with_n_touched: bool = False, binning=None,
                 bg_tiled: Optional[torch.Tensor] = None,
                 tiled: bool = False,
                 colors_precomp: Optional[torch.Tensor] = None) -> dict:
    """Render a MapState subset. `n_touched` comes back at full capacity
    (zeros unless asked for). `binning`, `bg_tiled` and `tiled` are those
    of `rasterize`; `colors_precomp` (capacity, 3) replaces the SH
    colours."""
    out = rasterize(cam=cam_inputs, settings=settings, tile_mask=tile_mask,
                    with_n_touched=with_n_touched, binning=binning,
                    bg_tiled=bg_tiled, tiled=tiled,
                    **state_render_args(state, cam_inputs, settings, subset,
                                        colors_precomp))
    n_touched = torch.zeros(state.capacity, dtype=torch.int32,
                            device=state.device)
    n_touched[:state.count] = out["n_touched"]
    out["n_touched"] = n_touched
    return out
