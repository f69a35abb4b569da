"""Renderer facade over the rasterizer (counterpart of
`dqo_map_tpu/slam/renderer.py`): renders a MapState subset and returns the
reference's map dict.

Alive slots are packed below the `count` watermark, so a render takes the
prefix [0:count]; dead slots inside it are culled by the valid mask. Slot
ids in the index maps are therefore global.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gaussian_map import STABLE, UNSTABLE, MapState
from ..ops.rasterize import RenderSettings, eval_colors, rasterize
from ..utils.math3d import normalize


class Renderer:
    def __init__(self, args, width: int, height: int):
        self.settings = RenderSettings.from_args(width, height, args)

    def render(self, cam_inputs: dict, state: MapState, subset: str = "global",
               tile_mask: Optional[torch.Tensor] = None) -> dict:
        return render_state(state, cam_inputs, self.settings, subset, tile_mask)


def subset_mask(state: MapState, subset: str) -> torch.Tensor:
    if subset == "global":
        return state.status != 0
    if subset == "unstable":
        return state.status == UNSTABLE
    if subset == "stable":
        return state.status == STABLE
    raise ValueError(subset)


def state_render_args(state: MapState, cam_inputs: dict,
                      settings: RenderSettings, subset: str = "global") -> dict:
    """The rasterizer's per-gaussian inputs for a MapState subset, over the
    alive prefix [0:count]."""
    B = state.count
    xyz = state.xyz[:B]
    colors = eval_colors(state.sh[:B], xyz, cam_inputs["cam_pos"],
                         settings.sh_degree)
    return dict(means3d=xyz, scales=torch.exp(state.scaling[:B]),
                rots=normalize(state.rotation[:B]),
                opacities=torch.sigmoid(state.opacity[:B]), colors=colors,
                valid_mask=subset_mask(state, subset)[:B])


def render_state(state: MapState, cam_inputs: dict, settings: RenderSettings,
                 subset: str = "global",
                 tile_mask: Optional[torch.Tensor] = None,
                 with_n_touched: bool = False) -> dict:
    """Render a MapState subset. `n_touched` comes back at full capacity
    (zeros unless asked for)."""
    out = rasterize(cam=cam_inputs, settings=settings, tile_mask=tile_mask,
                    with_n_touched=with_n_touched,
                    **state_render_args(state, cam_inputs, settings, subset))
    n_touched = torch.zeros(state.capacity, dtype=torch.int32,
                            device=state.device)
    n_touched[:state.count] = out["n_touched"]
    out["n_touched"] = n_touched
    return out
