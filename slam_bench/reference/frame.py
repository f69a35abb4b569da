"""A frame's preprocessing for tracking, in plain PyTorch: a frozen copy
of the port's `slam/tracker.py::preprocess_frame` and `build_pyramids`
(depth validity, the optional bilateral filter, vertex, normal and
confidence maps, and the ICP pyramids).
"""

from __future__ import annotations

import torch

from . import image as im


def preprocess_frame(depth: torch.Tensor, color: torch.Tensor, K: torch.Tensor,
                     levels: int = 3, min_depth: float = 0.3,
                     max_depth: float = 5.0,
                     invalid_confidence_thresh: float = 0.2,
                     depth_filter: bool = False) -> dict:
    """depth (H,W) meters; color (H,W,3). Returns the frame map dict of
    camera-frame maps and pyramids; world-frame maps come after tracking."""
    if depth_filter:
        depth = im.bilateral_filter(depth, 5, 2.0, 2.0)[..., 0]
    valid = (depth > min_depth) & (depth < max_depth)
    depth = torch.where(valid, depth, 0.0)

    vertex_c = im.compute_vertex_map(depth, K)
    normal_c = im.compute_normal_map(vertex_c)
    confidence = im.compute_confidence_map(normal_c, K)

    invalid_conf = (torch.all(normal_c == 0, dim=-1)
                    | (confidence[..., 0] < invalid_confidence_thresh))
    depth = torch.where(invalid_conf, 0.0, depth)
    normal_c = torch.where(invalid_conf[..., None], 0.0, normal_c)
    vertex_c = torch.where(invalid_conf[..., None], 0.0, vertex_c)
    confidence = torch.where(invalid_conf[..., None], 0.0, confidence)

    vertex_pyr, normal_pyr = build_pyramids(depth, K, levels)
    return {
        "depth_map": depth,
        "color_map": color,
        "vertex_map_c": vertex_c,
        "normal_map_c": normal_c,
        "confidence_map": confidence,
        "invalid_confidence_mask": invalid_conf,
        "vertex_pyr": vertex_pyr,
        "normal_pyr": normal_pyr,
    }


def build_pyramids(depth: torch.Tensor, K: torch.Tensor, levels: int = 3):
    vp = tuple(im.build_vertex_pyramid(depth, K, levels))
    return vp, tuple(im.build_normal_pyramid(vp))
