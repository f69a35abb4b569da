"""Per-Gaussian error accumulation from per-pixel error maps (counterpart of
`dqo_map_tpu/ops/error_accum.py`, the reference's
`cuda_utils.accumulate_gaussian_error`): each pixel's colour error is
max- (or sum-) scattered onto its colour-hit Gaussian and its depth and
normal errors onto its depth-hit Gaussian, with per-Gaussian counters of
over-threshold pixels.
"""

from __future__ import annotations

import torch


def accumulate_gaussian_error(P: int, color_error: torch.Tensor,
                              depth_error: torch.Tensor,
                              normal_error: torch.Tensor,
                              color_index: torch.Tensor,
                              depth_index: torch.Tensor,
                              color_threshold: float, depth_threshold: float,
                              normal_threshold: float, check_max: bool = True):
    """Image args are (H,W); index maps hold global gaussian ids or -1.
    Returns (gs_color_error, gs_depth_error, gs_normal_error, counter),
    each (P,)."""
    ce = color_error.reshape(-1)
    de = depth_error.reshape(-1)
    ne = normal_error.reshape(-1)
    # -1 goes to an extra slot P that is dropped at the end
    ci = torch.where(color_index.reshape(-1) >= 0, color_index.reshape(-1), P).long()
    di = torch.where(depth_index.reshape(-1) >= 0, depth_index.reshape(-1), P).long()
    zeros = lambda: torch.zeros(P + 1, dtype=torch.float32, device=ce.device)  # noqa: E731
    reduce = "amax" if check_max else "sum"
    gs_color = zeros().scatter_reduce_(0, ci, ce, reduce)[:P]
    gs_depth = zeros().scatter_reduce_(0, di, de, reduce)[:P]
    gs_normal = zeros().scatter_reduce_(0, di, ne, reduce)[:P]
    counter = (zeros().index_add_(0, ci, (ce > color_threshold).float())
               + zeros().index_add_(0, di, (de > depth_threshold).float()
                                    + (ne > normal_threshold).float()))[:P]
    return gs_color, gs_depth, gs_normal, counter
