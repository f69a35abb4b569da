"""Gaussian map lifecycle: add, optimize, promote, error-remove, delete
(counterpart of `dqo_map_tpu/slam/mapper.py`).

Densification samples new Gaussians where the model render is transparent
or wrong, drops those an unstable Gaussian already covers, lowers the
opacity of those that land on a stable surface, sets their scales from the
nearest neighbours and appends them. Promote / delete are status updates on
the fixed-capacity `MapState`.

The optimize scans run `gaussian_update_iter` masked Adam steps on every
`gaussian_update_frame`-th frame, each step a differentiable render (the
blend kernels K1 forward, K2 backward) of a frame drawn from the seeded
schedule, its loss and the update:

- the local scan (`local_optimize`) optimizes the unstable Gaussians over
  the memory frames: by default (`local_opt_mode="bg"`) compacted to those
  rows and blended in front of the frozen stable render, the one-surface
  background; with `"global"`, over the whole map's render. A confidence-
  weighted history merge (slerp for the rotations) follows;
- the keyframe scan (`global_optimization`) optimizes, on a keyframe, the
  stable Gaussians whose rects touch the tiles of largest colour error in
  the newest keyframes, at a tenth of the learning rate and with the
  positions fixed;
- the final whole-history pass (`global_optimization(is_end=True)`, at the
  end of `SLAMSystem.run`) promotes every unstable Gaussian, then runs
  `final_global_iter` Adam steps per keyframe over all keyframes, each
  whole (no tile mask), with SSIM in the loss and no depth term, on an
  unpinned schedule.

Every frame is binned once at scan entry and blended from the current
parameters with those tile lists. The compact scans compute their loss on
the kernels' tile rows, where the padded edge pixels are outside the
render mask: the same masked means as in image space. With
`gaussian_update_iter=0` no per-frame scan runs. `save_model` writes the
map as PLY files. `mapping` drives the object layer where the run has
one: in MODE=1 the box refinement on keyframes, in MODE=0 the render
refinement at the end of every frame with detections.

Where the frames carry a semantic image, every scan iteration also renders
the same geometry with the per-Gaussian `sem_rgb` in place of the SH
colours, with the colour render's binning, and adds its L1 against the
semantic image to the loss (the geometry keeps its gradient from this
pass); in the local scan it blends in front of a stable-subset semantic
background, one per memory frame and scan. Where they carry an instance
image, the loss also pulls the render's transmittance to 0 on its painted
pixels and to 1 elsewhere.

With a mesh (`Mapping.mesh`, installed by `SLAMSystem` under
`parallel_enabled`) the keyframe scan and the final pass run data-parallel
(`parallel/dp.py`). The mapper's work is in spans of the port's recorder
(`utils/trace.py`): densification and its KNN, the scans' preparation,
each Adam step's forward, backward and update, the history merge and the
host's waits on the card; its stage timers (`profile_enable`,
`stage_times`, switched on by `DQO_PROFILE`) time the mapper's, the
system's and the tracker's stages under the JAX package's tags.
"""

from __future__ import annotations

import math
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..models import gaussian_map as gm
from ..models.cameras import Camera
from ..models.gaussian_map import MapState
from ..ops import binning as binning_mod
from ..ops.blend import pack_bg_tiled, tile_map
from ..ops.error_accum import accumulate_gaussian_error
from ..ops.knn import knn2, scales_from_knn
from ..ops.projection import preprocess
from ..ops.rasterize import RenderSettings, gaussian_tile_overlap
from ..utils import image as im
from ..utils.host_copy import HostCopy
from ..utils.losses import ssim as ssim_fn
from ..utils.math3d import (normalize, quat_to_rotmat, rot_compare, slerp,
                            trans_compare)
from ..utils.monitor import ScalarLogger
from ..utils.ply import save_map_ply
from ..utils import trace
from ..utils.trace import profile_enable, stage_times  # noqa: F401
from .renderer import (Renderer, compute_binning_state, coverage_mask_state,
                       render_state, state_geometry)

# the optional supervision images of a scan's stacked frames
SEMANTIC_MAPS = ("semantics_color", "instance_img")
RECEIPTS = ("dropped_entries", "tile_dropped", "clipped_cells", "num_entries",
            "entry_demand")


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    denom = torch.clamp(m.sum() * (x.numel() / mask.numel()), min=1.0)
    return (x * m).sum() / denom


# ---------------------------------------------------------------------------
# masked Adam
# ---------------------------------------------------------------------------

OPT_FIELDS = ("xyz", "sh", "scaling", "rotation", "opacity", "sem_rgb")


class AdamState(NamedTuple):
    m: dict
    v: dict
    step: int


def adam_init(params: dict) -> AdamState:
    return AdamState(m={k: torch.zeros_like(v) for k, v in params.items()},
                     v={k: torch.zeros_like(v) for k, v in params.items()},
                     step=0)


def adam_update(params: dict, grads: dict, st: AdamState, lrs: dict,
                mask: torch.Tensor, b1=0.9, b2=0.999, eps=1e-15):
    """Adam with per-group learning rates and a row mask: a masked row's
    gradient is taken as 0 and its parameters do not move (its moments
    decay). Bias corrections in float32."""
    step = st.step + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        g = grads[k]
        mk = mask
        while mk.dim() < g.dim():
            mk = mk[..., None]
        g = torch.where(mk, g, 0.0)
        m = b1 * st.m[k] + (1 - b1) * g
        v = b2 * st.v[k] + (1 - b2) * g * g
        upd = lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k] = params[k] - torch.where(mk, upd, 0.0)
        new_m[k] = m
        new_v[k] = v
    return new_p, AdamState(m=new_m, v=new_v, step=step)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _is_zero(weights: dict, k: str) -> bool:
    w = weights.get(k, 0.0)
    return isinstance(w, (int, float)) and float(w) == 0.0


def compute_loss(render_out: dict, image_input: dict, params: dict,
                 init_stat: dict, opt_mask: torch.Tensor, weights: dict,
                 add_depth_thres: float, use_ssim: bool,
                 sem_render: Optional[torch.Tensor] = None):
    """The scans' loss: colour L1, depth L1 (valid depth, below the add
    threshold), normal cosine and SSIM terms, weighted; the semantic L1 of
    `sem_render` against `semantics_color` and the instance term (the
    render's T against 0 on the pixels `instance_img` paints, 1 elsewhere)
    where the inputs hold those images; plus the attach anchor that pins
    low-opacity Gaussians to their initial geometry. Terms whose weight is
    a Python zero are left out. Maps are image (H, W[, C]) or tile rows
    (T, 256[, C]); SSIM needs images. Returns (loss, report of the
    terms)."""
    render_mask = image_input["render_mask"]
    image = render_out["render"]
    depth_index = render_out["depth_index_map"]
    color_loss = masked_mean(torch.abs(image - image_input["color_map"]),
                             render_mask)
    depth_loss = 0.0
    if not _is_zero(weights, "depth"):
        depth_error = render_out["depth"] - image_input["depth_map"]
        valid_depth = ((depth_index != -1) & (image_input["depth_map"] > 0)
                       & (depth_error < add_depth_thres) & render_mask)
        depth_loss = masked_mean(torch.abs(depth_error), valid_depth)
    normal_loss = 0.0
    if not _is_zero(weights, "normal"):
        normal, gt_normal = render_out["normal"], image_input["normal_map"]
        cos_dist = 1.0 - torch.sum(normal * gt_normal, dim=-1) / (
            torch.linalg.norm(normal, dim=-1)
            * torch.linalg.norm(gt_normal, dim=-1) + 1e-8)
        valid_normal = (render_mask & (depth_index != -1)
                        & (~torch.all(gt_normal == 0, dim=-1)))
        normal_loss = masked_mean(cos_dist, valid_normal)
    ssim_loss = 0.0
    if use_ssim:
        ssim_loss = 1.0 - ssim_fn(image.permute(2, 0, 1),
                                  image_input["color_map"].permute(2, 0, 1))
    total = (weights["depth"] * depth_loss + weights["normal"] * normal_loss
             + weights["color"] * color_loss + weights["ssim"] * ssim_loss)

    semantic_loss = 0.0
    if sem_render is not None and "semantics_color" in image_input:
        semantic_loss = masked_mean(
            torch.abs(sem_render - image_input["semantics_color"]), render_mask)
        total = total + weights.get("semantic", 0.1) * semantic_loss
    instance_loss = 0.0
    if "instance_img" in image_input:
        inst_gt = torch.where(
            torch.sum(image_input["instance_img"], dim=-1) > 0, 0.0, 1.0)
        instance_loss = masked_mean(torch.abs(render_out["T_map"] - inst_gt),
                                    render_mask)
        total = total + weights.get("instance", 0.8) * instance_loss

    attach_mask = (torch.sigmoid(init_stat["opacity"]) < 0.9) & opt_mask
    attach = 1000.0 * (
        masked_mean((params["scaling"] - init_stat["scaling"]) ** 2, attach_mask)
        + masked_mean((params["xyz"] - init_stat["xyz"]) ** 2, attach_mask)
        + masked_mean((params["rotation"] - init_stat["rotation"]) ** 2,
                      attach_mask))
    report = {"total_loss": total, "color_loss": color_loss,
              "depth_loss": depth_loss, "normal_loss": normal_loss,
              "ssim_loss": ssim_loss, "scale_loss": attach,
              "semantic_loss": semantic_loss, "instance_loss": instance_loss}
    return total + attach, report


# ---------------------------------------------------------------------------
# the optimize scans
# ---------------------------------------------------------------------------

def _frame_cam(frames: dict, f: int) -> dict:
    return {"w2c": frames["w2c"][f], "full_proj": frames["full_proj"][f],
            "cam_pos": frames["cam_pos"][f], "K": frames["K"],
            "tan_fovx": frames["tan_fovx"], "tan_fovy": frames["tan_fovy"]}


def _substate(state: MapState, rows, status=None) -> MapState:
    """The given rows (a slice or an index tensor) as a map of their own."""
    sub = {f: getattr(state, f)[rows] for f in gm.FIELDS}
    if status is not None:
        sub["status"] = torch.full_like(sub["status"], status)
    return MapState(**sub, count=sub["xyz"].shape[0])


def _grads(sub: MapState, params: dict, loss_of):
    """The report of `loss_of(state, p)` -> (loss, report) at `params`, the
    state being `sub` with its `OPT_FIELDS` the leaves `p`, and the loss's
    gradients in those fields (0 where none reaches)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with trace.span("scans/step/forward"):
        loss, report = loss_of(sub.replace(**p), p)
    with trace.span("scans/step/backward"):
        grads = torch.autograd.grad(loss, [p[k] for k in OPT_FIELDS],
                                    allow_unused=True)
    return report, {k: torch.zeros_like(p[k]) if g is None else g
                    for k, g in zip(OPT_FIELDS, grads)}


def _adam_scan(sub: MapState, iters: int, lrs: dict, opt_mask,
               value_and_grad):
    """`iters` masked Adam steps on the parameters of `sub`; step `it`
    takes `value_and_grad(params, it)` -> (report, gradients). Confidence
    grows by one on the rows of `opt_mask` whose SH DC gradient is not
    exactly 0. Returns (params, confidence, reports of (iters,) curves)."""
    params = {k: getattr(sub, k) for k in OPT_FIELDS}
    opt_state = adam_init(params)
    confidence = sub.confidence
    reports = []
    for it in range(iters):
        with trace.span("scans/step"):
            report, grads = value_and_grad(params, it)
            with trace.span("scans/step/adam"), torch.no_grad():
                params, opt_state = adam_update(params, grads, opt_state,
                                                lrs, opt_mask)
                grad_mask = torch.any(grads["sh"][:, 0, :] != 0, dim=-1)
                confidence = confidence + (grad_mask & opt_mask).float()
            reports.append({k: v.detach() if torch.is_tensor(v) else
                            torch.full((), float(v), device=confidence.device)
                            for k, v in report.items()})
    curves = {k: torch.stack([r[k] for r in reports]) for k in reports[0]} \
        if reports else {}
    return params, confidence, curves


def _receipts(reports: dict, binnings: list, iters: int):
    for k, field in (("tile_dropped", "tile_dropped"),
                     ("clipped_cells", "clipped"),
                     ("num_entries", "num_entries"),
                     ("entry_demand", "demand")):
        reports[k] = max((getattr(b, field) for b in binnings), default=0)
    reports["iters"] = iters
    return reports


def optimize_scan(state: MapState, frames: dict, rand_idx, lrs: dict,
                  weights, settings: RenderSettings, iters: int,
                  status_value: int, add_depth_thres: float,
                  use_ssim: bool = False, with_tile_mask: bool = True,
                  subset: str = "global"):
    """`iters` Adam steps over the Gaussians with status `status_value`,
    each on a render of `subset` at frame `rand_idx[it]`, in image space.

    frames: stacked tensors: color (F,H,W,3), depth (F,H,W), normal
    (F,H,W,3), render_mask (F,H,W), tile_mask (F,TH,TW), w2c and full_proj
    (F,4,4), cam_pos (F,3); K (3,3), tan_fovx / tan_fovy; optionally
    semantics_color and instance_img (F,H,W,3), which add the semantic
    pass and the instance term (`compute_loss`). rand_idx:
    (iters,) frame choices (`Mapping._rand_schedule`). `use_ssim` adds the
    SSIM term to the loss; with `with_tile_mask=False` every frame is
    binned and rendered whole, its tile mask unused. Returns (state, report
    of (iters,) loss curves and the binning receipts)."""
    B = state.count
    sub = _substate(state, slice(0, B))
    opt_mask = sub.status == status_value
    loss_of, binnings = image_loss(sub, frames, settings, subset,
                                   with_tile_mask, opt_mask, weights,
                                   add_depth_thres, use_ssim)
    params, confidence, reports = _adam_scan(
        sub, iters, lrs, opt_mask, lambda params, it: _grads(
            sub, params, lambda st, p: loss_of(st, int(rand_idx[it]), p)))
    with_sem = "semantics_color" in frames
    reports = _receipts(reports, binnings, iters)
    reports["sem_iters"] = iters if with_sem else 0
    reports["blends"] = iters * (2 if with_sem else 1)
    return scattered(state, params, confidence), reports


def scattered(state: MapState, params: dict, confidence) -> MapState:
    """`state` with its first rows' `OPT_FIELDS` and confidence replaced by
    `params` and `confidence`."""
    B = confidence.shape[0]
    new = {k: torch.cat([params[k], getattr(state, k)[B:]])
           for k in OPT_FIELDS}
    new["confidence"] = torch.cat([confidence, state.confidence[B:]])
    return state.replace(**new)


def image_loss(sub: MapState, frames: dict, settings: RenderSettings,
               subset: str, with_tile_mask: bool, opt_mask, weights,
               add_depth_thres: float, use_ssim: bool):
    """The loss of the image-space scans: (`loss_of(state, f, p)` ->
    (loss, report), the binnings). Each stacked frame is binned once, from
    `sub`; `loss_of` renders `subset` of `state` (whose `OPT_FIELDS` are the
    leaves `p`) at frame f with its binning, with the semantic pass where
    the frames carry `semantics_color`, and takes `compute_loss` against
    frame f, the attach term anchored at `sub`."""
    weights = dict(weights)
    init_stat = {k: getattr(sub, k) for k in ("opacity", "scaling", "xyz",
                                              "rotation")}
    n_frames = frames["w2c"].shape[0]
    tms = (frames["tile_mask"] if with_tile_mask
           else [None] * n_frames)
    binnings = [compute_binning_state(sub, _frame_cam(frames, f), settings,
                                      subset, tms[f]) for f in range(n_frames)]

    def loss_of(st, f, p):
        cam = _frame_cam(frames, f)
        out = render_state(st, cam, settings, subset, tms[f],
                           binning=binnings[f])
        image_input = {"color_map": frames["color"][f],
                       "depth_map": frames["depth"][f],
                       "normal_map": frames["normal"][f],
                       "render_mask": frames["render_mask"][f]}
        for k in SEMANTIC_MAPS:
            if k in frames:
                image_input[k] = frames[k][f]
        sem = None
        if "semantics_color" in frames:
            # the semantic pass: the same geometry, with its gradient
            sem = render_state(st, cam, settings, subset, tms[f],
                               binning=binnings[f],
                               colors_precomp=p["sem_rgb"])["render"]
        return compute_loss(out, image_input, p, init_stat, opt_mask, weights,
                            add_depth_thres, use_ssim, sem_render=sem)

    return loss_of, binnings


def compact_optimize_scan(state: MapState, row_mask: torch.Tensor,
                          frames: dict, rand_idx, lrs: dict, weights,
                          settings: RenderSettings,
                          usettings: RenderSettings, iters: int,
                          add_depth_thres: float, use_bg: bool = True,
                          scope: str = "scans/local"):
    """`iters` Adam steps over the rows of `row_mask` alone, gathered once
    into a map of their own, rendered with `usettings` in tile space, and
    scattered back.

    - `use_bg=True` (the local scan, rows = unstable): each frame's stable
      render (with `settings`) is packed once into the one-surface
      background operand, and every iteration blends the rows in front of
      and behind it in depth order (K1 / K2's background variant); the hit
      maps compose by depth, the nearer hit winning.
    - `use_bg=False` (the keyframe scan, rows = stable rows that touch a
      masked tile): the rows render alone, exactly as the whole stable set
      would inside the masked tiles.

    With `semantics_color` in `frames`, every iteration also renders the
    semantic pass with the same binning, in front of the stable subset's
    semantic render where `use_bg` (one a frame and scan, every tile,
    packed with the colour background's depth and T).

    `scope` is the caller's scan span; the preparation is its `/prepare`.

    Returns (state, report of (iters,) loss curves, the binning receipts
    and the number of background and semantic background renders). Its
    loss is in tile space, so it has no SSIM term."""
    weights = dict(weights)
    with trace.span(scope + "/prepare"):
        with trace.span(scope + "/prepare/gather/wait"):
            uidx = torch.nonzero(row_mask)[:, 0]
        sub = _substate(state, uidx, gm.UNSTABLE)
        valid_u = torch.ones(sub.count, dtype=torch.bool, device=state.device)
        init_stat = {k: getattr(sub, k) for k in ("opacity", "scaling", "xyz",
                                                  "rotation")}
        n_frames = frames["w2c"].shape[0]
        ts, W, H = settings.tile_size, settings.width, settings.height
        with_semantics = "semantics_color" in frames
        gt = []
        for f in range(n_frames):
            g = {"color_map": tile_map(frames["color"][f], ts, W, H),
                 "depth_map": tile_map(frames["depth"][f], ts, W, H),
                 "normal_map": tile_map(frames["normal"][f], ts, W, H),
                 "render_mask": tile_map(frames["render_mask"][f], ts, W, H)}
            for k in SEMANTIC_MAPS:
                if k in frames:
                    g[k] = tile_map(frames[k][f], ts, W, H)
            gt.append(g)
        bgs, bgts, bgts_sem = [], [], []
        if use_bg:
            with torch.no_grad():
                for f in range(n_frames):
                    cam = _frame_cam(frames, f)
                    bg = render_state(state, cam, settings, "stable",
                                      frames["tile_mask"][f], tiled=True)
                    bgs.append({k: bg[k] for k in (
                        "render", "depth", "normal", "depth_index_map",
                        "T_map")})
                    bg_depth = torch.where(bg["depth_index_map"] >= 0,
                                           bg["depth"], 1e30)
                    bgts.append(pack_bg_tiled(bg["render"], bg_depth,
                                              bg["T_final"]))
                    if with_semantics:
                        # the stable subset's semantic render, every tile,
                        # packed with the colour background's depth and T
                        sem_bg = render_state(state, cam, settings, "stable",
                                              colors_precomp=state.sem_rgb,
                                              tiled=True)["render"]
                        bgts_sem.append(pack_bg_tiled(sem_bg, bg_depth,
                                                      bg["T_final"]))
        binnings = [compute_binning_state(sub, _frame_cam(frames, f),
                                          usettings, "global",
                                          frames["tile_mask"][f])
                    for f in range(n_frames)]

    def loss_of(st, f, p):
        cam = _frame_cam(frames, f)
        u = render_state(st, cam, usettings, "global", binning=binnings[f],
                         bg_tiled=bgts[f] if use_bg else None, tiled=True)
        out = u
        if use_bg:
            bg = bgs[f]
            hit_u = u["depth_index_map"] >= 0
            hit_bg = bg["depth_index_map"] >= 0
            u_wins = hit_u & ((~hit_bg) | (u["depth"] <= bg["depth"]))
            out = {"render": u["render"],
                   "depth": torch.where(u_wins, u["depth"], bg["depth"]),
                   "normal": torch.where(u_wins[..., None], u["normal"],
                                         bg["normal"]),
                   "depth_index_map": torch.where(u_wins, u["depth_index_map"],
                                                  bg["depth_index_map"]),
                   "T_map": u["T_map"] * bg["T_map"]}
        sem = None
        if with_semantics:
            sem = render_state(st, cam, usettings, "global",
                               colors_precomp=p["sem_rgb"],
                               binning=binnings[f],
                               bg_tiled=bgts_sem[f] if use_bg else None,
                               tiled=True)["render"]
        return compute_loss(out, gt[f], p, init_stat, valid_u, weights,
                            add_depth_thres, False, sem_render=sem)

    if sub.count == 0:
        reports = {}
    else:
        params, confidence, reports = _adam_scan(
            sub, iters, lrs, valid_u, lambda params, it: _grads(
                sub, params, lambda st, p: loss_of(st, int(rand_idx[it]), p)))
        new = {}
        for k in OPT_FIELDS:
            new[k] = getattr(state, k).clone()
            new[k][uidx] = params[k]
        new["confidence"] = state.confidence.clone()
        new["confidence"][uidx] = confidence
        state = state.replace(**new)
    reports = _receipts(reports, binnings, iters if sub.count else 0)
    reports["bg_renders"] = len(bgts)
    reports["sem_bg_renders"] = len(bgts_sem)
    reports["sem_iters"] = reports["iters"] if with_semantics else 0
    reports["blends"] = reports["iters"] * (2 if with_semantics else 1)
    return state, reports


def touched_rows(state: MapState, frames: dict, settings: RenderSettings,
                 status_value: int) -> torch.Tensor:
    """(capacity,) bool: the rows of status `status_value` whose projected
    rect overlaps a masked-on tile in any of the stacked frames (the
    keyframe scan's row selector)."""
    B = state.count
    TH, TW = binning_mod.tile_grid_size(settings.width, settings.height,
                                        settings.tile_size)
    xyz, sc, ro, _ = state_geometry(state)
    hit = torch.zeros(B, dtype=torch.bool, device=state.device)
    with torch.no_grad():
        for f in range(frames["w2c"].shape[0]):
            pre = preprocess(xyz, sc, ro, _frame_cam(frames, f),
                             settings.color_sigma, settings.width,
                             settings.height, settings.scale_modifier)
            hit = hit | gaussian_tile_overlap(pre, frames["tile_mask"][f],
                                              settings.tile_size, TH, TW)
    hit = hit & (state.status[:B] == status_value)
    return torch.cat([hit, torch.zeros(state.capacity - B, dtype=torch.bool,
                                       device=state.device)])


def history_merge(state: MapState, history: dict, confidence_pre: torch.Tensor,
                  opt_mask: torch.Tensor, max_weight: float = 0.5) -> MapState:
    """Pull the optimized rows back towards their values before the scan,
    by w = clip(max_weight * confidence before / confidence after): a lerp
    for positions, SH and log-scales, a slerp for the rotations (which it
    leaves normalized)."""
    w = torch.clamp(max_weight * confidence_pre / (state.confidence + 1e-6),
                    0.0, 1.0)[:, None]
    m = opt_mask[:, None]
    xyz = torch.where(m, history["xyz"] * w + (1 - w) * state.xyz, state.xyz)
    sh = torch.where(m[..., None], history["sh"] * w[..., None]
                     + (1 - w[..., None]) * state.sh, state.sh)
    scaling = torch.where(m, history["scaling"] * w + (1 - w) * state.scaling,
                          state.scaling)
    rot = slerp(history["rotation_act"], normalize(state.rotation), 1 - w)
    rotation = torch.where(m, rot, state.rotation)
    return state.replace(xyz=xyz, sh=sh, scaling=scaling, rotation=rotation)


def render_range_step(state: MapState, cam: dict, settings: RenderSettings,
                      global_opt: bool, sample_ratio: float,
                      gt_color: Optional[torch.Tensor], tile_size: int = 16):
    """The render and tile masks of a scan frame: for the keyframe scan
    (`global_opt`, `sample_ratio` > 0) the `sample_ratio` of the tiles with
    the largest colour error of the stable render; else the tiles more than
    half covered by the unstable render. Returns (render_mask (H,W) bool,
    tile_mask (TH,TW) int32)."""
    subset = "stable" if global_opt else "unstable"
    with torch.no_grad():
        out = render_state(state, cam, settings, subset)
    T_map = out["T_map"]
    if global_opt and sample_ratio > 0:
        image_diff = torch.abs(out["render"] - gt_color).sum(dim=-1)
        image_diff = torch.where(out["render"].sum(dim=-1) == 0, 0.0,
                                 image_diff)
        with trace.span("scans/keyframe/prepare/tiles/wait"):
            tile_mask = im.colorerror_to_tilemask(image_diff, tile_size,
                                                  sample_ratio)
        render_mask = im.tilemask_to_pixelmask(tile_mask, tile_size,
                                               *T_map.shape)
    else:
        render_mask = T_map != 1
        tile_mask = im.transmission_to_tilemask(render_mask, tile_size, 0.5)
    return render_mask, tile_mask


def _normals_of(rotation: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """World normals of the given rows: the rotation column of the
    min-scale axis."""
    R = quat_to_rotmat(rotation)
    idx = torch.argmin(scaling, dim=-1)
    return normalize(torch.take_along_dim(R, idx[:, None, None], dim=2)[..., 0])


# ---------------------------------------------------------------------------
# densification
# ---------------------------------------------------------------------------

def densify_step(state: MapState, frame_map: dict, cam: dict, model_map: dict,
                 is_first: bool, draws, time: int, frame_id: int,
                 max_add: int, cfg: tuple):
    """Sample new gaussians, filter them against the map, attach them to
    stable surfaces, set their scales by KNN, and append them.

    draws: two (H*W,) uniform tensors, one per sampling class.
    cfg: (uniform_sample_num, add_transmission_thres,
          transmission_sample_ratio, add_depth_thres, add_color_thres,
          error_sample_ratio, init_opacity, xyz_factor x3, scale_factor,
          min_radius, max_radius).
    On the first frame `model_map` is an all-transparent render and the
    sample budget is the full `uniform_sample_num`.
    Returns (state, number of points added).
    """
    (uniform_sample_num, add_transmission_thres, transmission_sample_ratio,
     add_depth_thres, add_color_thres, error_sample_ratio, init_opacity,
     xf0, xf1, xf2, scale_factor, min_radius, max_radius) = cfg
    depth = frame_map["depth_map"]
    H, W = depth.shape
    depth_ok = depth > 0
    # transmission mask: newly revealed surface
    trans_mask = (model_map["T_map"] > add_transmission_thres) & depth_ok
    trans_ratio = trans_mask.sum() / (H * W)
    want_a = (uniform_sample_num if is_first else
              (transmission_sample_ratio * trans_ratio
               * uniform_sample_num).to(torch.int32))
    # depth / colour error mask
    depth_err = torch.abs(depth - model_map["depth"])
    color_err = torch.abs(frame_map["color_map"] - model_map["render"]).mean(dim=-1)
    depth_sample = ((depth_err > add_depth_thres) & depth_ok
                    & (model_map["depth_index_map"] > -1))
    color_sample = ((color_err > add_color_thres) & depth_ok
                    & (model_map["T_map"] < add_transmission_thres))
    mask_b = (depth_sample | color_sample) & (~trans_mask)
    want_b = (mask_b.sum() * error_sample_ratio).to(torch.int32)

    # normals must be valid
    nvalid = torch.sum(frame_map["normal_map_w"], dim=-1) != 0
    half = max_add // 2
    idx_a, val_a = im.sample_pixels(draws[0], trans_mask & nvalid, half, want_a)
    idx_b, val_b = im.sample_pixels(draws[1], mask_b & nvalid, half, want_b)
    idx = torch.cat([idx_a, idx_b])
    valid = torch.cat([val_a, val_b])

    # with the object layer, each point takes the object index of its pixel
    oid = (frame_map["obj_id_map"].reshape(-1)[idx]
           if "obj_id_map" in frame_map else None)
    # with a semantic image, each point takes its pixel's semantic colour
    sem = (frame_map["semantics"].reshape(-1, 3)[idx]
           if frame_map.get("semantics") is not None else None)
    new = gm.make_new_points(
        frame_map["vertex_map_w"].reshape(-1, 3)[idx],
        frame_map["normal_map_w"].reshape(-1, 3)[idx],
        frame_map["color_map"].reshape(-1, 3)[idx], valid, time, frame_id,
        init_opacity, (xf0, xf1, xf2), obj_id=oid, sem_rgb=sem)

    # coverage filter: drop points an unstable gaussian already covers (one
    # of its 3 nearest unstable neighbours within 0.6 x its radius). This
    # search and the scale-init search share one distance pass.
    B = state.count
    M = new["xyz"].shape[0]
    dev = state.device
    scales_b = torch.exp(state.scaling[:B])
    exist_rad = (torch.sum(scales_b, dim=1) - torch.amin(scales_b, dim=1)) / 2
    cand_xyz = torch.cat([new["xyz"], state.xyz[:B]])
    cand_rad = torch.cat([torch.full((M,), 1e-6, device=dev), exist_rad])
    mask_unst = torch.cat([torch.zeros(M, dtype=torch.bool, device=dev),
                           state.status[:B] == gm.UNSTABLE])
    mask_all = torch.cat([new["valid"], state.status[:B] != gm.DEAD])
    with trace.span("mapping/add/densify/knn", staged=True):
        (d2u, iu), (d2a, ia) = knn2(new["xyz"], cand_xyz, mask_unst, mask_all,
                                    k=8)
    nn_rad = cand_rad[iu[:, :3]] * 0.6
    covered = (torch.any(torch.sqrt(d2u[:, :3]) < nn_rad, dim=-1)
               & (state.num_unstable() > 0))
    new["valid"] = new["valid"] & (~covered)

    # attach: points landing on a stable surface (the model render's colour
    # hit is a stable gaussian within half the depth threshold of the
    # point's plane) get a low opacity
    uv_h = im.transform_map(new["xyz"], cam["w2c"])
    zs = torch.where(uv_h[:, 2] == 0, 1e-8, uv_h[:, 2])
    uu = uv_h[:, 0] / zs
    vv = uv_h[:, 1] / zs
    K = cam["K"]
    px = (uu * K[0, 0] + K[0, 2]).to(torch.int32)
    py = (vv * K[1, 1] + K[1, 2]).to(torch.int32)
    inview = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    sidx = model_map["color_index_map"][torch.clamp(py, 0, H - 1).long(),
                                        torch.clamp(px, 0, W - 1).long()]
    sid = torch.clamp(sidx, min=0).long()
    on_stable = inview & (sidx >= 0) & (state.status[sid] == gm.STABLE)
    p2p = torch.sum((state.xyz[sid] - new["xyz"])
                    * _normals_of(state.rotation[sid], state.scaling[sid]), dim=-1)
    attach = on_stable & (torch.abs(p2p) < 0.5 * add_depth_thres) & (
        state.num_stable() > 0)
    new["opacity"] = torch.where(attach, math.log(0.1 / 0.9), new["opacity"])

    # scale init from the same search; coverage-dropped points are no
    # neighbours (they are not added)
    cand_excluded = torch.cat([covered, torch.zeros(B, dtype=torch.bool, device=dev)])
    new["scaling"], new["valid"] = scales_from_knn(
        d2a, ia, new["valid"], cand_rad, cand_excluded,
        scale_factor, (xf0, xf1, xf2), min_radius, max_radius)
    with trace.span("mapping/add/densify/wait"):
        n_added = int(new["valid"].sum())
    return gm.add_points(state, new), n_added


# ---------------------------------------------------------------------------
# pruning / promotion
# ---------------------------------------------------------------------------

def gaussians_fix(state: MapState, stable_confidence_thres: float) -> MapState:
    return gm.promote_points(state, state.confidence > stable_confidence_thres,
                             stable_confidence_thres)


def gaussians_delete(state: MapState, time: int, unstable_time_window: int,
                     unstable: bool = True) -> MapState:
    """Delete the gaussians of the pool whose radius exceeds ten times the
    pool's mean and, for the unstable pool, those older than the window."""
    radius = state.get_radius()
    pool = state.unstable_mask() if unstable else state.stable_mask()
    big = (radius > masked_mean(radius, pool) * 10) & pool
    if unstable:
        old = ((time - state.add_tick) > unstable_time_window) & pool
        return gm.delete_points(state, big | old)
    return gm.delete_points(state, big)


def prune_untouched(state: MapState, n_touched: torch.Tensor, w2c, K,
                    width: int, height: int, time: int, grace: int) -> MapState:
    """Delete unstable gaussians inside the frustum that touched no pixel of
    this render (out-of-view gaussians are untouched by definition)."""
    xyT = state.xyz.T
    zc = w2c[2, 0] * xyT[0] + w2c[2, 1] * xyT[1] + w2c[2, 2] * xyT[2] + w2c[2, 3]
    xc = w2c[0, 0] * xyT[0] + w2c[0, 1] * xyT[1] + w2c[0, 2] * xyT[2] + w2c[0, 3]
    yc = w2c[1, 0] * xyT[0] + w2c[1, 1] * xyT[1] + w2c[1, 2] * xyT[2] + w2c[1, 3]
    zs = torch.where(zc <= 0, 1e-6, zc)
    u = xc / zs * K[0, 0] + K[0, 2]
    v = yc / zs * K[1, 1] + K[1, 2]
    in_view = (zc > 0.2) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    kill = (state.unstable_mask() & in_view & (n_touched == 0)
            & ((time - state.add_tick) > grace))
    return gm.delete_points(state, kill)


def error_remove_step(state: MapState, frame_map: dict, cam: dict,
                      settings: RenderSettings, add_color_thres: float,
                      add_depth_thres: float, add_normal_thres: float,
                      time: int) -> MapState:
    """`error_remove_from` on a fresh whole-map render at `cam`."""
    out = render_state(state, cam, settings, "global")
    return error_remove_from(state, out, frame_map, add_color_thres,
                             add_depth_thres, add_normal_thres, time)


def error_remove_from(state: MapState, out: dict, frame_map: dict,
                      add_color_thres: float, add_depth_thres: float,
                      add_normal_thres: float, time: int) -> MapState:
    """Count, per stable gaussian, the frames whose render error at its hit
    pixels is twice the add threshold; at 10, depth errors delete it and
    colour errors release it to unstable."""
    diff = frame_map["depth_map"] - out["depth"]
    depth_error = torch.where(diff < 0, 0.0, torch.abs(diff))
    color_error = torch.abs(frame_map["color_map"] - out["render"]).sum(dim=-1)
    normal_error = torch.zeros_like(depth_error)
    invalid = (frame_map["depth_map"] == 0) | (out["depth_index_map"] == -1)
    depth_error = torch.where(invalid, 0.0, depth_error)
    color_error = torch.where(frame_map["depth_map"] == 0, 0.0, color_error)

    gs_color, gs_depth, _, _ = accumulate_gaussian_error(
        state.capacity, color_error, depth_error, normal_error,
        out["color_index_map"], out["depth_index_map"],
        add_color_thres, add_depth_thres, add_normal_thres, True)

    stable = state.stable_mask()
    depth_cnt = state.depth_err_cnt + ((gs_depth > 2 * add_depth_thres) & stable).int()
    color_cnt = state.color_err_cnt + ((gs_color > 2 * add_color_thres) & stable).int()
    del_mask = (depth_cnt >= 10) & stable
    rel_mask = (color_cnt >= 10) & stable & (~del_mask)
    state = gm.delete_points(state, del_mask)
    state = gm.release_points(state, rel_mask, time)
    # reset the counters of the slots acted upon
    acted = del_mask | rel_mask
    return state.replace(depth_err_cnt=torch.where(acted, 0, depth_cnt),
                         color_err_cnt=torch.where(acted, 0, color_cnt))


# ---------------------------------------------------------------------------
# host-side Mapping orchestrator
# ---------------------------------------------------------------------------

LOCAL_OPT_MODES = ("bg", "global")


class Mapping:
    def __init__(self, cfg: Config, width: int, height: int, device="cuda"):
        args = cfg.map
        self.local_opt_mode = str(getattr(args, "local_opt_mode", "bg"))
        self.object_mode = int(getattr(cfg.opt, "object_mode", 1))
        if self.local_opt_mode not in LOCAL_OPT_MODES:
            raise ValueError(f"local_opt_mode must be one of {LOCAL_OPT_MODES}, "
                             f"got {self.local_opt_mode!r}")
        self.cfg = cfg
        self.args = args
        self.opt = cfg.opt
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.state = gm.empty_map(args.capacity, self.device)
        self.renderer = Renderer(args, width, height)
        self.settings = self.renderer.settings
        # the unstable scans blend in 128-entry chunks with their own
        # per-Gaussian tile cap: both change the per-tile entry cap and the
        # R-window clip, so they change the image
        self.usettings = self.settings._replace(
            max_tiles_per_gaussian=int(
                getattr(args, "local_max_tiles_per_gaussian", 8) or 8),
            chunk=128)
        self.time = 0
        self.iter = 0                       # names the saved PLY files
        self.save_path = args.save_path
        self.logger = ScalarLogger(self.save_path,
                                   enabled=bool(args.use_tensorboard))
        self.memory_length = args.memory_length
        self.processed_frames: list = []    # [(cam_inputs, frame_map)]
        self.keyframe_ids: list = []
        self.keyframes: list = []           # [(Camera, cam_inputs, keymap)]
        self.optimize_frames_ids: list = []
        self.did_optimize = False
        self.model_map: Optional[dict] = None
        # the map counts' once-a-frame mirror (`counts`)
        self._counts_copy: Optional[HostCopy] = None
        self._cached_counts: Optional[tuple] = None
        self.live_count_reads = 0
        self.waited_count_reads = 0
        self.generator = torch.Generator(device=self.device).manual_seed(2024)
        # the scans' frame schedule, drawn as the JAX package draws it
        self._host_rng = np.random.default_rng(2024)
        self.receipts = dict.fromkeys(RECEIPTS, 0)   # max over the renders
        self.renders = 0
        # scans run (local, keyframe, final pass), their Adam steps (those
        # with the semantic pass apart), and the renders they make besides
        # the steps' own: stable backgrounds (colour and semantic) and
        # keyframe range renders
        self.scan_counts = dict.fromkeys(
            ("local", "global", "final", "iters", "sem_iters", "blends",
             "bg_renders", "sem_bg_renders", "range_renders"), 0)
        # (kind, (iters,) objective curve) of every scan run
        self.scan_log: list = []
        self._warned_dropped = False
        # SLAMSystem installs a `parallel.dp.Mesh` here with
        # `parallel_enabled`: the keyframe scan and the final pass then run
        # data-parallel over its devices (`dp_optimize_scan`)
        self.mesh = None

    # --------------------------------------------------------------
    def _uniform_draws(self, n: int):
        """The two (n,) uniform draws of one densification."""
        return tuple(torch.rand(n, generator=self.generator, device=self.device)
                     for _ in range(2))

    def get_render_output(self, cam_inputs: dict) -> dict:
        """The model render of the whole map at `cam_inputs`."""
        with trace.span("render/model", tag="render/_render_global"):
            out = render_state(self.state, cam_inputs, self.settings,
                               "global", with_n_touched=bool(
                                   getattr(self.args, "use_prune", False)))
            for k in RECEIPTS:
                self.receipts[k] = max(self.receipts[k], int(out[k]))
            self.renders += 1
        self.model_map = out
        return out

    def dropped_entries(self) -> tuple:
        """(dropped entries, most live entries of a model render, most
        clipped cells, most entries the per-tile cap cut) over the run so
        far, from the host's receipts: no wait for the card. The entry
        list is sized by the binning's demand, so `dropped` is 0 by
        construction. Warns once where the per-tile cap cut entries."""
        r = self.receipts
        d, td = r["dropped_entries"], r["tile_dropped"]
        if (d > 0 or td > 0) and not self._warned_dropped:
            self._warned_dropped = True
            print(f"[mapper] WARNING: render entry truncation occurred "
                  f"(budget {d}, per-tile {td}; raise max_chunks_per_tile)",
                  file=sys.stderr)
        return d, r["num_entries"], r["clipped_cells"], td

    def _prefetch_counts(self):
        """Queue the map's (n_unstable, n_stable) into pinned host memory
        at the end of a frame (`HostCopy`); the next `counts()` reads that
        snapshot, as the JAX package's `_prefetch_counts` does."""
        self._counts_copy = HostCopy(self._count_tensor(),
                                     "mapping/counts/wait")
        self._cached_counts = None

    def _count_tensor(self) -> torch.Tensor:
        s = self.state.status
        return torch.stack([(s == gm.UNSTABLE).sum(), (s == gm.STABLE).sum()])

    def counts(self) -> tuple:
        """(n_unstable, n_stable), as the JAX package reads them: once a
        frame. The first read after a frame's end takes the snapshot that
        frame queued, and every later read returns it, until the next
        frame's end. Only where the snapshot is dropped (before the first
        frame, after the final pass's promotion, after a checkpoint load)
        and no queued copy waits is the map read live, a wait for all the
        card's queued work, counted in `live_count_reads`. A snapshot read
        waits for the queued copy alone; where it had not landed yet, that
        wait is counted in `waited_count_reads`."""
        if self._cached_counts is None:
            copy, self._counts_copy = self._counts_copy, None
            if copy is None:
                self.live_count_reads += 1
                with trace.span("mapping/counts/wait"):
                    vals = self._count_tensor().tolist()
            else:
                self.waited_count_reads += not copy.done()
                vals = copy.numpy()
            self._cached_counts = tuple(int(v) for v in vals)
        return self._cached_counts

    def _zero_model_map(self) -> dict:
        """All-transparent model render for the first frame."""
        H, W, dev = self.height, self.width, self.device
        return {
            "T_map": torch.ones((H, W), device=dev),
            "depth": torch.zeros((H, W), device=dev),
            "render": torch.zeros((H, W, 3), device=dev),
            "depth_index_map": torch.full((H, W), -1, dtype=torch.int32, device=dev),
            "color_index_map": torch.full((H, W), -1, dtype=torch.int32, device=dev),
        }

    def gaussians_add(self, frame: Camera, frame_map: dict, frame_id: int) -> int:
        cam = frame.render_inputs(self.device)
        is_first = self.time == 0
        if is_first:
            model_map = self._zero_model_map()
        else:
            with trace.span(tag="add/model_render"):
                model_map = self.get_render_output(cam)
        a = self.args
        cfg = (a.uniform_sample_num, a.add_transmission_thres,
               a.transmission_sample_ratio, a.add_depth_thres,
               a.add_color_thres, a.error_sample_ratio, a.init_opacity,
               *[float(x) for x in a.xyz_factor], a.scale_factor,
               a.min_radius, a.max_radius)
        if not is_first and getattr(a, "use_prune", False):
            self.state = prune_untouched(
                self.state, model_map["n_touched"], cam["w2c"], cam["K"],
                self.width, self.height, self.time, a.unstable_time_window // 2)
            # the render no longer matches the map: finalize must not reuse it
            self.model_map = None
        with trace.span("mapping/add/densify", tag="add/densify"):
            self.state, n_added = densify_step(
                self.state, frame_map, cam, model_map, is_first,
                self._uniform_draws(self.width * self.height), self.time,
                frame_id, a.add_capacity, cfg)
        self._maybe_compact()
        return n_added

    def _maybe_compact(self):
        # the alive count from the mirror (the frame's start), then the
        # slot watermark, a host integer
        cap = self.state.capacity
        if (sum(self.counts()) + 2 * self.args.add_capacity > cap * 0.9
                and self.state.count > cap * 0.9):
            self.state = gm.compact(self.state)
            self.model_map = None      # slot ids moved; index maps stale
            if self.state.count > cap * 0.8:
                self.state = gm.grow(self.state, cap * 2)

    # --------------------------------------------------------------
    def check_keyframe(self, frame: Camera, frame_map: dict,
                       frame_id: int) -> bool:
        """Keep the frame as a keyframe when it turned or moved far enough
        from the last one (the first frame always). Its maps, the semantic
        and instance images included, stay on the device."""
        frame.sync_pose()
        keymap = {"color": frame_map["color_map"], "depth": frame_map["depth_map"],
                  "normal": frame_map["normal_map_w"]}
        if frame_map.get("semantics") is not None:
            keymap["semantics"] = frame_map["semantics"]
        if frame_map.get("instance_img") is not None:
            keymap["instance"] = frame_map["instance_img"]
        if self.time == 0:
            self.keyframes.append((frame, frame.render_inputs(self.device), keymap))
            self.keyframe_ids.append(frame_id)
            return False
        prev_frame = self.keyframes[-1][0]
        _, theta = rot_compare(prev_frame.R.T, frame.R.T)
        _, l2 = trans_compare(prev_frame.T, frame.T)
        if theta > self.args.keyframe_theta_thes or l2 > self.args.keyframe_trans_thes:
            self.keyframes.append((frame, frame.render_inputs(self.device), keymap))
            self.keyframe_ids.append(frame_id)
            return True
        return False

    # --------------------------------------------------------------
    def _lrs(self, coef_feature=1.0, coef_scaling=1.0, coef_rotation=1.0,
             lr_scale=1.0, position_lr=None) -> dict:
        """Per-group learning rates; the SH DC at `feature_lr`, the rest of
        the SH at a twentieth of it, `sem_rgb` at `semantic_lr` x
        `semantic_lr_coef`."""
        o = self.opt
        pos = o.position_lr if position_lr is None else position_lr
        sh_lr = torch.full((gm.SH_K, 1),
                           o.feature_lr / 20.0 * coef_feature * lr_scale,
                           device=self.device)
        sh_lr[0] = o.feature_lr * coef_feature * lr_scale
        sem_coef = getattr(self.args, "semantic_lr_coef", 1.0)
        return {"xyz": pos * lr_scale, "sh": sh_lr[None],
                "scaling": o.scaling_lr * coef_scaling * lr_scale,
                "rotation": o.rotation_lr * coef_rotation * lr_scale,
                "opacity": o.opacity_lr * lr_scale,
                "sem_rgb": o.semantic_lr * sem_coef * lr_scale}

    def _weights(self) -> dict:
        o = self.opt
        return {"color": o.color_weight, "depth": o.depth_weight,
                "normal": o.normal_weight, "ssim": o.ssim_weight,
                "semantic": o.semantic_color_weight,
                "instance": o.instance_weight}

    def _weights_t(self, **overrides) -> tuple:
        """The loss weights as sorted (name, value) pairs; a Python zero
        leaves its term out of the loss."""
        d = self._weights()
        d.update(overrides)
        return tuple(sorted(d.items()))

    def _stack_frames(self, entries: list, tile_size: int) -> dict:
        """entries: dicts of color / depth / normal maps, render_mask,
        tile_mask (None: every tile), cam (render inputs) and, where the
        first entry has them, semantics_color and instance_img."""
        TH, TW = binning_mod.tile_grid_size(self.width, self.height, tile_size)
        ones = torch.ones((TH, TW), dtype=torch.int32, device=self.device)
        cam0 = entries[0]["cam"]
        frames = {
            "color": torch.stack([e["color"] for e in entries]),
            "depth": torch.stack([e["depth"] for e in entries]),
            "normal": torch.stack([e["normal"] for e in entries]),
            "render_mask": torch.stack([e["render_mask"] for e in entries]),
            "tile_mask": torch.stack([ones if e["tile_mask"] is None
                                      else e["tile_mask"] for e in entries]),
            "w2c": torch.stack([e["cam"]["w2c"] for e in entries]),
            "full_proj": torch.stack([e["cam"]["full_proj"] for e in entries]),
            "cam_pos": torch.stack([e["cam"]["cam_pos"] for e in entries]),
            "K": cam0["K"], "tan_fovx": cam0["tan_fovx"],
            "tan_fovy": cam0["tan_fovy"],
        }
        for key in SEMANTIC_MAPS:
            if entries[0].get(key) is not None:
                frames[key] = torch.stack([e[key] for e in entries])
        return frames

    def _rand_schedule(self, iters: int, n_frames: int,
                       second_half_last: bool = True) -> np.ndarray:
        """A uniform frame choice per Adam step, from the mapper's seeded
        generator; with `second_half_last` the second half pinned to the
        newest frame."""
        idx = self._host_rng.integers(0, n_frames, size=iters).astype(np.int32)
        if second_half_last:
            idx[iters // 2 + 1:] = n_frames - 1
        return idx

    def _count_scan(self, kind: str, reports: dict):
        self.scan_counts[kind] += 1
        self.scan_counts["iters"] += reports["iters"]
        for k in ("sem_iters", "blends", "bg_renders", "sem_bg_renders"):
            self.scan_counts[k] += reports.get(k, 0)
        self.receipts["tile_dropped"] = max(self.receipts["tile_dropped"],
                                            reports["tile_dropped"])
        self.receipts["clipped_cells"] = max(self.receipts["clipped_cells"],
                                             reports["clipped_cells"])
        if reports["iters"]:
            self.scan_log.append((kind, (reports["total_loss"]
                                         + reports["scale_loss"]).detach()))
            if self.logger.enabled:
                self.logger.log_dict(self.time, {
                    k: float(v[-1]) if torch.is_tensor(v) else v
                    for k, v in reports.items()}, f"{kind}/")

    def local_optimize(self, frame: Camera):
        """Optimize the unstable Gaussians over the memory frames, then
        merge them back towards their values before the scan."""
        ts = self.settings.tile_size
        entries = []
        with trace.span("scans/local/prepare", tag="local/range_renders"):
            for fi, (cam, fm) in enumerate(self.processed_frames):
                with trace.span(tag=f"local/range_{fi}"):
                    # the tiles the unstable subset's rects cover (no render)
                    tm = coverage_mask_state(self.state, cam, self.settings,
                                             "unstable")
                    rm = im.tilemask_to_pixelmask(tm, ts, self.height,
                                                  self.width)
                    entries.append({
                        "color": fm["color_map"], "depth": fm["depth_map"],
                        "normal": fm["normal_map_w"], "render_mask": rm,
                        "tile_mask": tm, "cam": cam,
                        "semantics_color": fm.get("semantics"),
                        "instance_img": fm.get("instance_img")})
        iters = int(self.args.gaussian_update_iter)
        with trace.span(tag=f"local/optimize_scan x{iters}"):
            frames = self._stack_frames(entries, ts)
            rand_idx = self._rand_schedule(iters, len(entries))
            confidence_pre = self.state.confidence
            history = {"xyz": self.state.xyz, "sh": self.state.sh,
                       "scaling": self.state.scaling,
                       "rotation_act": normalize(self.state.rotation)}
            opt_mask = self.state.unstable_mask()
            if self.local_opt_mode == "global":
                self.state, reports = optimize_scan(
                    self.state, frames, rand_idx, self._lrs(),
                    self._weights_t(), self.settings, iters, gm.UNSTABLE,
                    self.args.add_depth_thres)
            else:
                self.state, reports = compact_optimize_scan(
                    self.state, opt_mask, frames, rand_idx, self._lrs(),
                    self._weights_t(), self.settings, self.usettings, iters,
                    self.args.add_depth_thres, use_bg=True)
        self._count_scan("local", reports)
        with trace.span("scans/local/merge", tag="local/history_merge"):
            self.state = history_merge(self.state, history, confidence_pre,
                                       opt_mask,
                                       self.args.history_merge_max_weight)

    def global_optimization(self, select_keyframe_num: int = -1,
                            is_end: bool = False):
        """The keyframe scan: the stable Gaussians that touch the tiles of
        largest colour error in the newest `select_keyframe_num` keyframes,
        at a tenth of the learning rate, positions fixed.

        With `select_keyframe_num=-1` the final whole-history pass: every
        unstable Gaussian promoted first, then `final_global_iter` steps per
        keyframe over every keyframe, whole, with SSIM and without the depth
        term, the positions fixed, on an unpinned schedule. `is_end` also
        promotes first.

        With a mesh (`parallel_enabled`) both run data-parallel
        (`parallel.dp.dp_optimize_scan`): every step on the weighted mean
        loss over all the selected keyframes, the stable subset rendered
        whole (with the keyframes' tile masks on the keyframe scan, SSIM on
        the final pass), in place of one keyframe a step."""
        if select_keyframe_num == -1 or is_end:
            self.state = gaussians_fix(self.state, -1.0)
            self._cached_counts = None
        if self.counts()[1] == 0 or not self.keyframes:
            return
        ts = self.settings.tile_size
        is_final = select_keyframe_num == -1
        n_sel = (len(self.keyframes) if is_final
                 else min(select_keyframe_num, len(self.keyframes)))
        entries = []
        with trace.span(None if is_final else "scans/keyframe/prepare"):
            for _, cam, keymap in (self.keyframes[-(i + 1)]
                                   for i in range(n_sel)):
                rm, tm = render_range_step(self.state, cam, self.settings,
                                           True, -1.0 if is_final else 0.4,
                                           keymap["color"], ts)
                self.scan_counts["range_renders"] += 1
                entries.append({
                    "color": keymap["color"], "depth": keymap["depth"],
                    "normal": keymap["normal"], "render_mask": rm,
                    "tile_mask": None if is_final else tm, "cam": cam,
                    "semantics_color": keymap.get("semantics"),
                    "instance_img": keymap.get("instance")})
        if self.mesh is not None:
            from ..parallel.dp import dp_slots
            entries, fweight = dp_slots(
                entries, None if is_final else select_keyframe_num,
                self.mesh.size)
        frames = self._stack_frames(entries, ts)
        a = self.args
        if is_final:
            iters = len(self.keyframes) * int(a.final_global_iter)
            lrs = self._lrs(a.feature_lr_coef, a.scaling_lr_coef,
                            a.rotation_lr_coef, position_lr=0.0)
            weights = self._weights_t(depth=0.0)
            rand_idx = self._rand_schedule(iters, n_sel,
                                           second_half_last=False)
        else:
            iters = int(a.gaussian_update_iter)
            lrs = self._lrs(lr_scale=0.1, position_lr=0.0)
            weights = self._weights_t()
            rand_idx = self._rand_schedule(iters, n_sel)
        if self.mesh is not None:
            from ..parallel.dp import dp_optimize_scan
            self.state, reports = dp_optimize_scan(
                self.mesh, self.state, frames, fweight, lrs, weights,
                self.settings, iters, gm.STABLE, a.add_depth_thres,
                subset="stable", with_tile_mask=not is_final,
                use_ssim=is_final)
        elif is_final:
            self.state, reports = optimize_scan(
                self.state, frames, rand_idx, lrs, weights, self.settings,
                iters, gm.STABLE, a.add_depth_thres, use_ssim=True,
                with_tile_mask=False, subset="stable")
        else:
            with trace.span("scans/keyframe/prepare"):
                mask = touched_rows(self.state, frames, self.settings,
                                    gm.STABLE)
                with trace.span("scans/keyframe/prepare/touched/wait"):
                    touched = int(mask.sum())
            if touched == 0:
                return
            with trace.span("scans/keyframe/scan", staged=True, steps=iters):
                self.state, reports = compact_optimize_scan(
                    self.state, mask, frames, rand_idx, lrs, weights,
                    self.settings, self.settings, iters, a.add_depth_thres,
                    use_bg=False, scope="scans/keyframe")
        self._count_scan("final" if is_final else "global", reports)

    def mapping(self, frame: Camera, frame_map: dict, frame_id: int,
                object_layer=None, defer_finalize: bool = False) -> bool:
        """Per-frame mapping step. With `defer_finalize` it stops before
        the promote / error-remove / delete tail, and the caller runs
        `finalize_frame` with the end-of-frame model render (as
        `SLAMSystem.step` does); without it the tail runs here, on a fresh
        render at the last processed frame (`error_remove_step`). On the
        optimize cadence it runs the local scan, or on a keyframe over a
        map with stable Gaussians the keyframe scan. With the object layer,
        the frame's detections are associated first and the new Gaussians
        take the object index of their pixel. In MODE=1 the matched objects
        are refined after the scan on a keyframe (and frame 0); in MODE=0
        every frame with detections ends with the render refinement of the
        objects and the deletion of the stable Gaussians whose radius
        exceeds ten times the stable mean."""
        if object_layer is not None:
            if frame.detections is not None:
                with trace.span("objects/associate"):
                    object_layer.process_frame(frame, frame_id)
            with trace.span("mapping/obj_ids/wait"):
                frame_map["obj_id_map"] = torch.as_tensor(
                    object_layer.obj_id_image(frame.width, frame.height),
                    device=self.device)
        # the frame's counts are read as it begins, as the JAX package's
        # `_update_bucket` reads them: the previous frame's snapshot, or
        # the empty map's before the first frame
        self.counts()
        with trace.span("mapping/add", tag="gaussians_add"):
            self.gaussians_add(frame, frame_map, frame_id)
        self.processed_frames.append((frame.render_inputs(self.device), frame_map))
        if len(self.processed_frames) > self.memory_length:
            self.processed_frames.pop(0)
        is_keyframe = False
        self.did_optimize = False
        if (self.time + 1) % self.args.gaussian_update_frame == 0 or self.time == 0:
            self.did_optimize = True
            self.optimize_frames_ids.append(frame_id)
            is_keyframe = self.check_keyframe(frame, frame_map, frame_id)
            if int(self.args.gaussian_update_iter) > 0:
                if not is_keyframe or self.counts()[1] <= 0:
                    with trace.span("scans/local"):
                        self.local_optimize(frame)
                else:
                    with trace.span("scans/keyframe",
                                    tag="global_optimization"):
                        self.global_optimization(self.args.global_keyframe_num)
            if (object_layer is not None and (is_keyframe or frame_id == 0)
                    and self.object_mode == 1):
                with trace.span("objects/refine", staged=True):
                    object_layer.optimize_objects()
        if (object_layer is not None and frame.detections
                and self.object_mode == 0):
            object_layer.optimize_objects_render(frame, self.settings)
            self.state = gaussians_delete(self.state, self.time,
                                          self.args.unstable_time_window,
                                          unstable=False)
        if not defer_finalize:
            a = self.args
            with trace.span("mapping/finalize",
                            tag="fix+error_remove+delete"):
                self.state = gaussians_fix(self.state,
                                           a.stable_confidence_thres)
                if self.processed_frames and self.counts()[1] > 0:
                    last_cam, last_fm = self.processed_frames[-1]
                    self.state = error_remove_step(
                        self.state, last_fm, last_cam, self.settings,
                        a.add_color_thres, a.add_depth_thres,
                        a.add_normal_thres, self.time)
                self.state = gaussians_delete(self.state, self.time,
                                              a.unstable_time_window,
                                              unstable=True)
            self._prefetch_counts()
        return is_keyframe

    def finalize_frame(self, out: dict, frame_map: dict):
        """Promote / error-remove / delete on the end-of-frame render `out`."""
        a = self.args
        with trace.span("mapping/finalize", tag="finalize(fix+err+del)"):
            self.state = gaussians_fix(self.state, a.stable_confidence_thres)
            if self.counts()[1] > 0:
                self.state = error_remove_from(
                    self.state, out, frame_map, a.add_color_thres,
                    a.add_depth_thres, a.add_normal_thres, self.time)
            self.state = gaussians_delete(self.state, self.time,
                                          a.unstable_time_window,
                                          unstable=True)
        self._prefetch_counts()

    # --------------------------------------------------------------
    def save_model(self, path: Optional[str] = None) -> str:
        """Write the map as PLY files: `<path>.ply` (unstable),
        `<path>_stable.ply`, `<path>_merge.ply` (all alive) and
        `<path>_obj<id>.ply` per object id; an empty subset writes no file.
        By default `path` is `save_model/frame_<time>/iter_<iter>` under the
        run's save path. Returns `path`."""
        if path is None:
            d = os.path.join(self.save_path, "save_model",
                             f"frame_{self.time:04d}")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"iter_{self.iter:04d}")
        for suffix, subset in (("", "unstable"), ("_stable", "stable"),
                               ("_merge", "global")):
            save_map_ply(self.state, path + suffix + ".ply", subset=subset,
                         include_confidence=True)
        obj_ids = self.state.obj_id.cpu().numpy()
        status = self.state.status.cpu().numpy()
        for oid in np.unique(obj_ids[(obj_ids >= 0) & (status != gm.DEAD)]):
            save_map_ply(self.state, path + f"_obj{oid}.ply", subset="global",
                         include_confidence=True, mask=obj_ids == oid)
        return path
