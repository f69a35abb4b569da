"""The first steps of an optimize scan, in plain PyTorch: a frozen copy of
the port's `slam/mapper.py` (`masked_mean`, `adam_update`, `compute_loss`
and `compact_optimize_scan`, whose rows are gathered once, rendered in
tile space, with or without the one-surface background), through the
frozen renderer and the plain blend (`blend_fn`).

`compact_scan_steps` runs the scan's first `steps` masked Adam steps from
the state and inputs the scan was called with and returns what the
benchmark compares: each step's loss, the first step's gradient as the
optimizer takes it, and the parameters after every step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gaussian_map as gm
from .blend import pack_bg_tiled, tile_map
from .gaussian_map import MapState
from .precision import rnd
from .renderer import compute_binning_state, render_state

OPT_FIELDS = ("xyz", "sh", "scaling", "rotation", "opacity", "sem_rgb")


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    denom = torch.clamp(m.sum() * (x.numel() / mask.numel()), min=1.0)
    return (x * m).sum() / denom


def adam_update(params: dict, grads: dict, st: dict, lrs: dict,
                mask: torch.Tensor, b1=0.9, b2=0.999, eps=1e-15):
    """Adam with per-group learning rates and a row mask: a masked row's
    gradient is taken as 0 and its parameters do not move. `st` holds
    m, v and step; returns (params, st)."""
    step = st["step"] + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        g = grads[k]
        mk = mask
        while mk.dim() < g.dim():
            mk = mk[..., None]
        g = torch.where(mk, g, 0.0)
        m = b1 * st["m"][k] + (1 - b1) * g
        v = b2 * st["v"][k] + (1 - b2) * g * g
        upd = lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k] = rnd(params[k] - torch.where(mk, upd, 0.0))
        new_m[k] = m
        new_v[k] = v
    return new_p, {"m": new_m, "v": new_v, "step": step}


def _is_zero(weights: dict, k: str) -> bool:
    w = weights.get(k, 0.0)
    return isinstance(w, (int, float)) and float(w) == 0.0


def compute_loss(render_out: dict, image_input: dict, params: dict,
                 init_stat: dict, opt_mask: torch.Tensor, weights: dict,
                 add_depth_thres: float):
    """The scans' loss without SSIM (the compact scans have none): colour
    L1, depth L1, normal cosine, the semantic and instance terms where the
    inputs hold their images (the benchmark's frames hold none), and the
    attach anchor."""
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
    total = (weights["depth"] * depth_loss + weights["normal"] * normal_loss
             + weights["color"] * color_loss)
    if "semantics_color" in image_input or "instance_img" in image_input:
        raise NotImplementedError("the reference scan has no semantic or "
                                  "instance terms")
    attach_mask = (torch.sigmoid(init_stat["opacity"]) < 0.9) & opt_mask
    attach = 1000.0 * (
        masked_mean((params["scaling"] - init_stat["scaling"]) ** 2, attach_mask)
        + masked_mean((params["xyz"] - init_stat["xyz"]) ** 2, attach_mask)
        + masked_mean((params["rotation"] - init_stat["rotation"]) ** 2,
                      attach_mask))
    return total + attach


def _frame_cam(frames: dict, f: int) -> dict:
    return {"w2c": frames["w2c"][f], "full_proj": frames["full_proj"][f],
            "cam_pos": frames["cam_pos"][f], "K": frames["K"],
            "tan_fovx": frames["tan_fovx"], "tan_fovy": frames["tan_fovy"]}


def _substate(state: MapState, rows, status=None) -> MapState:
    sub = {f: getattr(state, f)[rows] for f in gm.FIELDS}
    if status is not None:
        sub["status"] = torch.full_like(sub["status"], status)
    return MapState(**sub, count=sub["xyz"].shape[0])


def compact_scan_steps(state: MapState, row_mask: torch.Tensor, frames: dict,
                       rand_idx, lrs: dict, weights, settings, usettings,
                       add_depth_thres: float, use_bg: bool,
                       steps: int) -> dict:
    """The first `steps` steps of `compact_optimize_scan` with these
    arguments. Returns {"loss": [per step], "grad": {leaf: first step's
    masked gradient}, "params": [{leaf: after step s}], "init": {leaf}}."""
    weights = dict(weights)
    uidx = torch.nonzero(row_mask)[:, 0]
    sub = _substate(state, uidx, gm.UNSTABLE)
    valid_u = torch.ones(sub.count, dtype=torch.bool, device=state.device)
    init_stat = {k: getattr(sub, k) for k in ("opacity", "scaling", "xyz",
                                              "rotation")}
    n_frames = frames["w2c"].shape[0]
    ts, W, H = settings.tile_size, settings.width, settings.height
    gt = [{"color_map": tile_map(frames["color"][f], ts, W, H),
           "depth_map": tile_map(frames["depth"][f], ts, W, H),
           "normal_map": tile_map(frames["normal"][f], ts, W, H),
           "render_mask": tile_map(frames["render_mask"][f], ts, W, H)}
          for f in range(n_frames)]
    used = sorted({int(rand_idx[it]) for it in range(steps)})
    bgs, bgts = {}, {}
    if use_bg:
        with torch.no_grad():
            for f in used:
                cam = _frame_cam(frames, f)
                bg = render_state(state, cam, settings, "stable",
                                  frames["tile_mask"][f], tiled=True)
                bgs[f] = {k: bg[k] for k in ("render", "depth", "normal",
                                             "depth_index_map", "T_map")}
                bg_depth = torch.where(bg["depth_index_map"] >= 0,
                                       bg["depth"], 1e30)
                bgts[f] = pack_bg_tiled(bg["render"], bg_depth, bg["T_final"])
    binnings = {f: compute_binning_state(sub, _frame_cam(frames, f), usettings,
                                         "global", frames["tile_mask"][f])
                for f in used}

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
        return compute_loss(out, gt[f], p, init_stat, valid_u, weights,
                            add_depth_thres)

    params = {k: getattr(sub, k) for k in OPT_FIELDS}
    st = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
          "v": {k: torch.zeros_like(v) for k, v in params.items()}, "step": 0}
    res = {"loss": [], "grad": None, "params": [], "init": dict(params)}
    for it in range(steps):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_of(sub.replace(**p), int(rand_idx[it]), p)
        grads = torch.autograd.grad(loss, [p[k] for k in OPT_FIELDS],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else rnd(g)
                 for k, g in zip(OPT_FIELDS, grads)}
        with torch.no_grad():
            params, st = adam_update(params, grads, st, lrs, valid_u)
        if it == 0:
            res["grad"] = {k: torch.where(
                valid_u.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
                for k, g in grads.items()}
        res["loss"].append(float(loss.detach()))
        res["params"].append({k: v.detach() for k, v in params.items()})
    return res
