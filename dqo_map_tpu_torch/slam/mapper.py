"""Gaussian map lifecycle on the forward path: add, promote, error-remove,
delete (counterpart of the forward part of `dqo_map_tpu/slam/mapper.py`).

Densification samples new Gaussians where the model render is transparent
or wrong, drops those an unstable Gaussian already covers, lowers the
opacity of those that land on a stable surface, sets their scales from the
nearest neighbours and appends them. Promote / delete are status updates on
the fixed-capacity `MapState`.

The optimize scans (`local_optimize`, `global_optimization`: the Adam
steps, their gradients and the backward blend) are not ported yet. This
Mapping runs their cadence bookkeeping, the keyframe check and list, and
in place of each scan a scan of zero Adam steps: that leaves every
parameter and confidence where it was, and the history merge that follows
a scan is then the identity. So `gaussian_update_iter` must be 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import Config
from ..models import gaussian_map as gm
from ..models.cameras import Camera
from ..models.gaussian_map import MapState
from ..ops.error_accum import accumulate_gaussian_error
from ..ops.knn import knn2, scales_from_knn
from ..utils import image as im
from ..utils.math3d import normalize, quat_to_rotmat, rot_compare, trans_compare
from .renderer import Renderer, render_state

RECEIPTS = ("dropped_entries", "tile_dropped", "clipped_cells", "num_entries",
            "entry_demand")


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    denom = torch.clamp(m.sum() * (x.numel() / mask.numel()), min=1.0)
    return (x * m).sum() / denom


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

    new = gm.make_new_points(
        frame_map["vertex_map_w"].reshape(-1, 3)[idx],
        frame_map["normal_map_w"].reshape(-1, 3)[idx],
        frame_map["color_map"].reshape(-1, 3)[idx], valid, time, frame_id,
        init_opacity, (xf0, xf1, xf2))

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
    (d2u, iu), (d2a, ia) = knn2(new["xyz"], cand_xyz, mask_unst, mask_all, k=8)
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

class Mapping:
    def __init__(self, cfg: Config, width: int, height: int, device="cuda"):
        args = cfg.map
        if int(args.gaussian_update_iter) != 0:
            raise NotImplementedError(
                "the optimize scans (gaussian_update_iter > 0) come in "
                "slice 2 of the port; set gaussian_update_iter=0")
        self.cfg = cfg
        self.args = args
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.state = gm.empty_map(args.capacity, self.device)
        self.renderer = Renderer(args, width, height)
        self.settings = self.renderer.settings
        self.time = 0
        self.memory_length = args.memory_length
        self.processed_frames: list = []    # [(cam_inputs, frame_map)]
        self.keyframe_ids: list = []
        self.keyframes: list = []           # [(Camera, cam_inputs, keymap)]
        self.optimize_frames_ids: list = []
        self.did_optimize = False
        self.model_map: Optional[dict] = None
        self.generator = torch.Generator(device=self.device).manual_seed(2024)
        self.receipts = dict.fromkeys(RECEIPTS, 0)   # max over the renders
        self.renders = 0

    # --------------------------------------------------------------
    def _uniform_draws(self, n: int):
        """The two (n,) uniform draws of one densification."""
        return tuple(torch.rand(n, generator=self.generator, device=self.device)
                     for _ in range(2))

    def get_render_output(self, cam_inputs: dict) -> dict:
        """The model render of the whole map at `cam_inputs`."""
        out = render_state(self.state, cam_inputs, self.settings, "global",
                           with_n_touched=bool(getattr(self.args, "use_prune",
                                                       False)))
        for k in RECEIPTS:
            self.receipts[k] = max(self.receipts[k], int(out[k]))
        self.renders += 1
        self.model_map = out
        return out

    def counts(self) -> tuple:
        """(n_unstable, n_stable)."""
        s = self.state.status
        u, st = torch.stack([(s == gm.UNSTABLE).sum(), (s == gm.STABLE).sum()]).tolist()
        return u, st

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
        model_map = (self._zero_model_map() if is_first
                     else self.get_render_output(cam))
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
        self.state, n_added = densify_step(
            self.state, frame_map, cam, model_map, is_first,
            self._uniform_draws(self.width * self.height), self.time,
            frame_id, a.add_capacity, cfg)
        self._maybe_compact()
        return n_added

    def _maybe_compact(self):
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
        from the last one (the first frame always). Its maps stay on the
        device."""
        frame.sync_pose()
        keymap = {"color": frame_map["color_map"], "depth": frame_map["depth_map"],
                  "normal": frame_map["normal_map_w"]}
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
    def mapping(self, frame: Camera, frame_map: dict, frame_id: int) -> bool:
        """Per-frame mapping step up to, not including, the promote /
        error-remove / delete tail: the caller runs `finalize_frame` with
        the end-of-frame model render."""
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
            # here the reference runs its optimize scan (local, or global on
            # a keyframe): zero Adam steps, which change nothing
        return is_keyframe

    def finalize_frame(self, out: dict, frame_map: dict):
        """Promote / error-remove / delete on the end-of-frame render `out`."""
        a = self.args
        self.state = gaussians_fix(self.state, a.stable_confidence_thres)
        if self.counts()[1] > 0:
            self.state = error_remove_from(
                self.state, out, frame_map, a.add_color_thres,
                a.add_depth_thres, a.add_normal_thres, self.time)
        self.state = gaussians_delete(self.state, self.time,
                                      a.unstable_time_window, unstable=True)
