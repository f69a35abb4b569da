"""Dual-quadric object layer (counterpart of `dqo_map_tpu/models/quadrics.py`):
2D ellipse / 3D ellipsoid algebra in dual form, detection filtering,
projected-box association with occlusion handling, duplicate removal, and
the refinement of the ellipsoids: in MODE=1 every matched one at once on a
projected-box IoU loss, in MODE=0 every live one at once as one Gaussian
each, rendered through the map's rasterizer (the blend kernels K1 and K2
on the card) against the object-colour image.

The host half (algebra, filtering, association) is numpy, copied from the
JAX package so that the port imports nothing of it; the layer draws its
detection samples and observation schedules from the same
`np.random.default_rng(2024)` stream. `refine_objects` and
`refine_objects_render` are plain PyTorch around the rasterizer: a masked
Adam over all `MAX_OBJECTS` slots at once with `torch.autograd`, on the
layer's device. The caps that change the result are counted in
`TRUNCATION` and reported by the run.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
# with the module, not at the first call: the import takes ~1 s, which
# would otherwise land inside a tracked frame
from scipy.linalg import sqrtm

from ..ops.rasterize import rasterize
from ..utils import trace
from ..utils.math3d import normalize, quat_to_rotmat, rotmat_to_quat

OBS_CAP = 48          # observations kept per object (reference keeps all)
MAX_OBJECTS = 64      # compiled optimizer width
OBJ_ITERS = 20        # refinement iterations (ref quadrics.py:2252)

# no-silent-caps receipts: every time a fixed capacity actually bites, the
# event is counted here and surfaced in the run summary (the repo's rule
# from the binning work; the reference keeps all observations/objects).
TRUNCATION = {"obs_trimmed": 0, "objects_over_cap": 0}


# ---------------------------------------------------------------------------
# numpy dual-form algebra (host side)
# ---------------------------------------------------------------------------

class Ellipse:
    """2D ellipse in dual form C* (ref `Ellipse`, quadrics.py:148-248)."""

    def __init__(self, axes, angle, center):
        axes_half = 0.5 * np.asarray(axes, np.float64)
        C = np.diag([*(axes_half**2), -1.0])
        T = np.eye(3)
        T[:2, 2] = center
        R = np.array([[np.cos(angle), -np.sin(angle), 0],
                      [np.sin(angle), np.cos(angle), 0], [0, 0, 1.0]])
        tf = T @ R
        C = tf @ C @ tf.T
        C = 0.5 * (C + C.T)
        C /= -C[2, 2]
        self.C_ = C
        self.axes_ = axes_half
        self.angle_ = float(angle)
        self.center_ = np.asarray(center, np.float64)

    @classmethod
    def from_dual(cls, C):
        inst = cls.__new__(cls)
        C = 0.5 * (C + C.T)
        C = C / -C[2, 2]
        inst.C_ = C
        inst.center_ = -C[:2, 2]
        T = np.eye(3)
        T[:2, 2] = -inst.center_
        Cc = T @ C @ T.T
        Cc = 0.5 * (Cc + Cc.T)
        evals, evecs = np.linalg.eigh(Cc[:2, :2])
        if np.linalg.det(evecs) < 0:
            evecs[:, 1] *= -1
        if evecs[0, 0] < 0:
            evecs = -evecs
        inst.axes_ = np.sqrt(np.abs(evals))
        inst.angle_ = float(np.arctan2(evecs[1, 0], evecs[0, 0]))
        return inst

    def compute_bbox(self):
        c, s = np.cos(self.angle_), np.sin(self.angle_)
        xmax = np.sqrt(self.axes_[0]**2 * c**2 + self.axes_[1]**2 * s**2)
        ymax = np.sqrt(self.axes_[0]**2 * s**2 + self.axes_[1]**2 * c**2)
        return np.array([self.center_[0] - xmax, self.center_[1] - ymax,
                         self.center_[0] + xmax, self.center_[1] + ymax])

    def as_gaussian(self):
        """(mu, cov) view for the Wasserstein distance (ref quadrics.py:234-248)."""
        A = np.diag(self.axes_**2)
        c, s = np.cos(self.angle_), np.sin(self.angle_)
        R = np.array([[c, -s], [s, c]])
        cov = R @ A @ R.T
        return self.center_, np.clip(cov, 0, None)


class Ellipsoid:
    """3D ellipsoid in dual form Q* (ref `Ellipsoid`, quadrics.py:388-426)."""

    def __init__(self, axes, R, center):
        Q = np.diag([*(np.asarray(axes, np.float64)**2), -1.0])
        T = np.eye(4)
        T[:3, 3] = center
        Rw = np.eye(4)
        Rw[:3, :3] = R
        tf = T @ Rw
        Q = tf @ Q @ tf.T
        self.Q_ = 0.5 * (Q + Q.T)
        self.Q_ /= -self.Q_[3, 3]
        self.axes_ = np.asarray(axes, np.float64)
        self.R_ = np.asarray(R, np.float64)
        self.center_ = np.asarray(center, np.float64)

    def project(self, P) -> Ellipse:
        return Ellipse.from_dual(P @ self.Q_ @ P.T)


def bbox_area(bb):
    return max(bb[2] - bb[0], 0) * max(bb[3] - bb[1], 0)


def bboxes_iou(bb1, bb2):
    iw = max(min(bb1[2], bb2[2]) - max(bb1[0], bb2[0]), 0)
    ih = max(min(bb1[3], bb2[3]) - max(bb1[1], bb2[1]), 0)
    inter = iw * ih
    union = bbox_area(bb1) + bbox_area(bb2) - inter
    return inter / union if union > 0 else 0.0


def bboxes_intersection(bb1, bb2):
    iw = max(min(bb1[2], bb2[2]) - max(bb1[0], bb2[0]), 0)
    ih = max(min(bb1[3], bb2[3]) - max(bb1[1], bb2[1]), 0)
    return iw * ih


def is_cover(bb1, bb2):
    """bb2 covers >50% of bb1 while bb1 covers <50% of bb2
    (ref quadrics.py:296-311)."""
    inter = bboxes_intersection(bb1, bb2)
    a1, a2 = bbox_area(bb1), bbox_area(bb2)
    if a1 == 0:
        return False
    return inter / a1 > 0.5 and (a2 == 0 or inter / a2 < 0.5)


def wasserstein_similarity(ell1: Ellipse, ell2: Ellipse, C: float = 10.0):
    """exp(-W2/C) between ellipse Gaussians (ref `Calculate_distance`,
    quadrics.py:970-988)."""
    mu1, s1 = ell1.as_gaussian()
    mu2, s2 = ell2.as_gaussian()
    s11 = np.real(sqrtm(s1))
    s121 = np.real(sqrtm(s11 @ s2 @ s11))
    d = np.linalg.norm(mu1 - mu2)**2 + np.trace(s1 + s2 - 2 * s121)
    return np.exp(-np.sqrt(max(d, 0.0)) / C)


# ---------------------------------------------------------------------------
# detection filtering (ref `detections_filter`, quadrics.py:336-386)
# ---------------------------------------------------------------------------

def detections_filter(detections: List[dict], depth_map: np.ndarray,
                      W: int, H: int, rng=None):
    rng = rng or np.random.default_rng(0)
    kept = []
    for d in detections:
        if d.get("ellipse") is None:
            ell_bb = d["bbox"]
        else:
            e = d["ellipse"]
            ell_bb = Ellipse(e[2:4], e[4], e[0:2]).compute_bbox()
        if (d["score"] < 0.2 or bbox_area(d["bbox"]) < 300
                or bbox_area(d["bbox"]) > 0.5 * H * W
                or bboxes_iou(d["bbox"], ell_bb) < 0.2):
            continue
        similar = False
        for k in kept:
            iou = bboxes_iou(d["bbox"], k["bbox"])
            if (d["cat"] == k["cat"] and iou > 0.3) or (
                    d["cat"] != k["cat"] and iou > 0.6):
                similar = True
                break
        if not similar:
            kept.append(dict(d, obj=None, is_validate=True))

    depth_data = np.zeros((len(kept), 2))
    for i, d in enumerate(kept):
        bb = d["bbox"]
        us = rng.integers(int(bb[0]), max(int(bb[2]), int(bb[0]) + 1), 30)
        vs = rng.integers(int(bb[1]), max(int(bb[3]), int(bb[1]) + 1), 30)
        us = np.clip(us, 0, W - 1)
        vs = np.clip(vs, 0, H - 1)
        ds = depth_map[vs, us]
        ds = ds[ds > 0]
        if len(ds):
            depth_data[i, 0] = min(float(ds.mean()), 5.0)
            depth_data[i, 1] = min(max(float(ds.max() - ds.min()), 0.05), 0.2)
    return kept, depth_data


# ---------------------------------------------------------------------------
# Object (ref `Object`, quadrics.py:429-487)
# ---------------------------------------------------------------------------

class MapObject:
    _next_id = 0

    def __init__(self, det, depth_data, K, Rt, frame_idx):
        self.id_ = MapObject._next_id
        MapObject._next_id += 1
        self.category_id_ = det["cat"]
        self.color = det.get("color", [128, 128, 128])
        self.last_obs_frame = frame_idx
        self.last_obs = [-1, -1, -1.0]       # (frame, det index, best iou)
        self.bboxes_: List[np.ndarray] = []
        self.Rts_: List[np.ndarray] = []

        bb = np.asarray(det["bbox"], np.float64)
        avg_depth, diff_depth = depth_data
        bc = np.array([(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])
        u = (bc[0] - K[0, 2]) / K[0, 0]
        v = (bc[1] - K[1, 2]) / K[1, 1]
        bc_cam = np.array([u * avg_depth, v * avg_depth, avg_depth])
        Rcw = Rt[:3, :3]
        tcw = Rt[:3, 3]
        center_world = Rcw.T @ bc_cam - Rcw.T @ tcw

        zc = bc_cam / np.linalg.norm(bc_cam)
        up = np.array([0.0, -1.0, 0.0])
        xc = np.cross(-up, zc)
        xc /= np.linalg.norm(xc)
        yc = np.cross(zc, xc)
        rot_cam = np.stack([xc, yc, zc], axis=1)
        rot_world = Rcw.T @ rot_cam

        w_img = bb[2] - bb[0]
        h_img = bb[3] - bb[1]
        axes = np.array([
            w_img * avg_depth / K[0, 0] * 0.5,
            h_img * avg_depth / K[1, 1] * 0.5,
            diff_depth * 0.5,
        ])
        self.ellipsoid_ = Ellipsoid(axes, rot_world, center_world)
        self.add_observation(bb, Rt)

    def add_observation(self, bbox, Rt):
        self.bboxes_.append(np.asarray(bbox, np.float64))
        self.Rts_.append(np.asarray(Rt, np.float64))
        if len(self.bboxes_) > OBS_CAP:
            # keep the first observation + the most recent window
            TRUNCATION["obs_trimmed"] += len(self.bboxes_) - OBS_CAP
            self.bboxes_ = [self.bboxes_[0]] + self.bboxes_[-(OBS_CAP - 1):]
            self.Rts_ = [self.Rts_[0]] + self.Rts_[-(OBS_CAP - 1):]


# ---------------------------------------------------------------------------
# association (ref `Occlusions_Check` + IoU `MatchObject`,
# quadrics.py:926-968, 1013-1217)
# ---------------------------------------------------------------------------

def occlusions_check(objects, K, Rt, W, H):
    P = K @ Rt
    img_bbox = np.array([0, 0, W, H])
    proj = {}
    for i, obj in enumerate(objects):
        pe = obj.ellipsoid_.project(P)
        c3d = obj.ellipsoid_.center_
        bb = pe.compute_bbox()
        z = Rt[2, :] @ np.append(c3d, 1)
        if z < 0 or bboxes_intersection(bb, img_bbox) < 0.3 * bbox_area(bb):
            continue
        proj[i] = pe
        hidden = []
        for j, pj in list(proj.items()):
            if j != i and bboxes_iou(pj.compute_bbox(), bb) > 0.8:
                zj = Rt[2, :] @ np.append(objects[j].ellipsoid_.center_, 1)
                hidden.append(j if z < zj else i)
                break
        for h in hidden:
            proj.pop(h, None)
    return proj


def _det_ellipse(det) -> "Ellipse":
    """Detection's 2D ellipse; bbox-inscribed fallback when absent."""
    e = det.get("ellipse")
    if e is not None:
        return Ellipse(e[2:4], e[4], e[0:2])
    bb = det["bbox"]
    return Ellipse([(bb[2] - bb[0]) / 2, (bb[3] - bb[1]) / 2], 0.0,
                   [(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])


def _assoc_score(pe, bb_proj, det, mode: str):
    """Association score + accept flag for one (projected object, detection)
    pair. Variants match the reference's ablation
    (the QD metric and `Only_IOU` flag of the reference's
    quadrics.py:970-988):
      iou    — projected-bbox IoU > 0.5 (the shipped default)
      qd     — 2-Wasserstein ellipse similarity exp(-W2/C) > 0.5
      iou_qd — IoU > 0.5, or both moderately confident (IoU > 0.25 and
               QD > 0.5); ranked by the sum."""
    iou = bboxes_iou(bb_proj, det["bbox"])
    if mode == "iou":
        return iou, iou > 0.5
    try:
        w = wasserstein_similarity(pe, _det_ellipse(det))
    except Exception:
        w = 0.0
    if mode == "qd":
        return w, w > 0.5
    return iou + w, (iou > 0.5) or (iou > 0.25 and w > 0.5)


def match_objects(objects, detections, depth_data, proj, frame_id, K, Rt,
                  mode: str = "iou"):
    """Association with cover-based replacement (ref quadrics.py:1013-1217);
    `mode` selects the iou / qd / iou_qd matching variant.
    Returns has_new_object."""
    has_new = False
    for cur_order, det in enumerate(detections):
        best_score = 0.0
        matched = None
        node_id = -1
        bb_det = det["bbox"]
        replaced = False
        for i, pe in proj.items():
            obj = objects[i]
            bb_proj = pe.compute_bbox()
            iou = bboxes_iou(bb_proj, bb_det)
            if obj.category_id_ == det["cat"] and iou < 0.5:
                if is_cover(bb_proj, bb_det):
                    # the new detection covers the stored object: rebuild
                    objects[i] = MapObject(det, depth_data[cur_order], K, Rt,
                                           frame_id)
                    det["obj"] = objects[i]
                    replaced = True
                    break
                elif is_cover(bb_det, bb_proj):
                    det["is_validate"] = False
                    matched = None
                    break
            score, accept = _assoc_score(pe, bb_proj, det, mode)
            if accept and score > best_score:
                best_score = score
                matched = obj
                node_id = i
        if replaced:
            continue
        if matched is not None:
            if matched.last_obs[0] == frame_id:
                if best_score < matched.last_obs[2]:
                    continue
                prev_det = matched.last_obs[1]
                if 0 <= prev_det < len(detections):
                    detections[prev_det]["obj"] = None
            det["obj"] = matched
            det["node_id"] = node_id
            matched.last_obs = [frame_id, cur_order, best_score]
            pe = matched.ellipsoid_.project(K @ Rt)
            bbp = pe.compute_bbox()
            if bboxes_iou(bbp, bb_det) >= 0.01 or det["is_validate"]:
                if pe.axes_[0] > 1e-3 and pe.axes_[1] > 1e-3:
                    matched.add_observation(det["bbox"], Rt)

    for i, det in enumerate(detections):
        if det.get("obj") is None and det.get("is_validate", True):
            if 0.01 < depth_data[i][0] < 15.0:
                obj = MapObject(det, depth_data[i], K, Rt, frame_id)
                objects.append(obj)
                det["obj"] = obj
                det["node_id"] = len(objects) - 1
                has_new = True
    return has_new


def remove_outliers(objects, K, Rt):
    """Merge same-category objects whose projections nearly coincide
    (ref `remove_outlier`, quadrics.py:2397-2425)."""
    P = K @ Rt
    for i in range(len(objects) - 1, -1, -1):
        o1 = objects[i]
        for j in range(len(objects) - 1, i, -1):
            o2 = objects[j]
            if o1.category_id_ == o2.category_id_:
                try:
                    w = wasserstein_similarity(
                        o1.ellipsoid_.project(P), o2.ellipsoid_.project(P))
                except Exception:
                    continue
                if w < 0.1:
                    objects.pop(j)
    return objects


# ---------------------------------------------------------------------------
# batched refinement
# ---------------------------------------------------------------------------

def _project_bbox(axes, R, center, P):
    """Projected bounding boxes (O, 4) of the ellipsoids axes (O,3), R
    (O,3,3), center (O,3) under the projections P (O,3,4), differentiably:
    the dual quadric through P, then the closed-form symmetric 2x2
    eigensolve of the recentred conic. The clamps are `torch.maximum`, which
    splits the gradient at a tie as `jnp.maximum` does."""
    O = axes.shape[0]
    dev, dt = axes.device, axes.dtype
    eye4 = torch.eye(4, dtype=dt, device=dev).expand(O, 4, 4)
    Q = torch.diag_embed(torch.cat([axes ** 2,
                                    torch.full((O, 1), -1.0, dtype=dt,
                                               device=dev)], dim=1))
    T = torch.cat([torch.cat([eye4[:, :3, :3], center[:, :, None]], dim=2),
                   eye4[:, 3:]], dim=1)
    zc = torch.zeros((O, 3, 1), dtype=dt, device=dev)
    Rw = torch.cat([torch.cat([R, zc], dim=2), eye4[:, 3:]], dim=1)
    tf = T @ Rw
    Qw = tf @ Q @ tf.transpose(1, 2)
    Qw = 0.5 * (Qw + Qw.transpose(1, 2))
    Qw = Qw / -Qw[:, 3:4, 3:4]
    C = P @ Qw @ P.transpose(1, 2)
    C = 0.5 * (C + C.transpose(1, 2))
    C = C / -C[:, 2:3, 2:3]
    cx = -C[:, 0, 2]
    cy = -C[:, 1, 2]
    # the conic recentred: with C22 = -1 and C[0:2,2] = -centre, translating
    # by -centre gives [[C00 + cx^2, C01 + cx cy], [., C11 + cy^2]]
    a = C[:, 0, 0] + cx * cx
    b = C[:, 0, 1] + cx * cy
    c = C[:, 1, 1] + cy * cy
    with trace.span("project_bbox/wait"):
        tiny = torch.tensor(1e-12, dtype=dt, device=dev)
    mid = 0.5 * (a + c)
    rad = torch.sqrt(torch.maximum(0.25 * (a - c) ** 2 + b * b, tiny))
    l1 = torch.abs(mid + rad)
    l2 = torch.abs(mid - rad)
    theta = 0.5 * torch.atan2(2 * b, a - c)
    ax1 = torch.sqrt(torch.maximum(l1, tiny))
    ax2 = torch.sqrt(torch.maximum(l2, tiny))
    ct, st = torch.cos(theta), torch.sin(theta)
    xmax = torch.sqrt(ax1 ** 2 * ct ** 2 + ax2 ** 2 * st ** 2)
    ymax = torch.sqrt(ax1 ** 2 * st ** 2 + ax2 ** 2 * ct ** 2)
    return torch.stack([cx - xmax, cy - ymax, cx + xmax, cy + ymax], dim=1)


def _bbox_iou_t(bb1, bb2):
    """IoU of the (O, 4) boxes bb1 and bb2, row by row."""
    zero = torch.zeros((), dtype=bb1.dtype, device=bb1.device)
    iw = torch.maximum(torch.minimum(bb1[:, 2], bb2[:, 2])
                       - torch.maximum(bb1[:, 0], bb2[:, 0]), zero)
    ih = torch.maximum(torch.minimum(bb1[:, 3], bb2[:, 3])
                       - torch.maximum(bb1[:, 1], bb2[:, 1]), zero)
    inter = iw * ih
    a1 = (bb1[:, 2] - bb1[:, 0]) * (bb1[:, 3] - bb1[:, 1])
    a2 = (bb2[:, 2] - bb2[:, 0]) * (bb2[:, 3] - bb2[:, 1])
    return inter / torch.maximum(a1 + a2 - inter,
                                 torch.full_like(inter, 1e-8))


def objects_loss(axes, R, center, bbox, P, valid, opt_mask):
    """The refinement's objective: sum over the optimized slots of 1 - IoU
    of the observed box `bbox` (O,4) and the projection under `P` (O,3,4);
    an invalid observation, or one the projection misses entirely, adds 0
    (the reference skips such a step)."""
    iou = _bbox_iou_t(bbox, _project_bbox(axes, R, center, P))
    loss = torch.where(valid & (iou > 1e-6), 1.0 - iou, 0.0)
    return torch.sum(torch.where(opt_mask, loss, 0.0))


def refine_objects(axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask,
                   rand_idx, iters: int = OBJ_ITERS, lr_axes: float = 0.01,
                   lr_center: float = 0.001, lr_R: float = 0.01):
    """Masked Adam over all object slots at once.

    axes (O,3), R (O,3,3), center (O,3); obs_bbox (O,CAP,4), obs_P
    (O,CAP,3,4) (P = K @ Rt of each observation), obs_valid (O,CAP), opt_mask
    (O,), rand_idx (iters,O) the observation each slot fits at each step:
    tensors on one device. Returns the refined (axes, R, center); the
    slots outside `opt_mask` keep their values."""
    params = {"axes": axes, "R": R, "center": center}
    lrs = {"axes": lr_axes, "R": lr_R, "center": lr_center}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    with trace.span("refine_objects/wait"):
        rand_idx = torch.as_tensor(rand_idx, device=axes.device).long()
    rows = torch.arange(axes.shape[0], device=axes.device)
    for it in range(iters):
        o = rand_idx[it]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        total = objects_loss(leaves["axes"], leaves["R"], leaves["center"],
                             obs_bbox[rows, o], obs_P[rows, o],
                             obs_valid[rows, o], opt_mask)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        _masked_adam_step(params, grads, m, v, lrs, opt_mask, it + 1)
    return params["axes"], params["R"], params["center"]


def _masked_adam_step(params: dict, grads: dict, m: dict, v: dict, lrs: dict,
                      opt_mask, step: int):
    """Step `step` of the object refinements' masked Adam (eps 1e-15, bias
    corrections in float32), in place on `params`, `m` and `v`: the slots
    outside `opt_mask` take a zero gradient and do not move."""
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(0.9, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(0.999, dtype=torch.float32) ** t)
    for k, p in params.items():
        mk = opt_mask.reshape((-1,) + (1,) * (p.dim() - 1))
        gk = torch.where(mk, grads[k], 0.0)
        m[k] = 0.9 * m[k] + 0.1 * gk
        v[k] = 0.999 * v[k] + 0.001 * gk * gk
        upd = lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-15)
        params[k] = p - torch.where(mk, upd, 0.0)


# ---------------------------------------------------------------------------
# MODE=0: the render refinement
# ---------------------------------------------------------------------------

def refine_objects_render(log_axes, quat, center, colors, opt_mask, cam,
                          gt_obj_img, settings, iters: int = OBJ_ITERS,
                          object_weight: float = 0.1,
                          lr_center: float = 0.002, lr_axes: float = 0.01,
                          lr_quat: float = 0.01):
    """MODE=0's refinement: each ellipsoid of `opt_mask` is one Gaussian
    (centre, axes as its scales, rotation, its colour, opacity 0.99),
    rendered through `ops.rasterize.rasterize` at `cam` with `settings`,
    and a masked Adam (eps 1e-15) fits centres, log-axes and quaternions to
    `object_weight` x the L1 of the render against `gt_obj_img` (H,W,3).

    log_axes / center (O,3), quat (O,4) wxyz, colors (O,3), opt_mask (O,):
    tensors on one device. The slots outside `opt_mask` are left out
    before the projection, so an empty slot (maybe behind the camera)
    never reaches the blend, and keep their values. Returns the refined
    (log_axes, normalized quat, center) and the receipts of the renders'
    caps, `clipped_cells` and `tile_dropped`, each the largest over the
    iterations."""
    params = {"center": center, "log_axes": log_axes, "quat": quat}
    lrs = {"center": lr_center, "log_axes": lr_axes, "quat": lr_quat}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    live = torch.nonzero(opt_mask)[:, 0]
    opacity = torch.full((live.numel(),), 0.99, dtype=center.dtype,
                         device=center.device)
    colors = colors[live]
    caps = []
    for it in range(iters if live.numel() else 0):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        out = rasterize(leaves["center"][live],
                        torch.exp(leaves["log_axes"][live]),
                        normalize(leaves["quat"][live]), opacity, colors, cam,
                        settings, with_normal=False, with_n_touched=False)
        caps.append((out["clipped_cells"], out["tile_dropped"]))
        loss = object_weight * torch.abs(out["render"] - gt_obj_img).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        _masked_adam_step(params, grads, m, v, lrs, opt_mask, it + 1)
    receipts = {"clipped_cells": max((int(c) for c, _ in caps), default=0),
                "tile_dropped": max((int(t) for _, t in caps), default=0)}
    return (params["log_axes"], normalize(params["quat"]), params["center"],
            receipts)


# ---------------------------------------------------------------------------
# the object layer over a run
# ---------------------------------------------------------------------------

class ObjectLayer:
    """The objects of a run: `process_frame` associates a frame's
    detections with them (or makes new ones), `obj_id_image` paints the
    matched detections' object index for the new Gaussians to take,
    `optimize_objects` (MODE=1) refines the matched objects,
    `optimize_objects_render` (MODE=0) all of them, and `save` /
    `record_iou` write them out."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.objects: List[MapObject] = []
        self.current_dets: List[dict] = []
        self.rng = np.random.default_rng(2024)
        self.iou_log: dict = {}
        # association variant: iou | qd | iou_qd
        self.association = cfg.get("association", "iou")
        self._K = None
        # MODE=0's render caps, the largest over the run's refinements
        self.render_receipts = {"clipped_cells": 0, "tile_dropped": 0}
        # SLAMSystem installs a `parallel.dp.Mesh` here with
        # `parallel_enabled`: MODE=1's refinement then shards over objects
        self.mesh = None

    def process_frame(self, frame, frame_id: int):
        frame.sync_pose()          # the projections need the host pose
        dets = frame.detections
        if not dets:
            self.current_dets = []
            return
        K = frame.K.astype(np.float64)
        Rt = frame.Rt.astype(np.float64)
        W, H = frame.width, frame.height
        depth = np.asarray(frame.depth)
        mn = float(self.cfg.map.min_depth)
        mx = float(self.cfg.map.max_depth)
        depth = np.where((depth > mn) & (depth < mx), depth, 0.0)
        kept, depth_data = detections_filter(dets, depth, W, H, self.rng)
        if not self.objects:
            for i, det in enumerate(kept):
                if 0.0 < depth_data[i][0] < 15.0:
                    obj = MapObject(det, depth_data[i], K, Rt, frame_id)
                    self.objects.append(obj)
                    det["obj"] = obj
                    det["node_id"] = len(self.objects) - 1
        else:
            proj = occlusions_check(self.objects, K, Rt, W, H)
            match_objects(self.objects, kept, depth_data, proj, frame_id, K,
                          Rt, mode=self.association)
            remove_outliers(self.objects, K, Rt)
        self.current_dets = kept
        self._K = K

    def optimize_objects(self):
        """Refine every object matched in the last processed frame that has
        at least two observations, all at once (`refine_objects`), on the
        layer's device, or with a mesh split over its devices by object
        (`parallel.dp.shard_objects_refine`)."""
        active = []
        for det in self.current_dets:
            obj = det.get("obj")
            if obj is None or not det.get("is_validate", True):
                continue
            if len(obj.bboxes_) < 2:
                continue
            try:
                idx = self.objects.index(obj)
            except ValueError:
                continue
            active.append(idx)
        if not active:
            return
        if len(active) > MAX_OBJECTS:
            TRUNCATION["objects_over_cap"] += len(active) - MAX_OBJECTS
        active = active[:MAX_OBJECTS]
        O = MAX_OBJECTS
        K = self._K
        axes = np.zeros((O, 3), np.float32)
        R = np.tile(np.eye(3, dtype=np.float32), (O, 1, 1))
        center = np.zeros((O, 3), np.float32)
        obs_bbox = np.zeros((O, OBS_CAP, 4), np.float32)
        obs_P = np.zeros((O, OBS_CAP, 3, 4), np.float32)
        obs_valid = np.zeros((O, OBS_CAP), bool)
        opt_mask = np.zeros((O,), bool)
        n_obs = np.ones((O,), np.int64)
        for slot, i in enumerate(active):
            obj = self.objects[i]
            axes[slot] = obj.ellipsoid_.axes_
            R[slot] = obj.ellipsoid_.R_
            center[slot] = obj.ellipsoid_.center_
            n = min(len(obj.bboxes_), OBS_CAP)
            obs_bbox[slot, :n] = np.stack(obj.bboxes_[-n:])
            obs_P[slot, :n] = np.stack([K @ rt for rt in obj.Rts_[-n:]])
            obs_valid[slot, :n] = True
            opt_mask[slot] = True
            n_obs[slot] = n
        # the observation schedule: a random observation a step, the newest
        # after the first quarter of the steps
        rand_idx = self.rng.integers(0, n_obs[None, :], (OBJ_ITERS, O))
        for it in range(OBJ_ITERS // 4 + 1, OBJ_ITERS):
            rand_idx[it] = n_obs - 1
        args = []
        for a in (axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask):
            with trace.span("objects/upload/wait"):
                args.append(torch.as_tensor(a, device=self.device))
        if self.mesh is not None and MAX_OBJECTS % self.mesh.size == 0:
            from ..parallel.dp import shard_objects_refine
            out = shard_objects_refine(self.mesh, *args, rand_idx,
                                       iters=OBJ_ITERS)
        else:
            out = refine_objects(*args, rand_idx)
        host = []
        for x in out:
            with trace.span("objects/readback/wait"):
                host.append(x.cpu().numpy())
        new_axes, new_R, new_center = host
        for slot, i in enumerate(active):
            self.objects[i].ellipsoid_ = Ellipsoid(
                np.abs(new_axes[slot]), new_R[slot], new_center[slot])

    def optimize_objects_render(self, frame, settings) -> int:
        """MODE=0's frame-end pass: every live object (the first
        `MAX_OBJECTS`) refined as one Gaussian against the frame's
        object-colour image, the matched detections' boxes painted with
        their objects' colours on black (`refine_objects_render`, with
        the map's render `settings`), then written back to the objects'
        ellipsoids. Returns the number of objects refined."""
        objs = self.objects[:MAX_OBJECTS]
        if not objs:
            return 0
        O = MAX_OBJECTS
        log_axes = np.zeros((O, 3), np.float32)
        quat = np.tile(np.array([1, 0, 0, 0], np.float32), (O, 1))
        center = np.zeros((O, 3), np.float32)
        colors = np.zeros((O, 3), np.float32)
        opt_mask = np.zeros((O,), bool)
        for i, obj in enumerate(objs):
            e = obj.ellipsoid_
            log_axes[i] = np.log(np.maximum(np.abs(e.axes_), 1e-4))
            quat[i] = rotmat_to_quat(
                torch.as_tensor(e.R_, dtype=torch.float32)).numpy()
            center[i] = e.center_
            colors[i] = np.asarray(obj.color, np.float32) / 255.0
            opt_mask[i] = True
        oid = self.obj_id_image(frame.width, frame.height)
        gt = np.where(oid[..., None] >= 0, colors[np.clip(oid, 0, O - 1)],
                      0.0).astype(np.float32)
        dev = self.device
        new_la, new_q, new_c, receipts = refine_objects_render(
            *(torch.as_tensor(a, device=dev) for a in (
                log_axes, quat, center, colors, opt_mask)),
            frame.render_inputs(dev), torch.as_tensor(gt, device=dev),
            settings,
            object_weight=float(getattr(self.cfg.opt, "object_weight", 0.1)))
        for k, n in receipts.items():
            self.render_receipts[k] = max(self.render_receipts[k], n)
        R = quat_to_rotmat(new_q[:len(objs)]).cpu().numpy().astype(np.float64)
        new_la, new_c = new_la.cpu().numpy(), new_c.cpu().numpy()
        for i, obj in enumerate(objs):
            obj.ellipsoid_ = Ellipsoid(np.exp(new_la[i]).astype(np.float64),
                                       R[i], new_c[i].astype(np.float64))
        return len(objs)

    def obj_id_image(self, width: int, height: int) -> np.ndarray:
        """(H,W) int32 object index of this frame's matched detections (-1 =
        none), larger boxes painted first so that the smaller ones in front
        win. New Gaussians take the index of the pixel they come from."""
        img = np.full((height, width), -1, np.int32)
        dets = [d for d in self.current_dets if d.get("obj") is not None]
        dets.sort(key=lambda d: -bbox_area(d["bbox"]))
        for det in dets:
            try:
                idx = self.objects.index(det["obj"])
            except ValueError:
                continue
            x0, y0, x1, y1 = det["bbox"]
            x0 = max(0, int(x0))
            y0 = max(0, int(y0))
            x1 = min(width, int(np.ceil(x1)))
            y1 = min(height, int(np.ceil(y1)))
            if x1 > x0 and y1 > y0:
                img[y0:y1, x0:x1] = idx
        return img

    def categories_table(self) -> np.ndarray:
        """(MAX_OBJECTS,) int32 category per object slot (-1 = empty)."""
        t = np.full((MAX_OBJECTS,), -1, np.int32)
        for i, obj in enumerate(self.objects[:MAX_OBJECTS]):
            t[i] = int(obj.category_id_)
        return t

    # -- outputs ------------------------------------------------------------
    def record_iou(self, K: np.ndarray) -> dict:
        """Mean projected-box IoU of each object over its stored
        observations, those that overlap at all."""
        out = {}
        for obj in self.objects:
            ious = []
            for bb, Rt in zip(obj.bboxes_, obj.Rts_):
                pe = obj.ellipsoid_.project(K @ Rt)
                iou = bboxes_iou(bb, pe.compute_bbox())
                if iou > 0:
                    ious.append(iou)
            out[obj.id_] = float(np.mean(ious)) if ious else 0.0
        self.iou_log = out
        return out

    def save(self, path: str):
        """`objects.txt`, a line an object in the reference's format:
        `cat cx cy cz qx qy qz qw a1 a2 a3`."""
        from scipy.spatial.transform import Rotation
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "objects.txt"), "w") as f:
            for obj in self.objects:
                c = obj.ellipsoid_.center_
                q = Rotation.from_matrix(obj.ellipsoid_.R_).as_quat()  # xyzw
                a = obj.ellipsoid_.axes_
                f.write(f"{obj.category_id_} {c[0]} {c[1]} {c[2]} "
                        f"{q[0]} {q[1]} {q[2]} {q[3]} "
                        f"{a[0]} {a[1]} {a[2]}\n")

    # -- state --------------------------------------------------------------
    def state_dict(self) -> dict:
        """The layer as numpy and plain values (checkpoints, `convert.py`):
        the objects with their ellipsoids and observations, this frame's
        detections (their object as an index), the generator's state, the
        id counter and the capacity receipts."""
        return layer_state(self.objects, self.current_dets,
                           self.rng.bit_generator.state, self.iou_log,
                           self._K, MapObject._next_id, dict(TRUNCATION))

    def load_state_dict(self, d: dict):
        objs = []
        for o in d["objects"]:
            obj = MapObject.__new__(MapObject)
            obj.id_ = o["id"]
            obj.category_id_ = o["category"]
            obj.color = o["color"]
            obj.last_obs_frame = o["last_obs_frame"]
            obj.last_obs = list(o["last_obs"])
            obj.bboxes_ = [np.array(b, np.float64) for b in o["bboxes"]]
            obj.Rts_ = [np.array(r, np.float64) for r in o["Rts"]]
            obj.ellipsoid_ = Ellipsoid(o["axes"], o["R"], o["center"])
            objs.append(obj)
        self.objects = objs
        self.current_dets = [
            dict(det, obj=None if det["obj"] is None else objs[det["obj"]])
            for det in d["current_dets"]]
        self.rng.bit_generator.state = d["rng"]
        self.iou_log = dict(d["iou_log"])
        self._K = None if d["K"] is None else np.array(d["K"], np.float64)
        MapObject._next_id = max(MapObject._next_id, int(d["next_id"]))
        if d.get("truncation") is not None:
            TRUNCATION.update(d["truncation"])


def layer_state(objects, current_dets, rng_state, iou_log, K, next_id,
                truncation) -> dict:
    """`ObjectLayer.state_dict` of the given parts, which may come from
    either package's layer (their objects have the same attributes)."""
    def index(obj):
        for i, o in enumerate(objects):
            if o is obj:
                return i
        return None

    return {
        "objects": [{
            "id": int(o.id_), "category": o.category_id_, "color": o.color,
            "last_obs_frame": o.last_obs_frame, "last_obs": list(o.last_obs),
            "bboxes": np.array(o.bboxes_, np.float64).reshape(-1, 4),
            "Rts": np.array(o.Rts_, np.float64).reshape(-1, 3, 4),
            "axes": np.array(o.ellipsoid_.axes_, np.float64),
            "R": np.array(o.ellipsoid_.R_, np.float64),
            "center": np.array(o.ellipsoid_.center_, np.float64),
        } for o in objects],
        "current_dets": [dict(det, obj=None if det.get("obj") is None
                              else index(det["obj"]))
                         for det in current_dets],
        "rng": rng_state, "iou_log": dict(iou_log),
        "K": None if K is None else np.array(K, np.float64),
        "next_id": int(next_id), "truncation": truncation,
    }
