"""Oriented 3D bounding-box IoU / AP metrics and per-object mesh
evaluation for object maps (counterpart of `dqo_map_tpu/eval/obj_eval.py`).

Boxes as `cat tx ty tz qx qy qz qw a1 a2 a3` rows (the reference's
`eval_obj/compute3Dbbox/room_gt.txt` format), IoU by the convex hull of
the intersection of two oriented boxes, plus per-category accuracy and AP
summaries: numpy and scipy, copied from the JAX package. The per-object
mesh evaluation renders each object's Gaussians through the port's
renderer (the blend kernel K1 on the card), fuses them with `ops/tsdf.py`
and meshes them with `ops/marching.py`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from scipy.spatial import ConvexHull
from scipy.spatial.transform import Rotation

from ..ops.marching import (marching_tetrahedra, sample_mesh_points,
                            write_mesh_ply)
from ..ops.tsdf import fuse_frames
from ..utils.ply import read_mesh_ply
from .evaluate import eval_pcd


class Box3D:
    def __init__(self, category: int, translation, quat_xyzw, axes):
        self.category = int(category)
        self.t = np.asarray(translation, np.float64)
        self.R = Rotation.from_quat(quat_xyzw).as_matrix()
        self.axes = np.asarray(axes, np.float64)   # half-extents

    @property
    def vertices(self) -> np.ndarray:
        corners = np.array([
            [sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
        ], np.float64) * self.axes
        return corners @ self.R.T + self.t

    @property
    def volume(self) -> float:
        return float(np.prod(2 * self.axes))


def _hull_volume(points: np.ndarray) -> float:
    try:
        return float(ConvexHull(points).volume)
    except Exception:
        return 0.0


def box_iou(a: Box3D, b: Box3D, samples: int = 0) -> float:
    """Oriented-box IoU via half-space clipping (exact for convex boxes)."""
    # Sample-free: clip b's vertices + edge intersections against a's slabs
    # using the Sutherland-Hodgman style polytope clip in a's frame.
    pts = b.vertices
    # transform into a's frame
    local = (pts - a.t) @ a.R
    poly = _clip_box(local, a.axes)
    if poly is None or len(poly) < 4:
        return 0.0
    inter = _hull_volume(poly)
    union = a.volume + b.volume - inter
    return inter / union if union > 0 else 0.0


def _clip_box(points: np.ndarray, half: np.ndarray):
    """Clip the convex hull of `points` against the axis-aligned slab box
    [-half, half], returning intersection vertices."""
    try:
        hull = ConvexHull(points)
    except Exception:
        return None
    # collect hull facet planes (outward normals)
    planes = []
    for eq in hull.equations:           # n.x + d <= 0 inside
        planes.append((eq[:3], eq[3]))
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            planes.append((n, -half[axis]))
    # vertex enumeration: intersect all triples of planes, keep feasible
    verts = []
    P = len(planes)
    for i in range(P):
        for j in range(i + 1, P):
            for k in range(j + 1, P):
                A = np.stack([planes[i][0], planes[j][0], planes[k][0]])
                bvec = -np.array([planes[i][1], planes[j][1], planes[k][1]])
                if abs(np.linalg.det(A)) < 1e-10:
                    continue
                x = np.linalg.solve(A, bvec)
                ok = all(np.dot(n, x) + d <= 1e-7 for n, d in planes)
                if ok:
                    verts.append(x)
    if not verts:
        return None
    return np.unique(np.round(np.asarray(verts), 9), axis=0)


def load_box_file(path: str) -> List[Box3D]:
    """Parse `cat tx ty tz qx qy qz qw a1 a2 a3` rows
    (ref eval_obj/compute3Dbbox/room_gt.txt)."""
    boxes = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = list(map(float, line.split()))
            boxes.append(Box3D(v[0], v[1:4], v[4:8], v[8:11]))
    return boxes


def evaluate_boxes(pred: List[Box3D], gt: List[Box3D],
                   iou_thresholds=(0.25, 0.5)) -> dict:
    """Greedy category-matched IoU + accuracy at thresholds
    (ref eval_obj metrics: Accuracy / compute_ap_curve)."""
    matches = []
    used = set()
    for p in pred:
        best = (0.0, None)
        for gi, g in enumerate(gt):
            if gi in used or g.category != p.category:
                continue
            iou = box_iou(p, g)
            if iou > best[0]:
                best = (iou, gi)
        if best[1] is not None:
            used.add(best[1])
        matches.append(best[0])
    matches = np.asarray(matches) if matches else np.zeros(0)
    out = {
        "mean_iou": float(matches.mean()) if len(matches) else 0.0,
        "n_pred": len(pred), "n_gt": len(gt),
    }
    for thr in iou_thresholds:
        tp = float((matches >= thr).sum())
        out[f"accuracy@{thr}"] = tp / max(len(gt), 1)
        out[f"precision@{thr}"] = tp / max(len(pred), 1)
    return out


def compute_ap_curve(pred: List[Box3D], gt: List[Box3D],
                     thresholds=None, scores=None) -> dict:
    """Average-precision curve over a dense IoU-threshold sweep (the
    reference's Objectron-style `compute_ap_curve`, eval_obj metrics pyc).

    Without per-box confidences (the saved box format carries none), each
    threshold's AP reduces to recall under greedy category-matched IoU
    assignment — the Objectron convention for single-shot detections. When
    `scores` (len == pred) IS given, AP at each threshold is the 11-point
    interpolated area under the score-ranked precision/recall curve.
    Returns {"thresholds": [...], "ap": [...], "mean_ap": float}.
    """
    if thresholds is None:
        thresholds = [round(0.05 * i, 2) for i in range(1, 11)]  # .05..0.50
    order = (np.argsort(-np.asarray(scores)) if scores is not None
             else np.arange(len(pred)))
    aps = []
    for thr in thresholds:
        used = set()
        tp_flags = []
        for pi in order:
            p = pred[int(pi)]
            best = (0.0, None)
            for gi, g in enumerate(gt):
                if gi in used or g.category != p.category:
                    continue
                iou = box_iou(p, g)
                if iou > best[0]:
                    best = (iou, gi)
            hit = best[0] >= thr and best[1] is not None
            if hit:
                used.add(best[1])
            tp_flags.append(hit)
        tp = np.cumsum(np.asarray(tp_flags, np.float64))
        n_gt = max(len(gt), 1)
        if scores is None:
            aps.append(float(tp[-1] / n_gt) if len(tp) else 0.0)
        else:
            rank = np.arange(1, len(tp) + 1)
            prec = tp / rank
            rec = tp / n_gt
            ap = 0.0
            for r in np.linspace(0, 1, 11):
                mask = rec >= r
                ap += (float(prec[mask].max()) if mask.any() else 0.0) / 11
            aps.append(ap)
    return {"thresholds": list(thresholds), "ap": aps,
            "mean_ap": float(np.mean(aps)) if aps else 0.0}


def object_center_errors(pred: List[Box3D], gt: List[Box3D]) -> dict:
    errs = []
    for p in pred:
        ds = [np.linalg.norm(p.t - g.t) for g in gt if g.category == p.category]
        if ds:
            errs.append(min(ds))
    return {
        "mean_center_err_cm": float(np.mean(errs) * 100) if errs else np.nan,
        "n_matched": len(errs),
    }


# ---------------------------------------------------------------------------
# per-object mesh evaluation (the reference's `metric_obj.py`: each object's
# reconstruction against its GT mesh, accuracy / completion at 1 cm)
# ---------------------------------------------------------------------------

def per_object_mesh_eval(mapping, cameras, gt_points_by_obj: dict,
                         voxel_size: float = 0.01,
                         dist_thresh: float = 0.01,
                         min_gaussians: int = 30,
                         max_frames: int = 12,
                         mesh_out_dir: Optional[str] = None) -> dict:
    """Per-object surface metrics from the live map of `mapping`.

    For each object id: the map cut to that object's Gaussians (`obj_id`)
    is rendered at up to `max_frames` of `cameras` spread over the
    sequence, its covered depth fused into a TSDF of `voxel_size` voxels,
    meshed by marching tetrahedra, the mesh sampled, and the samples
    scored (`eval_pcd` at `dist_thresh`) against the object's GT surface
    points. Renders, fusion and scoring run on the mapping's device.

    gt_points_by_obj: {obj_id: (M,3) GT surface points, world frame}.
    Returns {obj_id: metrics}; objects without GT, or with fewer than
    `min_gaussians` Gaussians, are left out."""
    from ..slam.renderer import render_state

    state, dev = mapping.state, mapping.device
    obj_ids = state.obj_id.cpu().numpy()
    status = state.status.cpu().numpy()
    results = {}
    if len(cameras) > max_frames:
        idx = np.linspace(0, len(cameras) - 1, max_frames).astype(int)
        cameras = [cameras[i] for i in idx]

    for oid, gt_points in sorted(gt_points_by_obj.items()):
        mask = (obj_ids == int(oid)) & (status != 0)
        if mask.sum() < min_gaussians:
            continue
        # the object alone: every other Gaussian's status zeroed, so the
        # "global" subset renders just this object
        obj_state = state.replace(status=torch.where(
            torch.as_tensor(mask, device=dev), state.status, 0))
        depths, colors = [], []
        with torch.no_grad():
            for cam in cameras:
                out = render_state(obj_state, cam.render_inputs(dev),
                                   mapping.settings, "global")
                covered = out["depth_index_map"] >= 0
                depths.append(torch.where(covered, out["depth"], 0.0))
                colors.append(out["render"])
        vol = fuse_frames(cameras, depths, colors, voxel_size=voxel_size,
                          margin=8 * voxel_size, device=dev)
        verts, faces, _ = marching_tetrahedra(
            vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy(),
            vol.origin.cpu().numpy(), float(vol.voxel))
        if len(faces) == 0:
            results[int(oid)] = {"error": "empty mesh",
                                 "n_gaussians": int(mask.sum())}
            continue
        pts = sample_mesh_points(verts, faces, 100_000, seed=0)
        m = eval_pcd(pts, np.asarray(gt_points, np.float32),
                     threshold=dist_thresh, device=dev)
        m["n_gaussians"] = int(mask.sum())
        m["n_mesh_verts"] = int(len(verts))
        results[int(oid)] = m
        if mesh_out_dir:
            import os
            os.makedirs(mesh_out_dir, exist_ok=True)
            write_mesh_ply(os.path.join(mesh_out_dir, f"obj_{oid}.ply"),
                           verts, faces)
    return results


def load_gt_mesh_points(path: str, n: int = 200_000, seed: int = 0):
    """Surface points of a GT triangle-mesh PLY, sampled by area; a point
    cloud PLY gives its vertices."""
    verts, faces = read_mesh_ply(path)
    if faces is None or len(faces) == 0:
        return verts
    return sample_mesh_points(verts, faces, n, seed=seed)
