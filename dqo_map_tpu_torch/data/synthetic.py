"""Analytic synthetic RGB-D sequences (no files needed).

Serves the role the Replica download serves for the reference: an
end-to-end testbed with exact ground truth. A box room with checkerboard
walls plus a few ellipsoidal "objects"; RGB-D rendered by ray casting, object
detections emitted as projected bounding boxes + ellipses — the same
detection format the reference reads from JSON (`quadrics.py:72-127`).
"""

from __future__ import annotations

import numpy as np

from ..models.cameras import Camera


def _look_at(eye, target, up=(0, -1, 0)):
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


class SyntheticScene:
    """Box room [-2,2]x[-1.5,1.5]x[-2,2] with checkerboard faces and
    `n_objects` colored ellipsoids on the floor."""

    def __init__(self, seed: int = 0, n_objects: int = 3):
        rng = np.random.default_rng(seed)
        self.bounds = np.array([[-2.0, -1.5, -2.0], [2.0, 1.5, 2.0]])
        self.face_colors = rng.uniform(0.2, 0.9, (6, 3))
        self.objects = []
        for i in range(n_objects):
            # placed along the orbit's look-at arc (target ~ (0.9,0.3,1.6)
            # at the sequence start) so detections fire from frame 0
            center = np.array([
                rng.uniform(-0.3, 1.1), rng.uniform(0.1, 0.7),
                rng.uniform(0.7, 1.6),
            ])
            axes = rng.uniform(0.15, 0.35, 3)
            color = rng.uniform(0.1, 1.0, 3)
            self.objects.append({
                "center": center, "axes": axes, "R": np.eye(3),
                "color": color, "category_id": 10 + i,
            })

    # -- ray casting ---------------------------------------------------------
    def render(self, c2w: np.ndarray, K: np.ndarray, width: int, height: int):
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        xs = (np.arange(width) - cx) / fx
        ys = (np.arange(height) - cy) / fy
        dirs_c = np.stack(
            np.broadcast_arrays(xs[None, :], ys[:, None], 1.0), axis=-1
        ).reshape(-1, 3)
        R = c2w[:3, :3]
        o = c2w[:3, 3]
        d = dirs_c @ R.T

        t_best = np.full(d.shape[0], np.inf)
        color = np.zeros((d.shape[0], 3))

        # room faces (ray-box from the inside)
        lo, hi = self.bounds
        for axis in range(3):
            for side, bound in ((0, lo[axis]), (1, hi[axis])):
                denom = d[:, axis]
                safe = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
                t = (bound - o[axis]) / safe
                p = o[None] + t[:, None] * d
                oa = [a for a in range(3) if a != axis]
                inside = (
                    (t > 1e-4)
                    & (p[:, oa[0]] >= lo[oa[0]] - 1e-6) & (p[:, oa[0]] <= hi[oa[0]] + 1e-6)
                    & (p[:, oa[1]] >= lo[oa[1]] - 1e-6) & (p[:, oa[1]] <= hi[oa[1]] + 1e-6)
                )
                hit = inside & (t < t_best)
                base = self.face_colors[axis * 2 + side]
                check = (
                    (np.floor(p[:, oa[0]] * 2) + np.floor(p[:, oa[1]] * 2)) % 2
                )
                c = base[None, :] * (0.7 + 0.3 * check[:, None])
                t_best = np.where(hit, t, t_best)
                color = np.where(hit[:, None], c, color)

        # ellipsoid objects
        for obj in self.objects:
            inv_a = 1.0 / obj["axes"]
            oc = (o - obj["center"]) * inv_a
            dc = d * inv_a[None, :]
            A = np.sum(dc * dc, axis=1)
            B = 2 * np.sum(oc[None, :] * dc, axis=1)
            C = np.sum(oc * oc) - 1.0
            disc = B * B - 4 * A * C
            ok = disc > 0
            sq = np.sqrt(np.maximum(disc, 0))
            t = (-B - sq) / (2 * A)
            hit = ok & (t > 1e-4) & (t < t_best)
            shade = 0.6 + 0.4 * np.clip(-d[:, 1], 0, 1)
            t_best = np.where(hit, t, t_best)
            color = np.where(hit[:, None], obj["color"][None] * shade[:, None],
                             color)

        depth_ray = np.where(np.isfinite(t_best), t_best, 0.0)
        # z-depth (t is along unnormalized dir with z=1 in camera frame)
        depth = depth_ray.reshape(height, width)
        img = np.clip(color, 0, 1).reshape(height, width, 3)
        return img.astype(np.float32), depth.astype(np.float32)

    # -- detections ----------------------------------------------------------
    def detections(self, c2w: np.ndarray, K: np.ndarray, width: int,
                   height: int, noise: float = 2.0, rng=None):
        """Projected-bbox detections in the reference's dict format
        (ref `get_2dim_quarics`, quadrics.py:249-282)."""
        rng = rng or np.random.default_rng(0)
        w2c = np.linalg.inv(c2w)
        P = K @ w2c[:3, :4]
        out = []
        for obj in self.objects:
            Q = np.diag([*(obj["axes"] ** 2), -1.0])
            T = np.eye(4)
            T[:3, :3] = obj["R"]
            T[:3, 3] = obj["center"]
            Qw = T @ Q @ T.T
            Cd = P @ Qw @ P.T
            Cd = 0.5 * (Cd + Cd.T)
            Cd /= -Cd[2, 2]
            center2d = -Cd[:2, 2]
            Tc = np.eye(3)
            Tc[:2, 2] = -center2d
            Cc = Tc @ Cd @ Tc.T
            evals, evecs = np.linalg.eigh(0.5 * (Cc[:2, :2] + Cc[:2, :2].T))
            if (evals <= 0).any():
                continue  # behind camera / degenerate
            ax2 = np.sqrt(np.abs(evals))
            angle = float(np.arctan2(evecs[1, 0], evecs[0, 0]))
            zc = w2c[:3, :3] @ obj["center"] + w2c[:3, 3]
            if zc[2] <= 0.2:
                continue
            c, s = np.cos(angle), np.sin(angle)
            xmax = np.sqrt(ax2[0] ** 2 * c ** 2 + ax2[1] ** 2 * s ** 2)
            ymax = np.sqrt(ax2[0] ** 2 * s ** 2 + ax2[1] ** 2 * c ** 2)
            bb = np.array([
                center2d[0] - xmax, center2d[1] - ymax,
                center2d[0] + xmax, center2d[1] + ymax,
            ]) + rng.normal(0, noise, 4)
            if bb[2] <= 5 or bb[3] <= 5 or bb[0] >= width - 5 or bb[1] >= height - 5:
                continue
            out.append({
                "cat": obj["category_id"],
                "bbox": bb.tolist(),
                "score": 0.9,
                "ellipse": [center2d[0], center2d[1], 2 * ax2[0], 2 * ax2[1], angle],
                "color": (np.asarray(obj["color"]) * 255).astype(int).tolist(),
            })
        return out


def synthetic_sequence(n_frames: int = 30, width: int = 160, height: int = 120,
                       seed: int = 0, n_objects: int = 3,
                       with_detections: bool = False):
    """Orbit trajectory inside the room; returns (scene, [Camera])."""
    scene = SyntheticScene(seed=seed, n_objects=n_objects)
    fx = fy = 0.75 * width
    cx, cy = width / 2, height / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    rng = np.random.default_rng(seed + 1)
    cams = []
    # bounded per-frame motion so frame-to-frame tracking stays feasible
    step = min(np.pi / max(n_frames, 1), 0.03)
    for i in range(n_frames):
        ang = i * step
        eye = np.array([0.9 * np.sin(ang), 0.15 * np.sin(2 * ang), 0.9 * np.cos(ang) * 0.3])
        target = np.array([1.8 * np.sin(ang + 0.5), 0.3, 1.8 * np.cos(ang + 0.5)])
        c2w = _look_at(eye, target)
        img, depth = scene.render(c2w, K, width, height)
        det = (scene.detections(c2w, K, width, height, rng=rng)
               if with_detections else None)
        cams.append(Camera(
            uid=i, c2w=c2w, fx=fx, fy=fy, cx=cx, cy=cy, width=width,
            height=height, image=img, depth=depth, pose_gt=c2w.copy(),
            timestamp=i / 30.0, detections=det,
        ))
    return scene, cams
