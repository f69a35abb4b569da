"""The cells' RGB-D frames, made from the seed on the device.

The scene is the port's synthetic room (`data/synthetic.py`, copied here
so that the benchmark's frames do not change with the program): a box
room [-2,2]x[-1.5,1.5]x[-2,2] with checkerboard faces and a few coloured
ellipsoids on the floor, ray cast in float64 on the card in one batch of
frames at a time. A camera path kind (`slam_bench/paths/<kind>.py`) gives
the poses, the configuration file the camera. Depth is noise-free, as
Replica's renders are, or carries Kinect axial noise (Nguyen, Izadi and
Lovell 2012: sigma_z = 0.0012 + 0.0019 (z - 0.4)^2 m) drawn from the seed.
Detections are the objects' projected boxes and ellipses with Gaussian
box noise, as the port's generator emits them.
"""

from __future__ import annotations

import copy
import importlib

import numpy as np
import torch

# rays cast per batch: a few frames of 1200x680
RAY_BATCH = 1 << 22


def look_at(eye, target, up=(0, -1, 0)) -> np.ndarray:
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


class Scene:
    """The room of `seed`: face colours and `n_objects` ellipsoids, drawn
    as the port's `SyntheticScene` draws them. With `layout_seed` the
    ellipsoids' centres and axes are those of the room of `layout_seed`,
    and only the colours come from `seed`: every seed then has the same
    geometry, so the same work, in other colours."""

    def __init__(self, seed: int, n_objects: int = 3, layout_seed=None):
        rng = np.random.default_rng(seed)
        lrng = rng if layout_seed is None else np.random.default_rng(
            layout_seed)
        self.bounds = np.array([[-2.0, -1.5, -2.0], [2.0, 1.5, 2.0]])
        self.face_colors = rng.uniform(0.2, 0.9, (6, 3))
        if lrng is not rng:
            lrng.uniform(0.2, 0.9, (6, 3))
        self.objects = []
        for i in range(n_objects):
            center = np.array([lrng.uniform(-0.3, 1.1),
                               lrng.uniform(0.1, 0.7),
                               lrng.uniform(0.7, 1.6)])
            axes = lrng.uniform(0.15, 0.35, 3)
            if lrng is not rng:
                lrng.uniform(0.1, 1.0, 3)
            color = rng.uniform(0.1, 1.0, 3)
            self.objects.append({"center": center, "axes": axes,
                                 "R": np.eye(3), "color": color,
                                 "category_id": 10 + i})

    def render(self, c2ws: np.ndarray, K: np.ndarray, width: int, height: int,
               device) -> tuple:
        """Colour (F, H, W, 3) and z-depth (F, H, W), float32 on `device`,
        of the poses `c2ws` (F, 4, 4); a ray that hits nothing has depth 0."""
        f64 = dict(dtype=torch.float64, device=device)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        xs = (torch.arange(width, **f64) - cx) / fx
        ys = (torch.arange(height, **f64) - cy) / fy
        dirs_c = torch.stack(torch.broadcast_tensors(
            xs[None, :], ys[:, None], torch.ones((), **f64)), dim=-1)
        dirs_c = dirs_c.reshape(-1, 3)
        c2w = torch.as_tensor(np.asarray(c2ws), **f64)
        d = torch.einsum("pk,fjk->fpj", dirs_c, c2w[:, :3, :3])
        o = c2w[:, None, :3, 3].expand_as(d)
        d, o = d.reshape(-1, 3), o.reshape(-1, 3)
        t_best = torch.full((d.shape[0],), float("inf"), **f64)
        color = torch.zeros((d.shape[0], 3), **f64)
        lo, hi = self.bounds
        for axis in range(3):
            for side, bound in ((0, lo[axis]), (1, hi[axis])):
                denom = d[:, axis]
                safe = torch.where(denom.abs() < 1e-9, 1e-9, denom)
                t = (bound - o[:, axis]) / safe
                p = o + t[:, None] * d
                oa = [a for a in range(3) if a != axis]
                inside = ((t > 1e-4)
                          & (p[:, oa[0]] >= lo[oa[0]] - 1e-6)
                          & (p[:, oa[0]] <= hi[oa[0]] + 1e-6)
                          & (p[:, oa[1]] >= lo[oa[1]] - 1e-6)
                          & (p[:, oa[1]] <= hi[oa[1]] + 1e-6))
                hit = inside & (t < t_best)
                base = torch.as_tensor(self.face_colors[axis * 2 + side], **f64)
                check = torch.remainder(torch.floor(p[:, oa[0]] * 2)
                                        + torch.floor(p[:, oa[1]] * 2), 2)
                c = base[None, :] * (0.7 + 0.3 * check[:, None])
                t_best = torch.where(hit, t, t_best)
                color = torch.where(hit[:, None], c, color)
        for obj in self.objects:
            inv_a = torch.as_tensor(1.0 / obj["axes"], **f64)
            center = torch.as_tensor(obj["center"], **f64)
            oc = (o - center) * inv_a
            dc = d * inv_a
            A = (dc * dc).sum(1)
            B = 2 * (oc * dc).sum(1)
            C = (oc * oc).sum(1) - 1.0
            disc = B * B - 4 * A * C
            sq = torch.sqrt(torch.clamp(disc, min=0))
            t = (-B - sq) / (2 * A)
            hit = (disc > 0) & (t > 1e-4) & (t < t_best)
            shade = 0.6 + 0.4 * torch.clamp(-d[:, 1], 0, 1)
            ocol = torch.as_tensor(obj["color"], **f64)
            t_best = torch.where(hit, t, t_best)
            color = torch.where(hit[:, None], ocol[None] * shade[:, None],
                                color)
        depth = torch.where(torch.isfinite(t_best), t_best, 0.0)
        n = c2w.shape[0]
        img = torch.clamp(color, 0, 1).reshape(n, height, width, 3)
        return img.float(), depth.reshape(n, height, width).float()

    def detections(self, c2w: np.ndarray, K: np.ndarray, width: int,
                   height: int, noise: float, rng) -> list:
        """Projected-box detections in the reference's dict format, as the
        port's `SyntheticScene.detections` makes them."""
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
                continue
            ax2 = np.sqrt(np.abs(evals))
            angle = float(np.arctan2(evecs[1, 0], evecs[0, 0]))
            zc = w2c[:3, :3] @ obj["center"] + w2c[:3, 3]
            if zc[2] <= 0.2:
                continue
            c, s = np.cos(angle), np.sin(angle)
            xmax = np.sqrt(ax2[0] ** 2 * c ** 2 + ax2[1] ** 2 * s ** 2)
            ymax = np.sqrt(ax2[0] ** 2 * s ** 2 + ax2[1] ** 2 * c ** 2)
            bb = np.array([center2d[0] - xmax, center2d[1] - ymax,
                           center2d[0] + xmax, center2d[1] + ymax]) \
                + rng.normal(0, noise, 4)
            if (bb[2] <= 5 or bb[3] <= 5 or bb[0] >= width - 5
                    or bb[1] >= height - 5):
                continue
            out.append({
                "cat": obj["category_id"], "bbox": bb.tolist(), "score": 0.9,
                "ellipse": [center2d[0], center2d[1], 2 * ax2[0], 2 * ax2[1],
                            angle],
                "color": (np.asarray(obj["color"]) * 255).astype(int).tolist()})
        return out


def kinect_sigma(z: torch.Tensor) -> torch.Tensor:
    """Axial noise of a Kinect at depth z (m), Nguyen et al. 2012."""
    return 0.0012 + 0.0019 * (z - 0.4) ** 2


def camera_path(path: dict, n: int) -> np.ndarray:
    """(n, 4, 4) poses of the path kind `path["kind"]`
    (`slam_bench/paths/<kind>.py`) with the path's parameters."""
    mod = importlib.import_module(f"slam_bench.paths.{path['kind']}")
    return np.stack([look_at(*mod.eye_target(i, path)) for i in range(n)])


class FramePool:
    """A cell's frames: host arrays (as the port's `Camera` takes them),
    made on `device` from the seed. `frame(i)` is the pool's frame
    `i % len`, its ground-truth pose and its detections."""

    def __init__(self, camera: dict, traffic: dict, seed: int, device):
        self.width, self.height = int(camera["width"]), int(camera["height"])
        self.fx, self.fy = float(camera["fx"]), float(camera["fy"])
        self.cx, self.cy = float(camera["cx"]), float(camera["cy"])
        K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                      [0, 0, 1]], np.float64)
        n = int(traffic["pool_frames"])
        det = traffic.get("detections")
        self.scene = Scene(seed, int(det["objects"]) if det else 3,
                           traffic.get("layout_seed"))
        self.poses = camera_path(traffic["path"], n)
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = traffic.get("depth_noise")
        per = max(1, RAY_BATCH // (self.width * self.height))
        self.images = np.empty((n, self.height, self.width, 3), np.float32)
        self.depths = np.empty((n, self.height, self.width), np.float32)
        for a in range(0, n, per):
            img, depth = self.scene.render(self.poses[a:a + per], K,
                                           self.width, self.height, device)
            if noise == "kinect":
                z = torch.randn(depth.shape, generator=gen, device=device)
                depth = torch.where(depth > 0,
                                    depth + kinect_sigma(depth) * z, 0.0)
            elif noise is not None:
                raise ValueError(f"unknown depth noise {noise!r}")
            self.images[a:a + per] = img.cpu().numpy()
            self.depths[a:a + per] = depth.cpu().numpy()
        rng = np.random.default_rng(seed + 1)
        self.detections = [
            self.scene.detections(c2w, K, self.width, self.height,
                                  float(det["box_noise_px"]), rng)
            if det else None for c2w in self.poses]

    def __len__(self) -> int:
        return len(self.poses)

    def camera(self, i: int, camera_cls):
        """Frame `i` (the pool's `i % len`) as a fresh `camera_cls`: the
        tracker sets the pose of the object it is given."""
        j = i % len(self)
        return camera_cls(
            uid=i, c2w=self.poses[j].copy(), fx=self.fx, fy=self.fy,
            cx=self.cx, cy=self.cy, width=self.width, height=self.height,
            image=self.images[j], depth=self.depths[j],
            pose_gt=self.poses[j].copy(), timestamp=i / 30.0,
            detections=copy.deepcopy(self.detections[j]))
