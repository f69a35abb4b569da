"""Camera model (counterpart of `dqo_map_tpu/models/cameras.py`).

A Camera is host-side: numpy poses and image arrays. `render_inputs(device)`
packs what the rasterizer needs as float32 tensors on `device`. Plain
column-vector math: `w2c` and `K` are used as they are.

A camera may also hold its pose as a tensor on the device
(`set_pose_device`), which the tracker's pose chain leaves there: the
render inputs are then computed on the device, without a readback, and
host-side consumers call `sync_pose()` first, which reads the host copy
the tracker queued with the pose.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_projection_matrix(znear: float, zfar: float, fovX: float, fovY: float) -> np.ndarray:
    """Perspective NDC projection, z in [0,1]."""
    tanY = math.tan(fovY / 2)
    tanX = math.tan(fovX / 2)
    top = tanY * znear
    right = tanX * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass
class Camera:
    uid: int
    c2w: np.ndarray                      # (4,4) camera-to-world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    image: Optional[np.ndarray] = None   # (H,W,3) float32 in [0,1]
    depth: Optional[np.ndarray] = None   # (H,W) float32 meters
    pose_gt: np.ndarray = field(default_factory=lambda: np.eye(4))
    timestamp: float = 0.0
    depth_scale: float = 1.0
    semantics: Optional[np.ndarray] = None    # (H,W,3)
    instance: Optional[np.ndarray] = None     # (H,W,3)
    object_img: Optional[np.ndarray] = None
    detections: Optional[list] = None         # per-frame detection dicts
    znear: float = 0.01
    zfar: float = 100.0
    c2w_dev: Optional[torch.Tensor] = None    # device-side pose
    c2w_host: Optional[object] = None         # its queued host copy

    # --- pose ---------------------------------------------------------------
    @property
    def w2c(self) -> np.ndarray:
        return np.linalg.inv(self.c2w).astype(np.float32)

    @property
    def R(self) -> np.ndarray:
        """W2C rotation, stored transposed (the reference's Camera.R)."""
        return self.w2c[:3, :3].T

    @property
    def T(self) -> np.ndarray:
        return self.w2c[:3, 3]

    @property
    def Rt(self) -> np.ndarray:
        """(3,4) world -> camera [R|t], the object layer's projection pose."""
        return self.w2c[:3, :4]

    @property
    def camera_center(self) -> np.ndarray:
        return self.c2w[:3, 3]

    @property
    def FoVx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def FoVy(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float32
        )

    @property
    def projection_matrix(self) -> np.ndarray:
        return get_projection_matrix(self.znear, self.zfar, self.FoVx, self.FoVy)

    @property
    def full_proj(self) -> np.ndarray:
        """(4,4) world -> NDC."""
        return (self.projection_matrix @ self.w2c).astype(np.float32)

    def update_pose(self, pose_c2w: np.ndarray) -> None:
        self.c2w = np.asarray(pose_c2w, dtype=np.float64)
        self.c2w_dev = self.c2w_host = None

    def set_pose_device(self, c2w_dev: torch.Tensor, host) -> None:
        """Adopt a device-side pose: render inputs are then computed on the
        device; host-side consumers call `sync_pose()` first. `host` is its
        queued host copy, whose `numpy()` waits for that copy alone
        (`utils/host_copy.py::HostCopy`)."""
        self.c2w_dev, self.c2w_host = c2w_dev, host

    def sync_pose(self) -> None:
        """Copy the device pose's host copy into the numpy `c2w`."""
        if self.c2w_dev is not None:
            self.c2w = np.asarray(self.c2w_host.numpy(), np.float64)
            self.c2w_dev = self.c2w_host = None

    def resized(self, scale: float) -> "Camera":
        """A copy at `scale` of the size, the images sampled nearest; the
        camera itself at scale 1."""
        if scale == 1.0:
            return self
        H2, W2 = int(self.height * scale), int(self.width * scale)
        ys = (np.arange(H2) / scale).astype(np.int64).clip(0, self.height - 1)
        xs = (np.arange(W2) / scale).astype(np.int64).clip(0, self.width - 1)

        def rs(img):
            return None if img is None else img[ys][:, xs]

        return Camera(
            uid=self.uid, c2w=self.c2w, fx=self.fx * scale, fy=self.fy * scale,
            cx=self.cx * scale, cy=self.cy * scale, width=W2, height=H2,
            image=rs(self.image), depth=rs(self.depth), pose_gt=self.pose_gt,
            timestamp=self.timestamp, depth_scale=self.depth_scale,
            semantics=rs(self.semantics), instance=rs(self.instance),
            object_img=rs(self.object_img), detections=self.detections)

    # --- packing for the rasterizer -----------------------------------------
    def render_inputs(self, device="cuda") -> dict:
        """float32 tensors on `device`: w2c, cam_pos, full_proj, K and the
        half-FoV tangents. With a device pose everything is computed there,
        in float32, as the reference does on its device. The tangents stay
        host float32 scalars."""
        tx = np.float32(math.tan(self.FoVx * 0.5))
        ty = np.float32(math.tan(self.FoVy * 0.5))
        K = torch.as_tensor(self.K, device=device)
        if self.c2w_dev is not None:
            c2w = self.c2w_dev.to(device=device, dtype=torch.float32)
            w2c = torch.linalg.inv(c2w)
            proj = torch.as_tensor(self.projection_matrix, device=device)
            return {
                "w2c": w2c, "cam_pos": c2w[:3, 3], "full_proj": proj @ w2c,
                "K": K, "tan_fovx": tx, "tan_fovy": ty,
            }
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                        device=device)
        return {
            "w2c": f32(self.w2c),
            "cam_pos": f32(self.camera_center),
            "full_proj": f32(self.full_proj),
            "K": K,
            "tan_fovx": tx,
            "tan_fovy": ty,
        }
