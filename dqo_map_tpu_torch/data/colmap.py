"""COLMAP sparse-reconstruction parsers (binary + text).

Equivalent of the reference's `scene/colmap_loader.py`, rewritten from
the documented COLMAP file formats: `cameras.bin/.txt` and
`images.bin/.txt` under `sparse/0/`. Only what the dataset reader needs —
intrinsics per camera and world->camera poses per image.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

# model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _intrinsics(model: str, params) -> Tuple[float, float, float, float]:
    p = np.asarray(params, np.float64)
    if model == "SIMPLE_PINHOLE" or model.startswith("SIMPLE_RADIAL") \
            or model == "RADIAL" or model == "RADIAL_FISHEYE" or model == "FOV":
        return p[0], p[0], p[1], p[2]
    # PINHOLE / OPENCV family: fx fy cx cy ...
    return p[0], p[1], p[2], p[3]


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_bin(path: str) -> Dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            fx, fy, cx, cy = _intrinsics(name, params)
            cams[cid] = dict(model=name, width=int(w), height=int(h),
                             fx=fx, fy=fy, cx=cx, cy=cy, params=params)
    return cams


def read_cameras_txt(path: str) -> Dict[int, dict]:
    cams = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cid = int(parts[0])
        name = parts[1]
        w, h = int(parts[2]), int(parts[3])
        params = list(map(float, parts[4:]))
        fx, fy, cx, cy = _intrinsics(name, params)
        cams[cid] = dict(model=name, width=w, height=h, fx=fx, fy=fy,
                         cx=cx, cy=cy, params=params)
    return cams


def read_images_bin(path: str) -> Dict[int, dict]:
    imgs = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = struct.unpack("<4d", f.read(32))
            t = struct.unpack("<3d", f.read(24))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)                 # xy (2 f64) + point3D id (i64)
            imgs[iid] = dict(qvec=np.asarray(q), tvec=np.asarray(t),
                             camera_id=cam_id, name=name.decode())
    return imgs


def read_images_txt(path: str) -> Dict[int, dict]:
    imgs = {}
    lines = [ln for ln in open(path)
             if not ln.startswith("#") and ln.strip()]
    for i in range(0, len(lines), 2):        # every image takes 2 lines
        parts = lines[i].split()
        iid = int(parts[0])
        q = np.array(list(map(float, parts[1:5])))
        t = np.array(list(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        imgs[iid] = dict(qvec=q, tvec=t, camera_id=cam_id, name=name)
    return imgs


def load_colmap_sparse(sparse_dir: str):
    """Returns (cameras dict, images dict) from bin or txt files."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs


def image_c2w(img: dict) -> np.ndarray:
    """COLMAP stores world->camera (qvec, tvec); return camera->world."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec_to_rotmat(img["qvec"])
    w2c[:3, 3] = img["tvec"]
    return np.linalg.inv(w2c)
