"""Dataset readers: Replica, TUM, RO-MAP/Cube-Diorama, ScanNet++-style,
COLMAP, Blender, synthetic (a copy of `dqo_map_tpu/data/readers.py` that
builds the port's `Camera`).

Equivalent of `scene/dataset_readers.py` + `scene/__init__.py` +
`utils/camera_utils.py`. All readers emit `Camera` objects with
first-frame-relative ground-truth poses (the reference normalizes poses by
the first frame, `dataset_readers.py:908-916`). The "RO-MAP" type the
reference declares but never wires into its dispatch table
(`scene/__init__.py:25-74` — a latent bug) is supported here.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np

from ..models.cameras import Camera
from ..utils.png import read_png
from .detections import load_detection_json


def _pil_image(path: str, why: str):
    """`PIL.Image.open(path)`, or an `ImportError` that names the file and
    why it needs PIL where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {why} needs PIL, which is not "
                          "installed") from e
    return Image.open(path)


def _load_image(path: str, size=None) -> np.ndarray:
    """A colour image as float32 in [0, 1]. A PNG at its own size is
    decoded by `utils/png.py`; a JPEG, or a resize to another (W, H)
    `size`, goes through PIL."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if size is None or tuple(size) == (img.shape[1], img.shape[0]):
            return img.astype(np.float32) / 255.0
        why = f"resizing a {img.shape[1]}x{img.shape[0]} frame to {size}"
    else:
        why = "reading a JPEG (or other non-PNG) frame"
    img = _pil_image(path, why)
    if size is not None:
        img = img.resize(size)
    return np.asarray(img, np.float32) / 255.0


def _load_depth(path: str, scale: float) -> np.ndarray:
    """A depth image in metres: its samples over `scale`."""
    if path.lower().endswith(".png"):
        return read_png(path).astype(np.float32) / scale
    return np.asarray(_pil_image(path, "reading a non-PNG depth frame"),
                      np.float32) / scale


def _relative_poses(poses: List[np.ndarray]) -> List[np.ndarray]:
    inv0 = np.linalg.inv(poses[0])
    return [inv0 @ p for p in poses]


def read_replica(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
                 json_path: Optional[str] = None, use_object=False,
                 use_semantics=False, preload=True):
    """(ref `readReplicaSceneInfo`, dataset_readers.py:800-882).

    use_semantics loads `semantic_colors/semantic_color*.png` per frame
    (ref dataset_readers.py:820-822,934-944); the semantic color image also
    serves as the instance/object image, as in the reference
    (`object_img = semantic_copy`, dataset_readers.py:941-944)."""
    color_paths = sorted(glob.glob(f"{datapath}/results/frame*.jpg"))
    depth_paths = sorted(glob.glob(f"{datapath}/results/depth*.png"))
    sem_paths = (sorted(glob.glob(
        f"{datapath}/semantic_colors/semantic_color*.png"))
        if use_semantics else [])
    n_img = len(color_paths)
    with open(os.path.join(datapath, "../cam_params.json"), "r") as f:
        config = json.load(f)["camera"]
    fx, cx, cy = config["fx"], config["cx"], config["cy"]
    fy = config.get("fy", fx)
    depth_scale = config["scale"]

    poses = []
    with open(f"{datapath}/traj.txt", "r") as f:
        lines = f.readlines()
    for i in range(n_img):
        poses.append(np.array(list(map(float, lines[i].split()))).reshape(4, 4))
    poses = _relative_poses(poses)

    if frame_num == -1:
        indices = list(range(n_img))
    else:
        indices = list(range(min(n_img, frame_num)))
    indices = [frame_start + i * (frame_step + 1) for i in indices
               if frame_start + i * (frame_step + 1) < n_img]

    det_frames = None
    if use_object and json_path:
        probe = _load_depth(depth_paths[0], depth_scale)
        _, det_frames = load_detection_json(json_path, probe.shape[1],
                                            probe.shape[0])

    cams = []
    for uid, idx in enumerate(indices):
        depth = _load_depth(depth_paths[idx], depth_scale)
        H, W = depth.shape
        img = _load_image(color_paths[idx], (W, H))
        sem = None
        if sem_paths and idx < len(sem_paths):
            sem = _load_image(sem_paths[idx], (W, H))[..., :3]
        cams.append(Camera(
            uid=uid, c2w=poses[idx], fx=fx, fy=fy, cx=cx, cy=cy,
            width=W, height=H, image=img, depth=depth,
            pose_gt=poses[idx].copy(), timestamp=idx / 30.0,
            depth_scale=depth_scale,
            detections=det_frames[idx] if det_frames else None,
            semantics=sem, instance=sem,
        ))
    return cams


def read_ours(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
              eval_=False, crop_edge=0, scannetpp=False, **_):
    """ScanNet++ / self-captured "ours" layout (ref `readOursSceneInfo`,
    dataset_readers.py:1040-1145): color/*.jpg + depth/*.png + pose/*.txt
    (one 4x4 per frame) + intrinsic/intrinsic_depth.txt; optional
    eval_list.txt subset and *_eval dirs for held-out evaluation."""
    suffix = "_eval" if eval_ else ""
    key = lambda x: int(os.path.basename(x).split(".")[0])
    color_paths = sorted(glob.glob(f"{datapath}/color{suffix}/*.jpg")
                         + glob.glob(f"{datapath}/color{suffix}/*.png"),
                         key=key)
    depth_paths = sorted(glob.glob(f"{datapath}/depth{suffix}/*.png"), key=key)
    pose_paths = sorted(glob.glob(f"{datapath}/pose{suffix}/*.txt"), key=key)
    n_img = min(len(color_paths), len(depth_paths), len(pose_paths))
    poses = [np.loadtxt(pose_paths[i]).reshape(4, 4) for i in range(n_img)]

    if eval_:
        lst = os.path.join(datapath, "eval_list.txt")
        if os.path.exists(lst):
            keep = set(np.loadtxt(lst, dtype=np.int64).reshape(-1).tolist())
            sel0 = [i for i in range(n_img) if i in keep]
            color_paths = [color_paths[i] for i in sel0]
            depth_paths = [depth_paths[i] for i in sel0]
            poses = [poses[i] for i in sel0]
            n_img = len(poses)
        # eval poses are normalized by the TRAIN first frame (ref 1092-1096)
        train_pose0 = sorted(glob.glob(f"{datapath}/pose/*.txt"), key=key)
        if train_pose0:
            inv0 = np.linalg.inv(np.loadtxt(train_pose0[0]).reshape(4, 4))
            poses = [inv0 @ p for p in poses]
    else:
        poses = _relative_poses(poses)

    K = np.loadtxt(os.path.join(datapath, "intrinsic",
                                "intrinsic_depth.txt"))
    K = np.atleast_2d(K)[:3, :3]           # 3x3 or 4x4 ScanNet-style file
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    sel = list(range(n_img)) if frame_num == -1 else list(range(frame_num))
    sel = [frame_start + i * (frame_step + 1) for i in sel
           if frame_start + i * (frame_step + 1) < n_img]
    if eval_:
        sel = list(range(n_img))

    cams = []
    for uid, s in enumerate(sel):
        depth = _load_depth(depth_paths[s], 1000.0)
        H, W = depth.shape
        img = _load_image(color_paths[s], (W, H))
        cxs, cys = cx, cy
        if crop_edge > 0:
            img = img[crop_edge:-crop_edge, crop_edge:-crop_edge]
            depth = depth[crop_edge:-crop_edge, crop_edge:-crop_edge]
            H, W = depth.shape
            cxs, cys = cx - crop_edge, cy - crop_edge
        cams.append(Camera(
            uid=uid, c2w=poses[s], fx=fx, fy=fy, cx=cxs, cy=cys,
            width=W, height=H, image=img, depth=depth,
            pose_gt=poses[s].copy(), timestamp=(s + 1) / 30.0,
            depth_scale=1000.0,
        ))
    return cams


def read_tum(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
             max_dt=0.08, crop_edge=0, **_):
    """(ref `readTumSceneInfo`, dataset_readers.py:549-718): associate
    rgb/depth/groundtruth lists by timestamp. `crop_edge` trims distorted
    borders like the reference (dataset_readers.py:609,685)."""

    def read_list(p):
        out = []
        with open(p) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.strip().split()
                if parts:
                    out.append(parts)
        return out

    rgb_list = read_list(os.path.join(datapath, "rgb.txt"))
    depth_list = read_list(os.path.join(datapath, "depth.txt"))
    gt_list = read_list(os.path.join(datapath, "groundtruth.txt"))
    t_rgb = np.array([float(r[0]) for r in rgb_list])
    t_depth = np.array([float(r[0]) for r in depth_list])
    t_gt = np.array([float(r[0]) for r in gt_list])

    assoc = []
    for i, t in enumerate(t_rgb):
        j = int(np.argmin(np.abs(t_depth - t)))
        k = int(np.argmin(np.abs(t_gt - t)))
        if abs(t_depth[j] - t) < max_dt and abs(t_gt[k] - t) < max_dt:
            assoc.append((i, j, k))

    from scipy.spatial.transform import Rotation as Rot
    # standard TUM intrinsics (freiburg1); per-sequence yaml can override
    intr = {"fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3}
    cfg_path = os.path.join(datapath, "intrinsics.json")
    if os.path.exists(cfg_path):
        intr.update(json.load(open(cfg_path)))

    poses = []
    for (_, _, k) in assoc:
        t = np.array(list(map(float, gt_list[k][1:4])))
        q = np.array(list(map(float, gt_list[k][4:8])))
        c2w = np.eye(4)
        c2w[:3, :3] = Rot.from_quat(q).as_matrix()
        c2w[:3, 3] = t
        poses.append(c2w)
    poses = _relative_poses(poses)

    sel = list(range(len(assoc)))
    if frame_num != -1:
        sel = sel[:frame_num]
    sel = [frame_start + i * (frame_step + 1) for i in sel
           if frame_start + i * (frame_step + 1) < len(assoc)]

    cams = []
    ce = int(crop_edge or 0)
    for uid, s in enumerate(sel):
        i, j, _ = assoc[s]
        depth = _load_depth(os.path.join(datapath, depth_list[j][1]), 5000.0)
        H, W = depth.shape
        img = _load_image(os.path.join(datapath, rgb_list[i][1]), (W, H))
        cx, cy = intr["cx"], intr["cy"]
        if ce > 0:
            img = img[ce:-ce, ce:-ce]
            depth = depth[ce:-ce, ce:-ce]
            H, W = depth.shape
            cx, cy = cx - ce, cy - ce
        cams.append(Camera(
            uid=uid, c2w=poses[s], fx=intr["fx"], fy=intr["fy"],
            cx=cx, cy=cy, width=W, height=H, image=img,
            depth=depth, pose_gt=poses[s].copy(), timestamp=t_rgb[i],
            depth_scale=5000.0,
        ))
    return cams


def read_romap(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
               json_path: Optional[str] = None, use_object=False, **_):
    """RO-MAP / Cube-Diorama layout: rgb/ + depth/ + groundtruth.txt +
    intrinsics in a transforms/config json. The reference declares this
    dataset type but its dispatch never handles it (`scene/__init__.py:81`)."""
    rgb_paths = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")) +
                       glob.glob(os.path.join(datapath, "rgb", "*.jpg")))
    depth_paths = sorted(glob.glob(os.path.join(datapath, "depth", "*.png")))
    gt_file = os.path.join(datapath, "groundtruth.txt")
    from scipy.spatial.transform import Rotation as Rot
    poses = []
    with open(gt_file) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = list(map(float, line.split()))
            c2w = np.eye(4)
            c2w[:3, 3] = v[1:4]
            c2w[:3, :3] = Rot.from_quat(v[4:8]).as_matrix()
            poses.append(c2w)
    poses = _relative_poses(poses)

    cfg = json.load(open(os.path.join(datapath, "camera.json")))
    n = min(len(rgb_paths), len(depth_paths), len(poses))
    sel = list(range(n)) if frame_num == -1 else list(range(min(n, frame_num)))
    sel = [frame_start + i * (frame_step + 1) for i in sel
           if frame_start + i * (frame_step + 1) < n]

    det_frames = None
    if use_object and json_path:
        _, det_frames = load_detection_json(json_path, cfg["w"], cfg["h"])

    cams = []
    for uid, s in enumerate(sel):
        depth = _load_depth(depth_paths[s], cfg.get("scale", 1000.0))
        H, W = depth.shape
        img = _load_image(rgb_paths[s], (W, H))
        cams.append(Camera(
            uid=uid, c2w=poses[s], fx=cfg["fx"], fy=cfg["fy"], cx=cfg["cx"],
            cy=cfg["cy"], width=W, height=H, image=img, depth=depth,
            pose_gt=poses[s].copy(), timestamp=s / 30.0,
            depth_scale=cfg.get("scale", 1000.0),
            detections=det_frames[s] if det_frames and s < len(det_frames)
            else None,
        ))
    return cams


def read_colmap(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
                **_):
    """COLMAP layout (ref `readColmapSceneInfo`, dataset_readers.py:201-330):
    images/ + sparse/0/{cameras,images}.{bin,txt}. No depth — cameras carry
    depth=None; rendering/eval paths work, the SLAM loop needs RGB-D."""
    from .colmap import image_c2w, load_colmap_sparse
    sparse = os.path.join(datapath, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(datapath, "sparse")
    cams_meta, imgs = load_colmap_sparse(sparse)
    order = sorted(imgs.keys(), key=lambda i: imgs[i]["name"])

    sel = list(range(len(order))) if frame_num == -1 else list(range(frame_num))
    sel = [frame_start + i * (frame_step + 1) for i in sel
           if frame_start + i * (frame_step + 1) < len(order)]

    poses = [image_c2w(imgs[order[s]]) for s in sel]
    cams = []
    for uid, (s, c2w) in enumerate(zip(sel, poses)):
        meta = imgs[order[s]]
        cm = cams_meta[meta["camera_id"]]
        img_path = os.path.join(datapath, "images", meta["name"])
        img = _load_image(img_path) if os.path.exists(img_path) else None
        H = img.shape[0] if img is not None else cm["height"]
        W = img.shape[1] if img is not None else cm["width"]
        sx, sy = W / cm["width"], H / cm["height"]
        cams.append(Camera(
            uid=uid, c2w=c2w, fx=cm["fx"] * sx, fy=cm["fy"] * sy,
            cx=cm["cx"] * sx, cy=cm["cy"] * sy, width=W, height=H,
            image=img, depth=None, pose_gt=c2w.copy(), timestamp=s / 30.0,
        ))
    return cams


def read_blender(datapath: str, frame_start=0, frame_num=-1, frame_step=0,
                 split="train", **_):
    """Blender/NeRF-synthetic layout (ref `readNerfSyntheticInfo`,
    dataset_readers.py:332-395): transforms_<split>.json with
    camera_angle_x + per-frame transform_matrix (OpenGL convention — flip
    Y/Z to get the OpenCV camera the rasterizer expects)."""
    meta = json.load(open(os.path.join(datapath, f"transforms_{split}.json")))
    frames = meta["frames"]
    sel = list(range(len(frames))) if frame_num == -1 else list(range(frame_num))
    sel = [frame_start + i * (frame_step + 1) for i in sel
           if frame_start + i * (frame_step + 1) < len(frames)]
    cams = []
    for uid, s in enumerate(sel):
        fr = frames[s]
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1          # OpenGL -> OpenCV
        p = fr["file_path"]
        img_path = os.path.join(datapath, p)
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        img = _load_image(img_path) if os.path.exists(img_path) else None
        if img is not None and img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:]     # composite over black
        H, W = (img.shape[:2] if img is not None else (800, 800))
        fx = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
        cams.append(Camera(
            uid=uid, c2w=c2w, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
            width=W, height=H, image=img, depth=None,
            pose_gt=c2w.copy(), timestamp=s / 30.0,
        ))
    return cams


def read_synthetic(datapath: str = "", frame_num=30, use_object=False,
                   width=160, height=120, seed=0, **_):
    from .synthetic import synthetic_sequence
    n = 30 if frame_num == -1 else frame_num
    _, cams = synthetic_sequence(n, width=width, height=height, seed=seed,
                                 with_detections=use_object)
    return cams


READERS = {
    "Replica": read_replica,
    "Tum": read_tum,
    "TUM": read_tum,
    "RO-MAP": read_romap,
    "CubeDiorama": read_romap,
    "Ours": read_ours,
    "Scannetpp": read_ours,
    "Colmap": read_colmap,
    "Blender": read_blender,
    "Synthetic": read_synthetic,
}


class Dataset:
    """Dispatching dataset (ref `scene/__init__.py:16-88`)."""

    def __init__(self, params):
        t = params.type
        if t not in READERS:
            raise ValueError(f"unknown dataset type {t!r}; known: {list(READERS)}")
        kwargs = dict(
            frame_start=params.frame_start, frame_num=params.frame_num,
            frame_step=params.frame_step, use_object=params.use_object,
            json_path=params.json_path,
        )
        if t == "Replica":
            kwargs["use_semantics"] = params.use_semantics
        if t == "TUM":
            kwargs["crop_edge"] = params.crop_edge
        if t in ("Ours", "Scannetpp"):
            kwargs = dict(frame_start=params.frame_start,
                          frame_num=params.frame_num,
                          frame_step=params.frame_step,
                          eval_=params.eval, crop_edge=params.crop_edge,
                          scannetpp=(t == "Scannetpp"))
        if t == "Synthetic":
            kwargs = {"frame_num": params.frame_num,
                      "use_object": params.use_object}
        self.cameras: List[Camera] = READERS[t](params.source_path, **kwargs)

    def __len__(self):
        return len(self.cameras)

    def __getitem__(self, i) -> Camera:
        return self.cameras[i]
