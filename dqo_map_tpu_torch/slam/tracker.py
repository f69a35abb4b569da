"""Frontend tracker: frame preprocessing and pose estimation (counterpart of
`dqo_map_tpu/slam/tracker.py`).

Preprocessing builds the vertex / normal / confidence maps, the range and
confidence masks and the ICP pyramids. With `async_pose` (set by
SLAMSystem) and no feature backend the pose chain stays on the device: the
ICP result is composed there, the frame adopts the device pose, and the
failure check reads the PREVIOUS frame's residual, one frame late, so the
host waits on nothing: on a card the frame's uploads go through pinned
memory without a wait, and the residual and the pose are copied into
pinned host memory as they are queued (`HostCopy`), so the next frame's
check and every later host reader of the pose wait only for that copy,
never for the work queued after it; and the ICP pyramid is one CUDA
graph launch (`icp.IcpGraph`), whose thousands of kernels would
otherwise fill the card's launch queue and hold the host. With the feature backend
(`use_orb_backend`, `pose_backend.py`) the pose is fused on the host: the
backend's detection runs while the device still computes the ICP pose,
then the pose and residual are read back once and fused, with the
feature pose standing in where ICP failed.
A failed frame's diagnostics are kept on the device and written at the end
of the run (`flush_icp_failures`, called by `save_traj`), which also writes
the trajectory files and the ATE.
"""

from __future__ import annotations

import atexit
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.cameras import Camera
from ..utils import image as im
from ..utils.host_copy import HostCopy
from ..utils import trace
from ..utils.math3d import eval_ate
from .icp import IcpConfig, IcpGraph, icp_pyramid
from .pose_backend import PoseBackend


def preprocess_frame(depth: torch.Tensor, color: torch.Tensor, K: torch.Tensor,
                     levels: int = 3, min_depth: float = 0.3,
                     max_depth: float = 5.0,
                     invalid_confidence_thresh: float = 0.2,
                     depth_filter: bool = False) -> dict:
    """depth (H,W) meters; color (H,W,3). Returns the frame map dict of
    camera-frame maps and pyramids; world-frame maps come after tracking."""
    if depth_filter:
        depth = im.bilateral_filter(depth, 5, 2.0, 2.0)[..., 0]
    valid = (depth > min_depth) & (depth < max_depth)
    depth = torch.where(valid, depth, 0.0)

    vertex_c = im.compute_vertex_map(depth, K)
    normal_c = im.compute_normal_map(vertex_c)
    confidence = im.compute_confidence_map(normal_c, K)

    invalid_conf = (torch.all(normal_c == 0, dim=-1)
                    | (confidence[..., 0] < invalid_confidence_thresh))
    depth = torch.where(invalid_conf, 0.0, depth)
    normal_c = torch.where(invalid_conf[..., None], 0.0, normal_c)
    vertex_c = torch.where(invalid_conf[..., None], 0.0, vertex_c)
    confidence = torch.where(invalid_conf[..., None], 0.0, confidence)

    vertex_pyr, normal_pyr = build_pyramids(depth, K, levels)
    return {
        "depth_map": depth,
        "color_map": color,
        "vertex_map_c": vertex_c,
        "normal_map_c": normal_c,
        "confidence_map": confidence,
        "invalid_confidence_mask": invalid_conf,
        "vertex_pyr": vertex_pyr,
        "normal_pyr": normal_pyr,
    }


def build_pyramids(depth: torch.Tensor, K: torch.Tensor, levels: int = 3):
    vp = tuple(im.build_vertex_pyramid(depth, K, levels))
    return vp, tuple(im.build_normal_pyramid(vp))


def _median3x3(x: torch.Tensor) -> torch.Tensor:
    """9-tap median of (H,W), edge-padded."""
    H, W = x.shape
    p = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    v = torch.stack([p[dy:dy + H, dx:dx + W] for dy in range(3)
                     for dx in range(3)])
    return torch.sort(v, dim=0).values[4]


def fuse_model_depth(render_depth, frame_depth, render_normal, frame_normal,
                     sample_distance_threshold: float = 0.01,
                     sample_normal_threshold: float = 0.01):
    """Frame-to-model depth fusion for the next ICP reference: the 3x3
    median of the render depth, blended with the frame depth by inverse
    variance where the two agree, the frame's own speckle giving the sensor
    noise (see the reference's docstring for the derivation)."""
    rd = _median3x3(render_depth)
    cos = torch.sum(render_normal * frame_normal, dim=-1) / (
        torch.linalg.norm(render_normal, dim=-1)
        * torch.linalg.norm(frame_normal, dim=-1) + 1e-8)
    normal_ok = (1.0 - cos) <= sample_normal_threshold
    both = (frame_depth > 0) & (rd > 0)
    agree = both & normal_ok & (
        torch.abs(rd - frame_depth) <= sample_distance_threshold)

    def gated_mean(x, m):
        return torch.sum(torch.where(m, x, 0.0)) / torch.clamp(torch.sum(m), min=1)

    hp = torch.abs(frame_depth - _median3x3(frame_depth))
    s_f = gated_mean(hp, agree) * 1.2533
    s_d = gated_mean(torch.abs(rd - frame_depth), agree) * 1.2533
    s_r2 = torch.clamp(s_d * s_d - s_f * s_f, min=1e-12)
    w = (s_f * s_f) / (s_f * s_f + s_r2)
    fused = torch.where(agree, w * rd + (1.0 - w) * frame_depth, frame_depth)
    return torch.where(frame_depth > 0, fused, rd)


def _upload(a, dev: torch.device) -> torch.Tensor:
    """A host array as a float32 tensor on `dev`; to a card through pinned
    memory without waiting for the stream."""
    t = torch.as_tensor(np.asarray(a, np.float32))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class Tracker:
    def __init__(self, args, width: int, height: int, device="cuda"):
        self.device = torch.device(device)
        self.use_gt_pose = args.use_gt_pose
        self.icp_use_model_depth = args.icp_use_model_depth
        self.min_depth = args.min_depth
        self.max_depth = args.max_depth
        self.depth_filter = args.depth_filter
        self.invalid_confidence_thresh = args.invalid_confidence_thresh
        self.icp_sample_distance_threshold = args.icp_sample_distance_threshold
        self.icp_sample_normal_threshold = args.icp_sample_normal_threshold
        self.levels = len(args.icp_downscales)
        self.icp_cfg = IcpConfig(
            downscales=tuple(args.icp_downscales),
            iters=tuple(args.icp_downscale_iters),
            distance_threshold=args.icp_distance_threshold,
            normal_threshold_cos=float(
                math.cos(math.radians(args.icp_normal_threshold))),
            damping=args.icp_damping,
            fail_threshold=args.icp_fail_threshold,
            min_valid_ratio=getattr(args, "icp_min_valid_ratio", 0.3),
        )
        self.width = width
        self.height = height
        self.K = None
        self.pose_gt: list = []
        self.pose_es: list = []        # numpy (4,4), the last maybe a tensor
        self._pose_copy = None         # HostCopy of a tensor pose_es[-1]
        self.timestamps: list = []
        self.icp_fail_count = 0
        self.save_path: Optional[str] = None   # set by SLAMSystem for dumps
        self._fail_dumps = 0
        self._fail_pending: list = []
        self.async_pose = False        # device-side pose chain (SLAMSystem)
        self._pending_p2p = None       # HostCopy of [p2p, valid_ratio]
        self._last_pyr = None          # (vertex_pyr, normal_pyr) of frame t0
        self._curr_pyr = None
        self._icp_graph = None         # IcpGraph, on a card
        # the feature pose backend; its library is built here at first use
        self.pose_backend = (PoseBackend(args)
                             if getattr(args, "use_orb_backend", False)
                             else None)

    # ------------------------------------------------------------------
    def map_preprocess(self, frame: Camera, frame_id: int) -> dict:
        dev = self.device
        self.K = _upload(frame.K, dev)
        fm = preprocess_frame(
            _upload(frame.depth, dev), _upload(frame.image, dev), self.K,
            levels=self.levels, min_depth=self.min_depth,
            max_depth=self.max_depth,
            invalid_confidence_thresh=self.invalid_confidence_thresh,
            depth_filter=self.depth_filter,
        )
        self._curr_pyr = (fm["vertex_pyr"], fm["normal_pyr"])
        fm["time"] = frame_id
        # the semantic and instance images, which the scans supervise with
        for key, img in (("semantics", frame.semantics),
                         ("instance_img", frame.instance)):
            fm[key] = None if img is None else _upload(img, dev)
        return fm

    def tracking(self, frame: Camera, frame_map: dict) -> bool:
        """Estimate the frame pose, update `frame`, and lift the maps to the
        world frame."""
        self.pose_gt.append(np.asarray(frame.pose_gt, np.float64))
        self.timestamps.append(frame.timestamp)
        success = True
        if self.use_gt_pose:
            pose_t1_w = self.pose_gt[-1]
        elif self._last_pyr is None:
            # first frame (or first after a resume): hold the last pose
            pose_t1_w = (self._pose_np(len(self.pose_es) - 1)
                         if self.pose_es else np.eye(4))
            if self.pose_backend is not None:
                # the feature tracker's reference frame
                self.pose_backend.ingest(frame)
                self.pose_backend.poses.append(pose_t1_w)
        else:
            pose10, p2p, valid_ratio = self._icp(*self._last_pyr,
                                                 *self._curr_pyr)
            if self.async_pose and self.pose_backend is None:
                # deferred failure check on the previous frame's residual,
                # read from its host copy before the next one is queued
                if self._pending_p2p is not None:
                    p_prev, vr_prev = self._pending_p2p.numpy().tolist()
                    if (p_prev > self.icp_cfg.fail_threshold
                            or vr_prev < self.icp_cfg.min_valid_ratio):
                        self.icp_fail_count += 1
                        self._dump_icp_failure(frame_map, p_prev, None)
                self._pending_p2p = HostCopy(torch.stack(
                    [p2p, valid_ratio.float()]), "tracking/icp/residual/wait")
                pose_dev = self._pose_dev() @ pose10
                pose_copy = HostCopy(pose_dev, "tracking/pose/wait")
                self._last_pyr = self._curr_pyr
                self._append_pose(pose_dev, pose_copy)
                frame.set_pose_device(pose_dev, pose_copy)
                frame_map["vertex_map_w"] = im.transform_map(
                    frame_map["vertex_map_c"], pose_dev)
                frame_map["normal_map_w"] = im.rotate_map(
                    frame_map["normal_map_c"], pose_dev)
                return True
            if self.pose_backend is not None:
                # the native detection needs no pose: it runs while the
                # device still computes the ICP result
                with trace.span(tag="tracker/feature_detect",
                                wait_end=False):
                    self.pose_backend.detect(frame)
            # one readback of the pose and the residual
            with trace.span("tracking/icp/readback/wait",
                            tag="tracker/pose_sync", wait_end=False):
                host = torch.cat([pose10.reshape(-1), p2p.reshape(1).float(),
                                  valid_ratio.reshape(1).float()]
                                 ).cpu().numpy()
            pose10 = host[:16].reshape(4, 4).astype(np.float64)
            p2p, valid_ratio = float(host[16]), float(host[17])
            success = (p2p <= self.icp_cfg.fail_threshold
                       and valid_ratio >= self.icp_cfg.min_valid_ratio)
            if not success:
                self.icp_fail_count += 1
                self._dump_icp_failure(frame_map, p2p, pose10)
            if self.pose_backend is not None:
                # fusion, the feature pose standing in where ICP failed
                with trace.span(tag="tracker/feature_backend",
                                wait_end=False):
                    pose_t1_w = self.pose_backend.track(frame, pose10,
                                                        success)
            else:
                pose_t1_w = self._pose_np(len(self.pose_es) - 1) @ pose10

        self._last_pyr = self._curr_pyr
        self._append_pose(np.asarray(pose_t1_w, np.float64))
        frame.update_pose(pose_t1_w)
        with trace.span("tracking/pose/upload/wait"):
            c2w = torch.as_tensor(frame.c2w, dtype=torch.float32,
                                  device=self.device)
        frame_map["vertex_map_w"] = im.transform_map(frame_map["vertex_map_c"], c2w)
        frame_map["normal_map_w"] = im.rotate_map(frame_map["normal_map_c"], c2w)
        return success

    def _icp(self, vp0, np0, vp1, np1):
        """`icp_pyramid` of the two frames; on a card through its
        `IcpGraph`, captured at the first call (and again where the
        shapes change)."""
        if not self.K.is_cuda:
            return icp_pyramid(vp0, np0, vp1, np1, self.K, self.icp_cfg)
        if self._icp_graph is None or not self._icp_graph.fits(vp0, self.K):
            self._icp_graph = IcpGraph(vp0, np0, vp1, np1, self.K,
                                       self.icp_cfg)
        return self._icp_graph(vp0, np0, vp1, np1, self.K)

    def _append_pose(self, pose, copy: Optional[HostCopy] = None) -> None:
        """Append a pose: numpy, or a device tensor with its `HostCopy`.
        The pose before it, where it was a device tensor, becomes its host
        copy's array, so that only the last pose holds a copy in flight."""
        if self._pose_copy is not None:
            self.pose_es[-1] = np.asarray(self._pose_copy.numpy(), np.float64)
        self._pose_copy = copy
        self.pose_es.append(pose)

    def _pose_np(self, i: int) -> np.ndarray:
        """`pose_es[i]` as float64 numpy. Only the last pose can be a
        device tensor; it is read from the host copy queued with it."""
        p = self.pose_es[i]
        if isinstance(p, torch.Tensor):
            p = self._pose_copy.numpy()
        return np.asarray(p, np.float64)

    def _pose_dev(self) -> torch.Tensor:
        """Last pose as a float32 device tensor."""
        if self.pose_es:
            p = self.pose_es[-1]
            if isinstance(p, torch.Tensor):
                return p
            with trace.span("tracking/pose/upload/wait"):
                return torch.as_tensor(np.asarray(p), dtype=torch.float32,
                                       device=self.device)
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def _dump_icp_failure(self, frame_map: dict, p2p: float,
                          pose10: Optional[np.ndarray], max_dumps: int = 5):
        """Keep a failed frame's diagnostics, at most `max_dumps`: the
        finest-level vertex maps of both frames, the depth, the rejected
        relative pose (None where the check ran a frame late) and the
        residual. Only references to the device tensors are kept here;
        `flush_icp_failures` writes them, at the end of the run (or at
        exit, so that they outlive a crash), never inside a tracked
        frame."""
        if self.save_path is None or self._fail_dumps >= max_dumps:
            return
        self._fail_pending.append({
            "idx": len(self.pose_es), "p2p": p2p, "pose10": pose10,
            "vertex_last": (self._last_pyr[0][-1]
                            if self._last_pyr is not None else None),
            "vertex_curr": self._curr_pyr[0][-1],
            "depth": frame_map["depth_map"],
            "n_fail": self.icp_fail_count,
        })
        self._fail_dumps += 1
        if self._fail_dumps == 1:
            atexit.register(self.flush_icp_failures)
        if self._fail_dumps >= max_dumps:
            self.flush_icp_failures()

    def flush_icp_failures(self):
        """Write the kept failure diagnostics to
        `<save_path>/icp_fail/fail_<frame>.npz`."""
        if not self._fail_pending or self.save_path is None:
            return
        d = os.path.join(self.save_path, "icp_fail")
        os.makedirs(d, exist_ok=True)

        def host(x):
            if x is None:
                return np.zeros(0)
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        for rec in self._fail_pending:
            np.savez_compressed(
                os.path.join(d, f"fail_{rec['idx']:05d}.npz"),
                p2p=rec["p2p"], pose10=host(rec["pose10"]),
                vertex_last=host(rec["vertex_last"]),
                vertex_curr=host(rec["vertex_curr"]),
                depth=host(rec["depth"]), n_fail=rec["n_fail"])
        self._fail_pending = []

    def update_last_status(self, frame, render_depth, frame_depth,
                           render_normal, frame_normal):
        """With `icp_use_model_depth`, the fused rendered depth becomes the
        next ICP reference."""
        if not self.icp_use_model_depth:
            return
        fused = fuse_model_depth(
            render_depth, frame_depth, render_normal, frame_normal,
            self.icp_sample_distance_threshold,
            self.icp_sample_normal_threshold)
        self._last_pyr = build_pyramids(fused, self.K, self.levels)

    # ------------------------------------------------------------------
    def poses_np(self) -> list:
        return [self._pose_np(i) for i in range(len(self.pose_es))]

    def eval_ate_series(self) -> float:
        es = np.stack([p[:3, 3] for p in self.poses_np()])
        gt = np.stack([p[:3, 3] for p in self.pose_gt])
        return eval_ate(es, gt)

    def save_traj(self, save_path: str) -> float:
        """Write `save_traj/`: the estimated and ground-truth poses
        (`pose_es.npy`, `pose_gt.npy`), the estimate as a TUM trajectory
        (`poses.txt`: stamp tx ty tz qx qy qz qw) and the ATE in cm
        (`ate.txt`); flush the failure diagnostics. Returns the ATE."""
        from scipy.spatial.transform import Rotation
        traj_dir = os.path.join(save_path, "save_traj")
        os.makedirs(traj_dir, exist_ok=True)
        self.flush_icp_failures()
        pose_es = np.stack(self.poses_np())
        np.save(os.path.join(traj_dir, "pose_es.npy"), pose_es)
        np.save(os.path.join(traj_dir, "pose_gt.npy"), np.stack(self.pose_gt))
        ate = self.eval_ate_series()
        with open(os.path.join(traj_dir, "poses.txt"), "w") as f:
            for ts, p in zip(self.timestamps, pose_es):
                q = Rotation.from_matrix(p[:3, :3]).as_quat()
                t = p[:3, 3]
                f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
        with open(os.path.join(traj_dir, "ate.txt"), "w") as f:
            f.write(f"{ate}\n")
        return ate
