"""The feature pose backend (counterpart of `dqo_map_tpu/slam/pose_backend.py`):
the port's own ctypes binding of the native tracker in
`runtime/orb_backend.cc` (oriented-BRIEF corners, Hamming matching, RANSAC
3D-3D alignment, a keyframe store with local bundle adjustment, loop
detection), and the fusion policy that turns its answers and the ICP pose
into the frame's world pose.

The library is built from `runtime/orb_backend.cc` at first use, with
`g++` and the flags of `runtime/Makefile`, into `dqo_map_tpu_torch/_build/`
under a name keyed by the source's and the flags' hash, so that both
packages run the same code. `runtime/` is only read. A failed build or load
raises, with the compiler's output: the tracker does not fall back to ICP
alone.

Fusion, per frame:
  * the ICP relative pose seeds the feature matcher (projective gating);
  * a keyframe's absolute pose wins when its match is strong and agrees
    with the composed relative estimate (or right after a tracking loss);
  * else the feature relative pose, with enough inliers;
  * else the ICP relative pose, when ICP converged;
  * else the last pose is held.
The fused pose is committed back, so the backend anchors its keyframes in
the world frame; every `LOOP_EVERY` frames a loop is looked for, and a
found one relaxes the keyframe chain (`pose_graph.close_loop`).

Spans (`utils/trace.py`, off by default): `tracking/backend/detect` (the
detection), `tracking/backend/match` (`ob_match_staged`: matching,
keyframe insertion and its local BA), `tracking/backend/fuse` (the policy
and `commit`) and `tracking/backend/loop` (`maybe_close_loop`, staged tag
`tracker/feature_loop`); they nest in the tracker's `tracking/icp`.
Counters: `source_counts` (frames won by each estimate), beside
`num_keyframes`, `num_mappoints` and `loop_closures`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..utils import trace
from ..utils.native import build_shared
from .pose_graph import close_loop

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "runtime" / "orb_backend.cc"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]
# the estimates that can set a tracked frame's pose (`PoseBackend.track`)
SOURCES = ("keyframe", "features", "icp", "hold")


def build_library() -> Path:
    """Compile `runtime/orb_backend.cc` into `_build/` unless a library of
    the same source and flags is already there; returns its path. Raises
    with the compiler's output when `g++` is missing or fails."""
    return build_shared(SOURCE, BUILD_DIR, "liborb_backend", CXX_FLAGS, [],
                        "the feature pose backend")


_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    d, i, v = ctypes.c_double, ctypes.c_int, ctypes.c_void_p
    dptr, iptr = ctypes.POINTER(d), ctypes.POINTER(i)
    u8ptr, fptr = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    sigs = {
        "ob_create": (v, [i, i, d, d, d, d, i]),
        "ob_ingest_frame": (i, [v, u8ptr, fptr]),
        "ob_match_staged": (i, [v, dptr, dptr, dptr, iptr]),
        "ob_accept_pose": (None, [v, dptr]),
        "ob_num_keyframes": (i, [v]),
        "ob_detect_loop": (i, [v, i, i, iptr, iptr, dptr]),
        "ob_get_kf_poses": (i, [v, dptr, i]),
        "ob_set_kf_poses": (None, [v, dptr, i]),
        "ob_destroy": (None, [v]),
        "ob_local_ba": (i, [v, i, i]),
        "ob_num_mappoints": (i, [v]),
        "ob_ba_residual": (d, [v]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _LIB = lib
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class PoseBackend:
    """Per-sequence feature tracker with a keyframe map.
    `track(frame, icp_pose10, icp_success)` returns the frame's world pose
    (c2w)."""

    MIN_INLIERS = 12
    MIN_KF_INLIERS = 20
    # a keyframe's absolute pose wins only when it agrees with the composed
    # relative estimate (one wrong keyframe match must not move the camera
    # across the room); after a tracking loss ("hold") it always wins
    KF_GATE_TRANS = 0.30         # meters
    KF_GATE_ROT = 20.0           # degrees
    KF_GAIN = 1.0                # share of the keyframe correction applied
    LOOP_MIN_GAP = 20            # keyframes between query and candidate
    LOOP_MIN_INLIERS = 25
    LOOP_EVERY = 5               # frames between loop searches

    def __init__(self, args):
        self._lib = _load_lib()
        self._handle = None
        self._staged = None
        self._max_feats = int(getattr(args, "orb_max_feats", 1000))
        # feature-tracking image subsample factor (1 = full resolution);
        # the native cost grows with the pixels
        self._scale = max(1, int(getattr(args, "orb_downsample", 1) or 1))
        self.KF_GAIN = float(getattr(args, "orb_kf_gain", self.KF_GAIN))
        self.use_icp = bool(getattr(args, "orb_useicp", True))
        self.use_loop_closing = bool(getattr(args, "orb_loop_closing", True))
        self.LOOP_MIN_GAP = int(getattr(args, "orb_loop_min_gap",
                                        self.LOOP_MIN_GAP))
        self.LOOP_MIN_INLIERS = int(getattr(args, "orb_loop_min_inliers",
                                            self.LOOP_MIN_INLIERS))
        self.LOOP_EVERY = int(getattr(args, "orb_loop_every", self.LOOP_EVERY))
        self.poses: list = []
        self.n_inliers_last = -1
        self.kf_inliers_last = -1
        self.source_last = "init"
        self.source_counts = dict.fromkeys(SOURCES, 0)
        self.loop_closures = 0
        self._frame_i = 0

    def _ensure(self, W, H, K):
        if self._handle is None:
            self._handle = self._lib.ob_create(
                int(W), int(H), float(K[0, 0]), float(K[1, 1]),
                float(K[0, 2]), float(K[1, 2]), self._max_feats)

    def _frame_arrays(self, frame):
        """uint8 grey image and float32 depth of `frame`, subsampled."""
        img = np.asarray(frame.image)
        s = self._scale
        if s > 1:
            img = img[::s, ::s]
        if img.ndim == 3:
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])
        else:
            gray = img
        if gray.dtype != np.uint8:
            gray = np.clip(gray * (255.0 if gray.max() <= 1.5 else 1.0),
                           0, 255).astype(np.uint8)
        depth = np.asarray(frame.depth, np.float32)
        if s > 1:
            depth = depth[::s, ::s]
        return np.ascontiguousarray(gray), np.ascontiguousarray(depth)

    def detect(self, frame) -> int:
        """The detection phase alone (pyramid, corners, descriptors, depth
        lift), which needs no pose: the tracker calls it while the device
        still computes the ICP pose (the ctypes call releases the GIL).
        `ingest` or `track` on the same frame then only match."""
        with trace.span("tracking/backend/detect"):
            gray, depth = self._frame_arrays(frame)
            H, W = gray.shape
            K = np.asarray(frame.K, np.float64)
            if self._scale > 1:
                K = K.copy() / self._scale
                K[2, 2] = 1.0
            self._ensure(W, H, K)
            n = self._lib.ob_ingest_frame(
                self._handle,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        self._staged = frame
        return n

    def ingest(self, frame, icp_pose10: np.ndarray = None) -> int:
        """Feed one frame; returns the feature pose's inlier count (< 0
        before the second frame). Sets `rel` (T_{prev<-curr}) and, where a
        keyframe matched, `abs_pose` (T_{world<-curr})."""
        if self._staged is not frame:
            self.detect(frame)
        self._staged = None
        rel = np.eye(4, dtype=np.float64).reshape(-1)
        abs_p = np.eye(4, dtype=np.float64).reshape(-1)
        kf_inl = ctypes.c_int(-1)
        prior = (np.ascontiguousarray(icp_pose10, np.float64).reshape(-1)
                 if icp_pose10 is not None else None)
        with trace.span("tracking/backend/match"):
            n = self._lib.ob_match_staged(
                self._handle, _dptr(prior) if prior is not None else None,
                _dptr(rel), _dptr(abs_p), ctypes.byref(kf_inl))
        self.rel = rel.reshape(4, 4)
        self.abs_pose = abs_p.reshape(4, 4)
        self.n_inliers_last = n
        self.kf_inliers_last = int(kf_inl.value)
        return n

    @staticmethod
    def _nudge(a: np.ndarray, b: np.ndarray, g: float) -> np.ndarray:
        """Pose a moved towards b by the fraction g: translation lerped,
        rotation along the axis of the relative rotation (Rodrigues)."""
        out = a.copy()
        out[:3, 3] = (1 - g) * a[:3, 3] + g * b[:3, 3]
        R = a[:3, :3].T @ b[:3, :3]
        c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        ang = np.arccos(c)
        if ang > 1e-8:
            axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                             R[1, 0] - R[0, 1]]) / (2.0 * np.sin(ang))
            th = g * ang
            Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            Rg = (np.eye(3) + np.sin(th) * Kx
                  + (1 - np.cos(th)) * (Kx @ Kx))
            out[:3, :3] = a[:3, :3] @ Rg
        return out

    @staticmethod
    def _pose_gap(a: np.ndarray, b: np.ndarray):
        """(translation distance, rotation angle in degrees) of two poses."""
        dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
        R = a[:3, :3].T @ b[:3, :3]
        c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        return dt, float(np.degrees(np.arccos(c)))

    def _kf_agrees(self, est: np.ndarray) -> bool:
        dt, dr = self._pose_gap(self.abs_pose, est)
        return dt <= self.KF_GATE_TRANS and dr <= self.KF_GATE_ROT

    def track(self, frame, icp_pose10: np.ndarray, icp_success: bool):
        """The fused world pose of `frame`; `source_last` says which
        estimate won (keyframe, features, icp or hold)."""
        icp_ok = self.use_icp and icp_success and icp_pose10 is not None
        n = self.ingest(frame, icp_pose10 if (self.use_icp and icp_success)
                        else None)
        with trace.span("tracking/backend/fuse"):
            last = self.poses[-1] if self.poses else np.eye(4)
            # the composed relative estimate: the keyframe gate's yardstick
            if n >= self.MIN_INLIERS:
                est = last @ self.rel
            elif icp_ok:
                est = last @ np.asarray(icp_pose10, np.float64)
            else:
                est = None
            if self.kf_inliers_last >= self.MIN_KF_INLIERS and (
                    est is None or self.source_last == "hold"
                    or self._kf_agrees(est)):
                if est is None or self.source_last == "hold":
                    pose_w = self.abs_pose
                else:
                    pose_w = self._nudge(est, self.abs_pose, self.KF_GAIN)
                self.source_last = "keyframe"
            elif n >= self.MIN_INLIERS:
                pose_w = last @ self.rel
                self.source_last = "features"
            elif icp_ok:
                pose_w = last @ np.asarray(icp_pose10, np.float64)
                self.source_last = "icp"
            else:
                pose_w = last.copy()
                self.source_last = "hold"
            self.poses.append(pose_w)
            self.commit(pose_w)
            self.source_counts[self.source_last] += 1
        self._frame_i += 1
        if self.use_loop_closing and self._frame_i % self.LOOP_EVERY == 0:
            with trace.span("tracking/backend/loop", tag="tracker/feature_loop",
                            wait_end=False):
                self.maybe_close_loop()
        return self.poses[-1]

    # -- loop closing -------------------------------------------------------
    def get_kf_poses(self) -> np.ndarray:
        n = self.num_keyframes()
        out = np.zeros((max(n, 1), 16), np.float64)
        got = self._lib.ob_get_kf_poses(self._handle, _dptr(out),
                                        int(out.shape[0]))
        return out[:got].reshape(-1, 4, 4)

    def set_kf_poses(self, poses: np.ndarray):
        p = np.ascontiguousarray(poses, np.float64).reshape(-1)
        self._lib.ob_set_kf_poses(self._handle, _dptr(p), int(poses.shape[0]))

    def maybe_close_loop(self) -> bool:
        """Look for a loop at the newest keyframe; where one is found, relax
        the keyframe chain, write the corrected anchors back to the native
        store and move the newest pose with its keyframe."""
        if self._handle is None:
            return False
        q, m = ctypes.c_int(-1), ctypes.c_int(-1)
        rel = np.eye(4, dtype=np.float64).reshape(-1)
        inl = self._lib.ob_detect_loop(
            self._handle, self.LOOP_MIN_GAP, self.LOOP_MIN_INLIERS,
            ctypes.byref(q), ctypes.byref(m), _dptr(rel))
        if inl <= 0:
            return False
        kf_poses = self.get_kf_poses()
        if kf_poses.shape[0] <= max(q.value, m.value):
            return False
        new_poses, delta = close_loop(kf_poses, q.value, m.value,
                                      rel.reshape(4, 4))
        self.set_kf_poses(new_poses)
        if self.poses:
            self.poses[-1] = delta @ self.poses[-1]
            self.commit(self.poses[-1])
        self.loop_closures += 1
        return True

    def commit(self, pose_w: np.ndarray):
        """Feed the fused world pose back for keyframe anchoring."""
        p = np.ascontiguousarray(pose_w, np.float64).reshape(-1)
        self._lib.ob_accept_pose(self._handle, _dptr(p))

    def num_keyframes(self) -> int:
        return int(self._lib.ob_num_keyframes(self._handle)) \
            if self._handle else 0

    def num_mappoints(self) -> int:
        """Landmarks with live observations (the local BA's state)."""
        return int(self._lib.ob_num_mappoints(self._handle)) \
            if self._handle else 0

    def local_ba(self, window: int = 5, sweeps: int = 3) -> int:
        """One windowed local bundle adjustment (it also runs at every
        keyframe insertion); returns the landmarks optimized."""
        return int(self._lib.ob_local_ba(self._handle, window, sweeps)) \
            if self._handle else 0

    def ba_residual(self) -> float:
        """Mean 3D residual (m) over the landmarks seen more than once."""
        return float(self._lib.ob_ba_residual(self._handle)) \
            if self._handle else 0.0

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.ob_destroy(self._handle)
            self._handle = None
