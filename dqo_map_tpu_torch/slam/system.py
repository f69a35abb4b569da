"""SLAM orchestration: tracker + mapper over a sequence of frames
(counterpart of `dqo_map_tpu/slam/system.py`, its `step`).

The port runs synchronously: `step` waits for the device at the end of
tracking and at the end of mapping, so the two times it returns are the
device's. `step` runs the whole per-frame loop, the optimize scans
included. The reference's `run` (its final whole-history optimization and
the map export), the feature pose backend, the object layer and
multi-device mapping are not ported yet.
"""

from __future__ import annotations

import time

import torch

from ..config import Config
from ..models.cameras import Camera
from .mapper import Mapping
from .tracker import Tracker


class SLAMSystem:
    def __init__(self, cfg: Config, cameras, device="cuda"):
        if cfg.opt.use_object:
            raise NotImplementedError("the object layer is not ported yet; "
                                      "set use_object=False")
        if cfg.parallel.parallel_enabled:
            raise NotImplementedError("multi-device mapping is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cameras = cameras
        self.width, self.height = cameras[0].width, cameras[0].height
        self.mapping = Mapping(cfg, self.width, self.height, self.device)
        self.tracker = Tracker(cfg.tracking, self.width, self.height, self.device)
        # the pose chain stays on the device
        self.tracker.async_pose = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, frame: Camera, frame_id: int) -> dict:
        """One tracked and mapped frame. The caller advances
        `mapping.time` after it, as the reference's callers do."""
        t0 = time.perf_counter()
        frame_map = self.tracker.map_preprocess(frame, frame_id)
        self.tracker.tracking(frame, frame_map)
        self._sync()
        t1 = time.perf_counter()

        self.mapping.mapping(frame, frame_map, frame_id)
        # the end-of-frame model render feeds the finalize error counts and
        # the tracker's model-depth reference. Where no optimize scan ran,
        # the pre-densify render of `gaussians_add` (same pose, the map less
        # this frame's new points, whose error counters are zero) serves.
        if self.mapping.did_optimize or self.mapping.model_map is None:
            out = self.mapping.get_render_output(frame.render_inputs(self.device))
        else:
            out = self.mapping.model_map
        self.mapping.finalize_frame(out, frame_map)
        self.tracker.update_last_status(
            frame, out["depth"], frame_map["depth_map"], out["normal"],
            frame_map["normal_map_w"])
        self._sync()
        t2 = time.perf_counter()
        return {"tracker_s": t1 - t0, "mapper_s": t2 - t1, "render": out}
