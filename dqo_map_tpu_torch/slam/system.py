"""SLAM orchestration: tracker + mapper over a sequence of frames
(counterpart of `dqo_map_tpu/slam/system.py`).

The port runs synchronously: `step` waits for the device at the end of
tracking and at the end of mapping, so the two times it returns are the
device's. `step` runs the whole per-frame loop, the optimize scans
included. `run` drives `step` over the frames with periodic evaluation and
checkpoints, then runs the final whole-history pass, the final evaluation,
and writes the trajectory, the PLY map and `performance.json`.
`save_checkpoint` / `resume` stop and restart a run at any frame. The
feature pose backend, the object layer and multi-device mapping are not
ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..config import Config
from ..data import Dataset
from ..eval.evaluate import eval_frame
from ..models.cameras import Camera
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.monitor import Recorder
from ..utils.ply import densify_point_cloud, write_point_normal_ply
from .mapper import Mapping
from .tracker import Tracker


class SLAMSystem:
    def __init__(self, cfg: Config, cameras=None, device="cuda"):
        """Over `cameras`, or by default the frames of `cfg.dataset`."""
        if cfg.opt.use_object:
            raise NotImplementedError("the object layer is not ported yet; "
                                      "set use_object=False")
        if cfg.parallel.parallel_enabled:
            raise NotImplementedError("multi-device mapping is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        if cameras is None:
            cameras = Dataset(cfg.dataset).cameras
        self.cameras = cameras
        self.width, self.height = cameras[0].width, cameras[0].height
        self.recorder = Recorder(self.device)
        self.mapping = Mapping(cfg, self.width, self.height, self.device)
        self.tracker = Tracker(cfg.tracking, self.width, self.height, self.device)
        self.tracker.save_path = cfg.map.save_path
        # the pose chain stays on the device
        self.tracker.async_pose = True
        self.save_path = cfg.map.save_path
        os.makedirs(self.save_path, exist_ok=True)
        self.metrics_history: list = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, frame: Camera, frame_id: int) -> dict:
        """One tracked and mapped frame. The caller advances
        `mapping.time` after it, as `run` does."""
        t0 = time.perf_counter()
        frame_map = self.tracker.map_preprocess(frame, frame_id)
        self.tracker.tracking(frame, frame_map)
        self._sync()
        t1 = time.perf_counter()
        self.recorder.update_mean("tracking", t1 - t0)

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
        self.recorder.update_mean("mapping", t2 - t1)
        return {"tracker_s": t1 - t0, "mapper_s": t2 - t1, "render": out}

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write a checkpoint (`utils/checkpoint.py`), by default
        `checkpoint/ckpt_<time>` under the save path; returns the npz
        path."""
        if path is None:
            path = os.path.join(self.save_path, "checkpoint",
                                f"ckpt_{self.mapping.time:05d}")
        return save_checkpoint(path, self)

    def resume(self, path: str) -> int:
        """Restore from `save_checkpoint` output (the path with or without
        its .npz suffix); returns the next frame id."""
        if path.endswith(".npz"):
            path = path[:-4]
        return load_checkpoint(path, self)

    def _eval(self, frame: Camera) -> dict:
        c = self.cfg.map
        return eval_frame(self.mapping, frame,
                          os.path.join(self.save_path, "eval_render"),
                          c.min_depth, c.max_depth, save_picture=True)

    def run(self, eval_every: int = 0, verbose: bool = True,
            max_frames: int = -1, start_frame: int = 0,
            checkpoint_every: int = 0) -> dict:
        """Frames `start_frame` .. (all, or `max_frames`), evaluated on the
        first and every `eval_every`-th, checkpointed every
        `checkpoint_every`-th; then the final whole-history pass, the final
        evaluation at the last frame, the trajectory (`save_traj/`), the map
        (`save_model/`) and `performance.json`. Returns the final metrics
        with `ate_cm` and the performance numbers."""
        n = len(self.cameras) if max_frames < 0 else min(max_frames,
                                                         len(self.cameras))
        for frame_id in range(start_frame, n):
            frame = self.cameras[frame_id]
            info = self.step(frame, frame_id)
            if verbose:
                u, st = self.mapping.counts()
                print(f"frame {frame_id:4d}: tracker {info['tracker_s']*1000:6.1f} ms"
                      f"  mapper {info['mapper_s']*1000:6.1f} ms"
                      f"  unstable {u}  stable {st}")
            if eval_every and ((frame_id + 1) % eval_every == 0 or frame_id == 0):
                m = self._eval(frame)
                m["frame"] = frame_id
                self.metrics_history.append(m)
                if verbose:
                    print(f"  eval: psnr {m['psnr']:.2f}  depth-L1 "
                          f"{m['depth_l1_cm']:.2f} cm")
            self.mapping.time += 1
            if checkpoint_every and (frame_id + 1) % checkpoint_every == 0:
                p = self.save_checkpoint()
                if verbose:
                    print(f"  checkpoint -> {p}")

        self.mapping.global_optimization(is_end=True)
        final = self._eval(self.cameras[n - 1])
        self.metrics_history.append({**final, "frame": "final"})
        ate = self.tracker.save_traj(self.save_path)
        self.mapping.save_model()
        if self.cfg.map.pcd_densify:
            pts, nrms = densify_point_cloud(self.mapping.state, sigma=1,
                                            circle_num=30, levels=5)
            write_point_normal_ply(os.path.join(
                self.save_path, "save_model", "pcd_densify.ply"), pts, nrms)
        self.recorder.watch_gpu()
        self.recorder.cal_fps()
        perf = self.recorder.save(self.save_path)
        return {**final, "ate_cm": ate, **perf}
