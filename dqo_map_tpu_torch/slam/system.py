"""SLAM orchestration: tracker, mapper and object layer over a sequence of
frames (counterpart of `dqo_map_tpu/slam/system.py`).

`step` runs one frame: tracking, mapping with its optimize scans, the
end-of-frame render and the finalize tail. How often the host waits for
the device follows `sync_tracker2mapper_method`: `strict` (the default)
waits at the end of tracking and at the end of mapping, so the two times
`step` returns are the device's; `loose` waits only at the end of every
`sync_tracker2mapper_frames`-th frame and `free` never, so on the frames
that do not wait the times are the host's, the time to queue the work
(or, where the host had to read something back, to wait for it). Outside
strict mode `tracker_max_fps` caps the rate at which frames start. `run`
drives `step` over the frames with periodic evaluation and checkpoints,
then runs the final whole-history pass, the final evaluation, writes the
trajectory, the PLY map and `performance.json`, and, with the object
layer, `save_obj/` (`objects.txt`, `iou.txt`) and the instance and
semantic colour passes. `save_checkpoint` / `resume` stop and restart a
run at any frame. With `parallel_enabled` the system builds a mesh of
`parallel_devices` devices of its own type (by default every one) and
gives it to the mapper and the object layer: the keyframe scan and the
final pass then run data-parallel over it, and MODE=1's object refinement
shards over it by object (`parallel/dp.py`).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data import Dataset
from ..eval.evaluate import eval_frame
from ..models.cameras import Camera
from ..models.quadrics import TRUNCATION, ObjectLayer
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.monitor import Recorder
from ..utils.ply import densify_point_cloud, write_point_normal_ply
from ..utils.png import write_png
from ..parallel.dp import make_mesh
from ..utils import trace
from .mapper import Mapping
from .renderer import render_instance, render_semantic
from .tracker import Tracker

SYNC_METHODS = ("strict", "loose", "free")


class SLAMSystem:
    def __init__(self, cfg: Config, dataset: Optional[Dataset] = None,
                 cameras=None, device="cuda"):
        """Over `cameras`, else the frames of `dataset`, by default the
        `Dataset` of `cfg.dataset`."""
        self.cfg = cfg
        self.device = torch.device(device)
        if cameras is None:
            cameras = (dataset or Dataset(cfg.dataset)).cameras
        self.cameras = cameras
        self.width, self.height = cameras[0].width, cameras[0].height
        self.recorder = Recorder(self.device)
        self.mapping = Mapping(cfg, self.width, self.height, self.device)
        self.tracker = Tracker(cfg.tracking, self.width, self.height, self.device)
        self.tracker.save_path = cfg.map.save_path
        # the pose chain stays on the device (without the feature backend)
        self.tracker.async_pose = True
        self.object_layer = (ObjectLayer(cfg, self.device)
                             if cfg.opt.use_object else None)
        if cfg.parallel.parallel_enabled:
            mesh = make_mesh(cfg.parallel.parallel_devices or None,
                             self.device.type)
            self.mapping.mesh = mesh
            if self.object_layer is not None:
                self.object_layer.mesh = mesh
        self.save_path = cfg.map.save_path
        os.makedirs(self.save_path, exist_ok=True)
        self.metrics_history: list = []
        s = cfg.system
        self.sync_method = s.sync_tracker2mapper_method
        if self.sync_method not in SYNC_METHODS:
            raise ValueError(f"sync_tracker2mapper_method must be one of "
                             f"{SYNC_METHODS}, got {self.sync_method!r}")
        self.sync_frames = max(1, int(s.sync_tracker2mapper_frames or 1))
        self.tracker_max_fps = float(cfg.tracking.tracker_max_fps or 0)
        self._last_step_t = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _frame_syncs(self, frame_id: int) -> bool:
        """Does the host wait for the device at the end of this frame?"""
        return (self.sync_method == "strict"
                or (self.sync_method == "loose"
                    and (frame_id + 1) % self.sync_frames == 0))

    def step(self, frame: Camera, frame_id: int) -> dict:
        """One tracked and mapped frame. The caller advances
        `mapping.time` after it, as `run` does. Returns the tracking and
        mapping seconds (device times in strict mode, host times on the
        frames that do not wait otherwise) and the end-of-frame render.
        With the recorder on (`utils/trace.py`) the frame is one
        `system/step#<frame_id>` span."""
        with trace.frame(frame_id):
            return self._step(frame, frame_id)

    def _step(self, frame: Camera, frame_id: int) -> dict:
        t0 = time.perf_counter()
        if (self.tracker_max_fps > 0 and self.sync_method != "strict"
                and self._last_step_t is not None):
            wait = 1.0 / self.tracker_max_fps - (t0 - self._last_step_t)
            if wait > 0:
                time.sleep(wait)
                t0 = time.perf_counter()
        self._last_step_t = t0
        with trace.span(tag="tracker"):
            with trace.span("tracking/preprocess"):
                frame_map = self.tracker.map_preprocess(frame, frame_id)
            with trace.span("tracking/icp"):
                self.tracker.tracking(frame, frame_map)
        if self.sync_method == "strict":
            with trace.span("tracking/sync/wait"):
                self._sync()
        t1 = time.perf_counter()
        self.recorder.update_mean("tracking", t1 - t0)

        self.mapping.mapping(frame, frame_map, frame_id, self.object_layer,
                             defer_finalize=True)
        # the end-of-frame model render feeds the finalize error counts and
        # the tracker's model-depth reference. Where no optimize scan ran,
        # the pre-densify render of `gaussians_add` (same pose, the map less
        # this frame's new points, whose error counters are zero) serves.
        if self.mapping.did_optimize or self.mapping.model_map is None:
            with trace.span(tag="get_render_output"):
                out = self.mapping.get_render_output(
                    frame.render_inputs(self.device))
        else:
            out = self.mapping.model_map
        self.mapping.finalize_frame(out, frame_map)
        self.tracker.update_last_status(
            frame, out["depth"], frame_map["depth_map"], out["normal"],
            frame_map["normal_map_w"])
        if self._frame_syncs(frame_id):
            with trace.span("mapping/sync/wait"):
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

    def save_object_passes(self, frame: Camera):
        """The instance and semantic colour passes of the map at `frame`,
        written as `eval_render/instance.png` and `semantic.png`."""
        m = self.mapping
        cam = frame.render_inputs(self.device)
        cats = torch.as_tensor(self.object_layer.categories_table(),
                               device=self.device)
        d = os.path.join(self.save_path, "eval_render")
        os.makedirs(d, exist_ok=True)
        with torch.no_grad():
            for name, img in (
                    ("instance", render_instance(m.state, cam, m.settings)),
                    ("semantic", render_semantic(m.state, cam, m.settings,
                                                 cats))):
                arr = np.clip(img.cpu().numpy() * 255, 0, 255).astype(np.uint8)
                write_png(os.path.join(d, f"{name}.png"), arr)

    def save_objects(self, frame: Camera):
        """`save_obj/objects.txt`, the colour passes at `frame`, and
        `save_obj/iou.txt`: the mean projected-box IoU of each object over
        its observations (`record_iou`). As in the JAX package, a failure
        of the IoU log is printed and the run carries on."""
        obj_dir = os.path.join(self.save_path, "save_obj")
        self.object_layer.save(obj_dir)
        self.save_object_passes(frame)
        try:
            ious = self.object_layer.record_iou(np.asarray(frame.K,
                                                           np.float64))
            with open(os.path.join(obj_dir, "iou.txt"), "w") as f:
                for oid, iou in sorted(ious.items()):
                    f.write(f"{oid} {iou:.6f}\n")
        except Exception as e:
            print(f"[slam] record_iou failed: {e}")

    def run(self, eval_every: int = 0, verbose: bool = True,
            max_frames: int = -1, start_frame: int = 0,
            checkpoint_every: int = 0) -> dict:
        """Frames `start_frame` .. (all, or `max_frames`), evaluated on the
        first and every `eval_every`-th, checkpointed every
        `checkpoint_every`-th; then the final whole-history pass, the final
        evaluation at the last frame, the trajectory (`save_traj/`), the map
        (`save_model/`) and `performance.json`. Returns the final metrics
        with `ate_cm` and the performance numbers. A failed trajectory
        write is printed and leaves `ate_cm` None, as in the JAX
        package."""
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
        ate = None
        try:
            ate = self.tracker.save_traj(self.save_path)
        except Exception as e:
            print(f"[slam] traj save failed: {e}")
        self.mapping.save_model()
        if self.cfg.map.pcd_densify:
            pts, nrms = densify_point_cloud(self.mapping.state, sigma=1,
                                            circle_num=30, levels=5)
            write_point_normal_ply(os.path.join(
                self.save_path, "save_model", "pcd_densify.ply"), pts, nrms)
        if self.object_layer is not None:
            self.save_objects(self.cameras[n - 1])
        self.recorder.watch_gpu()
        self.recorder.cal_fps()
        perf = self.recorder.save(self.save_path)
        result = {**final, "ate_cm": ate, **perf}
        if self.object_layer is not None:
            # the capacity receipts: observations and objects the caps cut
            result["n_objects"] = len(self.object_layer.objects)
            result["obj_obs_trimmed"] = TRUNCATION["obs_trimmed"]
            result["obj_over_cap"] = TRUNCATION["objects_over_cap"]
        return result
