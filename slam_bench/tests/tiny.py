"""A cell of `BENCHMARK.json` cut to a size the CPU runs in seconds: the
same traffic and configuration files, the frames 1/15 of the size (the
camera scaled with them), a small map, a few samples, 4 Adam steps a
scan, a keyframe every ~11 frames, a quality frame of 11
and passes of two frames more, so that a run restarts its system."""

from __future__ import annotations

import copy

from slam_bench.harness import load_cell

SCALE = 15


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(load_cell(name))
    cam = cell["config"]["camera"]
    for k in ("fx", "fy"):
        cam[k] = cam[k] / SCALE
    for k, n in (("cx", "width"), ("cy", "height")):
        cam[k] = (cam[k] + 0.5) / SCALE - 0.5
    cam["width"] = cam["width"] // SCALE
    cam["height"] = cam["height"] // SCALE
    cell["config"]["config"].update(
        capacity=1 << 14, add_capacity=2048, uniform_sample_num=300,
        gaussian_update_iter=4, stable_confidence_thres=4)
    t = cell["traffic"]
    orbit = t["path"]["kind"] == "orbit"
    t["path"]["step_rad"] = 0.03
    if orbit:
        t["path"]["radius"] = 0.9
    t["pool_frames"] = 14 if orbit else t["pool_frames"]
    t["quality_frame"] = 11 if orbit else 5
    t["warmup"]["max_frames"] = 12
    t["window"]["pass_frames"] = t["quality_frame"] + 2
    t["trace"] = {"profiled_frames": 2, "min_timed_frames": 2,
                  "max_timed_frames": 6}
    t["check"]["track_frames"] = 2
    return cell
